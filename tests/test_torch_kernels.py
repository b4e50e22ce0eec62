"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks the ``cuda_device`` fixture for the card and
skips without one. On a GPU machine, where JAX is missing and
``tests/conftest.py`` cannot be imported:
``python -m pytest --noconftest tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from tcs_tpu_torch.ops import _kernels
from tcs_tpu_torch.ops import corr, splat

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _pyramid(g, B, H, W, dtype, dev, levels=4):
    f1 = torch.randn(B, H, W, 32, generator=g)
    f2 = torch.randn(B, H, W, 32, generator=g)
    cv = corr.build_cost_volume(f1, f2)
    return tuple(p.to(dtype).contiguous().to(dev) for p in corr.corr_pyramid(cv, levels))


@pytest.mark.parametrize("dtype,radius,tol", [(torch.float32, 4, 1e-5),
                                              (torch.bfloat16, 4, 1e-6),
                                              (torch.float32, 2, 1e-5)])
def test_lookup_kernel(cuda_device, dtype, radius, tol):
    g = torch.Generator().manual_seed(0)
    B, H, W = 2, 6, 45  # odd width: levels 45, 22, 11, 5
    pyr = _pyramid(g, B, H, W, dtype, cuda_device)
    coords = (torch.rand(B, H, W, generator=g) * (W + 20) - 10).to(cuda_device)
    coords[0, 0, :5] = torch.arange(5.0)  # integer coordinates
    before = _kernels.launches["corr_lookup"]
    out = corr.lookup(pyr, coords, radius)
    torch.cuda.synchronize()
    assert _kernels.launches["corr_lookup"] == before + 1
    ref = corr.lookup_plain(pyr, coords, radius)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert (out - ref).abs().max().item() <= tol


def test_lookup_kernel_rejects_bad_input(cuda_device):
    g = torch.Generator().manual_seed(0)
    pyr = _pyramid(g, 1, 2, 16, torch.float32, cuda_device)
    coords = torch.zeros(1, 2, 16, device=cuda_device)
    with pytest.raises(ValueError):
        corr.lookup(pyr[:1] + (pyr[1][..., :-1].contiguous(),), coords, 4)
    with pytest.raises(ValueError):
        corr.lookup(pyr, coords.cpu(), 4)
    with pytest.raises(TypeError):
        corr.lookup(pyr, coords.double(), 4)


LOOKUP_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-6}  # as chip_smoke.py holds them
# Level widths: 45 → 22 → 11 → 5 and 180 → 90 → 45 → 22, whose rows straddle
# the backward's 16-byte chunks; 8 → 4 → 2 → 1, every level narrower than a
# radius-8 window.
EDGE_WIDTHS = (45, 180, 8)
EDGE_ROWS = (1, 7, 33)  # fewer than a block, and not a multiple of one
EDGE_RADII = (1, 8)  # the kernels' template bounds
EDGE_DTYPES = (torch.float32, torch.bfloat16)


def _edge_inputs(dtype, radius, rows, width, dev, seed):
    """A 4-level pyramid of ``rows`` rows (1, 1, rows, width >> i), its
    coordinates and an output cotangent. From the sixth row on the
    coordinates are random across and past the row; the first five are NaN,
    +inf, -inf, +1e20 and -1e20 where there are that many rows."""
    g = torch.Generator().manual_seed(seed)
    f1 = torch.randn(1, 1, rows, 16, generator=g)
    f2 = torch.randn(1, 1, width, 16, generator=g)
    pyr = tuple(p.to(dtype).contiguous().to(dev)
                for p in corr.corr_pyramid(corr.build_cost_volume(f1, f2), 4))
    coords = torch.rand(1, 1, rows, generator=g) * (width + 2 * radius + 4) - radius - 2
    if rows >= 5:
        coords[0, 0, :5] = torch.tensor([float("nan"), float("inf"), float("-inf"),
                                         1e20, -1e20])
    cot = torch.randn(1, 1, rows, 4 * (2 * radius + 1), generator=g)
    return pyr, coords.to(dev), cot.to(dev)


@pytest.mark.parametrize("width", EDGE_WIDTHS)
@pytest.mark.parametrize("rows", EDGE_ROWS)
@pytest.mark.parametrize("radius", EDGE_RADII)
@pytest.mark.parametrize("dtype", EDGE_DTYPES)
def test_lookup_kernel_edges(cuda_device, dtype, radius, rows, width):
    """The forward kernel at the edges of its grid and its templates: NaN
    where the plain version has NaN (a non-finite coordinate), the rest
    within LOOKUP_TOL, zeros for far-out coordinates."""
    pyr, coords, _ = _edge_inputs(dtype, radius, rows, width, cuda_device, seed=rows + width)
    before = _kernels.launches["corr_lookup"]
    out = corr.lookup(pyr, coords, radius)
    torch.cuda.synchronize()
    assert _kernels.launches["corr_lookup"] == before + 1
    ref = corr.lookup_plain(pyr, coords, radius)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    nan = ref.isnan()
    assert torch.equal(out.isnan(), nan)
    assert (out[~nan] - ref[~nan]).abs().max().item() <= LOOKUP_TOL[dtype]
    if rows >= 5:
        assert not out[0, 0, 3:5].any()  # ±1e20 reads no tap


@pytest.mark.parametrize("width", EDGE_WIDTHS)
@pytest.mark.parametrize("rows", EDGE_ROWS)
@pytest.mark.parametrize("radius", EDGE_RADII)
@pytest.mark.parametrize("dtype", EDGE_DTYPES)
def test_lookup_backward_kernel_edges(cuda_device, dtype, radius, rows, width):
    """The backward kernel at the edges of its grid and its templates, bit
    for bit the plain backward: ragged level tails, chunks that straddle
    rows, rows of zeros for non-finite and far-out coordinates."""
    pyr, coords, cot = _edge_inputs(dtype, radius, rows, width, cuda_device,
                                    seed=100 + rows + width)
    leaves = [p.clone().requires_grad_() for p in pyr]
    before = _kernels.launches["corr_lookup_bwd"]
    grads = torch.autograd.grad(corr.lookup(leaves, coords, radius), leaves, cot)
    torch.cuda.synchronize()
    assert _kernels.launches["corr_lookup_bwd"] == before + 1
    refs = corr.lookup_bwd_plain(cot, coords, radius, [p.shape[-1] for p in pyr], dtype)
    for a, b in zip(grads, refs):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.equal(a, b)
        if rows >= 5:
            assert not a[0, 0, :5].any()


def test_splat_kernel(cuda_device):
    rng = np.random.default_rng(0)
    B, H, W, C = 2, 12, 20, 258
    values = torch.from_numpy(rng.normal(size=(B, H, W, C)).astype(np.float32))
    flow = rng.normal(scale=3.0, size=(B, H, W, 2)).astype(np.float32)
    flow[0, :, :3, 0] = -40.0
    flow[1, 2, 5, 0] = np.nan
    flow[1, 3, 7, 1] = np.inf
    values, flow = values.to(cuda_device), torch.from_numpy(flow).to(cuda_device)
    out = splat.splat_sum(values, flow)
    torch.cuda.synchronize()
    ref = splat.splat_sum_plain(values, flow)
    # fp32 atomics add in a varying order: hold to 1e-5 of the largest sum.
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("dtype,radius", [(torch.float32, 4), (torch.bfloat16, 4),
                                          (torch.float32, 2)])
def test_lookup_backward_kernel(cuda_device, dtype, radius):
    """Through the autograd function: bit for bit the plain backward (the
    same fp32 products and sum, one rounding into bf16)."""
    g = torch.Generator().manual_seed(1)
    B, H, W = 2, 6, 45  # odd width: levels 45, 22, 11, 5
    pyr = [p.requires_grad_() for p in _pyramid(g, B, H, W, dtype, cuda_device)]
    coords = (torch.rand(B, H, W, generator=g) * (W + 20) - 10).to(cuda_device)
    coords[0, 0, :5] = torch.arange(5.0)
    coords[1, 0, :3] = torch.tensor([float("nan"), float("inf"), -1e20])
    cot = torch.randn(B, H, W, 4 * (2 * radius + 1), generator=g).to(cuda_device)
    before = dict(_kernels.launches)
    out = corr.lookup(pyr, coords.clone().requires_grad_(), radius)
    grads = torch.autograd.grad(out, pyr, cot)
    torch.cuda.synchronize()
    assert _kernels.launches["corr_lookup"] == before["corr_lookup"] + 1
    assert _kernels.launches["corr_lookup_bwd"] == before["corr_lookup_bwd"] + 1
    refs = corr.lookup_bwd_plain(cot, coords, radius, [p.shape[-1] for p in pyr], dtype)
    for a, b in zip(grads, refs):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.equal(a, b)
        assert not a[1, 0, :3].any()


def test_splat_backward_kernel(cuda_device):
    rng = np.random.default_rng(2)
    B, H, W, C = 2, 12, 20, 258
    values = torch.from_numpy(rng.normal(size=(B, H, W, C)).astype(np.float32))
    flow = rng.normal(scale=3.0, size=(B, H, W, 2)).astype(np.float32)
    flow[0, :, :3, 0] = -40.0
    flow[0, 5, 5] = [2.0, -1.0]
    flow[1, 2, 5, 0] = np.nan
    flow[1, 3, 7, 1] = np.inf
    cot = torch.from_numpy(rng.normal(size=(B, H, W, C)).astype(np.float32)).to(cuda_device)
    values = values.to(cuda_device).requires_grad_()
    flow = torch.from_numpy(flow).to(cuda_device).requires_grad_()
    before = _kernels.launches["splat_sum_bwd"]
    dv, df = torch.autograd.grad(splat.splat_sum(values, flow), (values, flow), cot)
    torch.cuda.synchronize()
    assert _kernels.launches["splat_sum_bwd"] == before + 1
    rdv, rdf = splat.splat_sum_bwd_plain(cot, values.detach(), flow.detach())
    assert torch.isfinite(dv).all() and torch.isfinite(df).all()
    assert not df[1, 2, 5].any() and not dv[1, 3, 7].any()
    # dvalues: the same products in the same order; dflow: a warp sums the
    # channels' dot products in another order than torch.sum.
    assert (dv - rdv).abs().max().item() <= 1e-6 * rdv.abs().max().item()
    assert (df - rdf).abs().max().item() <= 1e-4 * rdf.abs().max().item()


def test_model_on_card_matches_cpu(cuda_device):
    """Three frames of the fp32 model at 64×96, kernels vs plain versions."""
    from tcs_tpu_torch import ModelConfig
    from tcs_tpu_torch.models import CameraParams, TCStereo, TemporalState

    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(mixed_precision=False, corr_dtype="float32")
    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 255, size=(3, 2, 1, 64, 96, 3)).astype(np.float32)
    K = torch.tensor([[[100.0, 0, 48], [0, 100.0, 32], [0, 0, 1]]])
    flows = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = TCStereo(cfg, device=dev, seed=2)
        state = TemporalState.zeros(1, 64, 96, cfg, device=dev)
        cam = CameraParams(K=K.to(dev), baseline=torch.full((1,), 0.5, device=dev))
        flows[dev.type] = []
        for k in range(3):
            T = torch.eye(4)[None].clone()
            T[0, 0, 3] = 0.02 * k
            out = model(torch.from_numpy(imgs[k, 0]).to(dev),
                        torch.from_numpy(imgs[k, 1]).to(dev), state, cam, T.to(dev),
                        iters=2)
            state = out.new_state
            flows[dev.type].append(out.flow.cpu())
    torch.backends.cudnn.allow_tf32 = True
    for a, b in zip(flows["cuda"], flows["cpu"]):
        assert (a - b).abs().max().item() <= 5e-2


def test_pool2x_backward_on_a_channel_last_hidden_state(cuda_device):
    """The layout the GRUs pool: an NCHW view of channel-last memory."""
    from tcs_tpu_torch.ops import sampler

    g = torch.Generator().manual_seed(9)
    hidden = torch.randn(2, 16, 24, 128, generator=g)
    cot = torch.randn(2, 128, 8, 12, generator=g)
    grads = []
    for dev in (cuda_device, "cpu"):
        x = hidden.to(dev).permute(0, 3, 1, 2).requires_grad_()
        grads.append(torch.autograd.grad(sampler.pool2x_nchw(x), x, cot.to(dev))[0].cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)
