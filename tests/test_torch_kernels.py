"""The port's CUDA kernels against their plain PyTorch versions on the card, and
the loader's pinned batches and the evaluator's uint8 frames on their way to
it.

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

# The test processes share the host: two intra-op threads each, so that
# several workers do not oversubscribe its cores.
torch.set_num_threads(2)

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


def _splat_inputs(case, B, H, W, C, seed):
    """(values, flow) on the CPU: values from 1e-4 to 1e4 in magnitude, and a
    flow of one kind. "mixed": small flow, some targets out of the image, a
    NaN and an inf; "collisions": eight columns collapse onto one; "one_cell":
    every source of an image to one point (buckets of H·W keys); "all_out":
    every target out of the image."""
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(B, H, W, C)) * 10.0 ** rng.uniform(-4, 4, size=(B, H, W, 1))
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    if case == "mixed":
        flow = rng.normal(scale=3.0, size=(B, H, W, 2))
        flow[0, :, :3, 0] = -40.0
        flow[-1, H // 2, W // 2, 0] = np.nan
        flow[-1, H // 3, W // 3, 1] = np.inf
    elif case == "collisions":
        flow = np.stack([np.broadcast_to(-(xs % 8), (B, H, W))
                         + rng.uniform(0, 0.25, size=(B, H, W)),
                         rng.normal(scale=0.7, size=(B, H, W))], -1)
    elif case == "one_cell":
        flow = np.broadcast_to(np.stack([W / 3 + 0.3 - xs, H / 2 + 0.6 - ys], -1),
                               (B, H, W, 2))
    else:
        flow = np.broadcast_to(np.array([W + 5.0, -0.5]), (B, H, W, 2))
    return (torch.from_numpy(values.astype(np.float32)),
            torch.from_numpy(np.ascontiguousarray(flow, dtype=np.float32)))


def _splat_on_card(values, flow, dev):
    before = _kernels.launches["splat_sum"]
    out = splat.splat_sum(values.to(dev), flow.to(dev))
    torch.cuda.synchronize()
    assert _kernels.launches["splat_sum"] == before + 1
    return out.cpu()


def test_splat_kernel(cuda_device):
    """Bit for bit the plain version on the CPU: the same (tap, source) order
    of fp32 sums, each product rounded first."""
    values, flow = _splat_inputs("mixed", 2, 12, 20, 258, seed=0)
    out = _splat_on_card(values, flow, cuda_device)
    assert torch.equal(out, splat.splat_sum_plain(values, flow))


def test_splat_kernel_is_deterministic(cuda_device):
    """Two launches on an input where many sources meet give the same bits."""
    values, flow = _splat_inputs("collisions", 2, 24, 40, 258, seed=1)
    first = _splat_on_card(values, flow, cuda_device)
    assert torch.equal(first, _splat_on_card(values, flow, cuda_device))
    assert torch.equal(first, splat.splat_sum_plain(values, flow))


# (case, B, H, W, C): buckets over 32 keys, every target out, odd C, and pixel
# counts at and around the scan's 4,096-count tiles and across many of them
# (40 tiles: more than one 32-tile window of its look-back).
SPLAT_EDGES = [("one_cell", 2, 12, 20, 258), ("one_cell", 1, 64, 96, 5),
               ("all_out", 2, 12, 20, 258), ("mixed", 2, 12, 20, 1),
               ("mixed", 2, 12, 20, 257), ("collisions", 1, 5, 819, 3),
               ("collisions", 1, 64, 64, 2), ("collisions", 1, 1, 8191, 4),
               ("mixed", 3, 100, 150, 6), ("collisions", 2, 200, 400, 2)]


@pytest.mark.parametrize("case,B,H,W,C", SPLAT_EDGES)
def test_splat_kernel_edges(cuda_device, case, B, H, W, C):
    values, flow = _splat_inputs(case, B, H, W, C, seed=B * H * W + C)
    out = _splat_on_card(values, flow, cuda_device)
    assert torch.equal(out, splat.splat_sum_plain(values, flow))
    if case == "all_out":
        assert not out.any()


def test_splat_kernel_without_pixels(cuda_device):
    values, flow = torch.zeros(2, 0, 7, 258), torch.zeros(2, 0, 7, 2)
    out = _splat_on_card(values, flow, cuda_device)
    assert out.shape == values.shape


def test_splat_kernel_rejects_past_int32_keys(cuda_device):
    """Its bucket keys are int32: 2^29 pixels or more raise before any launch
    (an expanded flow and zero channels: nothing that large is allocated)."""
    n = 2**29
    values = torch.empty(1, 1, n, 0, device=cuda_device)
    flow = torch.zeros(2, device=cuda_device).expand(1, 1, n, 2)
    before = _kernels.launches["splat_sum"]
    with pytest.raises(ValueError, match="int32"):
        splat.splat_sum(values, flow)
    assert _kernels.launches["splat_sum"] == before
    ok = torch.empty(1, 1, n - 1, 0, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):  # the next check, past the limit's
        splat.splat_sum(ok, flow[:, :, 1:])


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


def test_tartanair_evaluator_launches_the_kernels(cuda_device, tmp_path):
    """``validate_tartanair`` on a fabricated 64×96 tree (2 sequences of 3
    frames) reaches both forward kernels: one lookup per iteration and one
    splat per frame after each sequence's first."""
    from tcs_tpu_torch import ModelConfig
    from tcs_tpu_torch.data import fabricate
    from tcs_tpu_torch.evaluate import validate_tartanair
    from tcs_tpu_torch.models import TCStereo

    fabricate.tartanair_tree(str(tmp_path), frames=3, height=64, width=96)
    cfg = ModelConfig()
    _kernels.reset_launches()
    res = validate_tartanair(TCStereo(cfg, device=cuda_device), cfg, iters=2,
                             root=str(tmp_path), device=cuda_device)
    assert dict(_kernels.launches) == {"corr_lookup": 6 * 2, "corr_lookup_bwd": 0,
                                       "splat_sum": 6 - 2, "splat_sum_bwd": 0}
    assert len(res) == 5 and all(np.isfinite(v) for v in res.values())


class _Clips:
    """Six clips of random fields at a tiny size."""

    shapes = {"image1": (2, 4, 6, 3), "image2": (2, 4, 6, 3), "flow": (2, 4, 6, 1),
              "valid": (2, 4, 6, 1), "T": (2, 4, 4), "K": (3, 3), "baseline": ()}

    def __len__(self):
        return 6

    def load_sample(self, index, rng):
        return {k: rng.random(shape).astype(np.float32) for k, shape in self.shapes.items()}


@pytest.mark.parametrize("workers", [0, 1])
def test_loader_stacks_pinned_batches_that_reach_the_card_unchanged(cuda_device, workers):
    from tcs_tpu_torch.data.loader import SequenceLoader
    from tcs_tpu_torch.train import SequenceBatch

    plain = SequenceLoader(_Clips(), 2, seed=5, num_workers=0)
    with SequenceLoader(_Clips(), 2, seed=5, num_workers=workers, pin_memory=True) as pinned:
        for a, b in zip(plain, pinned):
            assert all(b[k].is_pinned() and np.array_equal(a[k], b[k].numpy())
                       for k in _Clips.shapes)
            on_card = SequenceBatch.from_loader(b, cuda_device)
            for k in _Clips.shapes:
                assert torch.equal(getattr(on_card, k).cpu(), torch.from_numpy(a[k]))


KITTI_STREAMS, KITTI_H, KITTI_W = 8, 375, 1242


def test_evaluator_casts_uint8_frames_on_the_card_bit_for_bit_at_kitti_size(cuda_device):
    """Three frames of 8 KITTI streams in the default (bf16) config: uint8
    frames cast on the card give the disparities and states that fp32 frames
    give, bit for bit."""
    from tcs_tpu_torch import ModelConfig
    from tcs_tpu_torch.device import deterministic
    from tcs_tpu_torch.evaluate import TemporalEvaluator
    from tcs_tpu_torch.models import TCStereo

    cfg = ModelConfig()
    model = TCStereo(cfg, device=cuda_device, seed=4)
    rng = np.random.default_rng(8)
    frames = rng.integers(0, 256, (3, 2, KITTI_STREAMS, KITTI_H, KITTI_W, 3), dtype=np.uint8)
    K = np.tile(np.array([[721.5377, 0, 609.5593], [0, 721.5377, 172.854], [0, 0, 1]],
                         np.float32), (KITTI_STREAMS, 1, 1))
    baseline = np.full((KITTI_STREAMS,), 0.54, np.float32)
    runs = {}
    with deterministic():
        for dtype in (np.uint8, np.float32):
            ev = TemporalEvaluator(model, cfg, iters=5, device=cuda_device)
            runs[dtype] = []
            for k in range(3):
                T = np.tile(np.eye(4, dtype=np.float32), (KITTI_STREAMS, 1, 1))
                T[:, 2, 3] = -0.8 * k
                i1, i2 = frames[k].astype(dtype)
                disp = ev(i1, i2, K, baseline, T)
                s = ev.state
                state = (s.disp_q, *s.net_list, s.fmap1, s.T_prev)
                runs[dtype].append((disp, [t.cpu() for t in state]))
    for (disp, state), (ref_disp, ref_state) in zip(runs[np.uint8], runs[np.float32]):
        assert disp.shape == (KITTI_STREAMS, KITTI_H, KITTI_W)
        np.testing.assert_array_equal(disp, ref_disp)
        assert all(torch.equal(a, b) for a, b in zip(state, ref_state))
