"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks the ``cuda_device`` fixture for the card and
skips without one. On a GPU machine: ``python -m pytest tests/test_torch_kernels.py``.
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
