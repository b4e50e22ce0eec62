"""The evaluator's inputs on the CPU: frames copied in their own dtype and
cast to fp32 on the device.

uint8 and int32 → fp32 are exact, so such frames give the disparities and
states that fp32 frames give, bit for bit. The frames are 60×90, which the
evaluator pads to 64×96. The card's side (KITTI size) is in
``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from tcs_tpu_torch import ModelConfig
from tcs_tpu_torch.evaluate import TemporalEvaluator
from tcs_tpu_torch.models import TCStereo

# The test processes share the host: two intra-op threads each, so that
# several workers do not oversubscribe its cores.
torch.set_num_threads(2)

H, W, ITERS, FRAMES, D = 60, 90, 2, 3, 2
CFG = ModelConfig(mixed_precision=False, corr_dtype="float32")


@pytest.fixture(scope="module")
def model():
    return TCStereo(CFG, device="cpu", seed=3)


@pytest.fixture(scope="module")
def stream():
    """FRAMES frames of D streams: uint8 views, K, baseline, poses."""
    rng = np.random.default_rng(17)
    K = np.tile(np.array([[60.0, 0, 44.5], [0, 60.0, 29.5], [0, 0, 1]], np.float32), (D, 1, 1))
    T = np.tile(np.eye(4, dtype=np.float32), (FRAMES, D, 1, 1))
    T[:, :, 0, 3] = 0.02 * np.arange(FRAMES)[:, None]
    return {"images": rng.integers(0, 256, (FRAMES, 2, D, H, W, 3), dtype=np.uint8),
            "K": K, "baseline": np.full((D,), 0.5, np.float32), "T": T}


def _run(model, stream, dtype, batched):
    """The evaluator over the stream's frames in ``dtype``; batched: all D
    streams in one call, else the first stream alone. Returns each frame's
    (disparity, state)."""
    ev = TemporalEvaluator(model, CFG, ITERS, device="cpu")
    out = []
    for k in range(FRAMES):
        i1, i2 = stream["images"][k].astype(dtype)
        if batched:
            args = (i1, i2, stream["K"], stream["baseline"], stream["T"][k])
        else:
            args = (i1[0], i2[0], stream["K"][0], float(stream["baseline"][0]), stream["T"][k][0])
        out.append((ev(*args), ev.state))
    return out


@pytest.fixture(scope="module")
def fp32_runs(model, stream):
    """The fp32 frames' runs, batched and unbatched, made once."""
    return {batched: _run(model, stream, np.float32, batched) for batched in (True, False)}


def _state_tensors(s):
    return (s.disp_q, *s.net_list, s.fmap1, s.T_prev)


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_input_dtypes_give_the_same_disparities_and_states(model, stream, fp32_runs,
                                                           batched, dtype):
    """uint8 frames (a decoder's) and int32 frames (a 16-bit PGM's) give what
    fp32 frames give, bit for bit."""
    got = _run(model, stream, dtype, batched)
    for (disp, state), (ref_disp, ref_state) in zip(got, fp32_runs[batched]):
        assert disp.shape == ((D, H, W) if batched else (H, W))
        np.testing.assert_array_equal(disp, ref_disp)
        assert state.valid and ref_state.valid
        for a, b in zip(_state_tensors(state), _state_tensors(ref_state)):
            assert torch.equal(a, b)


def _layouts(f):
    """Two views of (2, D, H, W, 4) frames in layouts a caller may hand over."""
    w_major = np.ascontiguousarray(f[1].transpose(0, 2, 1, 3)).transpose(0, 2, 1, 3)
    return {"rgba_channels": (f[0][..., :3], f[1][..., :3]),
            "mirrored": (f[0][:, :, ::-1, :3], f[1][..., 2::-1]),
            "w_major": (f[0][..., 1:], w_major[..., :3])}


@pytest.mark.parametrize("layout", ["rgba_channels", "mirrored", "w_major"])
def test_each_call_keeps_its_own_frames_in_any_layout(model, layout):
    """Views that are not contiguous, negative strides among them, reach the
    device as the frames they show."""
    ev = TemporalEvaluator(model, CFG, ITERS, device="cpu")
    rng = np.random.default_rng(5)
    views = _layouts(rng.integers(0, 256, (2, D, H, W, 4), dtype=np.uint8))[layout]
    assert not any(v.flags["C_CONTIGUOUS"] for v in views)
    for v, x in zip(views, ev._device_images(*views)):
        assert x.dtype == torch.float32
        assert torch.equal(x, torch.from_numpy(v.astype(np.float32)))
