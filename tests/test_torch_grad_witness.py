"""The port's frame gradients against a float64 run of the port, with the
ReLU kinks pinned: a check of the backward that kink noise cannot hide.

``tests/test_torch_train.py`` holds the named leaves of the port's fp32
gradient against ``tcs_tpu``'s at 3e-2 of the leaf's largest entry, the
free-kink limit: two fp32 runs put a dozen of the window's ReLU units on
different sides of their kinks, and each moves a leaf that sums over few
pixels by percents. That bound is too wide to catch a wrong backward. This
test needs no JAX program. It runs the same weights and frames (seed pair
(61, 7), frames 0 and 1, each frame's own backward from the carried state)
through the port twice: in float64 (``tcs_tpu_torch.utils.kinks.widened``),
and in fp32 with every ReLU and leaky-ReLU unit put on the side of its kink
that the float64 run took (``Kinks``). What is left is the rounding of fp32
arithmetic, and every named leaf is held to 1e-3 of the float64 gradient's
largest entry. Measured on an 8-core x86 CPU (torch 2.13.0+cpu): ≤ 5.2e-5,
on ``disp_completor.conv_disp_stem.0.weight`` (frame 0; 4.5e-5 on frame 1),
with 11 of 21,554,688 units pinned to the other side.
"""

import contextlib

import numpy as np
import torch

from tcs_tpu_torch import ModelConfig, TrainConfig
from tcs_tpu_torch.data.synthetic import SyntheticStereoSequence
from tcs_tpu_torch.models import CameraParams, TCStereo, TemporalState
from tcs_tpu_torch.models.layers import set_compute_dtype
from tcs_tpu_torch.train import SequenceBatch, frame_losses
from tcs_tpu_torch.utils.kinks import Kinks, widened

B, H, W, ITERS, FRAMES = 1, 64, 96, 2, 2
MODEL_SEED, SCENE_SEED = 61, 7
PINNED_RTOL = 1e-3  # of the float64 gradient's largest entry
NAMED_LEAVES = ("cnet.conv1.weight", "update_block.gru08.convzr.weight",
                "disp_completor.conv_disp_stem.0.weight", "disp_refine.mask.2.weight")


def _clip(seed):
    """``test_torch_train.py``'s clip: two planes, and a camera that also
    moves along y and z, so that no splat target falls on an integer."""
    ds = SyntheticStereoSequence(frame_length=FRAMES, height=H, width=W,
                                 layered_frac=1.0)
    clips = [ds.load_sample(i, np.random.default_rng(seed + i)) for i in range(B)]
    for c in clips:
        for t in range(FRAMES):
            c["T"][t, 1, 3] += 0.07 * t
            c["T"][t, 2, 3] += 0.3 * t
    return clips


def _frame_grads(wide, replay=None):
    """Each frame's gradient of its own loss, frame 1 from frame 0's carried
    state, as ``test_torch_train.py`` takes them; and the kinks' record."""
    mcfg = ModelConfig(mixed_precision=False, corr_dtype="float64" if wide else "float32")
    cfg = TrainConfig(model=mcfg, train_iters=ITERS, batch_size=B, image_size=(H, W),
                      frame_length=FRAMES, num_steps=100)
    model = TCStereo(mcfg, device="cpu", seed=MODEL_SEED)
    batch = SequenceBatch.from_numpy(_clip(SCENE_SEED), "cpu")
    if wide:
        model.double()
        model.dtype = torch.float64
        set_compute_dtype(model, torch.float64)
        batch = SequenceBatch(**{k: v.double() for k, v in vars(batch).items()})
    cam = CameraParams(K=batch.K, baseline=batch.baseline)
    state = TemporalState.zeros(B, H, W, mcfg, device="cpu")
    grads = []
    with contextlib.ExitStack() as stack:
        if wide:
            stack.enter_context(widened())
        kinks = stack.enter_context(Kinks(replay))
        for t in range(FRAMES):
            frame = batch.frame(t)
            out = model(frame.image1, frame.image2, state, cam, frame.T, iters=ITERS,
                        test_mode=False)
            loss, _ = frame_losses(out, frame, cfg)
            model.zero_grad(set_to_none=True)
            loss.backward()
            grads.append({k: model.get_parameter(k).grad.double().clone()
                          for k in NAMED_LEAVES})
            state = out.new_state
    return grads, kinks


def test_pinned_fp32_frame_gradients_match_float64():
    g64, k64 = _frame_grads(wide=True)
    g32, k32 = _frame_grads(wide=False, replay=k64.sides)
    units = sum(m.numel() for m in k64.sides)
    assert units > 1_000_000 and len(k32.sides) == len(k64.sides)
    worst = 0.0
    for t in range(FRAMES):
        for leaf in NAMED_LEAVES:
            ref = g64[t][leaf]
            share = ((g32[t][leaf] - ref).abs().max() / ref.abs().max()).item()
            print(f"frame {t} {leaf}: {share:.2e} of the float64 gradient's largest entry")
            assert np.isfinite(share) and share <= PINNED_RTOL, (t, leaf, share)
            worst = max(worst, share)
    print(f"worst {worst:.2e}; {k32.crossed(k64.sides)} of {units} ReLU units would have "
          f"fallen on another side in fp32 (pinned to float64's)")

