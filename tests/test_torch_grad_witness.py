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

A 4-frame window (the fl4 recipes') is held the same way on seed pair
(62, 17), frames 0 to 3, each frame from its own run's carried state. Its
frame 2 holds a sequence-loss residual 2.4e-7 px (the free fp32 run; 2.7e-6
in float64) from the kink of |r|, a kink that ``Kinks`` does not reach, so the L1 terms'
signs are pinned to the float64 run's too (``_l1_pin``). Measured: ≤ 3.6e-4
pinned; free, the fp32 run is 4.8e-2 from float64 on
``disp_refine.mask.2.weight`` in frame 2.
"""

import contextlib

import numpy as np
import torch

from tcs_tpu_torch import ModelConfig, TrainConfig
from tcs_tpu_torch import losses as L
from tcs_tpu_torch.data.synthetic import SyntheticStereoSequence
from tcs_tpu_torch.models import CameraParams, TCStereo, TemporalState
from tcs_tpu_torch.models.layers import set_compute_dtype
from tcs_tpu_torch.train import SequenceBatch, frame_losses
from tcs_tpu_torch.utils.kinks import Kinks, widened

# The test processes share the host: two intra-op threads each, so that
# several workers do not oversubscribe its cores.
torch.set_num_threads(2)

B, H, W, ITERS, FRAMES = 1, 64, 96, 2, 2
MODEL_SEED, SCENE_SEED = 61, 7
PINNED_RTOL = 1e-3  # of the float64 gradient's largest entry
NAMED_LEAVES = ("cnet.conv1.weight", "update_block.gru08.convzr.weight",
                "disp_completor.conv_disp_stem.0.weight", "disp_refine.mask.2.weight")


def _clip(seed, frames=FRAMES):
    """``test_torch_train.py``'s clip: two planes, and a camera that also
    moves along y and z, so that no splat target falls on an integer."""
    ds = SyntheticStereoSequence(frame_length=frames, height=H, width=W,
                                 layered_frac=1.0)
    clips = [ds.load_sample(i, np.random.default_rng(seed + i)) for i in range(B)]
    for c in clips:
        for t in range(frames):
            c["T"][t, 1, 3] += 0.07 * t
            c["T"][t, 2, 3] += 0.3 * t
    return clips


def _l1_pin(out, frame, signs):
    """The signs of the L1 residuals of the sequence loss (the flows it holds
    against the ground truth, each with its weight), and a term whose value
    is within rounding of zero and whose gradient turns each residual's sign
    into ``signs``' where those are given."""
    w = L.loss_weights(ITERS)
    terms = [(out.flow_init, 0.1), (out.flow_mono, 0.1)]
    for i in range(ITERS):
        terms += [(out.flow_predictions[0][i], w[i]), (out.flow_predictions[1][i], 1.2 * w[i])]
    with torch.no_grad():
        mag = torch.sqrt(torch.sum(frame.flow ** 2, dim=-1, keepdim=True))
        v = ((frame.valid >= 0.5) & (mag < 700.0)).to(frame.flow.dtype)
        own = [torch.sign(f - frame.flow) for f, _ in terms]
    pin = 0.0
    if signs is not None:
        for (f, c), s, o in zip(terms, signs, own):
            pin = pin + c * torch.sum((s.to(f.dtype) - o) * (f - frame.flow) * v) / v.sum()
    residual = min(float((f.detach() - frame.flow).abs().min()) for f, _ in terms)
    return pin, own, residual


def _frame_grads(wide, replay=None, frames=FRAMES, seeds=(MODEL_SEED, SCENE_SEED),
                 l1_signs=None):
    """Each frame's gradient of its own loss, each frame from the previous
    one's carried state, as ``test_torch_train.py`` takes them; the kinks'
    record; and each frame's L1 signs (pinned to ``l1_signs`` where given)
    and smallest L1 residual."""
    model_seed, scene_seed = seeds
    mcfg = ModelConfig(mixed_precision=False, corr_dtype="float64" if wide else "float32")
    cfg = TrainConfig(model=mcfg, train_iters=ITERS, batch_size=B, image_size=(H, W),
                      frame_length=frames, num_steps=100)
    model = TCStereo(mcfg, device="cpu", seed=model_seed)
    batch = SequenceBatch.from_numpy(_clip(scene_seed, frames), "cpu")
    if wide:
        model.double()
        model.dtype = torch.float64
        set_compute_dtype(model, torch.float64)
        batch = SequenceBatch(**{k: v.double() for k, v in vars(batch).items()})
    cam = CameraParams(K=batch.K, baseline=batch.baseline)
    state = TemporalState.zeros(B, H, W, mcfg, device="cpu")
    grads, signs, residuals = [], [], []
    with contextlib.ExitStack() as stack:
        if wide:
            stack.enter_context(widened())
        kinks = stack.enter_context(Kinks(replay))
        for t in range(frames):
            frame = batch.frame(t)
            out = model(frame.image1, frame.image2, state, cam, frame.T, iters=ITERS,
                        test_mode=False)
            loss, _ = frame_losses(out, frame, cfg)
            pin, own, residual = _l1_pin(out, frame, None if l1_signs is None else l1_signs[t])
            signs.append(own)
            residuals.append(residual)
            model.zero_grad(set_to_none=True)
            (loss + pin).backward()
            grads.append({k: model.get_parameter(k).grad.double().clone()
                          for k in NAMED_LEAVES})
            state = out.new_state
    return grads, kinks, signs, residuals


def test_pinned_fp32_frame_gradients_match_float64():
    g64, k64, _, _ = _frame_grads(wide=True)
    g32, k32, _, _ = _frame_grads(wide=False, replay=k64.sides)
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



def test_pinned_fp32_gradients_of_a_four_frame_window_match_float64():
    """Frames 2 and 3 take the state carried out of a warped frame."""
    kw = dict(frames=4, seeds=(62, 17))
    g64, k64, s64, r64 = _frame_grads(wide=True, **kw)
    g32, k32, _, r32 = _frame_grads(wide=False, replay=k64.sides, l1_signs=s64, **kw)
    free, _, _, r_free = _frame_grads(wide=False, **kw)
    assert len(k32.sides) == len(k64.sides)
    print(f"smallest L1 residual per frame: float64 {['%.1e' % r for r in r64]}, fp32 "
          f"pinned {['%.1e' % r for r in r32]}, fp32 free {['%.1e' % r for r in r_free]}")
    for t in range(4):
        for leaf in NAMED_LEAVES:
            ref = g64[t][leaf]
            share = ((g32[t][leaf] - ref).abs().max() / ref.abs().max()).item()
            loose = ((free[t][leaf] - ref).abs().max() / ref.abs().max()).item()
            print(f"fl4 frame {t} {leaf}: pinned {share:.2e}, free {loose:.2e} of the float64 "
                  "gradient's largest entry")
            assert np.isfinite(share) and share <= PINNED_RTOL, (t, leaf, share)
