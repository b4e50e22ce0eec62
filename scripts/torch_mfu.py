#!/usr/bin/env python
"""Model FLOPs and their share of the card's peak, for streaming inference
and for a recipe's training step, counted and timed in one run on one card.

The FLOPs are ``tcs_tpu_torch.utils.flops``'s count of the same call that
is timed: one carried frame of ``TemporalEvaluator`` at 384×1280, iters 5
(``chip_smoke.py`` phase 4's shapes), or one ``make_train_step`` step of the
recipe on a synthetic batch held on the card (phase 7's). The time is CUDA
events around each call, the median over the calls after the counted one;
no time is written into this file. The share is the FLOPs over that time
over the card's published dense bf16 peak (``utils.flops.PEAKS``); the
events' time is the call's, host-bound launches included. Beside it, the
share over the call's device time (the kernels', copies' and fills' time in
a ``torch.profiler`` trace of a few more calls), which leaves the host out.
The count leaves out elementwise work (norms, activations, GRU gates,
losses, the optimiser), about half of the device time, so neither share
says anything about it.

    python scripts/torch_mfu.py --mode inference
    python scripts/torch_mfu.py --mode train --recipe sceneflow|tartanair|kitti

The last line of standard output is one JSON record, with the card's
``nvidia-smi --query-gpu=name,power.limit`` line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np
import torch

RECIPES = {"sceneflow": "sceneflow", "tartanair": "TartanAir", "kitti": "kitti_raw"}
INFER_H, INFER_W, INFER_ITERS = 384, 1280, 5
DEV = "cuda"
LOGDIR = os.path.join("runs", "torch_mfu_trace")
TRACED = 2  # calls traced for the device time
NOTE = ("model FLOPs under utils/flops.py's convention; elementwise work (about half "
        "of the device time) is not counted")


def events_ms(call) -> float:
    """ms of one ``call`` by CUDA events around it."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def record(mode: str, flops, times: list, call, smi: str, **extra) -> dict:
    """The record of ``call``: its FLOPs, its time from ``times`` and its
    device time from a trace of ``TRACED`` more calls."""
    from tcs_tpu_torch.utils.flops import peak
    from tcs_tpu_torch.utils.profiling import device_ms

    ms = float(np.median(times))
    dev_ms, events = device_ms(call, LOGDIR, TRACED)
    rate, bf16 = flops.total / (ms / 1e3), peak(smi).bf16
    return dict(mode=mode, **extra, flops=flops.total, forward_flops=flops.phase("forward"),
                backward_flops=flops.phase("backward"), by_op=flops.by_op(), ms=ms,
                ms_each=times, achieved_tflops_per_s=rate / 1e12,
                peak_bf16_tflops_per_s=bf16 / 1e12, share_of_bf16_peak=rate / bf16,
                device_ms=dev_ms, device_events=events,
                share_of_bf16_peak_in_device_time=flops.total / (dev_ms / 1e3) / bf16,
                card=smi, note=NOTE)


def inference(smi: str, frames: int = 12) -> dict:
    """Frame 0, then frame 1 counted, then frames 2.. timed; a fronto-parallel
    shift and a moving pose, as phase 4 drives them."""
    from tcs_tpu_torch import ModelConfig
    from tcs_tpu_torch.evaluate import TemporalEvaluator
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.utils.flops import FlopCounter

    cfg = ModelConfig()
    ev = TemporalEvaluator(TCStereo(cfg, device=DEV, seed=0), cfg, iters=INFER_ITERS,
                           device=DEV)
    H, W = INFER_H, INFER_W
    n = frames + 2 + TRACED  # device_ms makes two calls ahead of the timed ones
    left = np.random.default_rng(2).uniform(0, 255, (n, H, W + 64, 3)).astype(np.float32)
    K = np.array([[721.5, 0, W / 2], [0, 721.5, H / 2], [0, 0, 1]], np.float32)

    def frame(k):
        T = np.eye(4, dtype=np.float32)
        T[0, 3], T[2, 3] = 0.01 * k, 0.02 * k
        return ev(left[k, :, 32:32 + W], left[k, :, 40 + k:40 + k + W], K, 0.54, T)

    frame(0)
    with FlopCounter() as counter:
        frame(1)
    times = [events_ms(lambda k=k: frame(k)) for k in range(2, frames)]
    more = iter(range(frames, n))
    return record("inference", counter, times, lambda: frame(next(more)), smi,
                  shape=f"B1 {H}x{W}", iters=INFER_ITERS)


def train(smi: str, recipe: str = "sceneflow", steps: int = 4) -> dict:
    """One step counted (it is also the warm-up), then ``steps`` timed, on
    one synthetic batch held on the card."""
    from tcs_tpu_torch.config import RECIPES as PORT_RECIPES
    from tcs_tpu_torch.data.synthetic import make_clips
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.train import SequenceBatch, make_train_step
    from tcs_tpu_torch.utils.flops import FlopCounter

    cfg = PORT_RECIPES[RECIPES[recipe]]()
    H, W = cfg.image_size
    step = make_train_step(TCStereo(cfg.model, device=DEV, seed=0), cfg)
    batch = SequenceBatch.from_numpy(
        make_clips(cfg.batch_size, H, W, cfg.frame_length, cfg.seed), DEV)
    with FlopCounter() as counter:
        step(batch)["live_loss"].item()
    torch.cuda.reset_peak_memory_stats()
    call = lambda: step(batch)["live_loss"].item()  # noqa: E731
    times = [events_ms(call) for _ in range(steps)]
    return record("train", counter, times, call, smi, recipe=recipe,
                  shape=f"B{cfg.batch_size} {H}x{W} frames {cfg.frame_length}",
                  frames_per_step=cfg.batch_size * cfg.frame_length,
                  iters=cfg.train_iters, peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def summary(rec: dict) -> str:
    what = rec["mode"] if rec["mode"] == "inference" else f"{rec['recipe']} step"
    return (f"MFU {what} {rec['shape']} iters {rec['iters']}: {rec['flops'] / 1e9:.1f} GFLOP "
            f"in {rec['ms']:.2f} ms = {rec['achieved_tflops_per_s']:.2f} TFLOP/s, "
            f"{100 * rec['share_of_bf16_peak']:.2f} % of the dense bf16 peak "
            f"({rec['peak_bf16_tflops_per_s']:.0f} TFLOP/s); over the {rec['device_ms']:.2f} ms of "
            f"device time {100 * rec['share_of_bf16_peak_in_device_time']:.2f} %; on "
            f"{rec['card']}; {rec['note']}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("inference", "train"), default="inference")
    ap.add_argument("--recipe", choices=sorted(RECIPES), default="sceneflow")
    ap.add_argument("--frames", type=int, default=12, help="inference: frames driven")
    ap.add_argument("--steps", type=int, default=4, help="train: steps timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU: the share of a card's peak is read on the card")
    import chip_smoke

    smi = chip_smoke.card_line()
    rec = (inference(smi, args.frames) if args.mode == "inference"
           else train(smi, args.recipe, args.steps))
    print(summary(rec))
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
