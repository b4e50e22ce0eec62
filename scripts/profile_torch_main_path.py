#!/usr/bin/env python
"""Where the time of the PyTorch port's main path goes, on one NVIDIA GPU.

Runs ``TCStereo`` (default config: bf16 conv stacks, bf16 pyramid) at
384×1280 with iters 5 on device-resident frames with a moving pose, and
reports:

- model ms/frame from CUDA events (no host-side image conversion);
- under ``tcs_tpu_torch.utils.profiling.trace`` (``torch.profiler``, no
  module ranges) and ``trace_summary.summarize_trace``: device time per
  frame (kernels, copies and fills), the device's busy share of the frame
  (device time / wall time), device events per frame, and the device time by
  family, by kernel and by the model's stage spans (``profiling.span``);
- from a second traced pass with a range a module call (``trace(logdir,
  model)``, whose ranges cost host time, so neither its wall time nor its
  busy share is read): the device time by module (the innermost module
  around each launch; launches outside any module are their own row).

Writes both Chrome traces (``runs/torch_main_path_trace/{plain,modules}/``)
and the full tables under ``runs/``.
Usage: ``python scripts/profile_torch_main_path.py``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tcs_tpu_torch import ModelConfig  # noqa: E402
from tcs_tpu_torch.models import CameraParams, TCStereo, TemporalState  # noqa: E402
from tcs_tpu_torch.utils.profiling import trace  # noqa: E402
from tcs_tpu_torch.utils.trace_summary import print_summary, summarize_trace  # noqa: E402

H, W, ITERS = 384, 1280, 5
WARM, TIMED, PROFILED = 3, 10, 4
LOGDIR = "runs/torch_main_path_trace"


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    cfg = ModelConfig()
    model = TCStereo(cfg, seed=0)
    g = torch.Generator().manual_seed(0)
    n = WARM + TIMED + 2 * PROFILED
    frames = (torch.rand(n, 2, 1, H, W, 3, generator=g) * 255).cuda()
    K = torch.tensor([[[721.5, 0, W / 2], [0, 721.5, H / 2], [0, 0, 1]]], device="cuda")
    cam = CameraParams(K=K, baseline=torch.full((1,), 0.54, device="cuda"))
    poses = torch.eye(4).repeat(n, 1, 1)
    poses[:, 0, 3] = 0.01 * torch.arange(n)
    poses = poses.cuda()
    state = TemporalState.zeros(1, H, W, cfg)

    def run(k):
        nonlocal state
        out = model(frames[k, 0], frames[k, 1], state, cam, poses[k:k + 1], iters=ITERS)
        state = out.new_state
        return out.flow

    for k in range(WARM):
        run(k)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(WARM, WARM + TIMED):
        run(k)
    stop.record()
    torch.cuda.synchronize()
    model_ms = start.elapsed_time(stop) / TIMED

    shutil.rmtree(LOGDIR, ignore_errors=True)
    plain, ranged = os.path.join(LOGDIR, "plain"), os.path.join(LOGDIR, "modules")
    first = WARM + TIMED
    with trace(plain):
        t0 = time.perf_counter()
        for k in range(first, first + PROFILED):
            run(k)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED
    with trace(ranged, model):
        for k in range(first + PROFILED, n):
            run(k)
        torch.cuda.synchronize()
    s, m = summarize_trace(plain), summarize_trace(ranged)
    dev_ms = s.total_ms / PROFILED
    with open("runs/torch_main_path_kernels.txt", "w") as f:
        print("without module ranges:", file=f)
        print_summary(s, PROFILED, top=10_000, file=f)
        print("\nwith a range a module call:", file=f)
        print_summary(m, PROFILED, top=10_000, file=f)

    print(f"card: {smi}")
    print(f"model ms/frame (CUDA events, device-resident inputs): {model_ms:.3f}")
    print(f"profiled wall ms/frame: {wall_ms:.3f}; device ms/frame: {dev_ms:.3f}; device "
          f"busy share {dev_ms / wall_ms:.3f}; device events/frame {s.events / PROFILED:.0f}")
    for fam, ms in s.by_category.most_common():
        print(f"  {fam:14s} {ms / PROFILED:8.3f} ms/frame  "
              f"{s.category_launches[fam] / PROFILED:7.1f} launches/frame")
    print(f"by module, from the pass with a range a module call "
          f"({m.total_ms / PROFILED:.3f} device ms/frame there):")
    print_summary(m, PROFILED, top=12)
    print(json.dumps({"model_ms_per_frame": model_ms, "wall_ms_per_frame": wall_ms,
                      "device_ms_per_frame": dev_ms,
                      "launches_per_frame": s.events / PROFILED,
                      "families_ms": {k: v / PROFILED for k, v in s.by_category.items()},
                      "unattributed_share": m.unattributed_ms / max(m.total_ms, 1e-9),
                      "card": smi}))


if __name__ == "__main__":
    main()
