#!/usr/bin/env python
"""Where the time of the PyTorch port's main path goes, on one NVIDIA GPU.

Runs ``TCStereo`` (default config: bf16 conv stacks, bf16 pyramid) at
384×1280 with iters 5 on device-resident frames with a moving pose, and
reports:

- model ms/frame from CUDA events (no host-side image conversion);
- under ``torch.profiler``: device kernel time per frame, the device's busy
  share of the frame (kernel time / wall time), kernel launches per frame,
  and the kernels with the most device time, grouped by family.

Writes the Chrome trace and the full table under ``runs/``.
Usage: ``python scripts/profile_torch_main_path.py``.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tcs_tpu_torch import ModelConfig  # noqa: E402
from tcs_tpu_torch.models import CameraParams, TCStereo, TemporalState  # noqa: E402

H, W, ITERS = 384, 1280, 5
WARM, TIMED, PROFILED = 3, 10, 4
FAMILIES = (("corr_lookup", "corr_lookup"), ("splat_sum", "splat_sum"),
            ("conv", "conv"), ("cudnn", "conv"), ("xmma", "conv"), ("sm90", "gemm/conv"),
            ("gemm", "gemm/conv"), ("cutlass", "gemm/conv"), ("reduce", "reduce"),
            ("elementwise", "elementwise"), ("index", "index/gather"),
            ("gather", "index/gather"), ("cat", "copy/cat"), ("copy", "copy/cat"))


def family(name: str) -> str:
    low = name.lower()
    for key, fam in FAMILIES:
        if key in low:
            return fam
    return "other"


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    cfg = ModelConfig()
    model = TCStereo(cfg, seed=0)
    g = torch.Generator().manual_seed(0)
    n = WARM + TIMED + PROFILED
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

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(WARM + TIMED, n):
            run(k)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in kernels) / PROFILED
    by_name = collections.Counter()
    by_family = collections.Counter()
    count_family = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / PROFILED
        by_family[family(e.name)] += e.time_range.elapsed_us() / PROFILED
        count_family[family(e.name)] += 1 / PROFILED
    os.makedirs("runs", exist_ok=True)
    prof.export_chrome_trace("runs/torch_main_path_trace.json.gz")
    with open("runs/torch_main_path_kernels.txt", "w") as f:
        for name, us in by_name.most_common():
            f.write(f"{us:10.1f} us/frame  {name}\n")

    print(f"card: {smi}")
    print(f"model ms/frame (CUDA events, device-resident inputs): {model_ms:.3f}")
    print(f"profiled wall ms/frame: {wall_ms:.3f}; device kernel ms/frame: "
          f"{dev_us / 1e3:.3f}; device busy share {dev_us / 1e3 / wall_ms:.3f}; "
          f"kernel launches/frame {len(kernels) / PROFILED:.0f}")
    for fam, us in by_family.most_common():
        print(f"  {fam:14s} {us / 1e3:8.3f} ms/frame  {count_family[fam]:7.1f} launches/frame")
    for name, us in by_name.most_common(12):
        print(f"  {us / 1e3:8.3f} ms  {name[:110]}")
    print(json.dumps({"model_ms_per_frame": model_ms, "wall_ms_per_frame": wall_ms,
                      "device_ms_per_frame": dev_us / 1e3,
                      "launches_per_frame": len(kernels) / PROFILED,
                      "families_ms": {k: v / 1e3 for k, v in by_family.items()},
                      "card": smi}))


if __name__ == "__main__":
    main()
