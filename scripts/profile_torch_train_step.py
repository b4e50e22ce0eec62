#!/usr/bin/env python
"""Where the time of the PyTorch port's training step goes, on one NVIDIA GPU.

Runs ``make_train_step`` over the default config (bf16 conv stacks, bf16
pyramid) at the SceneFlow recipe's shapes (batch 4, 320×720, 2 frames, 5
iterations) on a synthetic batch made from a seed, and reports:

- ms/step from CUDA events, and the host-clock split of the same step into
  the frames' forward and losses, the frames' backward, and gradient norm +
  clip + AdamW, through the step's ``mark`` seams (each seam synchronises the
  device, so the split costs some overlap and its sum is an upper bound of
  the unsplit step);
- under ``torch.profiler``: device kernel time per step, the device's busy
  share of the step (kernel time / wall time), kernel launches per step, and
  the kernels with the most device time, grouped by family;
- peak device memory of a step.

Writes the Chrome trace and the full table under ``runs/``.
Usage: ``python scripts/profile_torch_train_step.py``.
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

from tcs_tpu_torch.config import sceneflow_recipe  # noqa: E402
from tcs_tpu_torch.data.synthetic import make_clips  # noqa: E402
from tcs_tpu_torch.models import TCStereo  # noqa: E402
from tcs_tpu_torch.train import SequenceBatch, make_train_step  # noqa: E402

WARM, TIMED, SPLIT, PROFILED = 2, 5, 3, 2
FAMILIES = (("corr_lookup_bwd", "corr_lookup_bwd"), ("corr_lookup", "corr_lookup"),
            ("splat_sum_bwd", "splat_sum_bwd"), ("splat_sum", "splat_sum"),
            ("dgrad", "conv backward"), ("wgrad", "conv backward"),
            ("bwd", "conv backward"), ("backward", "backward elementwise/other"),
            ("conv", "conv"), ("cudnn", "conv"), ("xmma", "conv"), ("sm90", "gemm/conv"),
            ("gemm", "gemm/conv"), ("cutlass", "gemm/conv"), ("multi_tensor", "optimizer"),
            ("reduce", "reduce"), ("elementwise", "elementwise"),
            ("index", "index/gather/scatter"), ("gather", "index/gather/scatter"),
            ("scatter", "index/gather/scatter"), ("cat", "copy/cat"), ("copy", "copy/cat"))


def family(name: str) -> str:
    low = name.lower()
    for key, fam in FAMILIES:
        if key in low:
            return fam
    return "other"


class Seams:
    """A ``mark`` for the train step: synchronises the device at each seam
    and adds the host-clock time since the last seam to that part."""

    def __init__(self):
        self.seconds = collections.Counter()
        self.restart()

    def restart(self):
        torch.cuda.synchronize()
        self.last = time.perf_counter()

    def __call__(self, part: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds[part] += now - self.last
        self.last = now


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    cfg = sceneflow_recipe()
    H, W = cfg.image_size
    model = TCStereo(cfg.model, seed=0)
    step = make_train_step(model, cfg)
    batch = SequenceBatch.from_numpy(
        make_clips(cfg.batch_size, H, W, cfg.frame_length, cfg.seed), "cuda")

    for _ in range(WARM):
        step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED):
        step(batch)
    stop.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(stop) / TIMED
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    seams = Seams()
    for _ in range(SPLIT):
        seams.restart()
        step(batch, seams)
    parts = [seams.seconds[k] * 1e3 / SPLIT for k in ("forward", "backward", "update")]

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            step(batch)
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
    prof.export_chrome_trace("runs/torch_train_step_trace.json.gz")
    with open("runs/torch_train_step_kernels.txt", "w") as f:
        for name, us in by_name.most_common():
            f.write(f"{us:10.1f} us/step  {name}\n")

    frames = cfg.batch_size * cfg.frame_length
    print(f"card: {smi}")
    print(f"train step B{cfg.batch_size} {H}x{W} frames {cfg.frame_length} iters "
          f"{cfg.train_iters}: {step_ms:.2f} ms/step (CUDA events, {TIMED} steps), "
          f"{frames * 1000 / step_ms:.2f} frames/s; peak device memory {peak_gib:.3f} GiB")
    print(f"split step (host clock, synchronised parts, mean of {SPLIT}): forward+losses "
          f"{parts[0]:.2f} ms, backward {parts[1]:.2f} ms, norm+clip+AdamW {parts[2]:.2f} ms")
    print(f"profiled wall ms/step: {wall_ms:.2f}; device kernel ms/step: "
          f"{dev_us / 1e3:.2f}; device busy share {dev_us / 1e3 / wall_ms:.3f}; "
          f"kernel launches/step {len(kernels) / PROFILED:.0f}")
    for fam, us in by_family.most_common():
        print(f"  {fam:28s} {us / 1e3:9.3f} ms/step  {count_family[fam]:8.1f} launches/step")
    for name, us in by_name.most_common(15):
        print(f"  {us / 1e3:9.3f} ms  {name[:110]}")
    print(json.dumps({"step_ms": step_ms, "frames_per_s": frames * 1000 / step_ms,
                      "peak_gib": peak_gib, "split_ms": {"forward": parts[0],
                                                         "backward": parts[1],
                                                         "update": parts[2]},
                      "wall_ms_per_step": wall_ms, "device_ms_per_step": dev_us / 1e3,
                      "launches_per_step": len(kernels) / PROFILED,
                      "families_ms": {k: v / 1e3 for k, v in by_family.items()},
                      "families_launches": dict(count_family), "card": smi}))


if __name__ == "__main__":
    main()
