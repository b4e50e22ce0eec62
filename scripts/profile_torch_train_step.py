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
- under ``tcs_tpu_torch.utils.profiling.trace`` (``torch.profiler``, no
  module ranges) and ``trace_summary.summarize_trace``: device time per
  step (kernels, copies and fills), the device's busy share of the step
  (device time / wall time), device events per step, and the device time by
  family, by kernel and by the model's stage spans (``profiling.span``);
- from a second traced pass with a range a module call (``trace(logdir,
  model)``, whose ranges cost host time, so neither its wall time nor its
  busy share is read): the device time by module (a backward kernel goes to
  the module of its forward op, through the autograd node's sequence
  number);
- peak device memory of a step.

Writes both Chrome traces (``runs/torch_train_step_trace/{plain,modules}/``)
and the full tables under ``runs/``.
Usage: ``python scripts/profile_torch_train_step.py``.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tcs_tpu_torch.config import sceneflow_recipe  # noqa: E402
from tcs_tpu_torch.data.synthetic import make_clips  # noqa: E402
from tcs_tpu_torch.models import TCStereo  # noqa: E402
from tcs_tpu_torch.train import SequenceBatch, make_train_step  # noqa: E402
from tcs_tpu_torch.utils.profiling import trace  # noqa: E402
from tcs_tpu_torch.utils.trace_summary import print_summary, summarize_trace  # noqa: E402

WARM, TIMED, SPLIT, PROFILED = 2, 5, 3, 2
LOGDIR = "runs/torch_train_step_trace"


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

    shutil.rmtree(LOGDIR, ignore_errors=True)
    plain, ranged = os.path.join(LOGDIR, "plain"), os.path.join(LOGDIR, "modules")
    with trace(plain):
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED
    with trace(ranged, model):
        for _ in range(PROFILED):
            step(batch)
        torch.cuda.synchronize()
    s, m = summarize_trace(plain), summarize_trace(ranged)
    dev_ms = s.total_ms / PROFILED
    with open("runs/torch_train_step_kernels.txt", "w") as f:
        print("without module ranges:", file=f)
        print_summary(s, PROFILED, top=10_000, file=f)
        print("\nwith a range a module call:", file=f)
        print_summary(m, PROFILED, top=10_000, file=f)

    frames = cfg.batch_size * cfg.frame_length
    print(f"card: {smi}")
    print(f"train step B{cfg.batch_size} {H}x{W} frames {cfg.frame_length} iters "
          f"{cfg.train_iters}: {step_ms:.2f} ms/step (CUDA events, {TIMED} steps), "
          f"{frames * 1000 / step_ms:.2f} frames/s; peak device memory {peak_gib:.3f} GiB")
    print(f"split step (host clock, synchronised parts, mean of {SPLIT}): forward+losses "
          f"{parts[0]:.2f} ms, backward {parts[1]:.2f} ms, norm+clip+AdamW {parts[2]:.2f} ms")
    print(f"profiled wall ms/step: {wall_ms:.2f}; device ms/step: {dev_ms:.2f}; device "
          f"busy share {dev_ms / wall_ms:.3f}; device events/step {s.events / PROFILED:.0f}")
    for fam, ms in s.by_category.most_common():
        print(f"  {fam:28s} {ms / PROFILED:9.3f} ms/step  "
              f"{s.category_launches[fam] / PROFILED:8.1f} launches/step")
    print(f"by module, from the pass with a range a module call "
          f"({m.total_ms / PROFILED:.2f} device ms/step there):")
    print_summary(m, PROFILED, top=15)
    print(json.dumps({"step_ms": step_ms, "frames_per_s": frames * 1000 / step_ms,
                      "peak_gib": peak_gib, "split_ms": {"forward": parts[0],
                                                         "backward": parts[1],
                                                         "update": parts[2]},
                      "wall_ms_per_step": wall_ms, "device_ms_per_step": dev_ms,
                      "launches_per_step": s.events / PROFILED,
                      "families_ms": {k: v / PROFILED for k, v in s.by_category.items()},
                      "families_launches": {k: v / PROFILED
                                            for k, v in s.category_launches.items()},
                      "unattributed_share": m.unattributed_ms / max(m.total_ms, 1e-9),
                      "card": smi}))


if __name__ == "__main__":
    main()
