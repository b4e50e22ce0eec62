#!/usr/bin/env python
"""Weak scaling of the port's sharded streaming evaluation.

For each world size in ``--world`` the script starts that many ranks; the
streams are shared over them as ``evaluate.py``'s ``--sharded`` evaluation
shares its sequences (``evaluate._shard``), one stream a rank. Each rank
drives its stream through a ``TemporalEvaluator`` (the state carried, one
frame a call, the disparity back on the host), ``--warmup`` frames and then
``--steps`` timed frames of a seeded random scene that slides by a few
pixels a frame. A frame-step is the slowest rank's median ms a frame;
frames/s is the world's frames over it; the efficiency is frames/s over
(world × the first world size's frames/s per rank).

The ranks run where ``scripts/torch_bench_scaling.py`` puts them: ``--cpu``
Gloo ranks on the CPU (fp32 config), one card a rank, or all ranks sharing
card 0 over Gloo.

    python scripts/torch_bench_eval_scaling.py [--cpu] [--world 1 2] \\
        [--size H W] [--iters N] [--steps N] [--warmup N]

Prints one table row a world size, ``| world | frame-step ms | frames/s |
efficiency |``, then a JSON record with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from torch_bench_scaling import parser, placement, run

MAIN_SIZE, MAIN_ITERS = (384, 1280), 5  # the streaming path's shapes (chip_smoke.py phase 4)


def _rank(rank: int, world: int, store: str, out: str, args) -> None:
    from tcs_tpu_torch import ModelConfig
    from tcs_tpu_torch.evaluate import TemporalEvaluator, _shard
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.parallel import mesh

    if args.cpu:
        torch.set_num_threads(1)
    devices, backend = placement(world, args.cpu)
    dev = torch.device(devices[rank])
    mesh.initialize_distributed(f"file://{store}", world, rank, backend=backend, device=dev)
    try:
        cfg = ModelConfig(mixed_precision=False, corr_dtype="float32") if args.cpu \
            else ModelConfig()
        H, W = args.size or MAIN_SIZE
        ev = TemporalEvaluator(TCStereo(cfg, device=dev, seed=0), cfg,
                               args.iters or MAIN_ITERS, device=dev)
        K = np.array([[721.5, 0, W / 2], [0, 721.5, H / 2], [0, 0, 1]], np.float32)
        times = []
        for stream in _shard(world, True):
            rng = np.random.default_rng(stream)
            scene = rng.uniform(0, 255, (H, W + 64, 3)).astype(np.float32)
            ev.reset()
            for k in range(args.warmup + args.steps):
                T = np.eye(4, dtype=np.float32)
                T[0, 3] = 0.01 * k
                t0 = time.perf_counter()
                disp = ev(scene[:, 32 - k:32 - k + W], scene[:, 40 - k:40 - k + W], K, 0.54, T)
                if k >= args.warmup:
                    times.append(1e3 * (time.perf_counter() - t0))
            if not np.isfinite(disp).all():
                raise RuntimeError(f"rank {rank}: a disparity is not finite")
        mesh.barrier()
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(dict(ms=float(np.median(times)), device=str(dev)), f)
    finally:
        mesh.destroy()


def main() -> None:
    ap = parser(__doc__)
    args = ap.parse_args()
    args.per_rank_batch = 1  # one stream a rank, one frame a call
    run(_rank, args, "sharded streaming evaluation", "frames")


if __name__ == "__main__":
    main()
