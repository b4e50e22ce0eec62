#!/usr/bin/env python
"""Weak scaling of the port's data-parallel training step.

For each world size in ``--world`` the script starts that many ranks, each
a process running ``make_train_step`` on the model under DDP
(``tcs_tpu_torch.parallel.mesh.wrap``) with ``--per-rank-batch`` clips of
its own, so that the global batch grows with the world. Each rank times
``--steps`` steps after ``--warmup`` by the host clock (a step ends in a
``.item()``, which waits for the device); the world's step time is the
slowest rank's median. Samples/s is the global batch over that time and the
efficiency is samples/s over (world × the first world size's samples/s per
rank).

Where the ranks run:

- ``--cpu``: Gloo ranks on the CPU, one intra-op thread each, in the fp32
  config (the CPU's bf16 convolutions are slow and measure nothing here);
- on the card, with at least as many cards as ranks: one card a rank, NCCL;
- otherwise every rank on card 0 over Gloo, as ``chip_smoke.py`` phase 10
  (b) runs two (NCCL refuses two ranks on one card): the ranks then share
  the card's time, so this reads the cost of the shared card and of Gloo,
  not the scaling over cards.

    python scripts/torch_bench_scaling.py [--cpu] [--world 1 2] \\
        [--recipe sceneflow] [--size H W] [--frames N] [--iters N] \\
        [--per-rank-batch B] [--steps N] [--warmup N]

Prints one table row a world size, ``| world | step ms | samples/s |
efficiency |``, then a JSON record with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def placement(world: int, cpu: bool):
    """(devices of the ranks, backend) for ``world`` ranks."""
    if cpu:
        return ["cpu"] * world, "gloo"
    cards = torch.cuda.device_count()
    if world <= cards:
        return [f"cuda:{r}" for r in range(world)], "nccl"
    return ["cuda:0"] * world, "gloo"


def train_config(args):
    from tcs_tpu_torch.config import RECIPES, ModelConfig

    cfg = RECIPES[args.recipe]()
    H, W = args.size or cfg.image_size
    model = ModelConfig(mixed_precision=False, corr_dtype="float32") if args.cpu else cfg.model
    return dataclasses.replace(cfg, model=model, batch_size=args.per_rank_batch,
                               image_size=(H, W), frame_length=args.frames or cfg.frame_length,
                               train_iters=args.iters or cfg.train_iters)


def _rank(rank: int, world: int, store: str, out: str, args) -> None:
    from tcs_tpu_torch.data.synthetic import make_clips
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.parallel import mesh
    from tcs_tpu_torch.train import SequenceBatch, make_train_step

    if args.cpu:
        torch.set_num_threads(1)
    devices, backend = placement(world, args.cpu)
    dev = torch.device(devices[rank])
    mesh.initialize_distributed(f"file://{store}", world, rank, backend=backend, device=dev)
    try:
        cfg = train_config(args)
        H, W = cfg.image_size
        model = TCStereo(cfg.model, device=dev, seed=0)
        step = make_train_step(mesh.wrap(model), cfg)
        clips = make_clips(cfg.batch_size, H, W, cfg.frame_length,
                           cfg.seed + rank * cfg.batch_size)
        batch = SequenceBatch.from_numpy(clips, dev)
        for _ in range(args.warmup):
            step(batch)["live_loss"].item()
        times = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            loss = step(batch)["live_loss"].item()
            times.append(1e3 * (time.perf_counter() - t0))
        if not np.isfinite(loss):
            raise RuntimeError(f"rank {rank}: the loss is {loss}")
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(dict(ms=float(np.median(times)), device=str(dev)), f)
    finally:
        mesh.destroy()


def run(worker, args, title: str, unit: str) -> None:
    """Spawns ``worker(rank, world, store, out, args)`` at each world size
    and prints the table and the record; ``unit`` names what a rank's batch
    holds (samples or frames a step)."""
    import torch.multiprocessing as tmp

    if not args.cpu and not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU; pass --cpu to run Gloo ranks on the CPU")
    smi = "cpu" if args.cpu else cs.card_line()
    rows, base = [], None
    with tempfile.TemporaryDirectory(dir=args.store) as tmpdir:
        for world in args.world:
            out = os.path.join(tmpdir, f"world{world}")
            os.makedirs(out)
            devices, backend = placement(world, args.cpu)
            tmp.spawn(worker, args=(world, os.path.join(tmpdir, f"store{world}"), out, args),
                      nprocs=world, join=True)
            ms = max(json.load(open(os.path.join(out, f"rank{r}.json")))["ms"]
                     for r in range(world))
            rate = world * args.per_rank_batch * 1e3 / ms
            base = base if base is not None else rate / world
            rows.append(dict(world=world, ms=ms, rate=rate, efficiency=rate / (world * base),
                             devices=devices, backend=backend))
    print(f"{title} on {smi}; {unit}/s over the world")
    print("| world | ms | " + unit + "/s | efficiency |")
    for r in rows:
        print(f"| {r['world']} | {r['ms']:.1f} | {r['rate']:.3f} | "
              f"{100 * r['efficiency']:.1f}% |")
    print(json.dumps({"bench": title, "card": smi, "rows": rows,
                      "args": {k: v for k, v in vars(args).items() if k != "store"}}))


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="Gloo ranks on the CPU")
    ap.add_argument("--world", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--size", type=int, nargs=2, default=None, help="H W")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--store", default=None,
                    help="directory for the rendezvous files and the ranks' records")
    return ap


def main() -> None:
    ap = parser(__doc__)
    ap.add_argument("--recipe", default="sceneflow", choices=("sceneflow", "TartanAir",
                                                              "kitti_raw"))
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--per-rank-batch", type=int, default=4)
    args = ap.parse_args()
    run(_rank, args, f"DDP step, {args.recipe} recipe", "samples")


if __name__ == "__main__":
    main()
