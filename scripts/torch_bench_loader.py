#!/usr/bin/env python
"""The port's input pipeline alone at the TartanAir recipe's shapes.

Writes a TartanAir training tree at the dataset's 480×640 with
``tcs_tpu_torch/data/fabricate.py`` (Paeth-filtered PNGs and ``.npy``
depths, ``--scene-frames`` frames a sequence, two sequences), builds the
recipe's dataset (``data.datasets.fetch_dataset``: frame windows of
``--frames``, the recipe's augmentation and 480×640 crop) and reads
``SequenceLoader``'s samples/s alone at each ``--workers``, over
``--batches`` batches of the recipe's batch size after the first (which pays
for the workers' start): ``chip_smoke.loader_rate``, which phase 9 uses.
A sample is one clip: 2 × frames PNG decodes, the depths and the
sequence-consistent augmentation.

    python scripts/torch_bench_loader.py [--frames 4] [--workers 1 4 8] \\
        [--batches 6] [--scene-frames 12]

The last line of standard output is one JSON record with the host's cores
and, on a GPU machine, the card's ``nvidia-smi`` line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=4, help="frames a clip (the recipe's 4)")
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 4, 8])
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--scene-frames", type=int, default=12)
    args = ap.parse_args()

    from tcs_tpu_torch.config import tartanair_recipe
    from tcs_tpu_torch.data import datasets, fabricate

    card = cs.card_line() if torch.cuda.is_available() else "no GPU"
    host = cs.host_description()
    with tempfile.TemporaryDirectory(prefix="loader_tree_") as root:
        t0 = time.perf_counter()
        fabricate.tartanair_train_tree(root, frames=args.scene_frames)
        print(f"TartanAir tree, 2 sequences x {args.scene_frames} frames at 480x640, written "
              f"in {time.perf_counter() - t0:.2f} s")
        cfg = dataclasses.replace(tartanair_recipe(), data_root=root,
                                  frame_length=args.frames)
        ds = datasets.fetch_dataset(cfg)
        rates = {}
        for workers in args.workers:
            rates[workers] = cs.loader_rate(ds, workers, cfg.batch_size, args.batches)
            print(f"SequenceLoader, TartanAir recipe (B{cfg.batch_size}, {args.frames} frames, "
                  f"480x640, {len(ds)} samples), {workers} worker processes: "
                  f"{rates[workers]:.2f} samples/s ({rates[workers] * args.frames:.1f} frames/s); "
                  f"host {host}")
    print(json.dumps({"bench": "loader", "recipe": "TartanAir", "frames": args.frames,
                      "samples_per_s": rates, "host": host, "card": card}))


if __name__ == "__main__":
    main()
