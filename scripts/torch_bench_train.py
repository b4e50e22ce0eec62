#!/usr/bin/env python
"""Steady training-step throughput of the port at each recipe, on the card.

For each recipe in ``--recipe`` (SceneFlow B4 320×720 2 frames, TartanAir
B4 480×640 4 frames, KITTI raw B4 320×1024 4 frames; 5 iterations, the
default bf16 config): ``scripts/torch_mfu.py``'s step on one synthetic batch
held on the card (one counted step, which warms up, then ``--steps`` steps
each timed with CUDA events around it; the step ends in a ``.item()``): the
median ms/step, steps/s, training frames/s (batch × frames over the step),
the peak device memory, and the share of the dense bf16 peak beside. The
JAX knobs of ``scripts/bench_train.py`` (remat, scan unrolling, the
frame-inline backward, the backends) have no counterpart: the port
recomputes nothing and runs one formulation.

    python scripts/torch_bench_train.py [--recipe sceneflow tartanair kitti] [--steps 5]

The last line of standard output is one JSON record with the card's
``nvidia-smi --query-gpu=name,power.limit`` line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import torch_mfu as mfu  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--recipe", nargs="+", default=list(mfu.RECIPES), choices=list(mfu.RECIPES))
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU: the steps are timed on the card")
    smi = cs.phase_device()
    rows = []
    for name in args.recipe:
        rec = mfu.train(smi, name, args.steps)
        rec.update(steps_per_s=1e3 / rec["ms"],
                   frames_per_s=rec["frames_per_step"] * 1e3 / rec["ms"])
        rows.append(rec)
        print(f"{name} {rec['shape']} iters {rec['iters']}: median {rec['ms']:.2f} ms/step, "
              f"{rec['steps_per_s']:.3f} steps/s, {rec['frames_per_s']:.2f} training frames/s, "
              f"peak {rec['peak_gib']:.3f} GiB; ms {[round(t, 1) for t in rec['ms_each']]}; "
              f"{100 * rec['share_of_bf16_peak']:.2f} % of the bf16 peak; on {smi}")
        torch.cuda.empty_cache()
    print(json.dumps({"bench": "train", "card": smi, "rows": rows}))


if __name__ == "__main__":
    main()
