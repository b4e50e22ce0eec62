#!/usr/bin/env python
"""The port's model FLOPs of one streaming frame or one training step, by
module and by op, under ``tcs_tpu_torch/utils/flops.py``'s convention. No
time is taken, so it runs on the CPU as well as on the card: the count is
the same on both.

    python scripts/torch_flops.py --mode inference [--size 384 1280] [--iters 5]
    python scripts/torch_flops.py --mode train [--recipe sceneflow] \\
        [--size H W] [--batch B] [--frames N] [--iters N]
    ... [--fp32] [--device cpu]

``--mode inference train`` counts both, with the same sizes.
``--fp32`` counts the fp32 config (the count does not depend on the type);
``--device cpu`` runs the plain versions on the CPU (at the full sizes this
takes seconds a frame). The last line of standard output is one JSON record:
for each mode, the total, the forward and backward, the FLOPs by op in
each phase, and the forward's by module (the innermost module around each
op; inside autograd's backward torch does not say which module an op
serves).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def count(args, mode: str):
    from tcs_tpu_torch import ModelConfig
    from tcs_tpu_torch.config import RECIPES
    from tcs_tpu_torch.utils import flops

    model = ModelConfig(mixed_precision=False, corr_dtype="float32") if args.fp32 \
        else ModelConfig()
    if mode == "inference":
        H, W = args.size or (384, 1280)
        return flops.inference_flops(model, H, W, args.iters or 5, args.batch or 1,
                                     device=args.device)
    cfg = RECIPES[args.recipe]()
    cfg = dataclasses.replace(cfg, model=model, image_size=tuple(args.size or cfg.image_size),
                              batch_size=args.batch or cfg.batch_size,
                              frame_length=args.frames or cfg.frame_length,
                              train_iters=args.iters or cfg.train_iters)
    return flops.train_step_flops(cfg, device=args.device)[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("inference", "train"), nargs="+", default=["inference"])
    ap.add_argument("--recipe", default="sceneflow", choices=("sceneflow", "TartanAir",
                                                              "kitti_raw"))
    ap.add_argument("--size", type=int, nargs=2, default=None, help="H W")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None, help="train: the window")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--device", default=None, help="cpu to count on the CPU")
    ap.add_argument("--threads", type=int, default=None, help="torch's intra-op threads")
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    records = {}
    for mode in args.mode:
        counter = count(args, mode)
        print(f"{mode}:\n{counter.table()}")
        records[mode] = {
            "total": counter.total, "forward": counter.phase("forward"),
            "backward": counter.phase("backward"),
            "by_op": {ph: counter.by_op(ph) for ph in ("forward", "backward")},
            "by_module_forward": {path: {op: n for (op, ph), n in ops.items()
                                         if ph == "forward"}
                                  for path, ops in counter.own.items()}}
    print(json.dumps(records))

if __name__ == "__main__":
    main()
