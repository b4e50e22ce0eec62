#!/usr/bin/env python
"""The port's encoders alone, forward and backward, on the card.

One chunk of ``--batch`` × ``--frames`` image pairs at ``--size`` through
the shared-backbone encoders of the default bf16 config: the trunk on both
images batch-stacked with the context heads on the first (``cnet``) and
the matching head on the trunk (``conv2``), as one frame of the training
step runs them, but with no frame loop and nothing after them. The loss is
the sum of squares of every output; the backward takes every parameter's
gradient. Timed with ``chip_smoke.cuda_ms`` (device time, back to back),
beside the model FLOPs (``utils/flops.py``) and the share of the card's
dense bf16 peak, and the device time by kernel family from a
``torch.profiler`` trace.

    python scripts/torch_bench_encoder.py [--batch 4] [--frames 2] [--size 480 640]

The last line of standard output is one JSON record with the card's
``nvidia-smi --query-gpu=name,power.limit`` line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

LOGDIR = os.path.join("runs", "torch_bench_encoder_trace")
TRACED = 3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--frames", type=int, default=2, help="frames a chunk (batch multiplier)")
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640))
    ap.add_argument("--iters", type=int, default=10, help="calls timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU: the encoders are timed on the card")
    from tcs_tpu_torch import ModelConfig
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.ops.sampler import to_nchw
    from tcs_tpu_torch.utils.flops import FlopCounter, peak
    from tcs_tpu_torch.utils.profiling import trace
    from tcs_tpu_torch.utils.trace_summary import summarize_trace

    smi = cs.phase_device()
    H, W = args.size
    N = args.batch * args.frames
    model = TCStereo(ModelConfig(), seed=0)
    g = torch.Generator(device="cuda").manual_seed(0)
    images = torch.rand(2 * N, H, W, 3, device="cuda", generator=g) * 255
    img = to_nchw(2.0 * (images / 255.0) - 1.0)
    params = list(model.cnet.parameters()) + list(model.conv2.parameters())

    def fwd_bwd():
        cnet_list, trunk = model.cnet(img, dual_inp=True)
        outs = [x for pair in cnet_list for x in pair] + [model.conv2(trunk)]
        loss = sum(torch.sum(torch.square(x.float())) for x in outs)
        return torch.autograd.grad(loss, params)

    with FlopCounter() as counter:
        fwd_bwd()
    ms = cs.cuda_ms(fwd_bwd, reps=args.iters, warmup=2)
    shutil.rmtree(LOGDIR, ignore_errors=True)
    with trace(LOGDIR):
        for _ in range(TRACED):
            fwd_bwd()
        torch.cuda.synchronize()
    s = summarize_trace(LOGDIR)
    rate = counter.total / ms / 1e9
    share = rate * 1e12 / peak(smi).bf16
    print(f"encoders, {N} image pairs at {H}x{W} (B{args.batch} x {args.frames} frames), "
          f"forward and backward: {ms:.2f} ms ({ms / args.frames:.2f} ms a frame of "
          f"{args.batch} pairs), {counter.total / 1e9:.1f} GFLOP (forward "
          f"{counter.phase('forward') / 1e9:.1f}), {rate:.1f} TFLOP/s, {100 * share:.1f} % of "
          f"the dense bf16 peak; traced device time {s.total_ms / TRACED:.2f} ms, "
          f"{s.events / TRACED:.0f} events; on {smi}")
    for fam, fam_ms in s.by_category.most_common():
        print(f"  {fam:14s} {fam_ms / TRACED:8.3f} ms  {s.category_launches[fam] / TRACED:7.1f} "
              f"launches")
    print(json.dumps({"bench": "encoder", "card": smi, "pairs": N, "size": [H, W], "ms": ms,
                      "flops": counter.total, "tflops_per_s": rate, "share_of_bf16_peak": share,
                      "device_ms": s.total_ms / TRACED,
                      "families_ms": {k: v / TRACED for k, v in s.by_category.items()}}))


if __name__ == "__main__":
    main()
