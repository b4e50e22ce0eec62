#!/usr/bin/env python
"""Time and check the splat forward kernel of the PyTorch port on one NVIDIA
GPU.

The kernel (``csrc/softsplat.cu``) at the inference path's shape
(1, 96, 320, 258) fp32 and the training path's (4, 80, 180, 258), with
out-of-image and non-finite targets, and at the inference shape under
collapsing columns: each against its plain PyTorch version on CPU copies of
the inputs (bit for bit) and launch against launch, timed with the L2 warm
and cold, beside its bound, the plain version's time, the ``index_add_``
yardstick and the card's launch floor; then the device time of each of the
call's launches at both paths' shapes, from ``torch.profiler``, and the time
of a copy of the payload (one read, one write), the card's floor for the
kernel's compulsory traffic. The
measuring code is ``chip_smoke.py``'s, from this checkout.

``--root DIR`` imports ``tcs_tpu_torch`` from DIR in place of this checkout,
so that two versions of the kernel can be compared on one card: unpack the
other commit into a directory that ``.gitignore`` lists and run, in one
command, that tree and this one in turns::

    git archive HEAD | tar -x -C .chip_tree/parent
    python scripts/bench_splat_kernel.py --root .chip_tree/parent --tag parent --atomic
    python scripts/bench_splat_kernel.py --tag change
    python scripts/bench_splat_kernel.py --tag change
    python scripts/bench_splat_kernel.py --root .chip_tree/parent --tag parent --atomic

``--atomic`` is for a tree whose splat adds with float atomics (the design
before the gather): it is held to ``chip_smoke.SPLAT_ATOMIC_RTOL`` of the
largest reference entry instead of bit for bit, and whether it was exact and
deterministic is recorded. Each run builds the kernels of its tree. The last
line of standard output is a JSON record.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILED_CALLS = 20


def launch_times(splat, values, flow) -> dict:
    """Device µs per call of each launch of one ``splat_sum`` call (by kernel
    name; memsets included), from ``torch.profiler`` over back-to-back calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        splat.splat_sum(values, flow)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            splat.splat_sum(values, flow)
        torch.cuda.synchronize()
    us = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us[e.name] += e.time_range.elapsed_us() / PROFILED_CALLS
    return dict(us)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="tree whose tcs_tpu_torch is timed")
    ap.add_argument("--tag", default="change", help="name of the tree in the record")
    ap.add_argument("--atomic", action="store_true",
                    help="the tree's splat uses float atomics: hold it to a tolerance")
    args = ap.parse_args()
    root = os.path.abspath(args.root)

    sys.path.insert(0, HERE)
    import chip_smoke as cs  # the measuring code of this checkout

    sys.path.insert(0, root)  # the kernel under test, ahead of this checkout
    import torch

    import tcs_tpu_torch
    from tcs_tpu_torch.ops import _kernels, splat

    pkg = os.path.dirname(os.path.abspath(tcs_tpu_torch.__file__))
    if pkg != os.path.join(root, "tcs_tpu_torch"):
        sys.exit(f"imported tcs_tpu_torch from {pkg}, not from {root}")
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU: the kernels have no CPU mode")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"tree {args.tag}: {pkg}; card: {card}; torch {torch.__version__}")
    _kernels.lib()
    print(f"nvcc {_kernels.build_seconds} s; ptxas: {cs.ptxas_summary(_kernels.build_log)}")
    entry = None
    for line in _kernels.build_log.splitlines():  # the splat forward's entries
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and "splat_sum" in entry and "bwd" not in entry and (
                "Used" in line or "spill" in line):
            print(f"  {entry}: {line.strip()}")
    floor = cs.launch_floor()
    records, inputs = cs.splat_records(cs.hbm_bytes_per_s(card),
                                       torch.Generator(device="cpu").manual_seed(0),
                                       exact=not args.atomic)
    launches, copy_ms = {}, {}
    for shape in ("inference", "training"):
        launches[shape] = launch_times(splat, *inputs[shape])
        print(f"launches of one call [{shape}], device us: "
              + ", ".join(f"{k[:60]} {v:.2f}" for k, v in launches[shape].items()))
        # What the card takes to read the payload once and write as much.
        values = inputs[shape][0]
        copy_ms[shape] = cs.cuda_ms(lambda: values.clone())
        print(f"payload copy [{shape}] (values.clone()): {copy_ms[shape]:.4f} ms")
    print(json.dumps({"tag": args.tag, "card": card, "launch_floor": floor,
                      "records": [dict(kernel=k, shape=s, dtype=d, **r)
                                  for (k, s, d), r in records.items()],
                      "launch_us": launches, "copy_ms": copy_ms}))


if __name__ == "__main__":
    main()
