#!/usr/bin/env python
"""Time and check the two correlation-lookup kernels of the PyTorch port on
one NVIDIA GPU.

Both kernels, forward (``csrc/corr_lookup.cu``) and backward
(``csrc/corr_lookup_bwd.cu``), at the inference path's shapes (batch 1,
96×320 grid) and the training path's (batch 4, 80×180), for fp32 and bf16
pyramids: each against its plain PyTorch version (non-finite and far-out
coordinates included), timed with the L2 warm and cold, beside its bound, the
plain version's time, the ``grid_sample`` yardstick and the card's launch
floor. The measuring code is ``chip_smoke.py``'s, from this checkout.

``--root DIR`` imports ``tcs_tpu_torch`` from DIR in place of this checkout,
so that two versions of the kernels can be compared on one card: unpack the
other commit into a directory that ``.gitignore`` lists and run, in one
command, that tree and this one in turns::

    git archive HEAD | tar -x -C .chip_tree/parent
    python scripts/bench_lookup_kernels.py --root .chip_tree/parent --tag parent
    python scripts/bench_lookup_kernels.py --tag change
    python scripts/bench_lookup_kernels.py --tag change
    python scripts/bench_lookup_kernels.py --root .chip_tree/parent --tag parent

Each run builds the kernels of its tree. The last line of standard output is
a JSON record.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="tree whose tcs_tpu_torch is timed")
    ap.add_argument("--tag", default="change", help="name of the tree in the record")
    args = ap.parse_args()
    root = os.path.abspath(args.root)

    sys.path.insert(0, HERE)
    import chip_smoke as cs  # the measuring code of this checkout

    sys.path.insert(0, root)  # the kernels under test, ahead of this checkout
    import torch

    import tcs_tpu_torch
    from tcs_tpu_torch.ops import _kernels

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
    # Registers, shared memory and spills of the instantiations the model
    # runs: radius 4 (and 4 levels for the forward).
    entry = None
    for line in _kernels.build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and "corr_lookup" in entry and ("Li4ELi4E" in entry or (
                "bwd" in entry and "Li4EE" in entry)) and ("Used" in line or "spill" in line):
            print(f"  {entry}: {line.strip()}")
    floor = cs.launch_floor()
    # This checkout's peak table, whichever tree's kernels are timed.
    rate = cs.load_file("tcs_tpu_torch/utils/flops.py", "flops").hbm_bytes_per_s(card)
    records = cs.lookup_records(rate, torch.Generator(device="cpu").manual_seed(0))
    print(json.dumps({"tag": args.tag, "card": card, "launch_floor": floor,
                      "records": [dict(kernel=k, shape=s, dtype=d, **r)
                                  for (k, s, d), r in records.items()]}))


if __name__ == "__main__":
    main()
