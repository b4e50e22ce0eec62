#!/usr/bin/env python
"""The SceneFlow training step's hottest convolution shapes alone, on the card.

The step (B4 320×720, 2 frames, ``scripts/profile_torch_train_step.py``)
runs its encoder trunk on both images, batch-stacked (8 images a frame), at
full resolution with 64 channels, and its motion encoder's 1×1 correlation
convolution (36 → 64, the lookup's 4 levels × 9 taps) and the fine GRU's
3×3 convolutions at a quarter of it. Each shape is timed alone in bf16
through cuDNN, forward and backward (the input's and the weight's
gradients, one ``convolution_backward``), in the NCHW layout the port uses
and in channels-last, with ``chip_smoke.cuda_ms`` (device time, the L2 warm,
back to back). Beside each: its model FLOPs (``utils/flops.py``),
TFLOP/s and the share of the card's dense bf16 peak.

    python scripts/torch_bench_convs.py [stem layer1 layer2 layer3 convc1 convzr ...]

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

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402

# name: (what, N, H, W, Cin, Cout, kernel, stride); the step's shapes.
SHAPES = {
    "stem": ("cnet.conv1 7x7 3->64", 8, 320, 720, 3, 64, 7, 1),
    "layer1": ("cnet.layer1 3x3 64->64", 8, 320, 720, 64, 64, 3, 1),
    "layer2": ("cnet.layer2 3x3 96->96", 8, 160, 360, 96, 96, 3, 1),
    "layer3": ("cnet.layer3 3x3 128->128", 8, 80, 180, 128, 128, 3, 1),
    "convc1": ("update_block.encoder.convc1 1x1 36->64", 4, 80, 180, 36, 64, 1, 1),
    "convzr": ("update_block.gru08.convzr 3x3 384->256", 4, 80, 180, 384, 256, 3, 1),
}


def conv_records(name: str, peak_bf16: float) -> list:
    from tcs_tpu_torch.utils.flops import FlopCounter

    what, N, H, W, ci, co, k, s = SHAPES[name]
    g = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for layout in ("NCHW", "channels_last"):
        fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
        x = torch.randn(N, ci, H, W, device="cuda", generator=g).to(
            torch.bfloat16, memory_format=fmt)
        w = (torch.randn(co, ci, k, k, device="cuda", generator=g) / (ci * k * k) ** 0.5).to(
            torch.bfloat16, memory_format=fmt)
        fwd = lambda: F.conv2d(x, w, stride=s, padding=k // 2)  # noqa: E731
        gy = torch.randn_like(fwd())
        bwd = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            gy, x, w, None, (s, s), (k // 2, k // 2), (1, 1), False, (0, 0), 1,
            (True, True, False))
        for direction, fn in (("forward", fwd), ("dx+dw", bwd)):
            with FlopCounter() as counter:
                fn()
            ms = cs.cuda_ms(fn, reps=20, warmup=3)
            rate = counter.total / ms / 1e9
            out.append(dict(shape=name, what=what, layout=layout, direction=direction, ms=ms,
                            flops=counter.total, tflops_per_s=rate,
                            share_of_bf16_peak=rate * 1e12 / peak_bf16))
            print(f"{what} @{N}x{H}x{W} {layout:13s} {direction:8s} {ms:8.3f} ms "
                  f"{counter.total / 1e9:8.2f} GFLOP {rate:7.1f} TFLOP/s "
                  f"{100 * rate * 1e12 / peak_bf16:5.1f} % of peak")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="*", default=list(SHAPES), help=" ".join(SHAPES))
    args = ap.parse_args()
    unknown = set(args.which) - set(SHAPES)
    if unknown:
        ap.error(f"unknown shapes {sorted(unknown)}; known: {' '.join(SHAPES)}")
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU: the convolutions are timed on the card")
    from tcs_tpu_torch.utils.flops import peak

    smi = cs.phase_device()
    print(f"cuDNN {torch.backends.cudnn.version()}, benchmark={torch.backends.cudnn.benchmark}; "
          f"bf16 inputs and weights; on {smi}")
    rows = [r for name in args.which for r in conv_records(name, peak(smi).bf16)]
    print(json.dumps({"bench": "convs", "card": smi, "rows": rows}))


if __name__ == "__main__":
    main()
