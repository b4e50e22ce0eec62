#!/usr/bin/env python
"""How far two fp32 backward passes of the PyTorch port differ, leaf by leaf,
why, and a float64 run of the same code as the witness.

For each (weights seed, scene seed) pair one window of the small fp32 model
(64×96, batch 2, 2 frames, 2 iterations) goes through
``accumulate_window_grads``:

- ``f64``: on the CPU in float64, the same code with every fp32 cast widened
  (``tcs_tpu_torch.utils.kinks.widened``). Every other run is held against
  this one;
- ``cpu32``: on the CPU in fp32 (plain versions of the kernels);
- ``card32``: where there is a CUDA device, on the card in fp32 with TF32 off
  (the hand-written kernels);
- ``cpu32@f64``, ``card32@f64``: the fp32 runs again with every ReLU and leaky
  ReLU unit put on the side of its kink that the float64 run took;
- ``f64p``: float64 again with the images moved by one fp32 rounding (a
  factor 1 ± 2⁻²⁴ per value).

Printed per named leaf, as shares of the float64 gradient's largest entry:
each run against ``f64``, and ``card32-cpu32``, which is what a card-against-CPU
parity check reads. Beside them the number of units that fell on another side
of their kink than in ``f64``. A unit whose pre-activation is within rounding
of zero passes its whole upstream gradient in one run and none (or a hundredth)
in the other, so a few crossed kinks among a million units move a leaf that
sums over few pixels by percents; with the kinks pinned, what is left is the
rounding of the arithmetic. A gradient path that is wrong on one side would
show as a reading near 1 on that side only, pinned or not.

``--variant batch-shared`` takes ``tests/test_torch_variants.py``'s
batch-shared configuration in place of the default one: the batch context
norm on the shared backbone, its norm parameters drawn away from ones and
zeros as that test draws them (from the weights seed), batch 1 (so the
norm's statistics are the two images' of one pair), and the window cut to
frame 0, the argmax bootstrap, whose ``cnet.conv1.weight`` that test reads;
over ``VARIANT_PAIRS``, eight seed pairs.

The last line is a JSON record; the table also goes to ``runs/``.
Usage: ``python scripts/torch_grad_parity_seeds.py [--cpu] [--variant
batch-shared]``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tcs_tpu_torch import ModelConfig, TrainConfig  # noqa: E402
from tcs_tpu_torch.data.synthetic import make_clips  # noqa: E402
from tcs_tpu_torch.models import TCStereo  # noqa: E402
from tcs_tpu_torch.models.layers import set_compute_dtype  # noqa: E402
from tcs_tpu_torch.train import SequenceBatch  # noqa: E402
from tcs_tpu_torch.train.train_step import accumulate_window_grads  # noqa: E402
from tcs_tpu_torch.utils.kinks import Kinks, widened  # noqa: E402

H, W, B, FRAMES, ITERS = 64, 96, 2, 2, 2
SEED_PAIRS = ((61, 7), (62, 17), (63, 27), (64, 37), (65, 47), (66, 57))
# --variant batch-shared: (model kwargs, batch, frames, seed pairs)
VARIANTS = {"default": ({}, B, FRAMES, SEED_PAIRS),
            "batch-shared": (dict(context_norm="batch"), 1, 1,
                             tuple((70 + k, 5 + 10 * k) for k in range(8)))}
LEAVES = ("cnet.conv1.weight", "update_block.gru08.convzr.weight",
          "disp_completor.conv_disp_stem.0.weight", "disp_refine.mask.2.weight")


def draw_norms(model, seed: int) -> None:
    """The norms' parameters away from ones and zeros, as
    ``tests/test_torch_variants.py`` draws them."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if ".norm" in n:
                lo, hi = (0.5, 1.5) if n.endswith("weight") else (-0.2, 0.2)
                p.copy_(torch.empty(p.shape).uniform_(lo, hi, generator=g))


def window_grads(model_seed, scene_seed, device, wide=False, perturb=False, replay=None,
                 variant="default"):
    kw, b, frames, _ = VARIANTS[variant]
    mcfg = ModelConfig(mixed_precision=False,
                       corr_dtype="float64" if wide else "float32", **kw)
    cfg = TrainConfig(model=mcfg, train_iters=ITERS, batch_size=b, image_size=(H, W),
                      frame_length=frames)
    model = TCStereo(mcfg, device=device, seed=model_seed)
    if kw:
        draw_norms(model, model_seed)
    batch = SequenceBatch.from_numpy(
        make_clips(b, H, W, frames, scene_seed, generic_pose=True), device)
    with contextlib.ExitStack() as stack:
        if wide:
            model.double()
            model.dtype = torch.float64
            set_compute_dtype(model, torch.float64)
            batch = SequenceBatch(**{k: v.double() for k, v in vars(batch).items()})
            if perturb:
                gen = torch.Generator().manual_seed(scene_seed)
                for img in (batch.image1, batch.image2):
                    sign = torch.randint(0, 2, img.shape, generator=gen) * 2.0 - 1.0
                    img.mul_(1.0 + sign * 2.0 ** -24)
            stack.enter_context(widened())
        kinks = stack.enter_context(Kinks(replay, l1=True))
        metrics = accumulate_window_grads(model, cfg, batch)
    grads = {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()}
    return metrics["live_loss"].item(), grads, kinks


def main() -> None:
    args = sys.argv[1:]
    variant = args[args.index("--variant") + 1] if "--variant" in args else "default"
    on_card = "--cpu" not in args
    if on_card and not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU (or --cpu for the CPU runs alone)")
    card = "cpu only"
    if on_card:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    lines, records = [f"card: {card}; configuration: {variant}"], []
    for ms, ss in VARIANTS[variant][3]:
        l64, g64, k64 = window_grads(ms, ss, "cpu", wide=True, variant=variant)
        runs = {"f64p": window_grads(ms, ss, "cpu", wide=True, perturb=True, variant=variant)}
        for name, dev in (("cpu32", "cpu"), ("card32", "cuda"))[:1 + on_card]:
            runs[name] = window_grads(ms, ss, dev, variant=variant)
            runs[name + "@f64"] = window_grads(ms, ss, dev, replay=k64.sides, variant=variant)
        units = sum(m.numel() for m in k64.sides)
        gmax = max(g.abs().max().item() for g in g64.values())
        live = [k for k, g in g64.items() if g.abs().max().item() > 1e-5 * gmax]

        def share(a, b, leaf):
            return ((a[leaf] - b[leaf]).abs().max() / g64[leaf].abs().max()).item()

        pairs = [(k + "-f64", v[1], g64) for k, v in runs.items()]
        if on_card:
            pairs.append(("card32-cpu32", runs["card32"][1], runs["cpu32"][1]))
        rec = {"seeds": [ms, ss], "units": units, "loss": {"f64": l64},
               "crossed": {}, "leaves": {leaf: {} for leaf in LEAVES}, "worst": {}}
        for name, (loss, _, kinks) in runs.items():
            rec["loss"][name] = loss
            if "@" not in name:
                rec["crossed"][name] = kinks.crossed(k64.sides)
        for tag, a, b in pairs:
            for leaf in LEAVES:
                rec["leaves"][leaf][tag] = share(a, b, leaf)
            worst = max(live, key=lambda k: share(a, b, k))
            rec["worst"][tag] = [worst, share(a, b, worst)]
        lines.append(f"seeds ({ms}, {ss}): loss " + " ".join(
            f"{k} {v:.6f}" for k, v in rec["loss"].items()))
        lines.append(f"  kinks crossed against f64, of {units} units: " + " ".join(
            f"{k} {v}" for k, v in rec["crossed"].items()))
        for leaf in LEAVES:
            lines.append(f"  {leaf}: " + "  ".join(
                f"{t} {v:.2e}" for t, v in rec["leaves"][leaf].items()))
        lines.append("  worst leaf with a live gradient: " + "  ".join(
            f"{t} {v:.2e} ({k})" for t, (k, v) in rec["worst"].items()))
        records.append(rec)
    os.makedirs("runs", exist_ok=True)
    suffix = "" if variant == "default" else f"_{variant}"
    with open(f"runs/torch_grad_parity_seeds{suffix}.txt", "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    print(json.dumps({"card": card, "variant": variant, "pairs": records}))


if __name__ == "__main__":
    main()
