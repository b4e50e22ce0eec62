#!/usr/bin/env python
"""Synthetic convergence of the PyTorch port, and the temporal mechanism on
held-out clips (the port of ``scripts/convergence_synthetic.py``).

A few hundred real training steps on synthetic constant-disparity scenes
(``tcs_tpu_torch/data/synthetic.py``: the right view is the left view
shifted by an exact integer disparity), recording loss, full-resolution EPE
and gradient norm per step: a correct model, loss and optimiser must drive
the EPE toward zero. The run asserts the final EPE. The committed artifact is
``docs/convergence_synthetic_torch.md``:

  python scripts/torch_convergence_synthetic.py --steps 2000 \\
      --out docs/convergence_synthetic_torch

The real TCStereo (16,735,005 parameters, 5 GRU iterations), the four
losses, ``make_train_step`` (AdamW under the one-cycle schedule, lr 2e-4) on
``SequenceBatch.from_loader`` batches of the loader (2 worker processes, seed
0) at batch 1, 64×96, 2 frames. Mixed precision on the GPU, fp32 with
``--cpu``; the pyramid in fp32 either way. Half the training clips are
two-plane scenes, so the model learns the occlusion completion that the
evaluation probes.

After training it measures the paper's central claim on held-out two-plane
clips: the EPE of frames ≥ 2 from the CARRIED temporal state (pose warp and
completion) against the same frames from a state RESET to zeros (the argmax
bootstrap on every frame), at the full iterations and at 1, clean, and at the
full iterations with the foreground's projection erased from the right view
(matching impossible there; EPE over the foreground's box). Carried must win
under occlusion.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tcs_tpu_torch import device as device_lib  # noqa: E402
from tcs_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from tcs_tpu_torch.data.loader import SequenceLoader  # noqa: E402
from tcs_tpu_torch.data.synthetic import SyntheticStereoSequence  # noqa: E402
from tcs_tpu_torch.evaluate import make_eval_fn  # noqa: E402
from tcs_tpu_torch.models import CameraParams, TCStereo, TemporalState  # noqa: E402
from tcs_tpu_torch.ops import _kernels  # noqa: E402
from tcs_tpu_torch.train import SequenceBatch, make_train_step  # noqa: E402
from tcs_tpu_torch.utils.checkpoint import save_params_npz  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain PyTorch versions of the kernels, fp32)")
    p.add_argument("--scenes", type=int, default=8)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=96)
    p.add_argument("--iters", type=int, default=5,
                   help="GRU iterations (5 = the full recipe architecture)")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--epe-target", type=float, default=1.0,
                   help="final train-window EPE (px, full-res) to assert")
    p.add_argument("--eval-clips", type=int, default=8,
                   help="held-out clips for the carried-vs-reset eval")
    p.add_argument("--eval-frames", type=int, default=3)
    p.add_argument("--save-params", default=None,
                   help="write the trained weights to this .npz (tcs_tpu's format)")
    p.add_argument("--out", default=None, help="basename for .jsonl and .md artifacts")
    return p.parse_args(argv)


def card_description(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or 'CPU'."""
    if dev.type != "cuda":
        return "CPU"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", f"--id={dev.index or 0}"],
                          capture_output=True, text=True, check=True).stdout.strip()


def train(args, model, cfg, dev) -> tuple:
    """``args.steps`` training steps; one record a step, the training loop's
    kernel launches and its seconds."""
    ds = SequenceLoader(SyntheticStereoSequence(n_samples=args.scenes, frame_length=2,
                                                height=args.height, width=args.width,
                                                layered_frac=0.5),
                        batch_size=1, seed=0, num_workers=2, pin_memory=dev.type == "cuda")
    step = make_train_step(model, cfg)
    rows = []
    before = dict(_kernels.launches)
    t0 = time.time()
    with ds:
        batches = ds.stream(1)
        try:
            for n in range(1, args.steps + 1):
                metrics = step(SequenceBatch.from_loader(next(batches)[2], dev))
                rows.append({"step": n, "loss": metrics["live_loss"].item(),
                             "epe": metrics["epe"].item(),
                             "grad_norm": metrics["grad_norm"].item()})
                if n == 1 or n % 25 == 0:
                    print(f"step {n:4d}: loss {rows[-1]['loss']:8.3f} epe {rows[-1]['epe']:7.3f} "
                          f"px ({(time.time() - t0) / n:.2f} s/step)", file=sys.stderr, flush=True)
        finally:
            batches.close()
    seconds = time.time() - t0
    launches = {k: v - before[k] for k, v in _kernels.launches.items()}
    return rows, launches, seconds


def occluded_right_view(s, t):
    """Frame ``t``'s right image with the foreground's projection (and a
    2-pixel margin) painted with the image's mean colour, and the
    foreground's box (y0, y1, x0, x1) in the left image: matching is
    impossible there (supp Table 2's OCC setting)."""
    disp_gt = -s["flow"][t][..., 0]
    fg = disp_gt > disp_gt.min() + 0.5
    ys, xs = np.where(fg)
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    d_fg = int(round(disp_gt[fg].max()))
    img2 = s["image2"][t].copy()
    img2[max(y0 - 2, 0):y1 + 2, max(x0 - d_fg - 2, 0):x1 - d_fg + 2] = img2.reshape(-1, 3).mean(0)
    return img2, (y0, y1, x0, x1)


def temporal_eval(args, model, cfg, dev) -> dict:
    """Carried against reset on held-out two-plane clips, for each setting."""
    H, W = args.height, args.width
    eval_ds = SyntheticStereoSequence(n_samples=args.eval_clips, frame_length=args.eval_frames,
                                      height=H, width=W, layered_frac=1.0)
    clips = [eval_ds.load_sample(ci, np.random.default_rng(10_000 + ci))
             for ci in range(args.eval_clips)]
    ev_full = make_eval_fn(model, args.iters)
    ev_by_iters = {args.iters: ev_full, 1: make_eval_fn(model, 1)}

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)[None]

    def zeros():
        return TemporalState.zeros(1, H, W, cfg.model, device=dev)

    def seq_epe(n_it: int, carry: bool, occlude: bool) -> float:
        """Mean full-res EPE over frames ≥ 2 of each clip. The carry is always
        advanced by the full-iteration pass on the clean frame (the state a
        tracking system would have); the frame under test runs at ``n_it``
        iterations from that carried state or from a reset. ``occlude``: in
        frames ≥ 2 the right view is :func:`occluded_right_view`'s and the
        EPE is taken over the foreground's box."""
        errs = []
        for s in clips:
            cam = CameraParams(K=tensor(s["K"]), baseline=tensor(s["baseline"]))
            state = zeros()
            for t in range(args.eval_frames):
                img1, T = tensor(s["image1"][t]), tensor(s["T"][t])
                img2, (y0, y1, x0, x1) = occluded_right_view(s, t)
                if t >= 1:
                    flow, _ = ev_by_iters[n_it](img1, tensor(img2 if occlude else s["image2"][t]),
                                                state if carry else zeros(), cam, T)
                    err = np.abs(flow.cpu().numpy()[0, ..., 0] - s["flow"][t][..., 0])
                    if occlude:
                        err = err[y0:y1, x0:x1]
                    errs.append(float(err.mean()))
                _, state = ev_full(img1, tensor(s["image2"][t]), state, cam, T)
        return float(np.mean(errs))

    temporal = {}
    for key, (n_it, occ) in {f"iters{args.iters}_clean": (args.iters, False),
                             "iters1_clean": (1, False),
                             f"iters{args.iters}_occluded": (args.iters, True)}.items():
        temporal[key] = {"carried": seq_epe(n_it, True, occ),
                         "reset": seq_epe(n_it, False, occ)}
        print(f"temporal eval {key}: carried {temporal[key]['carried']:.3f} px vs reset "
              f"{temporal[key]['reset']:.3f} px", file=sys.stderr)
    return temporal


def run(args) -> dict:
    """Train, then evaluate the temporal mechanism; returns the records."""
    dev = torch.device("cpu") if args.cpu else device_lib.resolve(None)
    cfg = TrainConfig(model=ModelConfig(mixed_precision=not args.cpu, corr_dtype="float32"),
                      train_iters=args.iters, batch_size=1,
                      image_size=(args.height, args.width), frame_length=2,
                      num_steps=args.steps, lr=args.lr)
    model = TCStereo(cfg.model, device=dev, seed=0)
    rows, launches, seconds = train(args, model, cfg, dev)
    k = max(args.steps // 10, 1)
    epe = [r["epe"] for r in rows]
    t0 = time.time()
    temporal = temporal_eval(args, model, cfg, dev)
    return dict(rows=rows, k=k, first_epe=float(np.mean(epe[:k])),
                final_epe=float(np.mean(epe[-k:])), temporal=temporal, launches=launches,
                train_seconds=seconds, eval_seconds=time.time() - t0, model=model,
                card=card_description(dev))


def write_artifacts(args, res) -> None:
    rows, k = res["rows"], res["k"]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out + ".jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    width = max(args.steps // 12, 1)
    md = ["# Synthetic convergence curve (PyTorch port)", "",
          f"`python scripts/torch_convergence_synthetic.py{' --cpu' if args.cpu else ''} "
          f"--steps {args.steps} --out {args.out}`", "",
          f"Device: {res['card']}; {res['train_seconds'] / len(rows):.3f} s/step over "
          f"{len(rows)} steps (host clock, the loader and the first step's kernel build "
          "included).", "",
          f"Real train step (TCStereo {args.iters} GRU iters, frame_length 2, AdamW+OneCycle "
          f"lr {args.lr}) on {args.scenes} synthetic constant-disparity scenes at "
          f"{args.height}x{args.width}; full-resolution EPE from the training metrics "
          "(losses.sequence_loss), batch 1.", "",
          "| steps | mean EPE (px) | mean loss |", "|---|---|---|"]
    for lo in range(0, args.steps, width):
        sel = rows[lo:lo + width]
        md.append(f"| {lo + 1}-{lo + len(sel)} | {np.mean([r['epe'] for r in sel]):.3f} | "
                  f"{np.mean([r['loss'] for r in sel]):.3f} |")
    md += ["", f"first-{k} EPE {res['first_epe']:.3f} px → last-{k} EPE "
               f"**{res['final_epe']:.3f} px** (target < {args.epe_target} px)", "",
           "## Temporal mechanism (carried state vs reset)", "",
           f"Frame≥2 full-res EPE on {args.eval_clips} held-out geometrically consistent "
           f"clips ({args.eval_frames} frames each): the CARRIED temporal state (pose warp "
           "+ completion) against the same frames with the state reset to zeros (argmax "
           "bootstrap every frame). 'occluded': frames≥2 get a mean-color rectangle erased "
           "from the right image (matching impossible there; the carried state still knows "
           "the disparity) and EPE is measured over the affected pixels only.", "",
           "| setting | carried EPE (px) | reset EPE (px) |", "|---|---|---|"]
    md += [f"| {key} | **{r['carried']:.3f}** | {r['reset']:.3f} |"
           for key, r in res["temporal"].items()]
    with open(args.out + ".md", "w") as f:
        f.write("\n".join(md) + "\n")
    print(f"wrote {args.out}.jsonl and {args.out}.md", file=sys.stderr)


def main(argv=None) -> None:
    args = parse_args(argv)
    res = run(args)
    if args.save_params:
        save_params_npz(res["model"], args.save_params)
        print(f"wrote {args.save_params}", file=sys.stderr)
    if args.out:
        write_artifacts(args, res)
    print(json.dumps({"metric": "synthetic_final_epe", "value": round(res["final_epe"], 3),
                      "unit": "px", "first_window_epe": round(res["first_epe"], 3),
                      "steps": args.steps, "temporal": res["temporal"],
                      "s_per_step": res["train_seconds"] / args.steps,
                      "launches": res["launches"], "device": res["card"]}))
    if not res["final_epe"] < args.epe_target:
        sys.exit(f"synthetic EPE did not converge: {res['final_epe']:.3f} px "
                 f"(target {args.epe_target})")
    tocc = res["temporal"][f"iters{args.iters}_occluded"]
    if not tocc["carried"] < tocc["reset"]:
        sys.exit(f"temporal mechanism shows no benefit under occlusion: carried "
                 f"{tocc['carried']:.3f} vs reset {tocc['reset']:.3f} px")
    print(f"CONVERGENCE OK: EPE {res['first_epe']:.2f} -> {res['final_epe']:.3f} px; "
          f"occluded-region carried {tocc['carried']:.3f} < reset {tocc['reset']:.3f} px",
          file=sys.stderr)


if __name__ == "__main__":
    main()
