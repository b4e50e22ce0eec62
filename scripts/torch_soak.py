#!/usr/bin/env python
"""Soak of the PyTorch port's ``Trainer.train()`` on one GPU (the port of
``scripts/soak_tpu.py``): 400 real optimiser steps on synthetic two-plane
scenes with the divergence detector armed and a checkpoint every 100 steps,
a SIGTERM to the training process 60 s into its steps (the trainer
checkpoints and exits 0), then a fresh process that resumes from that
checkpoint and trains on to step 400. Writes ``docs/soak_torch.md`` with the
card, the SIGTERM and the resume, and the loss in 20-step windows.

Batch 2, 256×320, 2 frames, 5 GRU iterations, the default config (bf16 conv
stacks and pyramid), lr 2e-4 under the one-cycle schedule over the 400
steps, 2 loader worker processes over 64 scenes.

  python scripts/torch_soak.py            # both processes, then the report
  python scripts/torch_soak.py --child    # one training process (internal)

The trainer's own records drive the report: one JSON line a step in
``<workdir>/soak_steps.jsonl`` (both processes append to it), and its log.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STEPS = 400
PREEMPT_AFTER_S = 60.0
WINDOW = 20
CHILD_TIMEOUT_S = 1800


def child(args) -> None:
    import logging

    from tcs_tpu_torch.config import ModelConfig, TrainConfig
    from tcs_tpu_torch.data.synthetic import SyntheticStereoSequence
    from tcs_tpu_torch.train.trainer import Trainer

    logging.basicConfig(level=logging.INFO)
    cfg = TrainConfig(name="soak", checkpoint_dir=args.workdir, batch_size=2,
                      image_size=(256, 320), frame_length=2, train_iters=5, num_steps=STEPS,
                      lr=2e-4, num_workers=2, validation_frequency=100, model=ModelConfig())
    ds = SyntheticStereoSequence(n_samples=64, frame_length=2, height=256, width=320,
                                 layered_frac=0.5)
    trainer = Trainer(cfg)
    print(f"SOAK_RESUMED_AT step={trainer.ckpt.latest_step()}", flush=True)
    res = trainer.train(dataset=ds)
    print(f"SOAK_CHILD_DONE step={res['step']}", flush=True)


def windows(records) -> list:
    """(first step, last step, mean live_loss) of each 20-step window of the
    run's steps; a step recorded twice (after a divergence went back to a
    checkpoint) counts as it was last taken."""
    by_step = {r["step"]: r["live_loss"] for r in records}
    steps = sorted(by_step)
    return [(chunk[0], chunk[-1], float(np.mean([by_step[s] for s in chunk])))
            for chunk in (steps[i:i + WINDOW] for i in range(0, len(steps), WINDOW))]


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--child", action="store_true")
    p.add_argument("--workdir", default=os.path.join(ROOT, "runs", "soak_torch"))
    p.add_argument("--out", default=os.path.join(ROOT, "docs", "soak_torch.md"))
    args = p.parse_args()
    if args.child:
        child(args)
        return

    # A stale step-400 checkpoint would make the first process resume at the
    # target and stop at once.
    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)
    steps_path = os.path.join(args.workdir, "soak_steps.jsonl")
    cmd = [sys.executable, os.path.abspath(__file__), "--child", "--workdir", args.workdir]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]

    def launch(name):
        log = open(os.path.join(args.workdir, f"{name}.log"), "w")
        return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True), log

    def output(log) -> str:
        log.close()
        with open(log.name) as f:
            return f.read()

    print(f"process 1: SIGTERM {PREEMPT_AFTER_S:.0f} s after its first step record")
    t0 = time.time()
    p1, log1 = launch("process1")
    try:
        while not (os.path.exists(steps_path) and os.path.getsize(steps_path) > 0):
            if p1.poll() is not None:
                sys.exit(f"process 1 exited before its first step:\n{output(log1)[-4000:]}")
            time.sleep(1)
        print(f"stepping after {time.time() - t0:.0f} s")
        time.sleep(PREEMPT_AFTER_S)
        p1.send_signal(signal.SIGTERM)
        p1.wait(timeout=600)
    finally:
        if p1.poll() is None:
            p1.kill()
            p1.wait()
    out1 = output(log1)
    if p1.returncode != 0 or "SIGTERM: checkpointing at step" not in out1:
        sys.exit(f"process 1 did not stop cleanly (exit {p1.returncode}):\n{out1[-4000:]}")
    preempt_line = next(line for line in out1.splitlines() if "SIGTERM: checkpointing" in line)
    print("process 1 stopped:", preempt_line.strip())

    t1 = time.time()
    p2, log2 = launch("process2")
    try:
        p2.wait(timeout=CHILD_TIMEOUT_S)
    finally:
        if p2.poll() is None:
            p2.kill()
            p2.wait()
    out2 = output(log2)
    if p2.returncode != 0 or f"SOAK_CHILD_DONE step={STEPS}" not in out2:
        sys.exit(f"process 2 failed (exit {p2.returncode}):\n{out2[-4000:]}")
    resume_line = next(line for line in out2.splitlines() if line.startswith("SOAK_RESUMED_AT"))
    resumed_at = int(resume_line.split("=")[1])
    if not 0 < resumed_at < STEPS:
        sys.exit(f"process 2 did not resume mid-run: {resume_line}")
    print("process 2 resumed and finished:", resume_line.strip())

    with open(steps_path) as f:
        records = [json.loads(line) for line in f]
    wins = windows(records)
    later = [r for r in records if r["step"] > resumed_at + 1]
    step_ms = float(np.median([r["step_ms"] for r in later]))
    peaks = [r["peak_gib"] for r in records if r["peak_gib"] is not None]
    peak = f"{max(peaks):.3f} GiB" if peaks else "not measured"
    first, last = wins[0][2], wins[-1][2]
    md = [
        "# Soak of the PyTorch port's `Trainer.train()` on one GPU",
        "",
        f"Generated by `python scripts/torch_soak.py` on {time.strftime('%Y-%m-%d')}, "
        f"card `{card}` (nvidia-smi name, power limit).",
        "",
        f"- {STEPS} optimiser steps, B2 256x320 fl2 iters 5, default config (bf16 conv "
        "stacks and pyramid), synthetic two-plane scenes (layered_frac=0.5), 2 loader "
        "worker processes",
        "- divergence detector armed (FailureDetector patience 3); a checkpoint every "
        "100 steps",
        f"- **SIGTERM**: `{preempt_line.strip()}`: {PREEMPT_AFTER_S:.0f} s after the "
        "first step's record the training process got a SIGTERM, wrote its checkpoint "
        "and exited 0",
        f"- **resume**: `{resume_line.strip()}`: a fresh process and Trainer took the "
        f"full checkpoint (weights, optimiser, schedule, loader position) and trained "
        f"to step {STEPS} ({time.time() - t1:.0f} s of wall time, start-up and kernel "
        "build included)",
        f"- median step {step_ms:.1f} ms (host clock, steps after the resume's first), "
        f"peak device memory {peak}",
        "",
        f"## Loss trajectory (mean live_loss of {WINDOW}-step windows)",
        "",
        "| steps | live_loss |",
        "|---|---|",
    ]
    md += [f"| {a}-{b} | {v:.4f} |" for a, b, v in wins]
    md += ["", f"Loss {first:.3f} over steps {wins[0][0]}-{wins[0][1]} -> {last:.3f} over "
               f"steps {wins[-1][0]}-{wins[-1][1]} ({first / max(last, 1e-9):.1f}x drop)."]
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(md) + "\n")
    print(f"wrote {args.out}: loss {first:.3f} -> {last:.3f} over {len(wins)} windows")
    if not last < first:
        sys.exit(f"the loss did not fall: {first:.3f} -> {last:.3f}")


if __name__ == "__main__":
    main()
