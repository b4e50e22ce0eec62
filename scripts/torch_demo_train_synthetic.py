#!/usr/bin/env python
"""End-to-end sanity run of the PyTorch port: ``Trainer.train()`` on one
synthetic constant-disparity scene for a few steps; the loss must fall (the
port of ``scripts/demo_train_synthetic.py``).

Default config (bf16 conv stacks) on the GPU; fp32 conv stacks with
``--cpu``, which runs the plain PyTorch path on the CPU. Without ``--cpu`` and
without a GPU it raises. 64×96, batch 1, 2 frames, 2 GRU iterations, lr 2e-4
under the one-cycle schedule; the scene is loaded in the training process
(no loader workers). The losses come from the trainer's per-step records.

  python scripts/torch_demo_train_synthetic.py [--steps 8] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tcs_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from tcs_tpu_torch.data.synthetic import SyntheticStereoSequence  # noqa: E402
from tcs_tpu_torch.train.trainer import Trainer  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain PyTorch versions of the kernels, fp32)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    H, W = 64, 96
    with tempfile.TemporaryDirectory(prefix="tcs_torch_demo_") as workdir:
        cfg = TrainConfig(name="demo_synth", model=ModelConfig(mixed_precision=not args.cpu),
                          train_iters=2, batch_size=1, image_size=(H, W), frame_length=2,
                          num_steps=args.steps, lr=2e-4, checkpoint_dir=workdir,
                          num_workers=0)
        # A single repeated scene: the loss must fall step over step.
        ds = SyntheticStereoSequence(n_samples=1, frame_length=2, height=H, width=W)
        trainer = Trainer(cfg, device="cpu" if args.cpu else None)
        t0 = time.time()
        trainer.train(dataset=ds)
        with open(trainer.steps_path) as f:
            losses = [json.loads(line)["live_loss"] for line in f]
    print(f"device {trainer.device}; losses: {[round(v, 3) for v in losses]}")
    print(f"total {time.time() - t0:.1f}s")
    # Early steps at the peak learning rate are noisy (the bootstrap mask is
    # discontinuous in the weights): compare the first and last thirds.
    k = max(len(losses) // 3, 1)
    head, tail = sum(losses[:k]) / k, sum(losses[-k:]) / k
    if not tail < head:
        sys.exit(f"loss did not decrease: head={head:.2f} tail={tail:.2f}")
    print(f"DEMO OK: loss decreased {head:.2f} -> {tail:.2f}")


if __name__ == "__main__":
    main()
