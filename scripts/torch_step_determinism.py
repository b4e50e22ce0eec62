#!/usr/bin/env python
"""Is the fp32 training step reproducible on the card, and what does making
it so cost?

``chip_smoke.py`` phase 13 holds a resumed run's losses to the written run's
bit for bit, which needs a step that gives the same numbers twice. This
takes ``tcs_tpu``'s trained weights (``tests/fixtures/convergence_params.npz``)
at the SceneFlow recipe's shapes (B4 320x720, 2 frames, 5 iterations) in the
fp32 config with TF32 off, and runs 3 steps twice from the same weights and
batches, with cuDNN's deterministic algorithms off, on, and off again.
Prints each step's seconds (host clock around a synchronised step) and
loss, and whether the two runs' losses are equal bit for bit.

Usage: ``python scripts/torch_step_determinism.py`` (one NVIDIA GPU).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import chip_smoke as c
    from tcs_tpu_torch.config import sceneflow_recipe
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.train import make_train_step
    from tcs_tpu_torch.utils import checkpoint as ck

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    smi = c.phase_device()
    cfg = sceneflow_recipe()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, mixed_precision=False, corr_dtype="float32"))
    batches = [c._synthetic_batch(c.TRAIN_B, c.TRAIN_H, c.TRAIN_W, c.TRAIN_FRAMES,
                                  c.ORBAX_SEED + k, "cuda") for k in range(c.ORBAX_STEPS)]
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        for deterministic in (False, True, False):
            torch.backends.cudnn.deterministic = deterministic
            torch.backends.cudnn.benchmark = False
            with c.tf32_off():
                runs = []
                for rep in range(2):
                    model = TCStereo(cfg.model, seed=0)
                    ck.load_params_npz(model, c.FIXTURE)
                    step = make_train_step(model, cfg)
                    seconds, losses = [], []
                    for batch in batches:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        losses.append(step(batch)["live_loss"].item())
                        seconds.append(time.perf_counter() - t0)
                    runs.append(losses)
                    print(f"cudnn.deterministic={deterministic} run {rep}: step s "
                          f"{[round(t, 3) for t in seconds]} losses {losses}", flush=True)
                    del model, step
                print(f"cudnn.deterministic={deterministic}: the two runs' losses equal bit "
                      f"for bit: {runs[0] == runs[1]}; on {smi}", flush=True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


if __name__ == "__main__":
    main()
