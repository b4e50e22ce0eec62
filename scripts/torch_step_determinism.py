#!/usr/bin/env python
"""Is the training step reproducible on the card, and what does making it
so cost?

``chip_smoke.py`` phase 13 holds a resumed run's losses to the written run's
bit for bit, which needs a step that gives the same numbers twice. This
takes ``tcs_tpu``'s trained weights (``tests/fixtures/convergence_params.npz``)
at the SceneFlow recipe's shapes (B4 320x720, 2 frames, 5 iterations) in the
fp32 config with TF32 off, and runs 3 steps twice from the same weights and
batches, with cuDNN's deterministic algorithms off, on, and off again.
Prints each step's seconds (host clock around a synchronised step) and
loss, and whether the two runs' losses are equal bit for bit.

``--bf16`` takes the recipe's own default config (bf16 conv stacks and
pyramid), as the training CLI trains it, for 6 steps a run, with cuDNN's
deterministic algorithms (``tcs_tpu_torch.device.deterministic``, the CLI's
``--deterministic``) off, on, off, on: the flag's cost on the step from the
median over steps 2..6 of each mode's runs, beside the bit-for-bit check.

Usage: ``python scripts/torch_step_determinism.py [--bf16]`` (one NVIDIA GPU).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import contextlib

    import numpy as np

    import chip_smoke as c
    from tcs_tpu_torch import device as device_lib
    from tcs_tpu_torch.config import sceneflow_recipe
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.train import make_train_step
    from tcs_tpu_torch.utils import checkpoint as ck

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    bf16 = sys.argv[1:] == ["--bf16"]
    smi = c.phase_device()
    cfg = sceneflow_recipe()
    if not bf16:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, mixed_precision=False, corr_dtype="float32"))
    n_steps, modes = (6, (False, True, False, True)) if bf16 else (c.ORBAX_STEPS,
                                                                   (False, True, False))
    batches = [c._synthetic_batch(c.TRAIN_B, c.TRAIN_H, c.TRAIN_W, c.TRAIN_FRAMES,
                                  c.ORBAX_SEED + k, "cuda") for k in range(n_steps)]
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    steady = {False: [], True: []}
    try:
        for deterministic in modes:
            torch.backends.cudnn.deterministic = False
            torch.backends.cudnn.benchmark = False
            with (contextlib.nullcontext() if bf16 else c.tf32_off()), \
                    (device_lib.deterministic() if deterministic else contextlib.nullcontext()):
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
                    steady[deterministic] += seconds[1:]
                    print(f"cudnn.deterministic={deterministic} run {rep}: step s "
                          f"{[round(t, 3) for t in seconds]} losses {losses}", flush=True)
                    del model, step
                print(f"cudnn.deterministic={deterministic}: the two runs' losses equal bit "
                      f"for bit: {runs[0] == runs[1]}; on {smi}", flush=True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    med = {k: 1e3 * float(np.median(v)) for k, v in steady.items()}
    print(f"{'bf16' if bf16 else 'fp32'} step, median over steps 2..{n_steps}: "
          f"{med[False]:.2f} ms without cuDNN's deterministic algorithms, {med[True]:.2f} ms "
          f"with them, {med[True] / med[False]:.3f}x; on {smi}")


if __name__ == "__main__":
    main()
