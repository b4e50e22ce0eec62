"""Optimiser and learning-rate schedule (port of ``tcs_tpu.train.optim``;
reference ``train_stereo.py:185-192``).

AdamW (betas 0.9/0.999, eps 1e-8, weight decay 1e-5) under a linear one-cycle
schedule (pct_start 0.01, div_factor 25, final_div_factor 1e4, total steps
``num_steps + 100``), with global-norm gradient clipping.

The schedule is a ``LambdaLR`` of the JAX package's formula, not
``torch.optim.lr_scheduler.OneCycleLR``, which counts its phases from step 1
and so peaks one step earlier. The clip is optax's,
``g · clip / max(‖g‖, clip)``; ``torch.nn.utils.clip_grad_norm_`` divides by
``‖g‖ + 1e-6`` instead.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch

from tcs_tpu_torch.config import TrainConfig


def onecycle_linear_schedule(peak_lr: float, total_steps: int,
                             pct_start: float = 0.01, div_factor: float = 25.0,
                             final_div_factor: float = 1e4
                             ) -> Callable[[int], float]:
    """step → learning rate: linear warm-up from peak/div_factor to the peak
    over ``max(int(pct_start·total), 1)`` steps, then linear decay to
    peak/(div_factor·final_div_factor) at ``total_steps``, held after it."""
    initial = peak_lr / div_factor
    final = initial / final_div_factor
    warm = max(int(pct_start * total_steps), 1)

    def schedule(step: int) -> float:
        s = float(min(step, total_steps))
        if s < warm:
            return initial + (peak_lr - initial) * (s / warm)
        return peak_lr + (final - peak_lr) * ((s - warm) / max(total_steps - warm, 1))

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: TrainConfig
                   ) -> Tuple[torch.optim.Optimizer,
                              torch.optim.lr_scheduler.LambdaLR]:
    """AdamW and its schedule. Step the scheduler once after each optimiser
    step; update k (from 0) then runs at ``schedule(k)``."""
    schedule = onecycle_linear_schedule(cfg.lr, cfg.num_steps + 100)
    opt = torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.wdecay)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: schedule(step) / cfg.lr)
    return opt, sched


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """√Σ‖g‖² over all gradients, as a 0-d tensor on their device."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


@torch.no_grad()
def clip_by_global_norm_(grads: Iterable[torch.Tensor], norm: torch.Tensor,
                         max_norm: float) -> None:
    """In place, g ← g · max_norm / max(‖g‖, max_norm) (optax's
    ``clip_by_global_norm``); ``norm`` is :func:`global_norm` of ``grads``."""
    scale = max_norm / norm.clamp(min=max_norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
