"""The reference training step: for each frame of the window one train-mode
forward, the four losses, one backward of loss / frames (the carries
detached); then the global gradient norm, optax's clip
g · c / max(‖g‖, c), and AdamW under the linear one-cycle schedule, written
out here (the semantics of ``tcs_tpu_torch/train``).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.reference import losses
from benchmark.reference.model import State, TCStereo


def onecycle_lr(step: int, peak: float, total: int, pct_start: float = 0.01,
                div_factor: float = 25.0, final_div_factor: float = 1e4) -> float:
    """Linear warm-up from peak/div over max(int(pct·total), 1) steps, then
    linear decay to peak/(div·final_div) at ``total``, held after it."""
    initial = peak / div_factor
    final = initial / final_div_factor
    warm = max(int(pct_start * total), 1)
    s = float(min(step, total))
    if s < warm:
        return initial + (peak - initial) * (s / warm)
    return peak + (final - peak) * ((s - warm) / max(total - warm, 1))


class Step:
    """``step(batch) → {"loss", "grad_norm"}`` on ``model`` in place, with
    AdamW's moments per parameter. ``batch`` holds image1, image2, flow,
    valid (B,T,H,W,·), T (B,T,4,4), K (B,3,3), baseline (B,)."""

    def __init__(self, model: TCStereo, recipe: dict):
        self.model, self.recipe = model, recipe
        self.params = [p for p in model.parameters()]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.first_grads: List[torch.Tensor] = []  # the clipped gradients of the first step

    def window_grads(self, batch) -> torch.Tensor:
        B, Tn, H, W, _ = batch["image1"].shape
        for p in self.params:
            p.grad = None
        state = State.zeros(B, H, W, self.model.arch, batch["image1"].device)
        total = 0.0
        for t in range(Tn):
            out = self.model(batch["image1"][:, t], batch["image2"][:, t], state, batch["K"],
                             batch["baseline"], batch["T"][:, t], self.recipe["train_iters"],
                             train=True)
            loss = losses.frame_loss(out, batch["flow"][:, t], batch["valid"][:, t], self.recipe)
            (loss / Tn).backward()
            state = out.state
            total = total + loss.detach()
        return total / Tn

    @torch.no_grad()
    def update(self) -> torch.Tensor:
        r = self.recipe
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = r["grad_clip"] / norm.clamp(min=r["grad_clip"])
        grads = [g * scale for g in grads]
        if self.count == 0:
            self.first_grads = [g.clone() for g in grads]
        lr = onecycle_lr(self.count, r["lr"], r["num_steps"] + 100)
        self.count += 1
        b1, b2, eps, wd = 0.9, 0.999, 1e-8, r["wdecay"]
        c1, c2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1.0 - lr * wd)
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.sub_(lr / c1 * m / (v.sqrt() / math.sqrt(c2) + eps))
        return norm

    def __call__(self, batch) -> Dict[str, torch.Tensor]:
        loss = self.window_grads(batch)
        return {"loss": loss, "grad_norm": self.update()}
