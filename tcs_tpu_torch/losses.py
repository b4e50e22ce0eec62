"""Training losses (port of ``tcs_tpu/losses.py``; reference
``train_stereo.py:41-182``).

All losses take NHWC tensors and return ``(loss, metrics)`` with the metrics
as 0-d tensors on the inputs' device (no host synchronisation: the caller
decides when to fetch them).

- :func:`sequence_loss`: γ-weighted L1 over the per-iteration (disp, refined)
  pairs + 0.1·L1 on init/mono.
- :func:`init_loss`: cost-volume contrastive loss at 1/4 scale.
- :func:`disp_normal_loss`: L1 + (1−cos) on disparity normals.
- :func:`disp_grad_loss`: L1 on the refined disparity gradients.
- :func:`loss_weights`: the γ-schedule.

The JAX package lowers the cost row's interpolation and the top-k as one-hot
reductions, because TPU lanes cannot gather. Here the interpolation is two
``gather``s and a lerp, and the top-k is k rounds of first-occurrence argmax
and mask: ``torch.topk`` promises no order among ties, and the suppressed
cost volume is full of tied zeros.

Each masked mean takes an optional ``count``, the mask's count over the
global batch when the batch is split over ranks (``parallel.mesh``); the
numerator stays this rank's, so the ranks' losses sum to the global batch's
(``tcs_tpu`` takes every mean over its globally sharded batch). Without it
the count is this batch's own, as in one process. The ground-truth side of
each loss is a function of its own (``*_targets``), so that the train step
can count the masks before the forward and reduce the counts while the
forward runs.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from tcs_tpu_torch.geometry import disp2disp_normal_xy
from tcs_tpu_torch.ops.sampler import (
    max_pool,
    median_pool,
    resize_bilinear,
    resize_nearest,
)

Metrics = Dict[str, torch.Tensor]


def l1(r: torch.Tensor) -> torch.Tensor:
    """|r| of every L1 term; ``utils.kinks.Kinks(l1=True)`` stands in for it
    to pin the kinks at r = 0."""
    return r.abs()


def _denominator(m: torch.Tensor, count: Optional[torch.Tensor]) -> torch.Tensor:
    """The mask's count, this batch's or the given one, in the mask's dtype
    (a count is an integer: its sum is exact in any order), at least 1."""
    return (torch.sum(m) if count is None else count.to(m.dtype)).clamp(min=1.0)


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of x over mask (bool or 0/1), safe for an empty mask; ``count``
    replaces the mask's own count (see the module docstring)."""
    m = mask.to(x.dtype)
    return torch.sum(x * m) / _denominator(m, count)


def loss_weights(n_predictions: int, gamma: float = 0.9, device=None) -> torch.Tensor:
    """w_i = (γ^(15/(n−1)))^(n−1−i) (reference train_stereo.py:364-367)."""
    if n_predictions == 1:
        return torch.ones(1, dtype=torch.float32, device=device)
    adjusted = gamma ** (15.0 / (n_predictions - 1))
    return torch.tensor([adjusted ** (n_predictions - 1 - i)
                         for i in range(n_predictions)],
                        dtype=torch.float32, device=device)


def _per_iteration_mean(x: torch.Tensor, mask: torch.Tensor,
                        count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(iters, B, h, w, 1) → (iters,): masked mean of each iteration, with the
    mask (B, h, w, 1) shared between them."""
    m = mask.to(x.dtype)
    return torch.sum(x * m[None], dim=(1, 2, 3, 4)) / _denominator(m, count)


def sequence_loss(flow_mono, flow_init, flow_preds, flow_gt, valid,
                  weights, count: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Metrics]:
    """L1 sequence loss (reference :96-135).

    flow_mono / flow_init: (B, H, W, 1) full-resolution flows (≤ 0);
    flow_preds: (flows_up, flows_refine_up), each (iters, B, H, W, 1);
    flow_gt: (B, H, W, 1); valid: (B, H, W, 1) bool; weights: (iters,);
    count: valid's count over the global batch (module docstring).
    """
    flows_up, flows_refine_up = flow_preds
    v = valid.to(torch.float32)
    loss = 0.1 * masked_mean(l1(flow_init - flow_gt), v, count)
    loss = loss + 0.1 * masked_mean(l1(flow_mono - flow_gt), v, count)
    per_iter = l1(flows_up - flow_gt[None]) + 1.2 * l1(flows_refine_up - flow_gt[None])
    loss = loss + torch.sum(weights * _per_iteration_mean(per_iter, v, count))

    with torch.no_grad():
        def epe_of(flow):
            return torch.sqrt(torch.sum((flow - flow_gt) ** 2, dim=-1))

        def mm(x):
            return masked_mean(x, v[..., 0], count)

        epe, epe_refine = epe_of(flows_up[-1]), epe_of(flows_refine_up[-1])
        metrics = {"epe": mm(epe), "epe_refine": mm(epe_refine),
                   "epe_init": mm(epe_of(flow_init))}
        for px in (1, 3, 5):
            metrics[f"{px}px"] = mm((epe < px).float())
        for px in (1, 3, 5):
            metrics[f"{px}px_refine"] = mm((epe_refine < px).float())
    return loss, metrics


def _topk_values(x: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k values along the last axis by k rounds of first-occurrence argmax
    and mask: the values, the tie order and the gradient routing (to exactly
    the selected index) of ``lax.top_k``."""
    j = torch.arange(x.shape[-1], device=x.device)
    outs = []
    for _ in range(k):
        top = x.amax(dim=-1, keepdim=True)
        # torch.max does not promise the first of tied maxima; take it explicitly.
        idx = torch.where(x == top, j, x.shape[-1]).amin(dim=-1, keepdim=True)
        idx = idx.clamp(max=x.shape[-1] - 1)  # a row of NaNs matches nowhere
        outs.append(torch.gather(x, -1, idx))
        x = x.masked_fill(j == idx, float("-inf"))
    return torch.cat(outs, dim=-1)


class InitTargets(NamedTuple):
    """The ground-truth side of :func:`init_loss` on the (B, h, w, W2) cost
    volume: the cell mask (B, h, w, 1), the GT index's lower tap and
    fraction, and the cells that the top-k skips (the GT band and the masked
    cells)."""

    mask: torch.Tensor
    lo: torch.Tensor
    frac: torch.Tensor
    suppress: torch.Tensor


@torch.no_grad()
def init_targets(flow_gt, valid, shape, max_flow: float = 700.0,
                 scale: float = 0.25) -> InitTargets:
    """:class:`InitTargets` for a cost volume of ``shape`` (B, h, w, W2)."""
    B, h, w, W2 = shape
    flow_q = scale * resize_nearest(flow_gt, (h, w))
    valid_q = resize_bilinear(valid.to(torch.float32), (h, w))
    valid_q = (valid_q == 1.0) & (flow_q.abs() < max_flow * scale)
    x_idx = torch.arange(w, dtype=torch.float32, device=flow_gt.device).reshape(1, 1, w, 1)
    index_gt = x_idx + flow_q  # x − disp_gt
    mask = (index_gt >= 0) & (index_gt <= W2 - 1) & valid_q
    index_gt = index_gt.clamp(0, W2 - 1)
    lo = torch.floor(index_gt)
    frac = index_gt - lo
    j = torch.arange(W2, dtype=torch.float32, device=flow_gt.device)
    band = (j >= index_gt - 1.5) & (j < index_gt + 1.5)
    return InitTargets(mask, lo.long(), frac, band | ~mask)


def init_loss(cost_volume, flow_gt, valid, max_flow: float = 700.0, k: int = 1,
              scale: float = 0.25, threshold: float = 0.1,
              targets: Optional[InitTargets] = None,
              counts: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              offset: float = 1.0) -> Tuple[torch.Tensor, Metrics]:
    """Cost-volume contrastive loss (reference :138-182).

    Pulls the linearly interpolated cost at the GT disparity towards 1 and
    pushes the top-k peaks outside the GT band below φ(d_gt) − threshold.

    cost_volume: (B, h, w, W2) masked cosine cost volume; flow_gt:
    (B, H, W, 1) full-resolution flow (≤ 0); valid: (B, H, W, 1);
    ``targets``: :func:`init_targets`, computed here when not given;
    ``counts``: the mask's count and the cells of the global batch (module
    docstring); ``offset``: the 1 of the GT term 1 − φ, which one rank of a
    process group adds and the others leave out, so that the ranks' losses
    sum to the global batch's.
    """
    W2 = cost_volume.shape[-1]
    if targets is None:
        targets = init_targets(flow_gt, valid, cost_volume.shape, max_flow, scale)
    mask, lo, frac, suppress = targets
    count, cells = (None, None) if counts is None else counts

    # φ(d_gt): at d = W2 − 1 the upper tap is clipped and its weight is zero.
    phi_gt = (1.0 - frac) * torch.gather(cost_volume, -1, lo) \
        + frac * torch.gather(cost_volume, -1, (lo + 1).clamp(max=W2 - 1))
    gt_loss = offset - masked_mean(phi_gt, mask, count)

    cost_nm = _topk_values(cost_volume.masked_fill(suppress, 0.0), k)  # (B,h,w,k)
    hinge = (cost_nm + threshold - phi_gt.detach()).clamp(min=0.0)
    nm_loss = masked_mean(hinge, mask.expand_as(hinge), None if count is None else k * count)
    total = gt_loss + nm_loss
    with torch.no_grad():
        rate = torch.mean((cost_nm[..., :1] + 0.3 - phi_gt > 0).float())
        if cells is not None:  # this batch's share of the global batch's rate
            rate = rate * (mask.numel() / cells)
    metrics = {"init_loss": total.detach(), "init_gt_loss": gt_loss.detach(),
               "init_nm_loss": nm_loss.detach(), "forward_mask_rate": rate}
    return total, metrics


def _gt_valid_q(valid: torch.Tensor, hw, dense_gt: bool) -> torch.Tensor:
    """Validity at the 1/4 grid: any valid pixel of the 4×4 window for dense
    ground truth, all of the bilinear footprint for sparse ground truth."""
    v = valid.to(torch.float32)
    if dense_gt:
        return max_pool(v, 4, 4, 0) > 0
    return resize_bilinear(v, hw) == 1.0


@torch.no_grad()
def normal_targets(disp_norm_gt, valid, scale: float = 0.25, dense_gt: bool = True):
    """The ground-truth side of :func:`disp_normal_loss`: the GT normals at
    the q scale (B, h, w, 3) and their mask (B, h, w, 1)."""
    gt = median_pool(disp_norm_gt, int(round(1.0 / scale)))
    mask = (gt[..., 0:1] / gt[..., 2:3] < 5) & (gt[..., 1:2] / gt[..., 2:3] < 5)
    return gt, _gt_valid_q(valid, gt.shape[1:3], dense_gt) & mask


def disp_normal_loss(flow_q_preds, disp_norm_gt, valid, weights,
                     scale: float = 0.25, dense_gt: bool = True,
                     targets=None, count: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Metrics]:
    """Disparity-normal loss on both per-iteration q-scale predictions
    (reference :67-93).

    flow_q_preds: (flow_q, flow_q_refine), each (iters, B, h, w, 1);
    disp_norm_gt: (B, H, W, 3) full-resolution GT normals; valid: (B, H, W, 1);
    ``targets``: :func:`normal_targets`, computed here when not given;
    ``count``: the mask's count over the global batch (module docstring).
    """
    flow_q_seq, flow_refine_seq = flow_q_preds
    gt, v = targets if targets is not None else normal_targets(
        disp_norm_gt, valid, scale, dense_gt)

    def one_term(flow_q):
        normal, _ = disp2disp_normal_xy(-flow_q)
        l1_term = torch.mean(l1(normal - gt[None]), dim=-1, keepdim=True)
        cos = torch.sum(normal * gt[None], dim=-1, keepdim=True)
        return _per_iteration_mean(0.5 * l1_term + 0.5 * (1.0 - cos), v, count)

    loss = torch.sum(weights * (one_term(flow_q_seq) + 1.2 * one_term(flow_refine_seq)))
    return loss, {"norm_loss": loss.detach()}


@torch.no_grad()
def grad_targets(disp_grad_gt, valid, scale: float = 0.25, dense_gt: bool = True):
    """The ground-truth side of :func:`disp_grad_loss`: the GT gradients at
    the q scale (B, h, w, 2) and their mask (B, h, w, 1)."""
    gt = median_pool(disp_grad_gt, int(round(1.0 / scale)))
    mask = (gt[..., 0:1] < 5) & (gt[..., 1:2] < 5)
    return gt, _gt_valid_q(valid, gt.shape[1:3], dense_gt) & mask


def disp_grad_loss(disp_grad_preds, disp_grad_gt, valid, weights,
                   scale: float = 0.25, dense_gt: bool = True,
                   targets=None, count: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Metrics]:
    """Disparity-gradient loss on the refined gradients (reference :41-64).

    disp_grad_preds: (iters, B, h, w, 2); disp_grad_gt: (B, H, W, 2)
    full-resolution GT gradients; valid: (B, H, W, 1); ``targets`` and
    ``count`` as in :func:`disp_normal_loss` (:func:`grad_targets`).
    """
    gt, v = targets if targets is not None else grad_targets(
        disp_grad_gt, valid, scale, dense_gt)
    i_loss = torch.mean(l1(disp_grad_preds - gt[None]), dim=-1, keepdim=True)
    loss = torch.sum(weights * _per_iteration_mean(i_loss, v, count))
    return loss, {"grad_loss": loss.detach()}
