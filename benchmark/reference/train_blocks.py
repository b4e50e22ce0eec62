"""The reference training step on a global batch, computed in blocks of rows
so that a batch of several ranks fits on one card: the function that the
port's data-parallel step computes (``tcs_tpu_torch/parallel/mesh.py``),
written out in plain fp32 from the single-process reference.

Each of the four losses is a sum of masked means. Over the global batch a
masked mean is the blocks' masked sums over the global batch's count of its
mask, so a block's term is its own masked mean times its own count over the
global count; the one constant term, the 1 of the init loss's 1 − φ, is
counted once, in the first block. The blocks' gradients add up in ``.grad``;
then the global norm, the clip and AdamW of :class:`reference.train.Step`.
"""

from __future__ import annotations

import torch

from benchmark.reference import geometry, losses, ops
from benchmark.reference.model import State
from benchmark.reference.train import Step

SCALE = 0.25  # the losses' quarter-resolution grid
MAX_FLOW = 700.0


@torch.no_grad()
def _masks(flow_gt, valid_in, factor: int, recipe: dict):
    """The four losses' masks of one frame of a block, as the loss functions
    of :mod:`reference.losses` make them: sequence (valid), init, normal and
    gradient."""
    dense_gt = recipe["dataset"] != "kitti_raw"
    B, H, W, _ = flow_gt.shape
    h, w = H // factor, W // factor
    mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=-1, keepdim=True))
    valid = (valid_in >= 0.5) & (mag < MAX_FLOW)
    flow_q = SCALE * ops.resize_nearest(flow_gt, (h, w))
    valid_q = ops.resize_bilinear(valid.float(), (h, w))
    valid_q = (valid_q == 1.0) & (flow_q.abs() < MAX_FLOW * SCALE)
    x_idx = torch.arange(w, dtype=torch.float32, device=flow_gt.device).reshape(1, 1, w, 1)
    index_gt = x_idx + flow_q
    init = (index_gt >= 0) & (index_gt <= w - 1) & valid_q
    grad_gt, _ = geometry.disp2disp_gradient_xy(-flow_gt)
    norm_gt = torch.cat([grad_gt, -torch.ones_like(grad_gt[..., :1])], dim=-1)
    norm_gt = norm_gt / torch.linalg.vector_norm(norm_gt, dim=-1, keepdim=True).clamp(min=1e-12)
    k = int(round(1.0 / SCALE))
    n = ops.median_pool(norm_gt, k)
    normal = losses._gt_valid_q(valid, n.shape[1:3], dense_gt) \
        & (n[..., 0:1] / n[..., 2:3] < 5) & (n[..., 1:2] / n[..., 2:3] < 5)
    g = ops.median_pool(grad_gt, k)
    grad = losses._gt_valid_q(valid, g.shape[1:3], dense_gt) & (g[..., 0:1] < 5) & (g[..., 1:2] < 5)
    return valid, init, normal, grad


def counts(flow_gt, valid_in, factor: int, recipe: dict) -> torch.Tensor:
    """(4,) float64: the masks' counts of one frame of a block."""
    return torch.stack([m.double().sum() for m in _masks(flow_gt, valid_in, factor, recipe)])


def block_frame_loss(out, flow_gt, valid_in, recipe: dict, own: torch.Tensor,
                     total: torch.Tensor, first: bool) -> torch.Tensor:
    """One block's share of one frame's global loss: each term of
    :func:`reference.losses.frame_loss` times the block's count of its mask
    over the global batch's (``own``, ``total``: :func:`counts`), the init
    loss's constant once, in the ``first`` block."""
    dense_gt = recipe["dataset"] != "kitti_raw"
    share = (own.clamp(min=1.0) / total.clamp(min=1.0)).float()
    with torch.no_grad():
        mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=-1, keepdim=True))
        valid = (valid_in >= 0.5) & (mag < MAX_FLOW)
        grad_gt, _ = geometry.disp2disp_gradient_xy(-flow_gt)
        norm_gt = torch.cat([grad_gt, -torch.ones_like(grad_gt[..., :1])], dim=-1)
        norm_gt = norm_gt / torch.linalg.vector_norm(norm_gt, dim=-1, keepdim=True).clamp(min=1e-12)
    weights = losses.loss_weights(out.flow_predictions[0].shape[0], recipe["loss_gamma"],
                                  flow_gt.device)
    seq = losses.sequence_loss(out.flow_mono, out.flow_init, out.flow_predictions, flow_gt,
                               valid, weights)
    ini = losses.init_loss(out.cost_volume, flow_gt, valid, recipe["init_k"], SCALE,
                           recipe["init_thres"])
    nrm = losses.normal_loss(out.flow_q_predictions, norm_gt, valid, weights, SCALE, dense_gt)
    grd = losses.grad_loss(out.disp_grad_q_predictions, grad_gt, valid, weights, SCALE,
                           dense_gt)
    return (share[0] * seq + share[1] * (ini - 1.0) + float(first)
            + recipe["normal_loss_weight"] * share[2] * nrm
            + recipe["grad_loss_weight"] * share[3] * grd)


class BlockStep(Step):
    """:class:`reference.train.Step` on a global batch taken ``block`` rows at
    a time: ``step(batch) → {"loss", "grad_norm"}``, the global batch's."""

    def __init__(self, model, recipe: dict, block: int):
        super().__init__(model, recipe)
        self.block = block

    def window_grads(self, batch) -> torch.Tensor:
        B, Tn, H, W, _ = batch["image1"].shape
        f = self.model.arch.factor
        for p in self.params:
            p.grad = None
        blocks = [slice(b, min(b + self.block, B)) for b in range(0, B, self.block)]
        own = [[counts(batch["flow"][rows, t], batch["valid"][rows, t], f, self.recipe)
                for t in range(Tn)] for rows in blocks]
        total = [sum(c[t] for c in own) for t in range(Tn)]
        loss_sum = 0.0
        for i, rows in enumerate(blocks):
            part = {k: v[rows] for k, v in batch.items()}
            state = State.zeros(part["image1"].shape[0], H, W, self.model.arch,
                                part["image1"].device)
            for t in range(Tn):
                out = self.model(part["image1"][:, t], part["image2"][:, t], state, part["K"],
                                 part["baseline"], part["T"][:, t], self.recipe["train_iters"],
                                 train=True)
                loss = block_frame_loss(out, part["flow"][:, t], part["valid"][:, t],
                                        self.recipe, own[i][t], total[t], i == 0)
                (loss / Tn).backward()
                state = out.state
                loss_sum = loss_sum + loss.detach()
        return loss_sum / Tn
