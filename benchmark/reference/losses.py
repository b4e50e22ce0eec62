"""The four training losses of the reference, fp32, NHWC, one process:
every masked mean is over this batch's own mask (the semantics of
``tcs_tpu_torch/losses.py`` without a process group).
"""

from __future__ import annotations

import torch

from benchmark.reference import geometry, ops


def masked_mean(x, mask):
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.sum(m).clamp(min=1.0)


def loss_weights(n: int, gamma: float, device) -> torch.Tensor:
    """w_i = (γ^(15/(n−1)))^(n−1−i)."""
    if n == 1:
        return torch.ones(1, device=device)
    a = gamma ** (15.0 / (n - 1))
    return torch.tensor([a ** (n - 1 - i) for i in range(n)], dtype=torch.float32, device=device)


def _per_iteration_mean(x, mask):
    m = mask.to(x.dtype)
    return torch.sum(x * m[None], dim=(1, 2, 3, 4)) / torch.sum(m).clamp(min=1.0)


def sequence_loss(flow_mono, flow_init, flow_preds, flow_gt, valid, weights):
    flows_up, flows_refine_up = flow_preds
    v = valid.float()
    loss = 0.1 * masked_mean((flow_init - flow_gt).abs(), v)
    loss = loss + 0.1 * masked_mean((flow_mono - flow_gt).abs(), v)
    per_iter = (flows_up - flow_gt[None]).abs() + 1.2 * (flows_refine_up - flow_gt[None]).abs()
    return loss + torch.sum(weights * _per_iteration_mean(per_iter, v))


def _topk_values(x, k):
    """k rounds of first-occurrence max and mask."""
    j = torch.arange(x.shape[-1], device=x.device)
    outs = []
    for _ in range(k):
        top = x.amax(dim=-1, keepdim=True)
        idx = torch.where(x == top, j, x.shape[-1]).amin(dim=-1, keepdim=True)
        idx = idx.clamp(max=x.shape[-1] - 1)
        outs.append(torch.gather(x, -1, idx))
        x = x.masked_fill(j == idx, float("-inf"))
    return torch.cat(outs, dim=-1)


def init_loss(cost_volume, flow_gt, valid, k, scale, threshold, max_flow=700.0):
    """Cost-volume contrastive loss: the lerped cost at the GT disparity pulled
    towards 1, the top-k peaks outside the GT band pushed below it − threshold."""
    B, h, w, W2 = cost_volume.shape
    with torch.no_grad():
        flow_q = scale * ops.resize_nearest(flow_gt, (h, w))
        valid_q = ops.resize_bilinear(valid.float(), (h, w))
        valid_q = (valid_q == 1.0) & (flow_q.abs() < max_flow * scale)
        x_idx = torch.arange(w, dtype=torch.float32, device=flow_gt.device).reshape(1, 1, w, 1)
        index_gt = x_idx + flow_q
        mask = (index_gt >= 0) & (index_gt <= W2 - 1) & valid_q
        index_gt = index_gt.clamp(0, W2 - 1)
        lo = torch.floor(index_gt)
        frac = index_gt - lo
        j = torch.arange(W2, dtype=torch.float32, device=flow_gt.device)
        suppress = ((j >= index_gt - 1.5) & (j < index_gt + 1.5)) | ~mask
        lo = lo.long()
    phi_gt = (1.0 - frac) * torch.gather(cost_volume, -1, lo) \
        + frac * torch.gather(cost_volume, -1, (lo + 1).clamp(max=W2 - 1))
    gt_loss = 1.0 - masked_mean(phi_gt, mask)
    cost_nm = _topk_values(cost_volume.masked_fill(suppress, 0.0), k)
    hinge = (cost_nm + threshold - phi_gt.detach()).clamp(min=0.0)
    return gt_loss + masked_mean(hinge, mask.expand_as(hinge))


def _gt_valid_q(valid, hw, dense_gt):
    v = valid.float()
    if dense_gt:
        return ops.max_pool(v, 4, 4, 0) > 0
    return ops.resize_bilinear(v, hw) == 1.0


def normal_loss(flow_q_preds, norm_gt_full, valid, weights, scale, dense_gt):
    with torch.no_grad():
        gt = ops.median_pool(norm_gt_full, int(round(1.0 / scale)))
        mask = (gt[..., 0:1] / gt[..., 2:3] < 5) & (gt[..., 1:2] / gt[..., 2:3] < 5)
        v = _gt_valid_q(valid, gt.shape[1:3], dense_gt) & mask

    def term(flow_q):
        normal, _ = geometry.disp2disp_normal_xy(-flow_q)
        l1 = torch.mean((normal - gt[None]).abs(), dim=-1, keepdim=True)
        cos = torch.sum(normal * gt[None], dim=-1, keepdim=True)
        return _per_iteration_mean(0.5 * l1 + 0.5 * (1.0 - cos), v)

    q, qr = flow_q_preds
    return torch.sum(weights * (term(q) + 1.2 * term(qr)))


def grad_loss(grad_preds, grad_gt_full, valid, weights, scale, dense_gt):
    with torch.no_grad():
        gt = ops.median_pool(grad_gt_full, int(round(1.0 / scale)))
        mask = (gt[..., 0:1] < 5) & (gt[..., 1:2] < 5)
        v = _gt_valid_q(valid, gt.shape[1:3], dense_gt) & mask
    i_loss = torch.mean((grad_preds - gt[None]).abs(), dim=-1, keepdim=True)
    return torch.sum(weights * _per_iteration_mean(i_loss, v))


def frame_loss(out, flow_gt, valid_in, recipe) -> torch.Tensor:
    """seq + init + w_n·normal + w_g·grad of one frame; ``recipe`` is a
    configuration's ``train`` object."""
    scale = 0.25
    dense_gt = recipe["dataset"] != "kitti_raw"
    with torch.no_grad():
        mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=-1, keepdim=True))
        valid = (valid_in >= 0.5) & (mag < 700.0)
        grad_gt, _ = geometry.disp2disp_gradient_xy(-flow_gt)
        norm_gt = torch.cat([grad_gt, -torch.ones_like(grad_gt[..., :1])], dim=-1)
        norm_gt = norm_gt / torch.linalg.vector_norm(norm_gt, dim=-1, keepdim=True).clamp(min=1e-12)
    weights = loss_weights(out.flow_predictions[0].shape[0], recipe["loss_gamma"], flow_gt.device)
    seq = sequence_loss(out.flow_mono, out.flow_init, out.flow_predictions, flow_gt, valid, weights)
    ini = init_loss(out.cost_volume, flow_gt, valid, recipe["init_k"], scale,
                    recipe["init_thres"])
    nrm = normal_loss(out.flow_q_predictions, norm_gt, valid, weights, scale, dense_gt)
    grd = grad_loss(out.disp_grad_q_predictions, grad_gt, valid, weights, scale, dense_gt)
    return seq + ini + recipe["normal_loss_weight"] * nrm + recipe["grad_loss_weight"] * grd
