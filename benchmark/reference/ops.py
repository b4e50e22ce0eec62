"""Plain fp32 operations of the reference: the cost volume, its pyramid and
bootstrap, the radius lookup, the softmax splat, sampling, pooling, resizing,
convex upsampling and the input padder.

A frozen copy of the semantics of ``tcs_tpu_torch``'s ``ops`` and
``utils/padder.py``, written with plain PyTorch operations only: no hand
kernel, no launch counter, no FLOP hook. Maps are NHWC (B, H, W, C) at the
public functions, conv features NCHW inside the model.

``lookup``, ``splat_sum`` and ``convex_upsample_nchw`` are the three
functions that the benchmark's FLOP count takes by their taps
(``benchmark/flops``); the model calls them through this module, so that
the count can wrap them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import precision

_EPS = 1e-7
_TAPS = ((0, 0), (1, 0), (0, 1), (1, 1))


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


# --- cost volume -------------------------------------------------------------

def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True)).clamp(min=eps)


def build_cost_volume(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """Cosine cost (B,H,W1,C) × (B,H,W2,C) → (B,H,W1,W2), fp32."""
    return torch.matmul(l2_normalize(fmap1.float()), l2_normalize(fmap2.float()).transpose(-1, -2))


def corr_pyramid(cost: torch.Tensor, num_levels: int) -> Tuple[torch.Tensor, ...]:
    """Mean of pairs along W2, an odd width floored; level 0 is the volume."""
    levels = [cost]
    for _ in range(num_levels - 1):
        half = levels[-1].shape[-1] // 2
        levels.append(levels[-1][..., :2 * half].reshape(*levels[-1].shape[:-1], half, 2)
                      .mean(dim=-1))
    return tuple(levels)


def masked_cost_volume(cost: torch.Tensor) -> torch.Tensor:
    """Cells with w2 > w1 (negative disparity) set to zero."""
    W1, W2 = cost.shape[-2:]
    return cost * torch.ones(W1, W2, dtype=cost.dtype, device=cost.device).tril()


def argmax_disp(cost: torch.Tensor, margin: float, suppress_radius: float):
    """Bootstrap: the first maximum's disparity where it beats the best cell
    outside [idx − r, idx + r) by more than ``margin``; (disp, cost, mask),
    each (B, H, W1, 1)."""
    W1, W2 = cost.shape[-2:]
    main_cost = cost.amax(dim=-1, keepdim=True)
    j = torch.arange(W2, device=cost.device)
    index = torch.where(cost == main_cost, j, W2).amin(dim=-1, keepdim=True)
    jf, idxf = j.float(), index.float()
    band = (jf >= idxf - suppress_radius) & (jf < idxf + suppress_radius)
    sub_cost = torch.where(band, torch.zeros_like(cost), cost).amax(dim=-1, keepdim=True)
    mask = (main_cost - sub_cost > margin).float()
    disp = (torch.arange(W1, device=cost.device)[:, None] - index).float()
    return disp * mask, main_cost * mask, mask


def lookup(pyramid: Sequence[torch.Tensor], coords_x: torch.Tensor, radius: int) -> torch.Tensor:
    """Radius lookup across the pyramid: level i reads taps floor(c)+k,
    k ∈ [−r, r+1], of c = coords_x / 2^i (zero outside the row) and lerps
    neighbours; (B,H,W1) → (B,H,W1, L·(2r+1)), level-major. Differentiable
    in the pyramid; the coordinates are constants."""
    coords_x = coords_x.detach()
    k = torch.arange(-radius, radius + 2, device=coords_x.device)
    outs = []
    for i, corr in enumerate(pyramid):
        W2 = corr.shape[-1]
        c = coords_x / (2 ** i)
        base = torch.floor(c)
        frac = (c - base)[..., None]
        idx = base.long()[..., None] + k
        valid = (idx >= 0) & (idx <= W2 - 1)
        taps = torch.gather(corr, -1, idx.clamp(0, W2 - 1)).float() * valid
        outs.append((1.0 - frac) * taps[..., :-1] + frac * taps[..., 1:])
    return torch.cat(outs, dim=-1)


# --- splatting ---------------------------------------------------------------

def splat_sum(values: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear forward scatter-add: source (x, y) adds its values to the four
    integer neighbours of (x + fx, y + fy) with weight
    (1 − |tx − xi|)(1 − |ty − yi|); taps outside the image are dropped and
    non-finite targets skipped. (B,H,W,C), (B,H,W,2) → (B,H,W,C)."""
    B, H, W, C = values.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=values.dtype, device=values.device),
                            torch.arange(W, dtype=values.dtype, device=values.device),
                            indexing="ij")
    tx, ty = xs + flow[..., 0], ys + flow[..., 1]
    finite = torch.isfinite(tx) & torch.isfinite(ty)
    tx = torch.where(finite, tx, torch.full_like(tx, -10.0))
    ty = torch.where(finite, ty, torch.full_like(ty, -10.0))
    x0, y0 = torch.floor(tx), torch.floor(ty)
    out = values.new_zeros(B * H * W, C)
    src = values.reshape(B * H * W, C)
    boff = (torch.arange(B, device=values.device) * (H * W))[:, None, None]
    for dx, dy in _TAPS:
        xi, yi = x0 + dx, y0 + dy
        w = (1.0 - (tx - xi).abs()) * (1.0 - (ty - yi).abs())
        valid = ((xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)).reshape(-1)
        idx = (boff + yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()).reshape(-1)
        out.index_add_(0, idx[valid], (src * w.reshape(-1, 1))[valid])
    return out.reshape(B, H, W, C)


def softsplat(values, flow, metric, valid_mask):
    """Softmax splatting ('soft-clipeps'): splat [values·e^m·valid, e^m·valid],
    divide by clip(weight, 1e-7); mask = weight ≠ 0 before the clip."""
    values = values * valid_mask
    weight = torch.exp(metric)
    out = splat_sum(torch.cat([values * weight, weight * valid_mask], dim=-1).contiguous(),
                    flow.contiguous())
    norm = out[..., -1:]
    return out[..., :-1] / norm.clamp(min=_EPS), (norm != 0).to(values.dtype)


# --- sampling, resizing, pooling ---------------------------------------------

def coords_grid(batch: int, ht: int, wd: int, dtype, device) -> torch.Tensor:
    ys, xs = torch.meshgrid(torch.arange(ht, dtype=dtype, device=device),
                            torch.arange(wd, dtype=dtype, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1)[None].expand(batch, ht, wd, 2)


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``grid_sample(align_corners=True, padding 'zeros')`` at pixel coords:
    (B,H,W,C) at (B,Ho,Wo,2) → (B,Ho,Wo,C)."""
    B, H, W, C = img.shape
    Ho, Wo = coords.shape[1:3]
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1.0, y0 + 1.0
    flat = img.reshape(B, H * W, C)

    def tap(iy, ix, w):
        valid = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        lin = iy.clamp(0, H - 1).long() * W + ix.clamp(0, W - 1).long()
        vals = torch.gather(flat, 1, lin.reshape(B, Ho * Wo, 1).expand(-1, -1, C))
        return vals.reshape(B, Ho, Wo, C) * (w * valid.to(img.dtype))[..., None]

    return (tap(y0, x0, (x1 - x) * (y1 - y)) + tap(y0, x1, (x - x0) * (y1 - y))
            + tap(y1, x0, (x1 - x) * (y - y0)) + tap(y1, x1, (x - x0) * (y - y0)))


def _linear_positions(in_size: int, out_size: int, device):
    """align_corners=True source positions: i·c with c = (in − 1)·(1/(out − 1))
    in fp32 (as the JAX package's compiled ``linspace``), the last in − 1."""
    if out_size == 1 or in_size == 1:
        pos = torch.zeros(out_size, device=device)
    else:
        c = float(np.float32(in_size - 1) * (np.float32(1.0) / np.float32(out_size - 1)))
        pos = torch.arange(out_size, dtype=torch.float32, device=device) * c
        pos[-1] = in_size - 1
    i0 = torch.floor(pos).clamp(0, in_size - 1).long()
    return i0, (i0 + 1).clamp(max=in_size - 1), pos - i0.float()


def resize_bilinear_nchw(x: torch.Tensor, out_hw) -> torch.Tensor:
    H, W = x.shape[2:4]
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    if out_h != H:
        i0, i1, f = _linear_positions(H, out_h, x.device)
        f = f.to(x.dtype)[:, None]
        x = x[:, :, i0] * (1.0 - f) + x[:, :, i1] * f
    if out_w != W:
        j0, j1, g = _linear_positions(W, out_w, x.device)
        g = g.to(x.dtype)
        x = x[..., j0] * (1.0 - g) + x[..., j1] * g
    return x


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    return to_nhwc(resize_bilinear_nchw(to_nchw(x), out_hw))


def resize_nearest_nchw(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Source index floor(dst · in / out)."""
    H, W = x.shape[2:4]
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    iy = torch.floor(torch.arange(out_h, dtype=torch.float32, device=x.device) * (H / out_h)).long()
    ix = torch.floor(torch.arange(out_w, dtype=torch.float32, device=x.device) * (W / out_w)).long()
    return x[:, :, iy][:, :, :, ix]


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    return to_nhwc(resize_nearest_nchw(to_nchw(x), out_hw))


def pool2x_nchw(x: torch.Tensor) -> torch.Tensor:
    """avg_pool2d(3, stride 2, padding 1), padding counted."""
    return F.avg_pool2d(x.contiguous(), 3, stride=2, padding=1, count_include_pad=True)


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    return to_nhwc(F.max_pool2d(to_nchw(x), window, stride, padding))


def median_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping k×k lower median of (B,H,W,C)."""
    B, H, W, C = x.shape
    win = x.reshape(B, H // k, k, W // k, k, C).permute(0, 1, 3, 5, 2, 4)
    return win.reshape(B, H // k, W // k, C, k * k).median(dim=-1).values


def convex_upsample_nchw(field: torch.Tensor, mask_logits: torch.Tensor,
                         factor: int) -> torch.Tensor:
    """(B,D,H,W), (B,9·f·f,H,W) → (B,D,f·H,f·W): softmax over the 9 taps of
    logit channel (k·f + fy)·f + fx, field scaled by f."""
    B, D, H, W = field.shape
    f = factor
    m = torch.softmax(mask_logits.reshape(B, 1, 9, f, f, H, W), dim=2)
    nb = F.unfold(field * f, [3, 3], padding=1).reshape(B, D, 9, 1, 1, H, W)
    up = torch.sum(m * nb, dim=2)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, D, f * H, f * W)


# --- input padding -----------------------------------------------------------

class InputPadder:
    """Replicate-pads NHWC images to a multiple of ``divis_by``, split
    symmetrically ('sintel' mode), shifting K's principal point; ``unpad``
    crops back."""

    def __init__(self, dims, divis_by: int = 32):
        ht, wd = int(dims[-3]), int(dims[-2])
        pad_ht = (((ht // divis_by) + 1) * divis_by - ht) % divis_by
        pad_wd = (((wd // divis_by) + 1) * divis_by - wd) % divis_by
        self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2]

    def pad(self, *inputs, K: Optional[torch.Tensor] = None):
        outs = [F.pad(x.permute(0, 3, 1, 2), self._pad, mode="replicate").permute(0, 2, 3, 1)
                for x in inputs]
        shift = torch.zeros(3, 3, dtype=K.dtype, device=K.device)
        shift[0, 2], shift[1, 2] = self._pad[0], self._pad[2]
        return outs, K + shift

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        ht, wd = x.shape[-3], x.shape[-2]
        return x[..., self._pad[2]:ht - self._pad[3], self._pad[0]:wd - self._pad[1], :]


def store_pyramid(levels, mode: str):
    """The pyramid as the precision ``mode`` stores it (see ``precision``)."""
    return tuple(precision.round_operand(lvl, mode).contiguous() for lvl in levels)
