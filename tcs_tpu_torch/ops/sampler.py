"""Sampling, pooling and resizing primitives (port of ``tcs_tpu/ops/sampler.py``).

Public functions keep the JAX package's NHWC layout so that they compare like
with like. The model keeps its conv activations NCHW (cuDNN's layout) and
calls the ``*_nchw`` cores directly; the NHWC functions are permutes around
the same cores.

Semantics (as in the JAX package and the reference):

- ``bilinear_sampler`` is ``grid_sample(align_corners=True, padding='zeros')``
  driven by pixel coordinates: a tap counts only while its index is in range.
- ``resize_bilinear`` matches ``F.interpolate(mode='bilinear', align_corners=True)``.
- ``resize_nearest`` takes source index ``floor(dst * in / out)``.
- ``pool2x`` is ``avg_pool2d(3, stride 2, padding 1, count_include_pad)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC → NCHW view (no copy for a 1-channel map)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW → NHWC view."""
    return x.permute(0, 2, 3, 1)


def coords_grid(batch: int, ht: int, wd: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """(B, H, W, 2) pixel-coordinate grid with channels (x, y)."""
    ys, xs = torch.meshgrid(torch.arange(ht, dtype=dtype, device=device),
                            torch.arange(wd, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)[None].expand(batch, ht, wd, 2)


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (B, H, W, C) at pixel coords (B, Ho, Wo, 2) → (B, Ho, Wo, C).

    Out-of-range taps contribute zero (reference ``core/utils/utils.py:82``).
    """
    B, H, W, C = img.shape
    Ho, Wo = coords.shape[1:3]
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1.0, y0 + 1.0
    flat = img.reshape(B, H * W, C)

    def tap(iy, ix, w):
        valid = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        lin = (iy.clamp(0, H - 1).long() * W + ix.clamp(0, W - 1).long())
        vals = torch.gather(flat, 1, lin.reshape(B, Ho * Wo, 1).expand(-1, -1, C))
        return vals.reshape(B, Ho, Wo, C) * (w * valid.to(img.dtype))[..., None]

    return (tap(y0, x0, (x1 - x) * (y1 - y)) + tap(y0, x1, (x - x0) * (y1 - y))
            + tap(y1, x0, (x1 - x) * (y - y0)) + tap(y1, x1, (x - x0) * (y - y0)))


def _linear_resize_weights(in_size: int, out_size: int, device):
    """align_corners=True source positions → (idx0, idx1, frac).

    Positions i·(in−1)/(out−1) are rounded once to fp32 from float64; the
    JAX package's fp32 ``linspace`` lands within an ulp of them.
    """
    if out_size == 1 or in_size == 1:
        pos = torch.zeros(out_size, device=device)
    else:
        pos = (torch.arange(out_size, dtype=torch.float64, device=device)
               * ((in_size - 1) / (out_size - 1))).float()
    i0 = torch.floor(pos).clamp(0, in_size - 1).long()
    i1 = (i0 + 1).clamp(max=in_size - 1)
    return i0, i1, pos - i0.float()


def resize_bilinear_nchw(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Separable bilinear resize of (B, C, H, W), align_corners=True."""
    H, W = x.shape[2:4]
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    if out_h != H:
        i0, i1, f = _linear_resize_weights(H, out_h, x.device)
        f = f.to(x.dtype)[:, None]
        x = x[:, :, i0] * (1.0 - f) + x[:, :, i1] * f
    if out_w != W:
        j0, j1, g = _linear_resize_weights(W, out_w, x.device)
        g = g.to(x.dtype)
        x = x[..., j0] * (1.0 - g) + x[..., j1] * g
    return x


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C), align_corners=True."""
    return to_nhwc(resize_bilinear_nchw(to_nchw(x), out_hw))


def resize_nearest_nchw(x: torch.Tensor, out_hw) -> torch.Tensor:
    H, W = x.shape[2:4]
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    iy = torch.floor(torch.arange(out_h, dtype=torch.float32, device=x.device)
                     * (H / out_h)).long()
    ix = torch.floor(torch.arange(out_w, dtype=torch.float32, device=x.device)
                     * (W / out_w)).long()
    return x[:, :, iy][:, :, :, ix]


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize of (B, H, W, C): source index floor(dst * in / out)."""
    return to_nhwc(resize_nearest_nchw(to_nchw(x), out_hw))


def pool2x_nchw(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)


def pool2x(x: torch.Tensor) -> torch.Tensor:
    """``core/update.py:114``: avg_pool2d(x, 3, stride=2, padding=1) on NHWC."""
    return to_nhwc(pool2x_nchw(to_nchw(x)))


def convex_upsample_nchw(field: torch.Tensor, mask_logits: torch.Tensor,
                         factor: int) -> torch.Tensor:
    """(B, D, H, W) field, (B, 9·f·f, H, W) logits → (B, D, f·H, f·W).

    Logit channel ``(k·f + fy)·f + fx`` weighs 3×3 tap k for sub-pixel
    (fy, fx); softmax over the 9 taps; field values are scaled by f.
    """
    B, D, H, W = field.shape
    f = factor
    m = torch.softmax(mask_logits.reshape(B, 1, 9, f, f, H, W), dim=2)
    nb = F.unfold(field * f, [3, 3], padding=1).reshape(B, D, 9, 1, 1, H, W)
    up = torch.sum(m * nb, dim=2)  # (B, D, f, f, H, W)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, D, f * H, f * W)


def convex_upsample(field: torch.Tensor, mask_logits: torch.Tensor,
                    factor: int) -> torch.Tensor:
    """RAFT convex upsampling on NHWC (reference ``tc_stereo.py:75-88``)."""
    return to_nhwc(convex_upsample_nchw(to_nchw(field), to_nchw(mask_logits), factor))
