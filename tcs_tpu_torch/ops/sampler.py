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
- ``upflow`` is ``factor × resize_bilinear`` to ``factor`` times the size.
- ``pool2x`` and ``pool4x`` are ``avg_pool2d(count_include_pad)`` with
  (window, stride, padding) (3, 2, 1) and (5, 4, 1).
- ``median_pool`` and ``median_filter`` take the lower median, as
  ``torch.median`` does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tcs_tpu_torch.utils import flops


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

    The positions are those of ``tcs_tpu``'s fp32 ``jnp.linspace(0, in − 1,
    out)`` (``tcs_tpu/ops/sampler.py:99-110``) as XLA compiles it: position
    i < out − 1 is i·c with c = (in − 1)·(1 / (out − 1)), each operation
    rounded to fp32 (XLA turns the division into a product by the
    reciprocal and folds the constants), and the last is in − 1; equal on
    every size pair tried. A position an ulp away changes where the weights
    of an all-valid footprint sum to exactly 1, which the losses' ``== 1.0``
    masks of sparse ground truth read.
    """
    if out_size == 1 or in_size == 1:
        pos = torch.zeros(out_size, device=device)
    else:
        c = float(np.float32(in_size - 1) * (np.float32(1.0) / np.float32(out_size - 1)))
        pos = torch.arange(out_size, dtype=torch.float32, device=device) * c
        pos[-1] = in_size - 1
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


def upflow(flow: torch.Tensor, factor: int) -> torch.Tensor:
    """``upflow8`` for any factor (reference ``core/utils/utils.py:106``):
    (B, H, W, C) resized bilinearly, align corners, to (factor·H, factor·W)
    and its values multiplied by ``factor``."""
    H, W = flow.shape[1:3]
    return factor * resize_bilinear(flow, (factor * H, factor * W))


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
    """avg_pool2d(3, stride 2, padding 1) of (B, C, H, W).

    The input is made NCHW-contiguous first. The hidden states reach this
    function as NCHW views of channel-last memory, and on that layout the
    CUDA backward of a padded ``avg_pool2d`` returned gradients that were off
    by 0.9 of their largest entry (torch 2.11.0+cu128; the forward, the CPU
    and the contiguous layout are right).
    """
    return F.avg_pool2d(x.contiguous(), 3, stride=2, padding=1, count_include_pad=True)


def pool2x(x: torch.Tensor) -> torch.Tensor:
    """``core/update.py:114``: avg_pool2d(x, 3, stride=2, padding=1) on NHWC."""
    return to_nhwc(pool2x_nchw(to_nchw(x)))


def pool4x_nchw(x: torch.Tensor) -> torch.Tensor:
    """avg_pool2d(5, stride 4, padding 1) of (B, C, H, W), through an
    NCHW-contiguous copy for the reason :func:`pool2x_nchw` gives."""
    return F.avg_pool2d(x.contiguous(), 5, stride=4, padding=1, count_include_pad=True)


def pool4x(x: torch.Tensor) -> torch.Tensor:
    """``core/update.py:118``: avg_pool2d(x, 5, stride=4, padding=1) on NHWC."""
    return to_nhwc(pool4x_nchw(to_nchw(x)))


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    """``F.max_pool2d`` on NHWC (padding counts as −inf)."""
    return to_nhwc(F.max_pool2d(to_nchw(x), window, stride, padding))


def median_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping k×k lower-median pooling of (B, H, W, C): the element
    at sorted index (k·k − 1)//2 of each window, which is what
    ``torch.median`` returns (reference ``core/utils/utils.py:121``)."""
    B, H, W, C = x.shape
    if H % k or W % k:
        raise ValueError(f"median_pool: {H}x{W} is not a multiple of {k}")
    win = x.reshape(B, H // k, k, W // k, k, C).permute(0, 1, 3, 5, 2, 4)
    return win.reshape(B, H // k, W // k, C, k * k).median(dim=-1).values


def median_filter(x: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Overlapping k×k lower-median filter of (B, H, W, C), stride 1: the
    element at sorted index (k·k − 1)//2 of each window, reflect padding
    (k//2 before, k − 1 − k//2 after, so an even ``k`` pads one more row and
    column before than after); the general ``MedianPool2d(k, 1, same=True)``
    (reference ``core/utils/utils.py:121``).

    A window that holds a NaN gives NaN, as in ``tcs_tpu``: ``torch.median``
    returns NaN for it, and ``tcs_tpu``'s min/max network passes a NaN on to
    every wire it meets, and each output's wires meet every input's.
    """
    B, H, W, C = x.shape
    p = k // 2
    xp = F.pad(to_nchw(x), (p, k - 1 - p, p, k - 1 - p), mode="reflect")
    taps = xp.unfold(2, k, 1).unfold(3, k, 1)  # (B, C, H, W, k, k)
    return to_nhwc(taps.reshape(B, C, H, W, k * k).median(dim=-1).values)


@flops.counted("convex_upsample",
               lambda field, mask_logits, factor: 9 * factor * factor * field.numel(),
               lambda field, mask_logits, factor: (field, mask_logits))
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
