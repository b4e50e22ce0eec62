"""Bytes the hand kernels must move, from shapes (the arithmetic of
``chip_smoke.py``'s ``_lookup_bytes`` and the splat's ``nbytes``, counted
from shapes alone): each input byte read once, each output byte written
once.

- lookup: the 2r+2 window taps of every level of every pixel's row, the
  fp32 coordinates, the fp32 output of L·(2r+1) a pixel. Taps that fall
  outside a row are counted as read: for coordinates spread over the row
  that overstates the pyramid's bytes by the edge share, under 7 % at the
  coarsest level of a 1/4-scale row of 80 or more cells.
- lookup backward: the fp32 cotangent and coordinates read, every level's
  gradient written whole (in the pyramid's dtype).
- splat: the fp32 payload (1 + 256 + 1 channels: disparity, features,
  weight) and flow read, the payload's sum written.
- splat backward: cotangent, payload and flow read, their gradients written.
"""

from __future__ import annotations

PAYLOAD_CHANNELS = 1 + 256 + 1


def per_launch(B: int, h: int, w: int, model: dict) -> dict:
    """Bytes of one launch of each hand kernel on a (B, h, w) grid."""
    L, r = model["corr_levels"], model["corr_radius"]
    e = 2 if model["corr_dtype"] == "bfloat16" else 4
    n = B * h * w
    widths = sum(w >> i for i in range(L))
    C = PAYLOAD_CHANNELS
    return {
        "corr_lookup": n * L * (2 * r + 2) * e + 4 * n + 4 * n * L * (2 * r + 1),
        "corr_lookup_bwd": 4 * n * L * (2 * r + 1) + 4 * n + n * widths * e,
        "splat_sum": 4 * n * C + 8 * n + 4 * n * C,
        "splat_sum_bwd": 3 * 4 * n * C + 2 * 8 * n,
    }


def total(launches: dict, B: int, h: int, w: int, model: dict) -> float:
    each = per_launch(B, h, w, model)
    return float(sum(each[k] * n for k, n in launches.items() if k in each))
