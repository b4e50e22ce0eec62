"""Forward softmax splatting (port of ``tcs_tpu/ops/splat.py``).

``splat_sum`` is the bilinear forward scatter-add. On a CUDA tensor it
launches the hand-written ``csrc/softsplat.cu`` kernel (fp32 ``atomicAdd``);
on a CPU tensor it runs :func:`splat_sum_plain`, built on ``index_add_``.
Atomics add in an order that changes from run to run, so the two agree to a
tolerance, not bit for bit.
"""

from __future__ import annotations

import torch

from tcs_tpu_torch.ops import _kernels

_EPS = 1e-7
_TAPS = ((0, 0), (1, 0), (0, 1), (1, 1))


def splat_sum_plain(values: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear forward scatter-add of ``values`` along ``flow``.

    Each source pixel (x, y) adds ``values[b, y, x]`` to the four integer
    neighbours of (x + flow_x, y + flow_y) with weight
    (1 − |tx − xi|)(1 − |ty − yi|). Taps outside the image are dropped and
    non-finite targets skipped (reference kernel ``softsplat.py:301-302``).

    values: (B, H, W, C), flow: (B, H, W, 2) → (B, H, W, C).
    """
    B, H, W, C = values.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=values.dtype, device=values.device),
                            torch.arange(W, dtype=values.dtype, device=values.device),
                            indexing="ij")
    tx = xs + flow[..., 0]
    ty = ys + flow[..., 1]
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
        idx = (boff + yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long())
        idx = idx.reshape(-1)
        out.index_add_(0, idx[valid], (src * w.reshape(-1, 1))[valid])
    return out.reshape(B, H, W, C)


def splat_sum(values: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """:func:`splat_sum_plain`'s contract; the CUDA kernel on a CUDA tensor."""
    if values.device.type == "cpu" and flow.device.type == "cpu":
        return splat_sum_plain(values, flow)
    if values.device.type != "cuda" or flow.device != values.device:
        raise ValueError(f"splat_sum: values on {values.device}, flow on "
                         f"{flow.device}; both must be on one CUDA device or the CPU")
    if values.dtype != torch.float32 or flow.dtype != torch.float32:
        raise TypeError("splat_sum kernel takes fp32 values and flow")
    if values.dim() != 4 or flow.shape != (*values.shape[:3], 2):
        raise ValueError(f"splat_sum: values {tuple(values.shape)} and flow "
                         f"{tuple(flow.shape)} must be (B,H,W,C) and (B,H,W,2)")
    if not (values.is_contiguous() and flow.is_contiguous()):
        raise ValueError("splat_sum kernel takes contiguous tensors")
    B, H, W, C = values.shape
    out = torch.zeros_like(values)
    lib = _kernels.lib()
    with torch.cuda.device(values.device):
        err = lib.tcs_splat_sum(values.data_ptr(), flow.data_ptr(), out.data_ptr(),
                                B, H, W, C, torch.cuda.current_stream().cuda_stream)
    _kernels.check(err, "splat_sum")
    _kernels.launches["splat_sum"] += 1
    return out


def softsplat(values: torch.Tensor, flow: torch.Tensor, metric: torch.Tensor,
              valid_mask=None):
    """Softmax splatting, mode ``'soft-clipeps'`` (reference ``softsplat.py:232``).

    The only mode the model uses (reference ``geo_utils.py:196``). Splats
    ``[values·e^metric·valid, e^metric·valid]`` in one pass, divides by
    clip(weight, 1e-7) and returns (warped (B,H,W,C), mask (B,H,W,1)) with
    mask = (weight ≠ 0) taken before the clip.
    """
    if valid_mask is None:
        valid_mask = torch.ones_like(values[..., :1])
    values = values * valid_mask
    weight = torch.exp(metric)
    out = splat_sum(torch.cat([values * weight, weight * valid_mask], dim=-1)
                    .contiguous(), flow.contiguous())
    norm = out[..., -1:]
    mask = (norm != 0).to(values.dtype)
    return out[..., :-1] / norm.clamp(min=_EPS), mask
