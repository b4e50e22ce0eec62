"""All-pairs 1D correlation volume, pyramid, bootstrap and lookup
(port of ``tcs_tpu/ops/corr.py`` and ``tcs_tpu/ops/pallas/corr_kernel.py``).

Layouts follow the JAX package: the cost volume is (B, H, W1, W2) with W2
innermost, every pyramid level (B, H, W1, W2 >> i) is row-contiguous, so the
lookup window of a pixel is one short contiguous read.

``lookup`` launches the hand-written ``csrc/corr_lookup.cu`` kernel on a CUDA
tensor and runs :func:`lookup_plain` on a CPU tensor. Both lerp in fp32 on
pyramids stored in fp32 or bf16, as ``lookup_pallas`` does.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from tcs_tpu_torch.ops import _kernels

MAX_LEVELS = 8
MAX_RADIUS = 8


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize``: x / max(‖x‖₂, eps)."""
    return x / torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True)).clamp(min=eps)


def build_cost_volume(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """Cosine cost: (B,H,W1,C), (B,H,W2,C) → (B,H,W1,W2) fp32 (reference corr.py:54-62)."""
    f1 = l2_normalize(fmap1.float())
    f2 = l2_normalize(fmap2.float())
    return torch.matmul(f1, f2.transpose(-1, -2))


def corr_pyramid(cost: torch.Tensor, num_levels: int) -> Tuple[torch.Tensor, ...]:
    """Average-pool pyramid along W2; odd widths floor-pool (180→90→45→22)."""
    levels = [cost]
    cur = cost
    for _ in range(num_levels - 1):
        half = cur.shape[-1] // 2
        cur = cur[..., :2 * half].reshape(*cur.shape[:-1], half, 2).mean(dim=-1)
        levels.append(cur)
    return tuple(levels)


def masked_cost_volume(cost: torch.Tensor) -> torch.Tensor:
    """Zero the cells with w2 > w1 (negative disparity)."""
    W1, W2 = cost.shape[-2:]
    keep = torch.ones(W1, W2, dtype=torch.bool, device=cost.device).tril()
    return cost * keep.to(cost.dtype)


def argmax_disp(cost_masked: torch.Tensor, margin: float = 0.3,
                suppress_radius: float = 1.5):
    """Semi-dense bootstrap (reference corr.py:67-79).

    Per pixel: the first-occurrence max-cost match, the runner-up outside the
    band j ∈ [idx − r, idx + r), and a keep mask where the margin over the
    runner-up exceeds ``margin``. Returns (sparse_disp, main_cost, mask), each
    (B, H, W1, 1).
    """
    W1, W2 = cost_masked.shape[-2:]
    main_cost, index = torch.max(cost_masked, dim=-1, keepdim=True)
    # torch.max does not promise the first of tied maxima; take it explicitly.
    j = torch.arange(W2, device=cost_masked.device)
    index = torch.where(cost_masked == main_cost, j, W2).amin(dim=-1, keepdim=True)
    jf = j.to(torch.float32)
    idxf = index.to(torch.float32)
    band = (jf >= idxf - suppress_radius) & (jf < idxf + suppress_radius)
    sub_cost = torch.where(band, torch.zeros_like(cost_masked), cost_masked
                           ).amax(dim=-1, keepdim=True)
    mask = (main_cost - sub_cost > margin).to(cost_masked.dtype)
    w1 = torch.arange(W1, device=cost_masked.device)[:, None]
    disp = (w1 - index).to(cost_masked.dtype)
    return disp * mask, main_cost * mask, mask


def lookup_plain(pyramid: Sequence[torch.Tensor], coords_x: torch.Tensor,
                 radius: int) -> torch.Tensor:
    """Radius-r bilinear lookup across the pyramid (semantics of
    ``lookup_gather`` / ``lookup_pallas``).

    Level i reads the 2r+2 integer taps T_k = corr_i[floor(c)+k],
    k ∈ [−r, r+1], with c = coords_x·2⁻ⁱ (zero outside [0, W2ᵢ−1]), casts
    them to fp32 and emits (1−frac)·T_t + frac·T_{t+1}.

    pyramid: (B,H,W1,W2>>i) fp32 or bf16; coords_x: (B,H,W1) fp32 →
    (B,H,W1, L·(2r+1)) fp32, level-major.
    """
    outs = []
    k = torch.arange(-radius, radius + 2, device=coords_x.device)
    for i, corr in enumerate(pyramid):
        W2 = corr.shape[-1]
        c = coords_x.float() / (2 ** i)
        base = torch.floor(c)
        frac = (c - base)[..., None]
        idx = base.long()[..., None] + k
        valid = (idx >= 0) & (idx <= W2 - 1)
        taps = torch.gather(corr, -1, idx.clamp(0, W2 - 1)).float() * valid
        outs.append((1.0 - frac) * taps[..., :-1] + frac * taps[..., 1:])
    return torch.cat(outs, dim=-1)


def lookup(pyramid: Sequence[torch.Tensor], coords_x: torch.Tensor,
           radius: int) -> torch.Tensor:
    """:func:`lookup_plain`'s contract; the CUDA kernel on CUDA tensors."""
    if coords_x.device.type == "cpu" and all(p.device.type == "cpu" for p in pyramid):
        return lookup_plain(pyramid, coords_x, radius)
    dev = coords_x.device
    L = len(pyramid)
    if dev.type != "cuda" or any(p.device != dev for p in pyramid):
        raise ValueError("lookup: the pyramid and coords must all be on one "
                         "CUDA device or all on the CPU")
    if not 1 <= L <= MAX_LEVELS or not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"lookup kernel takes 1..{MAX_LEVELS} levels and radius "
                         f"1..{MAX_RADIUS}, got {L} and {radius}")
    dt = pyramid[0].dtype
    if dt not in (torch.float32, torch.bfloat16) or coords_x.dtype != torch.float32:
        raise TypeError("lookup kernel takes an fp32 or bf16 pyramid and fp32 coords")
    B, H, W1, W2 = pyramid[0].shape
    if coords_x.shape != (B, H, W1):
        raise ValueError(f"coords {tuple(coords_x.shape)} != {(B, H, W1)}")
    for i, p in enumerate(pyramid):
        if p.dtype != dt or p.shape != (B, H, W1, W2 >> i):
            raise ValueError(f"level {i}: {p.dtype} {tuple(p.shape)}, expected "
                             f"{dt} {(B, H, W1, W2 >> i)}")
        if not p.is_contiguous():
            raise ValueError(f"level {i} is not contiguous")
    if not coords_x.is_contiguous():
        raise ValueError("coords_x is not contiguous")
    out = torch.empty(B, H, W1, L * (2 * radius + 1), dtype=torch.float32,
                      device=dev)
    ptrs = (ctypes.c_void_p * L)(*[p.data_ptr() for p in pyramid])
    lib = _kernels.lib()
    with torch.cuda.device(dev):
        err = lib.tcs_corr_lookup(ptrs, L, W2, coords_x.data_ptr(), out.data_ptr(),
                                  B * H * W1, radius, int(dt == torch.bfloat16),
                                  torch.cuda.current_stream().cuda_stream)
    _kernels.check(err, "corr_lookup")
    _kernels.launches["corr_lookup"] += 1
    return out
