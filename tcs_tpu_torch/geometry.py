"""Pinhole geometry and pose-based temporal warping (port of ``tcs_tpu/geometry.py``).

Maps are NHWC (B, H, W, C); intrinsics (B, 3, 3); poses world→camera
(B, 4, 4); baselines (B,). All of it runs in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tcs_tpu_torch.ops.sampler import to_nchw, to_nhwc
from tcs_tpu_torch.ops.splat import softsplat

# 8-neighbour offsets in the reference's kernel order (v, u) relative to the
# 3x3 window; reference geo_utils.py:83.
_NEIGHBOUR_VUS = ((0, 0), (0, 1), (0, 2), (1, 2), (2, 2), (2, 1), (2, 0), (1, 0))


def cal_relative_transformation(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    """Camera-1 → camera-2 transform T2 @ inv(T1) (reference geo_utils.py:148)."""
    return torch.matmul(T2, torch.linalg.inv(T1))


def scale_intrinsics(K: torch.Tensor, scale: float) -> torch.Tensor:
    """Scale the fx, fy, cx, cy rows of K by ``scale``."""
    s = torch.tensor([scale, scale, 1.0], dtype=K.dtype, device=K.device)
    return K * s.reshape(1, 3, 1)


def disp2disp_gradient_xy(disp: torch.Tensor):
    """Forward-difference (gx, gy) with replicate padding.

    disp (B, H, W, 1) → grads (B, H, W, 2), edge_mask (B, H, W, 1).
    """
    H, W = disp.shape[1:3]
    dp = to_nhwc(F.pad(to_nchw(disp), (1, 1, 1, 1), mode="replicate"))
    center = dp[:, 1:1 + H, 1:1 + W]
    gx = dp[:, 1:1 + H, 2:2 + W] - center
    gy = dp[:, 2:2 + H, 1:1 + W] - center
    return torch.cat([gx, gy], dim=-1), (gx.abs() < 5) & (gy.abs() < 5)


def disp2disp_grad_candidates(disp: torch.Tensor, level: int = 2) -> torch.Tensor:
    """Plane-gradient candidates: disp (B,H,W,1) → (B,H,W, 8·level, 2).

    For each dilation and each of 8 directions, the (Δx, Δy, Δd) difference
    from centre to neighbour; consecutive-pair directions (roll −2) are
    crossed into plane normals n, and the candidate is −(nx, ny)/nz.
    """
    B, H, W, _ = disp.shape
    diffs = []
    for i in range(level):
        d = i + 1
        dp = F.pad(disp, (0, 0, d, d, d, d))
        centre = dp[:, d:d + H, d:d + W]
        for v, u in _NEIGHBOUR_VUS:
            dv, du = (v - 1) * d, (u - 1) * d
            nb = dp[:, d + dv:d + dv + H, d + du:d + du + W]
            diffs.append(torch.cat([torch.full_like(centre, float(du)),
                                    torch.full_like(centre, float(dv)),
                                    nb - centre], dim=-1))
    vecs = torch.stack(diffs, dim=3)  # (B,H,W, 8·level, 3)
    cross = torch.linalg.cross(vecs, torch.roll(vecs, shifts=-2, dims=3), dim=-1)
    return -cross[..., :2] / cross[..., 2:]


def _reproject_components(disp, relative_T, K_inv, baseline, fx,
                          clip_disp_min=None):
    """disp → depth → camera points → rigid transform, as (B,H,W) planes."""
    B, H, W, _ = disp.shape
    d = disp[..., 0]
    if clip_disp_min is not None:
        d = d.clamp(min=clip_disp_min)
    depth = (baseline * fx)[:, None, None] / d.clamp(min=0.001)
    yg, xg = torch.meshgrid(torch.arange(H, dtype=disp.dtype, device=disp.device),
                            torch.arange(W, dtype=disp.dtype, device=disp.device),
                            indexing="ij")

    def kv(M, i, j):
        return M[:, i, j][:, None, None]

    rx = kv(K_inv, 0, 0) * xg + kv(K_inv, 0, 1) * yg + kv(K_inv, 0, 2)
    ry = kv(K_inv, 1, 0) * xg + kv(K_inv, 1, 1) * yg + kv(K_inv, 1, 2)
    rz = kv(K_inv, 2, 0) * xg + kv(K_inv, 2, 1) * yg + kv(K_inv, 2, 2)
    X0, Y0, Z0 = depth * rx, depth * ry, depth * rz
    T = relative_T
    X = kv(T, 0, 0) * X0 + kv(T, 0, 1) * Y0 + kv(T, 0, 2) * Z0 + kv(T, 0, 3)
    Y = kv(T, 1, 0) * X0 + kv(T, 1, 1) * Y0 + kv(T, 1, 2) * Z0 + kv(T, 1, 3)
    Z = kv(T, 2, 0) * X0 + kv(T, 2, 1) * Y0 + kv(T, 2, 2) * Z0 + kv(T, 2, 3)
    return X, Y, Z, xg, yg


def _finite_or_neg1(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.full_like(x, -1.0))


def _project_pixels(X, Y, Z, K):
    """(u, v) = (K·P)/Z, with non-finite values mapped to −1."""

    def kv(i, j):
        return K[:, i, j][:, None, None]

    u = (kv(0, 0) * X + kv(0, 1) * Y + kv(0, 2) * Z) / Z
    v = (kv(1, 0) * X + kv(1, 1) * Y + kv(1, 2) * Z) / Z
    return _finite_or_neg1(u), _finite_or_neg1(v)


@torch.no_grad()
def warp(disp: torch.Tensor, fmap: torch.Tensor, relative_T: torch.Tensor,
         K: torch.Tensor, K_inv: torch.Tensor, baseline: torch.Tensor):
    """Forward-warp the previous disparity and features into the current frame.

    disp → depth → 3D → rigid transform → reproject, then one softmax splat of
    the 1+C channel payload [disp, fmap] along the induced flow with metric
    clip(disp − mean, ±50). Outputs are gradient-free, as in the reference
    (geo_utils.py:158). Returns (disp (B,H,W,1), fmap (B,H,W,C), mask (B,H,W,1)).
    """
    W = disp.shape[2]
    fx = K[:, 0, 0]
    X, Y, Z, xg, yg = _reproject_components(disp, relative_T, K_inv, baseline, fx)
    cur_disp = _finite_or_neg1((baseline * fx)[:, None, None, None] / Z[..., None])
    valid = ((cur_disp > 0) & (cur_disp < W)).to(disp.dtype)
    u, v = _project_pixels(X, Y, Z, K)
    forward_flow = torch.stack([u - xg, v - yg], dim=-1)
    metric = (cur_disp - cur_disp.mean(dim=(1, 2, 3), keepdim=True)).clamp(-50.0, 50.0)
    splatted, mask = softsplat(torch.cat([cur_disp, fmap], dim=-1), forward_flow,
                               metric, valid_mask=valid)
    return splatted[..., :1], splatted[..., 1:], mask


def get_backward_grid(disp: torch.Tensor, relative_T: torch.Tensor,
                      K: torch.Tensor, K_inv: torch.Tensor,
                      baseline: torch.Tensor) -> torch.Tensor:
    """Pixel grid mapping current-frame pixels into the previous frame.

    disp (B,H,W,1) is clipped ≥ 0.01; pixels behind the camera (Z ≤ 0) map to
    −1. Returns (B,H,W,2).
    """
    X, Y, Z, _, _ = _reproject_components(disp, relative_T, K_inv, baseline,
                                          K[:, 0, 0], clip_disp_min=0.01)
    u, v = _project_pixels(X, Y, Z, K)
    valid = Z > 0
    neg1 = torch.full_like(u, -1.0)
    return torch.stack([torch.where(valid, u, neg1),
                        torch.where(valid, v, neg1)], dim=-1)
