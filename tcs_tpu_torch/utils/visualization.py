"""Visualization utilities (the port's copy of ``tcs_tpu/utils/visualization.py``;
reference ``core/utils/visualization.py``).

- KITTI-style disparity colormap (``disp_map:11`` / ``pseudoColorMap:75``)
- colored disparity-error map (``gen_error_colormap:131`` spec)
- PLY point-cloud export (``:181``)
All host-side numpy; images are written through
:mod:`tcs_tpu_torch.data.png`.
"""

from __future__ import annotations

import numpy as np

from tcs_tpu_torch.data import png

# KITTI devkit histogram colormap control points: (r, g, b, bin_width).
_KITTI_MAP = np.array([
    [0, 0, 0, 114],
    [0, 0, 1, 185],
    [1, 0, 0, 114],
    [1, 0, 1, 174],
    [0, 1, 0, 114],
    [0, 1, 1, 185],
    [1, 1, 0, 114],
    [1, 1, 1, 0],
], dtype=np.float64)


def kitti_disp_colormap(norm: np.ndarray) -> np.ndarray:
    """Map normalized disparity [0, 1] (H, W) → RGB float [0, 1] (H, W, 3)
    using the KITTI histogram colormap."""
    bins = _KITTI_MAP[:-1, 3]
    cbins = np.cumsum(bins) / bins.sum()  # upper edges, last == 1.0
    widths = bins / bins.sum()
    edges = np.concatenate([[0.0], cbins])  # lower edges per segment

    x = np.clip(norm, 0.0, 1.0)
    seg = np.sum(x[..., None] > cbins[:-1], axis=-1)  # segment index 0..6
    frac = (x - edges[seg]) / widths[seg]
    frac = np.clip(frac, 0.0, 1.0)[..., None]
    lo = _KITTI_MAP[seg, :3]
    hi = _KITTI_MAP[seg + 1, :3]
    return lo * (1 - frac) + hi * frac


def pseudo_color_map(arr: np.ndarray, vmin: float = 0.0, vmax: float = 96.0,
                     kitti_style: bool = True) -> np.ndarray:
    """(H, W) scalar field → uint8 RGB (H, W, 3)."""
    a = np.clip(np.asarray(arr, np.float64), vmin, vmax) / max(vmax, 1e-9)
    if kitti_style:
        rgb = kitti_disp_colormap(a)
    else:  # simple turbo-free fallback: grayscale→jet-ish 3-stop gradient
        rgb = np.stack([a, 1.0 - np.abs(2 * a - 1.0), 1.0 - a], axis=-1)
    return np.uint8(255 * rgb)


# Error-map spec from the KITTI devkit (reference gen_error_colormap:131):
# log-spaced |err| thresholds with fixed colors.
_ERROR_COLS = np.array([
    [0 / 3.0, 0.1875 / 3.0, 49, 54, 149],
    [0.1875 / 3.0, 0.375 / 3.0, 69, 117, 180],
    [0.375 / 3.0, 0.75 / 3.0, 116, 173, 209],
    [0.75 / 3.0, 1.5 / 3.0, 171, 217, 233],
    [1.5 / 3.0, 3 / 3.0, 224, 243, 248],
    [3 / 3.0, 6 / 3.0, 254, 224, 144],
    [6 / 3.0, 12 / 3.0, 253, 174, 97],
    [12 / 3.0, 24 / 3.0, 244, 109, 67],
    [24 / 3.0, 48 / 3.0, 215, 48, 39],
    [48 / 3.0, float("inf"), 165, 0, 38],
])


def error_colormap(disp_est: np.ndarray, disp_gt: np.ndarray,
                   valid: np.ndarray) -> np.ndarray:
    """Colored disparity-error visualization (uint8 RGB). The error measure is
    min(|err|/3, |err|/gt/0.05) as in the KITTI devkit."""
    err = np.abs(disp_est - disp_gt)
    rel = np.minimum(err / 3.0, err / np.maximum(np.abs(disp_gt), 1e-6) / 0.05)
    out = np.zeros((*disp_est.shape, 3), np.uint8)
    for lo, hi, r, g, b in _ERROR_COLS:
        m = (rel >= lo) & (rel < hi)
        out[m] = (r, g, b)
    out[~valid.astype(bool)] = 0
    return out


def export_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None):
    """Write an ASCII PLY point cloud. points (N, 3); colors uint8 (N, 3)."""
    n = points.shape[0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i, 0]} {points[i, 1]} {points[i, 2]}"
            if colors is not None:
                row += f" {int(colors[i, 0])} {int(colors[i, 1])} {int(colors[i, 2])}"
            f.write(row + "\n")


def disparity_panel(image: np.ndarray, disp_pred: np.ndarray,
                    disp_gt: np.ndarray | None = None,
                    vmax: float = 96.0) -> np.ndarray:
    """Stacked RGB panel (input | predicted colormap | GT | error) for image
    logging — the reference's ``logFeatureMap``/wandb image role
    (visualization.py:98-179). Returns uint8 (N*H, W, 3)."""
    rows = [np.asarray(image, np.uint8)]
    rows.append(pseudo_color_map(disp_pred, 0, vmax, kitti_style=True))
    if disp_gt is not None:
        rows.append(pseudo_color_map(disp_gt, 0, vmax, kitti_style=True))
        rows.append(error_colormap(disp_pred, disp_gt,
                                   np.abs(disp_gt) < 192))
    return np.concatenate(rows, axis=0)


def save_disparity_panel(path: str, image, disp_pred, disp_gt=None,
                         vmax: float = 96.0):
    png.write_png(path, disparity_panel(image, disp_pred, disp_gt, vmax))


def disparity_to_pointcloud(disp: np.ndarray, image: np.ndarray,
                            K: np.ndarray, baseline: float):
    """Back-project a disparity map into a colored point cloud
    (reference :181-207)."""
    H, W = disp.shape
    fx = K[0, 0]
    depth = baseline * fx / np.clip(disp, 1e-3, None)
    ys, xs = np.mgrid[0:H, 0:W]
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).reshape(-1, 3)
    rays = pix @ np.linalg.inv(K).T
    pts = rays * depth.reshape(-1, 1)
    cols = image.reshape(-1, 3).astype(np.uint8)
    good = (disp.reshape(-1) > 0) & np.isfinite(depth.reshape(-1))
    return pts[good], cols[good]
