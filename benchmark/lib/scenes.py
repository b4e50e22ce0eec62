"""Seeded synthetic stereo video, the benchmark's frozen copy of
``tcs_tpu_torch/data/synthetic.py`` (``make_clips`` with ``generic_pose``),
with the intrinsics given by the configuration.

A clip is a wide texture (smooth low-frequency colour plus high-frequency
detail) seen by a camera that slides along x by whole pixels a frame, half
of the clips with a foreground rectangle at twice the background disparity.
The generic pose also moves frame t along y and z, so that the warp's splat
targets do not sit on whole pixels (where coverage hangs on the last bit).
Clip i is drawn from ``numpy.random.default_rng(seed + i)``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _texture(rng: np.random.Generator, H: int, W: int) -> np.ndarray:
    low = rng.uniform(0, 255, size=(H // 8 + 2, W // 8 + 2, 3))
    ys = np.linspace(0, low.shape[0] - 1.001, H)
    xs = np.linspace(0, low.shape[1] - 1.001, W)
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    tex = (low[y0][:, x0] * (1 - fy) * (1 - fx) + low[y0][:, x0 + 1] * (1 - fy) * fx
           + low[y0 + 1][:, x0] * fy * (1 - fx) + low[y0 + 1][:, x0 + 1] * fy * fx)
    return 0.7 * tex + 0.3 * rng.uniform(0, 255, size=(H, W, 3))


def _pose(delta: float, t: int) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -delta * t
    return T


def clip(rng: np.random.Generator, frames: int, H: int, W: int, K: np.ndarray,
         baseline: float) -> Dict[str, np.ndarray]:
    """One clip: image1/image2 (T,H,W,3) float32 in [0, 255], flow (T,H,W,1)
    = −disparity, valid (T,H,W,1), T (T,4,4) world→camera, K, baseline."""
    fx = float(K[0, 0])
    max_disp = min(64.0, W / 8)
    s_bg = max(4, W // 90)
    layered = rng.random() < 0.5
    d_bg = int(rng.integers(2, int(max_disp) // 2 + 1))
    delta = s_bg * (baseline * fx / d_bg) / fx
    tex = _texture(rng, H, W + d_bg + s_bg * (frames - 1))
    lefts, rights, poses, flows = [], [], [], []
    if layered:
        d_fg, s_fg = 2 * d_bg, 2 * s_bg
        rh = int(rng.integers(H // 3, H // 2))
        rw = int(rng.integers(W // 4, W // 3))
        ry = int(rng.integers(2, H - rh - 2))
        rx0 = int(rng.integers(d_fg + s_fg * (frames - 1) + 2,
                               max(W - rw - 2, d_fg + s_fg * (frames - 1) + 3)))
        fg_tex = _texture(rng, rh, rw)
    for t in range(frames):
        s = s_bg * t
        left = np.array(tex[:, s:s + W], np.float32)
        right = np.array(tex[:, s + d_bg:s + d_bg + W], np.float32)
        disp = np.full((H, W), float(d_bg), np.float32)
        if layered:
            rx = rx0 - s_fg * t
            left[ry:ry + rh, rx:rx + rw] = fg_tex
            right[ry:ry + rh, rx - d_fg:rx - d_fg + rw] = fg_tex
            disp[ry:ry + rh, rx:rx + rw] = float(d_fg)
        lefts.append(left)
        rights.append(right)
        pose = _pose(delta, t)
        pose[1, 3] += 0.07 * t
        pose[2, 3] += 0.3 * t
        poses.append(pose)
        flows.append(-disp[..., None])
    return {"image1": np.stack(lefts), "image2": np.stack(rights), "flow": np.stack(flows),
            "valid": np.ones((frames, H, W, 1), np.float32), "T": np.stack(poses),
            "K": np.asarray(K, np.float32), "baseline": np.float32(baseline)}


def clips(count: int, frames: int, H: int, W: int, K, baseline: float, seed: int
          ) -> List[Dict[str, np.ndarray]]:
    return [clip(np.random.default_rng(seed + i), frames, H, W, np.asarray(K, np.float32),
                 baseline) for i in range(count)]


def principal_k(fx: float, H: int, W: int) -> np.ndarray:
    """K with the principal point at the image centre."""
    return np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]], np.float32)
