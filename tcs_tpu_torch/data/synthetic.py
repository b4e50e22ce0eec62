"""Synthetic stereo-video dataset for end-to-end tests and demos (the port's
own copy of ``tcs_tpu/data/synthetic.py``; numpy only).

Generates fronto-parallel textured scenes with exact disparity ground truth
that are **geometrically consistent across time**: each clip has ONE static
wide texture (a plane at depth Z), and every frame is rendered by sliding a
window across it according to the camera's x-translation — so the carried
temporal state (warped previous disparity + features) genuinely predicts the
next frame, and carried-state-vs-reset comparisons are meaningful
(exercises the paper's central claim; reference warp path
``core/utils/geo_utils.py:158-198``).

Rendering model: a plane at depth Z = baseline·fx/d gives constant disparity
d (the right view is the left view shifted by d pixels). A camera translating
by δ along +x between frames shifts the image content LEFT by
u = fx·δ/Z pixels; with world→cam poses this is T_t[0,3] = −δ·t. Frames are
windows of the shared texture at origin s_t = round(u)·t (left) and s_t + d
(right). The reference has no equivalent.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _make_texture(rng: np.random.Generator, H: int, W: int) -> np.ndarray:
    """Smooth low-frequency texture + high-frequency detail, (H, W, 3)."""
    low = rng.uniform(0, 255, size=(H // 8 + 2, W // 8 + 2, 3))
    ys = np.linspace(0, low.shape[0] - 1.001, H)
    xs = np.linspace(0, low.shape[1] - 1.001, W)
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    tex = (
        low[y0][:, x0] * (1 - fy) * (1 - fx)
        + low[y0][:, x0 + 1] * (1 - fy) * fx
        + low[y0 + 1][:, x0] * fy * (1 - fx)
        + low[y0 + 1][:, x0 + 1] * fy * fx
    )
    # high-frequency detail for unambiguous correspondence
    return 0.7 * tex + 0.3 * rng.uniform(0, 255, size=(H, W, 3))


def make_synthetic_frame(rng: np.random.Generator, H: int, W: int,
                         disparity: float):
    """One stereo pair with constant integer disparity and smooth texture."""
    d = int(round(disparity))
    tex = _make_texture(rng, H, W + d)
    left = tex[:, :W]
    right = tex[:, d : W + d]
    return (np.ascontiguousarray(left, np.float32),
            np.ascontiguousarray(right, np.float32))


class SyntheticStereoSequence:
    """Geometrically consistent constant-disparity clips under x-translating
    camera motion; ``load_sample`` returns one clip as a dict of numpy arrays
    with the fields of ``train.SequenceBatch``.

    ``shift_px`` is the per-frame image shift of the scene content in pixels
    (the camera translation is derived from it: δ = shift_px·Z/fx).
    """

    def __init__(self, n_samples: int = 16, frame_length: int = 2,
                 height: int = 64, width: int = 96, max_disp: float = 12.0,
                 baseline: float = 0.5, fx: float = 100.0,
                 shift_px: int = 4, layered_frac: float = 0.0):
        self.n_samples = n_samples
        self.frame_length = frame_length
        self.H, self.W = height, width
        self.max_disp = max_disp
        self.baseline = baseline
        self.fx = fx
        self.shift_px = int(shift_px)
        # fraction of clips rendered as TWO-plane scenes (foreground
        # rectangle at 2× the background disparity, correct per-layer
        # parallax + z-ordering). Spatially varying disparity makes
        # occlusion completion non-trivial — needed to evaluate the
        # temporal mechanism (a constant-d scene can be infilled from any
        # neighbourhood).
        self.layered_frac = float(layered_frac)

    def __len__(self):
        return self.n_samples

    def _pose(self, delta: float, t: int) -> np.ndarray:
        Tm = np.eye(4, dtype=np.float32)
        Tm[0, 3] = -delta * t  # world→cam: camera centre at +delta*t
        return Tm

    def load_sample(self, index: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        T, H, W = self.frame_length, self.H, self.W
        layered = rng.random() < self.layered_frac
        d_bg = int(rng.integers(2, int(self.max_disp) // 2 + 1))
        depth_bg = self.baseline * self.fx / d_bg
        s_bg = self.shift_px
        # camera translation per frame producing exactly s_bg px of image
        # motion at the background depth: u = fx·delta/Z
        delta = s_bg * depth_bg / self.fx
        tex = _make_texture(rng, H, W + d_bg + s_bg * (T - 1))

        lefts, rights, poses, flows = [], [], [], []
        if not layered:
            for t in range(T):
                s = s_bg * t
                lefts.append(np.ascontiguousarray(tex[:, s : s + W], np.float32))
                rights.append(np.ascontiguousarray(
                    tex[:, s + d_bg : s + d_bg + W], np.float32))
                poses.append(self._pose(delta, t))
                flows.append(-np.full((H, W, 1), float(d_bg), np.float32))
        else:
            # foreground plane at half the depth → 2× disparity and 2× the
            # image-space parallax (u_fg = fx·delta/Z_fg = 2·s_bg)
            d_fg = 2 * d_bg
            s_fg = 2 * s_bg
            rh = int(rng.integers(H // 3, H // 2))
            rw = int(rng.integers(W // 4, W // 3))
            ry = int(rng.integers(2, H - rh - 2))
            # keep the rect inside the frame for all t in BOTH views
            rx0 = int(rng.integers(d_fg + s_fg * (T - 1) + 2,
                                   max(W - rw - 2, d_fg + s_fg * (T - 1) + 3)))
            fg_tex = _make_texture(rng, rh, rw)
            for t in range(T):
                s = s_bg * t
                # absolute image-coord fg position: shifts left s_fg px/frame
                rx = rx0 - s_fg * t
                left = np.array(tex[:, s : s + W], np.float32)
                right = np.array(tex[:, s + d_bg : s + d_bg + W], np.float32)
                disp = np.full((H, W), float(d_bg), np.float32)
                left[ry : ry + rh, rx : rx + rw] = fg_tex
                right[ry : ry + rh, rx - d_fg : rx - d_fg + rw] = fg_tex
                disp[ry : ry + rh, rx : rx + rw] = float(d_fg)
                lefts.append(left)
                rights.append(right)
                poses.append(self._pose(delta, t))
                flows.append(-disp[..., None])

        flow = np.stack(flows)
        valid = np.ones((T, H, W, 1), np.float32)
        K = np.array([[self.fx, 0, W / 2], [0, self.fx, H / 2], [0, 0, 1]],
                     np.float32)
        return {
            "image1": np.stack(lefts),
            "image2": np.stack(rights),
            "flow": flow,
            "valid": valid,
            "T": np.stack(poses),
            "K": K,
            "baseline": np.float32(self.baseline),
        }


def make_clips(batch: int, height: int, width: int, frames: int, seed: int,
               generic_pose: bool = False):
    """``batch`` clips sized to the image, half of them two-plane scenes: a
    list of ``load_sample`` dicts, ready for ``train.SequenceBatch.from_numpy``.
    Clip ``i`` is drawn from ``default_rng(seed + i)``.

    The dataset's camera slides along x by whole pixels, which puts the
    warp's splat targets on integers, where the coverage mask hangs on the
    last bit of the projection. A comparison of two implementations or two
    devices needs a generic pose: ``generic_pose`` also moves frame t along
    y and z (the ground truth stays that of the x-slide).
    """
    ds = SyntheticStereoSequence(frame_length=frames, height=height, width=width,
                                 max_disp=min(64.0, width / 8), fx=width / 2.0,
                                 shift_px=max(4, width // 90), layered_frac=0.5)
    clips = [ds.load_sample(i, np.random.default_rng(seed + i)) for i in range(batch)]
    if generic_pose:
        for c in clips:
            for t in range(frames):
                c["T"][t, 1, 3] += 0.07 * t
                c["T"][t, 2, 3] += 0.3 * t
    return clips
