"""Dataset trees in the evaluators' layouts, rendered from synthetic scenes.

Writes the files that :mod:`tcs_tpu_torch.data.datasets` indexes, through
the port's own writers, so that the evaluators can run where the real
datasets are absent:

- :func:`tartanair_tree`: ``TartanAir/<scene>/<scene>/<Easy|Hard>/<P…>/`` with
  ``image_left``, ``image_right``, ``depth_left`` (``.npy``) and
  ``pose_left.txt``;
- :func:`things_tree`: ``FlyingThings3D/{frames_cleanpass,disparity,pose}/
  TEST/<letter>/<scene>/`` with ``.pfm`` disparity and ``camera_data.txt``;
- :func:`kitti_tree`: ``KITTI/kitti_seq/kitti2015_testings/sequences/
  <scene>/`` with ``image_2``, ``image_3``, ``orbslam3_pose.txt`` and the
  ``P_rect_02`` calibration file.

Each sequence is a two-plane scene of :mod:`tcs_tpu_torch.data.synthetic`
seen by the dataset's own camera (intrinsics, baseline), so the ground truth
and the poses agree with the images: the camera slides along x by whole
pixels of image motion. It also moves a little along y and z (the ground
truth stays that of the slide), which keeps the warp's splat targets off
integer positions, where two implementations can round apart.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from tcs_tpu_torch.data import frame_utils, png
from tcs_tpu_torch.data.synthetic import SyntheticStereoSequence

KITTI_P_RECT_02 = (721.5377, 0.0, 609.5593, 44.85728, 0.0, 721.5377, 172.854,
                   0.2163791, 0.0, 0.0, 1.0, 0.002745884)


def scene(rng: np.random.Generator, frames: int, height: int, width: int,
          fx: float, baseline: float):
    """One sequence: left and right frames (T, H, W, 3) uint8, disparity
    (T, H, W) float32 and world→camera poses (T, 4, 4) float64."""
    ds = SyntheticStereoSequence(frame_length=frames, height=height, width=width,
                                 max_disp=min(64.0, width / 8), baseline=baseline,
                                 fx=fx, shift_px=max(2, width // 160), layered_frac=1.0)
    clip = ds.load_sample(0, rng)
    T = clip["T"].astype(np.float64)
    depth = baseline * fx / float(np.max(-clip["flow"]))  # the nearer plane
    t = np.arange(frames)
    T[:, 1, 3] += 0.004 * depth * t
    T[:, 2, 3] += 0.02 * depth * t
    to_u8 = lambda x: np.clip(np.round(x), 0, 255).astype(np.uint8)  # noqa: E731
    return to_u8(clip["image1"]), to_u8(clip["image2"]), -clip["flow"][..., 0], T


def _lines(rows) -> str:
    return "\n".join(" ".join(f"{v:.9g}" for v in r) for r in rows) + "\n"


def tartanair_tree(root, sequences: Sequence[Tuple[str, str, str]] = (
        ("gascola", "Easy", "P001"), ("hospital", "Hard", "P042")),
        frames: int = 6, height: int = 480, width: int = 640, seed: int = 0) -> None:
    """``sequences`` of (scene, difficulty, part); the defaults are two of
    the held-out ones (``tartanair_test_keywords``)."""
    rng = np.random.default_rng(seed)
    for name, difficulty, part in sequences:
        base = os.path.join(root, "TartanAir", name, name, difficulty, part)
        for d in ("image_left", "image_right", "depth_left"):
            os.makedirs(os.path.join(base, d), exist_ok=True)
        left, right, disp, T = scene(rng, frames, height, width, fx=320.0, baseline=0.25)
        for i in range(frames):
            png.write_png(os.path.join(base, "image_left", f"{i:06d}_left.png"), left[i])
            png.write_png(os.path.join(base, "image_right", f"{i:06d}_right.png"), right[i])
            np.save(os.path.join(base, "depth_left", f"{i:06d}_left_depth.npy"),
                    (80.0 / disp[i]).astype(np.float32))
        # world→cam = NED_TO_CAM · [Rᵀ | −Rᵀt] with R = I: t = P⁻¹·(−T[:3, 3])
        ned = (-T[:, :3, 3]) @ frame_utils._NED_TO_CAM[:3, :3]
        with open(os.path.join(base, "pose_left.txt"), "w") as f:
            f.write(_lines([(*p, 0.0, 0.0, 0.0, 1.0) for p in ned]))


def things_tree(root, scenes: Sequence[Tuple[str, str]] = (("A", "0000"),),
                frames: int = 10, height: int = 540, width: int = 960, seed: int = 0,
                unposed_trailing_frame: bool = False) -> None:
    """FlyingThings3D TEST scenes (letter, number). With
    ``unposed_trailing_frame`` each scene has one frame more than poses, as
    some real scenes do (the reader drops it)."""
    rng = np.random.default_rng(seed)
    ft = os.path.join(root, "FlyingThings3D")
    for letter, number in scenes:
        rel = os.path.join("TEST", letter, number)
        n = frames + unposed_trailing_frame
        left, right, disp, T = scene(rng, n, height, width, fx=1050.0, baseline=1.0)
        for sub in ("left", "right"):
            os.makedirs(os.path.join(ft, "frames_cleanpass", rel, sub), exist_ok=True)
        os.makedirs(os.path.join(ft, "disparity", rel, "left"), exist_ok=True)
        os.makedirs(os.path.join(ft, "pose", rel), exist_ok=True)
        for i in range(n):
            png.write_png(os.path.join(ft, "frames_cleanpass", rel, "left", f"{i:04d}.png"),
                          left[i])
            png.write_png(os.path.join(ft, "frames_cleanpass", rel, "right", f"{i:04d}.png"),
                          right[i])
            frame_utils.writePFM(os.path.join(ft, "disparity", rel, "left", f"{i:04d}.pfm"),
                                 disp[i])
        with open(os.path.join(ft, "pose", rel, "camera_data.txt"), "w") as f:
            for i in range(frames):
                cam2world = np.linalg.inv(T[i]).reshape(-1)
                f.write(f"Frame {i}\n")
                f.write("L " + _lines([cam2world]))
                f.write("R " + _lines([cam2world]) + "\n")


def kitti_tree(root, scenes: Sequence[str] = ("000000",), frames: int = 11,
               height: int = 375, width: int = 1242, seed: int = 0,
               image_set: str = "kitti_seq/kitti2015_testings") -> None:
    """KITTI 2015 submission sequences under ``root/KITTI``; the principal
    point is KITTI's, moved to the middle of a smaller image."""
    rng = np.random.default_rng(seed)
    p = list(KITTI_P_RECT_02)
    if width != 1242 or height != 375:
        p[2], p[6] = width / 2.0, height / 2.0
    for name in scenes:
        base = os.path.join(root, "KITTI", image_set, "sequences", name)
        for d in ("image_2", "image_3"):
            os.makedirs(os.path.join(base, d), exist_ok=True)
        left, right, _, T = scene(rng, frames, height, width, fx=p[0], baseline=0.54)
        for i in range(frames):
            png.write_png(os.path.join(base, "image_2", f"{i:06d}.png"), left[i])
            png.write_png(os.path.join(base, "image_3", f"{i:06d}.png"), right[i])
        with open(os.path.join(base, "orbslam3_pose.txt"), "w") as f:
            f.write(_lines([np.linalg.inv(t)[:3].reshape(-1) for t in T]))
        with open(os.path.join(base, name + ".txt"), "w") as f:
            f.write("P_rect_02: " + " ".join(f"{v:.9g}" for v in p) + "\n")
