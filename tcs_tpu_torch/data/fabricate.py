"""Dataset trees in the datasets' layouts, rendered from synthetic scenes.

Writes the files that :mod:`tcs_tpu_torch.data.datasets` indexes, through
the port's own writers, so that the evaluators and the trainer can run where
the real datasets are absent. Every PNG is written with Paeth-filtered rows,
as encoders write photographs, so reading one costs what a real file costs.
The evaluators' trees:

- :func:`tartanair_tree`: ``TartanAir/<scene>/<scene>/<Easy|Hard>/<P…>/`` with
  ``image_left``, ``image_right``, ``depth_left`` (``.npy``) and
  ``pose_left.txt``;
- :func:`things_tree`: ``FlyingThings3D/{frames_cleanpass,disparity,pose}/
  TEST/<letter>/<scene>/`` with ``.pfm`` disparity and ``camera_data.txt``;
- :func:`kitti_tree`: ``KITTI/kitti_seq/kitti2015_testings/sequences/
  <scene>/`` with ``image_2``, ``image_3``, ``orbslam3_pose.txt`` and the
  ``P_rect_02`` calibration file.

The trainer's trees, at the datasets' frame sizes by default:

- :func:`sceneflow_train_tree`: FlyingThings3D TRAIN, Monkaa and Driving
  (one scene of it under ``15mm_focallength``), clean and final passes, with
  ``.pfm`` disparity and ``camera_data.txt``;
- :func:`tartanair_train_tree`: TartanAir videos outside the held-out ones;
- :func:`falling_things_tree`: ``FallingThings/fat/<scene>/`` with
  ``<n>.left.jpg`` and ``<n>.right.jpg`` (the port's JPEG encoder, quality
  95), ``<n>.left.depth.png`` (uint16, 0.1 mm) and ``_camera_settings.json``,
  listed in ``filenames.txt``: a single-pair dataset, 960×540 by default;
- :func:`kitti_raw_tree`: ``kitti_raw/<date>/`` with its three calibration
  files and ``<date>_drive_<n>_sync`` sequences of ``image_02``,
  ``image_03``, ``leastereo`` (uint16 disparity, none in the top quarter,
  as semi-dense pseudo-labels have none in the sky) and ``oxts`` packets,
  to which ``python -m tcs_tpu_torch.data.kitti_raw_pose`` adds the
  ``pose.txt`` files that the dataset reads, as on the real tree.

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
from tcs_tpu_torch.data.jpeg import encode_jpeg
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
            _write_png(os.path.join(base, "image_left", f"{i:06d}_left.png"), left[i])
            _write_png(os.path.join(base, "image_right", f"{i:06d}_right.png"), right[i])
            np.save(os.path.join(base, "depth_left", f"{i:06d}_left_depth.npy"),
                    (80.0 / disp[i]).astype(np.float32))
        # world→cam = NED_TO_CAM · [Rᵀ | −Rᵀt] with R = I: t = P⁻¹·(−T[:3, 3])
        ned = (-T[:, :3, 3]) @ frame_utils._NED_TO_CAM[:3, :3]
        with open(os.path.join(base, "pose_left.txt"), "w") as f:
            f.write(_lines([(*p, 0.0, 0.0, 0.0, 1.0) for p in ned]))


def _write_png(path, array) -> None:
    png.write_png(path, array, filter="paeth")


def _sceneflow_scene(root, rel, rng, frames, height, width, fx, passes,
                     unposed_trailing_frame=False) -> None:
    """One SceneFlow scene ``root/<pass>/<rel>``, its disparity and poses.
    The final pass is the clean one darkened, so that the two differ."""
    n = frames + unposed_trailing_frame
    left, right, disp, T = scene(rng, n, height, width, fx=fx, baseline=1.0)
    for p in passes:
        for side, frames_ in (("left", left), ("right", right)):
            if p == "frames_finalpass":
                frames_ = (frames_.astype(np.uint16) * 7 // 8 + 16).astype(np.uint8)
            os.makedirs(os.path.join(root, p, rel, side), exist_ok=True)
            for i in range(n):
                _write_png(os.path.join(root, p, rel, side, f"{i:04d}.png"), frames_[i])
    os.makedirs(os.path.join(root, "disparity", rel, "left"), exist_ok=True)
    for i in range(n):
        frame_utils.writePFM(os.path.join(root, "disparity", rel, "left", f"{i:04d}.pfm"),
                             disp[i])
    os.makedirs(os.path.join(root, "pose", rel), exist_ok=True)
    with open(os.path.join(root, "pose", rel, "camera_data.txt"), "w") as f:
        for i in range(frames):
            cam2world = np.linalg.inv(T[i]).reshape(-1)
            f.write(f"Frame {i}\n")
            f.write("L " + _lines([cam2world]))
            f.write("R " + _lines([cam2world]) + "\n")


def things_tree(root, scenes: Sequence[Tuple[str, str]] = (("A", "0000"),),
                frames: int = 10, height: int = 540, width: int = 960, seed: int = 0,
                unposed_trailing_frame: bool = False) -> None:
    """FlyingThings3D TEST scenes (letter, number). With
    ``unposed_trailing_frame`` each scene has one frame more than poses, as
    some real scenes do (the reader drops it)."""
    rng = np.random.default_rng(seed)
    for letter, number in scenes:
        _sceneflow_scene(os.path.join(root, "FlyingThings3D"), os.path.join("TEST", letter, number),
                         rng, frames, height, width, 1050.0, ("frames_cleanpass",),
                         unposed_trailing_frame)


def sceneflow_train_tree(root, frames: int = 6, height: int = 540, width: int = 960,
                         seed: int = 0) -> None:
    """One training scene each of FlyingThings3D (``TRAIN/A/0000``), Monkaa
    and Driving (``15mm_focallength/scene_forwards/fast``, fx 450; the others
    fx 1050), in both passes."""
    rng = np.random.default_rng(seed)
    passes = ("frames_cleanpass", "frames_finalpass")
    for sub, rel, fx in (("FlyingThings3D", os.path.join("TRAIN", "A", "0000"), 1050.0),
                         ("Monkaa", "a_rain_of_stones_x2", 1050.0),
                         ("Driving", os.path.join("15mm_focallength", "scene_forwards", "fast"),
                          450.0)):
        _sceneflow_scene(os.path.join(root, sub), rel, rng, frames, height, width, fx, passes)


def tartanair_train_tree(root, sequences: Sequence[Tuple[str, str, str]] = (
        ("abandonedfactory", "Easy", "P000"), ("carwelding", "Hard", "P001")),
        frames: int = 6, height: int = 480, width: int = 640, seed: int = 0) -> None:
    """TartanAir training videos: (scene, difficulty, part) outside
    ``tartanair_test_keywords``."""
    tartanair_tree(root, sequences, frames, height, width, seed)


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
            _write_png(os.path.join(base, "image_2", f"{i:06d}.png"), left[i])
            _write_png(os.path.join(base, "image_3", f"{i:06d}.png"), right[i])
        with open(os.path.join(base, "orbslam3_pose.txt"), "w") as f:
            f.write(_lines([np.linalg.inv(t)[:3].reshape(-1) for t in T]))
        with open(os.path.join(base, name + ".txt"), "w") as f:
            f.write("P_rect_02: " + " ".join(f"{v:.9g}" for v in p) + "\n")


FALLING_THINGS_FX = 768.1605  # its cameras' focal length, px; the baseline is 6 cm


def falling_things_tree(root, scenes: Sequence[str] = (
        "single/002_master_chef_can_16k/kitchen_0", "mixed/kitchen_1"),
        frames: int = 2, height: int = 540, width: int = 960, seed: int = 0) -> None:
    """``root/FallingThings``: ``frames`` stereo pairs in each of ``scenes``,
    each pair a frame of a two-plane sequence, the depth PNG in FallingThings'
    unit (0.1 mm: ``readDispFallingThings`` takes disparity = fx · 6 · 100 /
    depth)."""
    rng = np.random.default_rng(seed)
    base_dir = os.path.join(root, "FallingThings")
    names = []
    for name in scenes:
        d = os.path.join(base_dir, "fat", name)
        os.makedirs(d, exist_ok=True)
        left, right, disp, _ = scene(rng, frames, height, width, fx=FALLING_THINGS_FX,
                                     baseline=0.06)
        for i in range(frames):
            stem = os.path.join(d, f"{i:06d}")
            for side, img in (("left", left[i]), ("right", right[i])):
                with open(f"{stem}.{side}.jpg", "wb") as f:
                    f.write(encode_jpeg(img, 95))
            depth = np.round(FALLING_THINGS_FX * 6.0 * 100 / disp[i])
            _write_png(f"{stem}.left.depth.png", np.clip(depth, 1, 65535).astype(np.uint16))
            names.append(f"fat/{name}/{i:06d}.left.jpg")
        with open(os.path.join(d, "_camera_settings.json"), "w") as f:
            f.write('{"camera_settings": [{"name": "left", "intrinsic_settings": '
                    f'{{"fx": {FALLING_THINGS_FX}, "fy": {FALLING_THINGS_FX}, '
                    f'"cx": {width / 2}, "cy": {height / 2}}}}}]}}\n')
    with open(os.path.join(base_dir, "filenames.txt"), "w") as f:
        f.write("\n".join(names) + "\n")


def _oxts(rng, frames: int) -> np.ndarray:
    """OXTS packets (30 values: lat, lon, alt, roll, pitch, yaw, velocities,
    accelerations, rates, accuracies and modes) of a car driving about 1 m a
    frame near Karlsruhe, with a little roll, pitch and yaw."""
    t = np.arange(frames)[:, None]
    packets = np.zeros((frames, 30))
    packets[:, :6] = (np.array([49.011, 8.4233, 112.8, 0.02, 0.01, 0.6])
                      + t * np.array([9e-6 * np.cos(0.6), 9e-6 * np.sin(0.6), 0.01, 0, 0, 0])
                      + rng.normal(scale=[0, 0, 0.005, 0.002, 0.002, 0.002], size=(frames, 6)))
    packets[:, 23:] = (0.35, 0.06, 4, 10, 4, 4, 4)
    return packets


def kitti_raw_tree(root, drives: Sequence[str] = ("0001", "0002"), date: str = "2011_09_26",
                   frames: int = 6, height: int = 375, width: int = 1242, seed: int = 0) -> None:
    """``root/kitti_raw/<date>/`` with one ``<date>_drive_<n>_sync`` sequence
    per drive, without the ``pose.txt`` files (the pose tool writes them)."""
    rng = np.random.default_rng(seed)
    day = os.path.join(root, "kitti_raw", date)
    os.makedirs(day, exist_ok=True)
    p = list(KITTI_P_RECT_02)
    if width != 1242 or height != 375:
        p[2], p[6] = width / 2.0, height / 2.0
    num = lambda v: " ".join(f"{x:.9g}" for x in v)  # noqa: E731
    with open(os.path.join(day, "calib_cam_to_cam.txt"), "w") as f:
        f.write("calib_time: 09-Jan-2012 13:57:47\n")
        f.write(f"R_rect_00: {num(np.eye(3).ravel())}\nP_rect_02: {num(p)}\n")
    with open(os.path.join(day, "calib_imu_to_velo.txt"), "w") as f:
        f.write(f"R: {num(np.eye(3).ravel())}\nT: -0.8086759 0.3195559 -0.7997231\n")
    with open(os.path.join(day, "calib_velo_to_cam.txt"), "w") as f:
        velo_to_cam = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], float)
        f.write(f"R: {num(velo_to_cam.ravel())}\nT: -0.004069766 -0.07631618 -0.2717806\n")
    for drive in drives:
        seq = os.path.join(day, f"{date}_drive_{drive}_sync")
        for d in ("image_02/data", "image_03/data", "leastereo/data", "oxts/data"):
            os.makedirs(os.path.join(seq, d), exist_ok=True)
        left, right, disp, _ = scene(rng, frames, height, width, fx=p[0], baseline=0.54)
        disp[:, : height // 4] = 0.0
        for i, packet in enumerate(_oxts(rng, frames)):
            name = f"{i:010d}"
            _write_png(os.path.join(seq, "image_02/data", name + ".png"), left[i])
            _write_png(os.path.join(seq, "image_03/data", name + ".png"), right[i])
            _write_png(os.path.join(seq, "leastereo/data", name + ".png"),
                       (disp[i] * 256.0).astype(np.uint16))
            with open(os.path.join(seq, "oxts/data", name + ".txt"), "w") as f:
                f.write(num(packet) + "\n")
