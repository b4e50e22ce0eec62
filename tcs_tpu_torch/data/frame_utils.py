"""File readers and writers and pose parsers (the port's copy of
``tcs_tpu/data/frame_utils.py``; reference ``core/utils/frame_utils.py``).

numpy only: PNG goes through :mod:`tcs_tpu_torch.data.png`, not PIL or a
native decoder. Disparity readers return ``(disp, valid)`` where the format
carries a validity channel; pose parsers return lists of world→camera
(4, 4) float64 matrices.
"""

from __future__ import annotations

import json
import os
import re
from os.path import basename, splitext

import numpy as np

from tcs_tpu_torch.data import png


def read_image(path) -> np.ndarray:
    """RGB uint8 (H, W, 3). 16-bit files keep their high byte, gray (and
    gray+alpha) files are tiled to 3 channels, an alpha channel is dropped."""
    ext = splitext(str(path))[-1].lower()
    if ext in (".jpg", ".jpeg"):
        raise NotImplementedError(
            f"{path}: the port reads PNG only; JPEG (FallingThings' frames, which"
            " no recipe reads) has no decoder in the port")
    if ext != ".png":
        raise ValueError(f"{path}: not an image format the port reads (PNG)")
    img = png.read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 3 and img.shape[2] == 2:
        img = img[..., 0]
    if img.ndim == 2:
        img = np.tile(img[..., None], (1, 1, 3))
    return img[..., :3]


def readPFM(path) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"Not a PFM file: {path}")
        dims = f.readline()
        m = re.match(rb"^(\d+)\s(\d+)\s$", dims)
        if not m:
            raise ValueError(f"Malformed PFM header: {path}")
        width, height = map(int, m.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).copy()


def writePFM(path, array: np.ndarray):
    assert splitext(path)[1] == ".pfm" and array.ndim == 2
    with open(path, "wb") as f:
        H, W = array.shape
        f.write(b"Pf\n" + f"{W} {H}\n".encode() + b"-1\n")
        f.write(np.flipud(array).astype("<f4").tobytes())


def read_uint16_png(path) -> np.ndarray:
    return png.read_png(path).astype(np.uint16)


def write_uint16_png(path, array: np.ndarray):
    png.write_png(path, np.asarray(array).astype(np.uint16))


def readDispKITTI(path):
    disp = read_uint16_png(path).astype(np.float32) / 256.0
    return disp, disp > 0.0


def writeDispKITTI(path, disp: np.ndarray):
    write_uint16_png(path, (disp * 256.0).astype(np.uint16))


def readDispSintelStereo(path):
    a = png.read_png(path).astype(np.float32)
    disp = a[..., 0] * 4 + a[..., 1] / (2 ** 6) + a[..., 2] / (2 ** 14)
    mask = png.read_png(path.replace("disparities", "occlusions"))
    return disp, (mask == 0) & (disp > 0)


def readDispFallingThings(path):
    a = png.read_png(path).astype(np.float32)
    with open(os.path.join(os.path.dirname(path), "_camera_settings.json")) as f:
        intrinsics = json.load(f)
    fx = intrinsics["camera_settings"][0]["intrinsic_settings"]["fx"]
    disp = (fx * 6.0 * 100) / a
    return disp, disp > 0


def readDispMiddlebury(path):
    if basename(path) == "disp0GT.pfm":
        disp = readPFM(path).astype(np.float32)
        nocc = png.read_png(path.replace("disp0GT.pfm", "mask0nocc.png"))
        return disp, nocc == 255
    disp = readPFM(path).astype(np.float32)
    return disp, disp < 1e3


def readDispTartanAir(path):
    depth = np.load(path)
    disp = 80.0 / (depth + 1e-5)
    return disp, disp > 0


def read_gen(path):
    """Generic reader by extension (reference :214)."""
    ext = splitext(path)[-1]
    if ext in (".png", ".jpeg", ".ppm", ".jpg"):
        return read_image(path)
    if ext in (".bin", ".raw", ".npy"):
        return np.load(path)
    if ext == ".pfm":
        x = readPFM(path).astype(np.float32)
        return x if x.ndim == 2 else x[..., :-1]
    raise ValueError(f"unknown extension: {path}")


# ---------------------------------------------------------------------------
# Pose parsers — all return lists of world→camera (4, 4) float64 matrices.
# ---------------------------------------------------------------------------

# NED (z-down) → camera (z-forward) axis correction, reference :248-255.
_NED_TO_CAM = np.array(
    [[0, 1, 0, 0], [0, 0, 1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float64
)


def _quat_to_matrix(qx, qy, qz, qw):
    """Unit-quaternion → rotation matrix (scipy-free)."""
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
    ])


def read_tartanair_extrinsic(path, side="left"):
    """TartanAir ``pose_left.txt``: tx ty tz qx qy qz qw per line (NED,
    cam→world) → world→cam with axis correction (reference :231-259)."""
    poses = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if len(vals) != 7:
                raise ValueError(f"pose line needs 7 values, got {len(vals)}")
            tx, ty, tz, qx, qy, qz, qw = vals
            R = _quat_to_matrix(qx, qy, qz, qw)
            T = np.eye(4)
            T[:3, :3] = R.T
            T[:3, 3] = -R.T @ np.array([tx, ty, tz])
            poses.append(_NED_TO_CAM @ T)
    return poses


def readsceneflow_pose(path):
    """SceneFlow ``camera_data.txt``: 'L <16 floats>' rows are left-camera
    cam→world; invert to world→cam (reference :262-271)."""
    poses = []
    with open(path) as f:
        for line in f:
            tokens = line.split()
            if tokens and tokens[0] == "L":
                pose = np.array([float(x) for x in tokens[1:]]).reshape(4, 4)
                poses.append(np.linalg.inv(pose))
    return poses


def read_kitti_extrinsic(path):
    """KITTI pose files: 12 floats per row (3×4 cam→world); invert
    (reference :274-284)."""
    poses = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if len(vals) != 12:
                raise ValueError(f"pose line needs 12 values, got {len(vals)}")
            T = np.vstack([np.array(vals).reshape(3, 4), [0, 0, 0, 1]])
            poses.append(np.linalg.inv(T))
    return poses


def read_calib_file(path):
    """KITTI calib file 'key: v0 v1 ...' → dict of float arrays
    (pykitti.utils.read_calib_file equivalent, no pykitti dependency)."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            try:
                out[key.strip()] = np.array(
                    [float(x) for x in vals.split()]
                )
            except ValueError:
                pass  # non-numeric entries (dates etc.)
    return out


def intrinsics_from_p_rect(p_rect: np.ndarray) -> np.ndarray:
    """K from a flattened 3×4 projection row (P_rect_02 layout)."""
    return np.array([
        [p_rect[0], 0.0, p_rect[2]],
        [0.0, p_rect[5], p_rect[6]],
        [0.0, 0.0, 1.0],
    ])
