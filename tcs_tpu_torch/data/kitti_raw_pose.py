"""Per-frame camera poses of KITTI raw from its OXTS GPS/IMU packets (the
port's copy of ``tools/preprocess_kitti_raw_pose.py``; reference
``core/utils/preprocess_kitti_raw_pose.py``, which relies on
``pykitti.utils.load_oxts_packets_and_poses``).

For every ``*_sync`` sequence under each date directory of ``--root`` it
writes ``pose.txt``: one 3x4 row-major camera -> first-frame-camera transform
per frame, the format ``frame_utils.read_kitti_extrinsic`` reads and
``datasets.KITTIraw`` needs. The chain is the reference's:
``c2i = inv(v2c @ i2v)``; the rectifying rotation R_rect_00 is read and, as
in the reference, not applied. The calibration goes through the port's own
``frame_utils.read_calib_file``, so the tool needs numpy only.

Usage: python -m tcs_tpu_torch.data.kitti_raw_pose --root datasets/kitti_raw
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np

from tcs_tpu_torch.data.frame_utils import read_calib_file

EARTH_RADIUS = 6378137.0


def rot_from_rpy(roll, pitch, yaw):
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def oxts_to_pose(files):
    """pykitti ``load_oxts_packets_and_poses`` equivalent: mercator-projected
    translation (scale from the first packet's latitude, origin at the first
    frame) + roll/pitch/yaw rotation → T_w_imu per frame."""
    poses = []
    scale = None
    origin = None
    for path in files:
        vals = np.loadtxt(path)
        lat, lon, alt, roll, pitch, yaw = vals[:6]
        if scale is None:
            scale = np.cos(lat * np.pi / 180.0)
        tx = scale * lon * np.pi * EARTH_RADIUS / 180.0
        ty = scale * EARTH_RADIUS * np.log(np.tan((90.0 + lat) * np.pi / 360.0))
        tz = alt
        t = np.array([tx, ty, tz])
        if origin is None:
            origin = t
        T = np.eye(4)
        T[:3, :3] = rot_from_rpy(roll, pitch, yaw)
        T[:3, 3] = t - origin
        poses.append(T)
    return poses


def transform_from_rot_trans(R, T):
    out = np.eye(4)
    out[:3, :3] = np.asarray(R).reshape(3, 3)
    out[:3, 3] = np.asarray(T).reshape(3)
    return out


def process_scene(scene: str):
    c2c = read_calib_file(os.path.join(scene, "calib_cam_to_cam.txt"))
    _ = c2c.get("R_rect_00")  # read but unused, mirroring the reference
    i2v_c = read_calib_file(os.path.join(scene, "calib_imu_to_velo.txt"))
    i2v = transform_from_rot_trans(i2v_c["R"], i2v_c["T"])
    v2c_c = read_calib_file(os.path.join(scene, "calib_velo_to_cam.txt"))
    v2c = transform_from_rot_trans(v2c_c["R"], v2c_c["T"])
    c2i = np.linalg.inv(v2c @ i2v)

    for seq in sorted(glob(os.path.join(scene, "*_sync"))):
        frame_files = sorted(glob(os.path.join(seq, "oxts/data/*.txt")))
        if not frame_files:
            continue
        imu_poses = oxts_to_pose(frame_files)
        imupose_init_inv = None
        w2c_0 = None
        lines = []
        for T_w_imu in imu_poses:
            if imupose_init_inv is None:
                imupose_init_inv = np.linalg.inv(T_w_imu)
            i2w = imupose_init_inv @ T_w_imu
            c2w = i2w @ c2i
            if w2c_0 is None:
                w2c_0 = np.linalg.inv(c2w)
            pose = w2c_0 @ c2w  # camera → first-frame camera
            lines.append(" ".join(f"{v:.9f}" for v in pose[:3].flatten()))
        with open(os.path.join(seq, "pose.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"{seq}: {len(lines)} poses")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="datasets/kitti_raw")
    args = ap.parse_args(argv)
    for scene in sorted(glob(os.path.join(args.root, "*"))):
        if os.path.isdir(scene):
            process_scene(scene)


if __name__ == "__main__":
    main()
