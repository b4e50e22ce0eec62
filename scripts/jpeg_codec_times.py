#!/usr/bin/env python
"""The port's JPEG codec beside libjpeg-turbo, and its MJPG video beside
OpenCV's writer, on this machine's CPU.

Times ``tcs_tpu_torch.data.jpeg.read_jpeg`` against ``tcs_tpu``'s native
reader (libjpeg through ``native/tcs_io.cc``) and ``encode_jpeg`` against
PIL's encoder (libjpeg-turbo) on the same files: the frames of a
``fabricate.falling_things_tree`` at FallingThings' 960x540 (quality 95,
4:2:0), the same frames at quality 90 in progressive mode, and 540x960 noise
at quality 90, the hardest case. Each decode is held equal to the other's,
each encode's bytes to PIL's. Then five 76x124 frames through
``utils.video.MJPGWriter`` and through ``cv2.VideoWriter`` (fourcc MJPG, 2
fps), each file read back through ``cv2.VideoCapture``: the PSNR of each
against its frame, OpenCV's backend, and the first JPEG of OpenCV's file
(its comment and luma quantiser), which say which encoder OpenCV used.
Prints one line a case and a JSON record.
It imports PIL, OpenCV and ``tcs_tpu``, so it runs on a host that has
them; the GPU machine has no PIL, OpenCV or JAX, and there
``chip_smoke.py`` phase 12 times the port alone.

Usage: ``python scripts/jpeg_codec_times.py [--reps 5]``.
"""

from __future__ import annotations

import argparse
import glob
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def best_ms(fn, reps: int) -> float:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(out))


def main() -> None:
    from PIL import Image

    from tcs_tpu.data import native_io
    from tcs_tpu_torch.data import fabricate
    from tcs_tpu_torch.data.jpeg import encode_jpeg, read_jpeg

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    rows = []
    with tempfile.TemporaryDirectory() as root:
        fabricate.falling_things_tree(root, scenes=("mixed/kitchen_1",), frames=2)
        frames = [read_jpeg(p) for p in sorted(glob.glob(
            os.path.join(root, "FallingThings", "**", "*.jpg"), recursive=True))]
        noise = np.random.default_rng(0).integers(0, 256, (540, 960, 3), dtype=np.uint8)
        cases = [("falling_things q95 4:2:0", f, dict(quality=95), False) for f in frames[:2]]
        cases += [("falling_things q90 progressive", frames[0],
                   dict(quality=90, progressive=True), True),
                  ("noise q90 4:2:0", noise, dict(quality=90), False)]
        for k, (name, img, kw, progressive) in enumerate(cases):
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "JPEG", subsampling=2, **kw)
            path = os.path.join(root, f"case{k}.jpg")
            with open(path, "wb") as f:
                f.write(buf.getvalue())
            same = np.array_equal(read_jpeg(path), native_io.read_jpeg(path))
            row = {"case": name, "size": list(img.shape[:2]), "bytes": len(buf.getvalue()),
                   "decode_equal": same,
                   "port_decode_ms": best_ms(lambda: read_jpeg(path), args.reps),
                   "libjpeg_decode_ms": best_ms(lambda: native_io.read_jpeg(path), args.reps)}
            if not progressive:
                row["encode_bytes_equal"] = encode_jpeg(img, kw["quality"]) == buf.getvalue()
                row["port_encode_ms"] = best_ms(lambda: encode_jpeg(img, kw["quality"]),
                                                args.reps)
                row["pil_encode_ms"] = best_ms(lambda: Image.fromarray(img).save(
                    io.BytesIO(), "JPEG", subsampling=2, **kw), args.reps)
            print(row)
            rows.append(row)
        video = video_yardstick(root)
    print(video)
    print(json.dumps({"cpu": os.cpu_count(), "rows": rows, "video": video}))


def video_yardstick(root: str) -> dict:
    import cv2

    from tcs_tpu_torch.utils.video import MJPGWriter, read_avi

    h, w = 76, 124  # even: OpenCV's FFMPEG writer drops an odd last row
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:h, 0:w]
    clip = [np.clip(np.stack([128 + 100 * np.sin(x / 9 + k + c) * np.cos(y / 7)
                              for c in range(3)], -1) + rng.normal(0, 8, (h, w, 3)),
                    0, 255).astype(np.uint8) for k in range(5)]
    port, ocv = os.path.join(root, "port.avi"), os.path.join(root, "cv2.avi")
    with MJPGWriter(port, 2, (w, h)) as video:
        for f in clip:
            video.write(f)
    writer = cv2.VideoWriter(ocv, cv2.VideoWriter_fourcc(*"MJPG"), 2, (w, h))
    for f in clip:
        writer.write(np.ascontiguousarray(f[..., ::-1]))
    backend = writer.getBackendName()
    writer.release()

    def psnrs(path):
        cap, out = cv2.VideoCapture(path), []
        for f in clip:
            ok, bgr = cap.read()
            mse = np.mean((bgr[..., ::-1].astype(np.float64) - f) ** 2)
            out.append(float(10 * np.log10(255.0 ** 2 / mse)))
        return out

    first = read_avi(ocv).frames[0]
    com = first.find(b"\xff\xfe")
    dqt = first.find(b"\xff\xdb")
    return {"cv2": cv2.__version__, "backend": backend,
            "cv2_first_frame_comment": first[com + 4:com + 4 + int.from_bytes(
                first[com + 2:com + 4], "big") - 2].decode(errors="replace") if com >= 0 else None,
            "cv2_luma_quantiser_first8_zigzag": list(first[dqt + 5:dqt + 13]),
            "port_psnr_db": psnrs(port), "cv2_psnr_db": psnrs(ocv)}


if __name__ == "__main__":
    main()
