#!/usr/bin/env python
"""Writes the JPEG fixtures of ``tests/fixtures/jpeg/`` and their digests.

Each ``.jpg`` fixture is a small file of one case of the port's JPEG
decoder, written with PIL (libjpeg-turbo) or, for 4:4:0, OpenCV:
progressive, 4:2:0 at an odd size, restart markers, gray, 4:4:0.
``digests.json`` holds, under ``decode``, the shape and the SHA-256 of
``tcs_tpu``'s decode of each (``tcs_tpu.data.frame_utils.read_image``,
libjpeg through ``native/tcs_io.cc``), and under ``encode``, for the RGB
image ``encode_420.ppm`` (an odd size), the SHA-256 of the bytes PIL writes
for it at quality 95, 4:2:0: the encoder's case, held against a reference
that does not share the port's code.
``tests/test_torch_jpeg.py`` holds the digests to ``tcs_tpu``, PIL and the
port on the CPU; ``chip_smoke.py`` phase 12 holds the port to them on the
card.

Usage: ``python scripts/make_jpeg_fixtures.py``.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests",
                   "fixtures", "jpeg")


def picture(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth colour waves with some noise, as a photograph has both."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 90 * np.sin(x / (5 + 2 * c) + c) * np.cos(y / (4 + c) - c)
                     for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def main() -> None:
    import cv2
    from PIL import Image

    from tcs_tpu.data.frame_utils import read_image

    cases = {
        "progressive_420.jpg": (picture(40, 56, 0), dict(progressive=True, optimize=True,
                                                         subsampling=2, quality=85)),
        "odd_420.jpg": (picture(37, 53, 1), dict(subsampling=2, quality=90)),
        "restart_422.jpg": (picture(33, 48, 2), dict(subsampling=1, quality=75,
                                                     restart_marker_blocks=3)),
        "gray.jpg": (picture(29, 43, 3)[..., 1], dict(quality=95)),
    }
    os.makedirs(OUT, exist_ok=True)
    for name, (img, kw) in cases.items():
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", **kw)
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(buf.getvalue())
    ok, enc = cv2.imencode(".jpg", picture(35, 46, 4)[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
    assert ok
    with open(os.path.join(OUT, "h1v2_440.jpg"), "wb") as f:
        f.write(enc.tobytes())
    digests = {"decode": {}, "encode": {}}
    for name in sorted(os.listdir(OUT)):
        if name.endswith(".jpg"):
            img = read_image(os.path.join(OUT, name))
            digests["decode"][name] = {"shape": list(img.shape),
                                       "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
    Image.fromarray(picture(37, 53, 5)).save(os.path.join(OUT, "encode_420.ppm"))
    buf = io.BytesIO()
    Image.open(os.path.join(OUT, "encode_420.ppm")).save(buf, "JPEG", quality=95, subsampling=2)
    digests["encode"]["encode_420.ppm"] = {"quality": 95,
                                           "sha256": hashlib.sha256(buf.getvalue()).hexdigest()}
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(digests, indent=1))


if __name__ == "__main__":
    main()
