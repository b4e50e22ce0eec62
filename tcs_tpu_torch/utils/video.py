"""Motion-JPEG ``.avi`` files, written and read without OpenCV.

:class:`MJPGWriter` is the port's counterpart of the ``cv2.VideoWriter``
calls of ``tcs_tpu/evaluate.py`` ``submit_kitti`` (reference
``evaluate_stereo.py:103-113``: fourcc ``MJPG``, 2 fps): the card's machine
has no OpenCV. Each frame is a baseline 4:2:0 JPEG from the port's encoder
(:func:`tcs_tpu_torch.data.jpeg.encode_jpeg`, quality 95, the default of
OpenCV's own MJPEG writer, ``VIDEOWRITER_PROP_QUALITY``). The
container is AVI 1.0 RIFF:

- ``LIST hdrl``: ``avih`` (the main header), ``LIST strl`` with ``strh``
  (``vids``, handler ``MJPG``, rate / scale = fps) and ``strf`` (a
  BITMAPINFOHEADER, compression ``MJPG``);
- ``LIST movi``: one ``00dc`` chunk a frame;
- ``idx1``: one key-frame entry a frame, offsets from the ``movi`` tag.

Frames go to disk as they come; :meth:`MJPGWriter.release` writes the index
and fills in the counts and sizes. :func:`read_avi` parses such a file (and
other single-stream MJPG AVI files) back into its frames' JPEG bytes.
"""

from __future__ import annotations

import struct
from fractions import Fraction
from typing import List, NamedTuple, Tuple

import numpy as np

from tcs_tpu_torch.data.jpeg import encode_jpeg

_AVIF_HASINDEX, _AVIF_ISINTERLEAVED, _AVIF_TRUSTCKTYPE = 0x10, 0x100, 0x800
_AVIIF_KEYFRAME = 0x10
_RIFF_LIMIT = 1 << 31  # AVI 1.0 keeps every size in 32 bits, and players read them as signed


def _chunk_header(tag: bytes, size: int) -> bytes:
    return tag + struct.pack("<I", size)


class MJPGWriter:
    """``MJPGWriter(path, fps, (width, height))``; :meth:`write` takes
    (height, width, 3) uint8 RGB frames; :meth:`release` (or leaving a
    ``with`` block) finishes the file."""

    def __init__(self, path, fps: float, frame_size: Tuple[int, int]):
        self.width, self.height = map(int, frame_size)
        if self.width < 1 or self.height < 1 or fps <= 0:
            raise ValueError(f"an MJPG video needs a positive size and fps, not "
                             f"{frame_size} at {fps}")
        rate = Fraction(fps).limit_denominator(1_000_000)
        self.rate, self.scale = rate.numerator, rate.denominator
        self._index: List[Tuple[int, int]] = []  # (offset from the movi tag, size)
        self._f = open(path, "wb")
        self._f.write(self._headers(0))
        self._movi_tag = self._f.tell() - 4

    def _headers(self, idx1_bytes: int) -> bytes:
        """Everything before the first frame's chunk, with the counts and
        sizes of the frames written so far and an index of ``idx1_bytes``."""
        n = len(self._index)
        biggest = max((s for _, s in self._index), default=0)
        us_per_frame = round(1e6 * self.scale / self.rate)
        avih = struct.pack("<14I", us_per_frame, int(biggest * self.rate / self.scale), 0,
                           _AVIF_HASINDEX | _AVIF_ISINTERLEAVED | _AVIF_TRUSTCKTYPE, n, 0, 1,
                           biggest + 8, self.width, self.height, 0, 0, 0, 0)
        strh = (b"vidsMJPG" + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0, self.scale, self.rate,
                                           0, n, biggest + 8, -1, 0)
                + struct.pack("<4h", 0, 0, self.width, self.height))
        strf = struct.pack("<IiiHH4sIiiII", 40, self.width, self.height, 1, 24, b"MJPG",
                           self.width * self.height * 3, 0, 0, 0, 0)
        strl = (b"strl" + _chunk_header(b"strh", len(strh)) + strh
                + _chunk_header(b"strf", len(strf)) + strf)
        hdrl = (b"hdrl" + _chunk_header(b"avih", len(avih)) + avih
                + _chunk_header(b"LIST", len(strl)) + strl)
        movi_size = 4 + sum(8 + s + (s & 1) for _, s in self._index)
        riff_size = 4 + 8 + len(hdrl) + 8 + movi_size + idx1_bytes
        return (_chunk_header(b"RIFF", riff_size) + b"AVI "
                + _chunk_header(b"LIST", len(hdrl)) + hdrl
                + _chunk_header(b"LIST", movi_size) + b"movi")

    def write(self, rgb: np.ndarray) -> None:
        if self._f.closed:
            raise ValueError("write to a released MJPGWriter")
        if rgb.shape != (self.height, self.width, 3):
            raise ValueError(f"a frame of shape {rgb.shape} in a {self.width}x{self.height} video")
        data = encode_jpeg(rgb, 95)
        pos = self._f.tell()
        if pos + 8 + len(data) + 16 * (len(self._index) + 1) + 8 >= _RIFF_LIMIT:
            raise ValueError("an AVI 1.0 file holds at most 2 GiB")
        self._f.write(_chunk_header(b"00dc", len(data)) + data + b"\0" * (len(data) & 1))
        self._index.append((pos - self._movi_tag, len(data)))

    def release(self) -> None:
        if self._f.closed:
            return
        try:
            self._f.write(_chunk_header(b"idx1", 16 * len(self._index)))
            for offset, size in self._index:
                self._f.write(struct.pack("<4sIII", b"00dc", _AVIIF_KEYFRAME, offset, size))
            self._f.seek(0)
            self._f.write(self._headers(8 + 16 * len(self._index)))
        finally:
            self._f.close()

    def __enter__(self) -> "MJPGWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class AVI(NamedTuple):
    fourcc: str
    fps: float
    width: int
    height: int
    frames: List[bytes]  # each frame's JPEG, in stream order


def read_avi(path) -> AVI:
    """The video stream of a single-stream MJPG AVI file: its handler, fps,
    size and the bytes of each ``00dc`` / ``00db`` chunk of ``movi``."""
    data = memoryview(open(path, "rb").read())
    if bytes(data[:4]) != b"RIFF" or bytes(data[8:12]) != b"AVI ":
        raise ValueError(f"{path}: not an AVI file")
    found = {"frames": []}

    def walk(start: int, end: int, in_movi: bool) -> None:
        pos = start
        while pos + 8 <= end:
            tag = bytes(data[pos:pos + 4])
            size = struct.unpack_from("<I", data, pos + 4)[0]
            body = pos + 8
            if body + size > len(data):
                raise ValueError(f"{path}: chunk {tag!r} runs past the file's end")
            if tag in (b"LIST", b"RIFF"):
                kind = bytes(data[body:body + 4])
                walk(body + 4, body + size, kind == b"movi")
            elif tag == b"strh" and "fps" not in found:
                handler = bytes(data[body + 4:body + 8])
                scale, rate = struct.unpack_from("<II", data, body + 20)
                found.update(fourcc=handler.decode("latin-1"), fps=rate / scale)
            elif tag == b"avih":
                found.update(width=struct.unpack_from("<I", data, body + 32)[0],
                             height=struct.unpack_from("<I", data, body + 36)[0])
            elif in_movi and tag[2:] in (b"dc", b"db"):
                found["frames"].append(bytes(data[body:body + size]))
            pos = body + size + (size & 1)

    walk(12, 8 + struct.unpack_from("<I", data, 4)[0], False)
    missing = {"fourcc", "fps", "width", "height"} - found.keys()
    if missing:
        raise ValueError(f"{path}: no {sorted(missing)} in the AVI headers")
    return AVI(**found)
