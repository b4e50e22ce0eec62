"""JPEG read and write through the port's own codec (``csrc/jpeg.c``).

The counterpart of ``tcs_tpu/data/native_io.py``'s ``read_jpeg`` (libjpeg):
the card's machine has no libjpeg, PIL or OpenCV. The decoder gives
libjpeg's default decompression bit for bit (ISLOW IDCT, fancy upsampling,
its YCbCr tables) for baseline and progressive Huffman files, 8-bit, gray or
three components; the encoder writes baseline 4:2:0 files as libjpeg does
with its defaults at a given quality. Both run in the host core
(:mod:`tcs_tpu_torch.data._host`) without the GIL.

What the decoder does not read raises :class:`UnsupportedJPEG` (a
``NotImplementedError``), naming the format: arithmetic coding, 12-bit and
other precisions, lossless and hierarchical files, CMYK/YCCK, other sampling
ratios, and progressive files that leave low coefficients unrefined (libjpeg
block-smooths those). A truncated or corrupt stream raises
:class:`CorruptJPEG` (an ``IOError``), where libjpeg warns and pads.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np

from tcs_tpu_torch.data import _host

_CORRUPT, _UNSUPPORTED, _NOMEM = 1, 2, 3


class UnsupportedJPEG(NotImplementedError):
    """A JPEG variant the port's decoder does not read."""


class CorruptJPEG(IOError):
    """A truncated or corrupt JPEG stream."""


class JPEGInfo(NamedTuple):
    width: int
    height: int
    channels: int
    progressive: bool


def _raise(rc: int, err, where) -> None:
    msg = f"{where}: {err.value.decode(errors='replace')}"
    if rc == _UNSUPPORTED:
        raise UnsupportedJPEG(msg)
    if rc == _NOMEM:
        raise MemoryError(msg)
    raise CorruptJPEG(msg)


def _bytes(source) -> tuple:
    """(uint8 array, name for messages) of a path or a bytes-like object."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        return np.frombuffer(source, np.uint8), "JPEG data"
    return np.fromfile(source, np.uint8), str(source)


def _info(data: np.ndarray, where) -> JPEGInfo:
    w, h, c, prog = (ctypes.c_int() for _ in range(4))
    err = ctypes.create_string_buffer(256)
    rc = _host.lib().tcs_jpeg_info(data.ctypes.data, data.size, ctypes.byref(w), ctypes.byref(h),
                                   ctypes.byref(c), ctypes.byref(prog), err, len(err))
    if rc:
        _raise(rc, err, where)
    return JPEGInfo(w.value, h.value, c.value, bool(prog.value))


def jpeg_info(source) -> JPEGInfo:
    """Width, height, components and whether the file is progressive, from
    its headers: a path or the file's bytes."""
    return _info(*_bytes(source))


def read_jpeg(source) -> np.ndarray:
    """(H, W, C) uint8 of a path or the file's bytes: C = 3 (RGB) or 1
    (gray), as ``tcs_tpu``'s native reader returns them."""
    data, where = _bytes(source)
    info = _info(data, where)
    out = np.empty((info.height, info.width, info.channels), np.uint8)
    err = ctypes.create_string_buffer(256)
    rc = _host.lib().tcs_jpeg_decode(data.ctypes.data, data.size, out.ctypes.data, out.size,
                                     err, len(err))
    if rc:
        _raise(rc, err, where)
    return out


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """Baseline JFIF, 4:2:0, of an (H, W, 3) uint8 RGB image at ``quality``
    (1..100, libjpeg's scaling of the Annex K tables)."""
    src = np.ascontiguousarray(rgb, np.uint8)
    if src.ndim != 3 or src.shape[2] != 3 or min(src.shape[:2]) < 1 or max(src.shape[:2]) > 65535:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8 RGB up to 65535 a side, "
                         f"not shape {rgb.shape}")
    if not 1 <= int(quality) <= 100:
        raise ValueError(f"quality {quality} is not in 1..100")
    h, w = src.shape[:2]
    cap = h * w * 3 // 2 + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = _host.lib().tcs_jpeg_encode(src.ctypes.data, w, h, int(quality), out.ctypes.data, cap)
        if n < 0:
            raise MemoryError("the host core could not allocate the encoder's planes")
        if n <= cap:
            return out[:n].tobytes()
        cap = n
