"""Zstandard decompression and CRC-32C through the port's host core
(``csrc/zstd.c``, a decoder written to RFC 8878).

tensorstore compresses the OCDBT manifests and b-tree nodes and the zarr
chunks of ``tcs_tpu``'s Orbax checkpoints with zstd; the card's machine has
no zstd module, so the port reads them with its own decoder, in the host
core (:mod:`tcs_tpu_torch.data._host`) without the GIL.

The caller names the output's capacity: a zarr chunk's shape times its item
size, an OCDBT node's decoded length. A truncated, overrunning or corrupt
input raises :class:`CorruptZstd` (an ``IOError``), and so does a frame that
needs a dictionary (named in the message): tensorstore writes none.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from tcs_tpu_torch.data import _host

_ERRLEN = 256


class CorruptZstd(IOError):
    """A truncated, overrunning or corrupt zstd input."""


def _view(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else \
        np.ascontiguousarray(data, np.uint8).reshape(-1)


def content_size(data) -> Optional[int]:
    """The first frame's content size from its header, or None where the
    header omits it. Raises :class:`CorruptZstd` where there is no frame
    header to read."""
    src = _view(data)
    n = _host.lib().tcs_zstd_content_size(src.ctypes.data, src.size)
    if n == -2:
        raise CorruptZstd("no readable zstd frame header")
    return None if n == -1 else int(n)


def decompress(data, capacity: int) -> bytes:
    """The content of every frame of ``data``, concatenated (skippable
    frames skipped); at most ``capacity`` bytes, or :class:`CorruptZstd`."""
    return decompress_into(data, np.empty(capacity, np.uint8)).tobytes()


def decompress_into(data, out: np.ndarray) -> np.ndarray:
    """Decodes ``data`` into the uint8 array ``out`` (its size is the
    capacity); returns the part of ``out`` written."""
    src = _view(data)
    if out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("decompress_into needs a contiguous uint8 output")
    err = ctypes.create_string_buffer(_ERRLEN)
    n = _host.lib().tcs_zstd_decompress(src.ctypes.data, src.size, out.ctypes.data,
                                        out.size, err, _ERRLEN)
    if n < 0:
        raise CorruptZstd(err.value.decode(errors="replace"))
    return out[:n]


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``."""
    src = _view(data)
    return int(_host.lib().tcs_crc32c(crc, src.ctypes.data, src.size))
