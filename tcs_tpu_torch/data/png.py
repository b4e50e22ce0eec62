"""PNG reader and writer on ``zlib`` and numpy.

The port reads its datasets' frames and ground truth without PIL, OpenCV or
libpng, which the GPU machine does not have (``tcs_tpu`` decodes through PIL
and a native libpng decoder, ``tcs_tpu/data/frame_utils.py:29``).

:func:`read_png` reads non-interlaced files of bit depth 8 or 16 in every
colour type (gray, RGB, palette, gray+alpha, RGBA). ``zlib`` inflates the
image data (it releases the GIL while it does) and the port's host core
(``csrc/host_io.c`` through :mod:`tcs_tpu_torch.data._host`) undoes the five
row filters, which real files mix row by row. Two numpy versions stay beside
it as its plain references: :func:`_unfilter_rows` for None, Sub and Up rows,
a row at a time, and :func:`_unfilter_diagonals` for any mix, along the
image's anti-diagonals, since Average and Paeth predict from the
reconstructed pixel to the left. :func:`write_png` writes 8-bit gray and RGB
and 16-bit gray, with every row unfiltered or every row Paeth-filtered (what
encoders choose for photographs, and what costs a reader most).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from tcs_tpu_torch.data import _host

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type → samples per pixel


def _chunks(data: bytes, path):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in the {kind.decode(errors='replace')} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(filt: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Rows filtered with None (0), Sub (1) or Up (2) only."""
    out = np.empty_like(filt)
    prev = np.zeros(filt.shape[1], np.uint8)
    for r, kind in enumerate(kinds):
        row = filt[r]
        if kind == 1:  # each byte adds the reconstructed byte one pixel left
            row = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            row = row + prev
        out[r] = prev = row
    return out


def _unfilter_diagonals(filt: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Any mix of the five filters. Pixel (r, x) depends on (r, x-1),
    (r-1, x) and (r-1, x-1), so each anti-diagonal r + x = t depends only on
    the two before it and is undone as one vector operation."""
    H = filt.shape[0]
    W = filt.shape[1] // bpp
    f = filt.reshape(H, W, bpp).astype(np.int16)
    rec = np.zeros((H + 1, W + 1, bpp), np.int16)  # a zero row on top, a zero column left
    for t in range(H + W - 1):
        rr = np.arange(max(0, t - W + 1), min(H - 1, t) + 1)
        xx = t - rr
        a, b, c = rec[rr + 1, xx], rec[rr, xx + 1], rec[rr, xx]
        k = kinds[rr][:, None]
        pred = np.where(k == 1, a, np.where(k == 2, b, np.where(
            k == 3, (a + b) >> 1, np.where(k == 4, _paeth(a, b, c), 0))))
        rec[rr + 1, xx + 1] = (f[rr, xx] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8).reshape(H, W * bpp)


def read_png(path) -> np.ndarray:
    """(H, W) for gray, (H, W, C) otherwise; uint8 or uint16 by bit depth.
    Palette files come back as RGB (any transparency is dropped)."""
    data = Path(path).read_bytes()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG files are not supported")
    if depth not in (8, 16) or color not in _CHANNELS or (color == 3 and depth != 8):
        raise ValueError(f"{path}: bit depth {depth} with colour type {color} is not"
                         " supported (bit depths 8 and 16 are)")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (width * bpp + 1):
        raise ValueError(f"{path}: image data has {raw.size} bytes, expected "
                         f"{height * (width * bpp + 1)}")
    try:
        rec = _host.png_unfilter(raw.reshape(height, width * bpp + 1), bpp)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if depth == 16:
        img = rec.view(">u2").astype(np.uint16).reshape(height, width, channels)
    else:
        img = rec.reshape(height, width, channels)
    if color == 3:
        return palette[img[..., 0]]
    return img[..., 0] if channels == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def _paeth_filter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Each byte less the Paeth predictor of its unfiltered neighbours."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    return ((x - _paeth(a, b, c)) & 0xFF).astype(np.uint8)


def write_png(path, array: np.ndarray, level: int = 6, filter: str = "none") -> None:
    """uint8 (H, W) or (H, W, 3), or uint16 (H, W), as gray, RGB or 16-bit
    gray (big-endian); every row with filter None (``filter="none"``) or
    Paeth (``"paeth"``)."""
    a = np.asarray(array)
    if a.dtype == np.uint8 and a.ndim == 2:
        color, depth = 0, 8
    elif a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3:
        color, depth = 2, 8
    elif a.dtype == np.uint16 and a.ndim == 2:
        color, depth, a = 0, 16, a.astype(">u2")
    else:
        raise ValueError(f"{path}: cannot write a {a.dtype} array of shape {a.shape}"
                         " (uint8 gray or RGB, or uint16 gray)")
    if filter not in ("none", "paeth"):
        raise ValueError(f"filter {filter!r}: 'none' or 'paeth'")
    height, width = a.shape[:2]
    rows = np.ascontiguousarray(a).view(np.uint8).reshape(height, -1)
    kind = 0
    if filter == "paeth":
        kind, rows = 4, _paeth_filter(rows, rows.shape[1] // width)
    raw = np.concatenate([np.full((height, 1), kind, np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
                + _chunk(b"IEND", b""))
