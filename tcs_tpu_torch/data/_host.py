"""Build, load and call the port's host core (``tcs_tpu_torch/csrc/host_io.c``
and ``csrc/jpeg.c``).

The port's counterpart of ``tcs_tpu/data/native_io.py``. At first use the C
sources are compiled with the host compiler (``cc``, the one ``nvcc`` drives)
into one ``tcs_tpu_torch/_build/libtcs_host_<hash>.so``, named by a hash of
every source and the flags, so a changed source builds anew and concurrent
builds by several processes cannot mix. It is loaded with ``ctypes.CDLL``, which
releases the GIL for the length of each call: decoding and augmenting
threads or processes do not hold up the thread that launches the training
step's kernels. A missing compiler, a failed build or a failed load raises;
nothing falls back to the numpy versions, which the tests hold the core to
(``png._unfilter_rows`` / ``png._unfilter_diagonals``,
``augmentor.resize_bilinear_plain``, ``augmentor.color_jitter_plain``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host_io.c"
JPEG_SOURCE = _PKG / "csrc" / "jpeg.c"  # the codec behind data/jpeg.py
_BUILD = _PKG / "_build"
# No FMA contraction: the resize must round as numpy does (see host_io.c).
# -fno-trapping-math changes no result (nothing here reads the FP exception
# flags); it lets the compiler vectorise the hue rotation's selects.
CFLAGS = ("-O3", "-fPIC", "-ffp-contract=off", "-fno-trapping-math")

_lib = None
_lock = threading.Lock()


def _compiler() -> str:
    found = shutil.which("cc")
    if found is None:
        raise RuntimeError("no host C compiler: tcs_tpu_torch builds its data core "
                           f"({SOURCE.name}) at first use with `cc`, which is not on PATH")
    return found


def _sources() -> tuple:
    return SOURCE, JPEG_SOURCE


def _build(lib_path: Path) -> None:
    cc = _compiler()
    _BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        out = Path(tmp) / lib_path.name
        proc = subprocess.run([cc, *CFLAGS, "-shared", "-o", str(out),
                               *map(str, _sources()), "-lm"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the host core failed ({cc} exited "
                               f"{proc.returncode}):\n{proc.stdout}")
        os.replace(out, lib_path)


def lib() -> ctypes.CDLL:
    """The loaded host core, built first where it is missing."""
    global _lib
    with _lock:
        if _lib is None:
            digest = hashlib.sha256(" ".join(CFLAGS).encode()
                                    + b"".join(p.read_bytes() for p in _sources()))
            path = _BUILD / f"libtcs_host_{digest.hexdigest()[:16]}.so"
            if not path.exists():
                _build(path)
            try:
                loaded = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"loading the host core {path} failed: {e}") from e
            vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            loaded.tcs_png_unfilter.argtypes = [vp, vp, i32, i32, i32]
            loaded.tcs_png_unfilter.restype = i32
            loaded.tcs_resize_bilinear.argtypes = [vp, i32, i32, i32, vp, i32, i32,
                                                   i32, i32, i32, i32]
            loaded.tcs_resize_bilinear.restype = i32
            loaded.tcs_color_jitter.argtypes = [vp, vp, vp, ctypes.c_long, vp,
                                                f64, f64, f64, f64, f64, f64]
            loaded.tcs_color_jitter.restype = None
            ip, cp, lng = ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_long
            loaded.tcs_jpeg_info.argtypes = [vp, lng, ip, ip, ip, ip, cp, i32]
            loaded.tcs_jpeg_info.restype = i32
            loaded.tcs_jpeg_decode.argtypes = [vp, lng, vp, lng, cp, i32]
            loaded.tcs_jpeg_decode.restype = i32
            loaded.tcs_jpeg_encode.argtypes = [vp, i32, i32, i32, vp, lng]
            loaded.tcs_jpeg_encode.restype = lng
            _lib = loaded
        return _lib


def png_unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + rowbytes) uint8 rows, each led by its filter type →
    (H, rowbytes) reconstructed bytes. An unknown filter type raises."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.ndim != 2 or bpp not in (1, 2, 3, 4, 6, 8) or (raw.shape[1] - 1) % bpp:
        raise ValueError(f"rows of shape {raw.shape} do not hold whole {bpp}-byte pixels")
    height, rowbytes = raw.shape[0], raw.shape[1] - 1
    out = np.empty((height, rowbytes), np.uint8)
    bad = lib().tcs_png_unfilter(raw.ctypes.data, out.ctypes.data, height, rowbytes, bpp)
    if bad:
        raise ValueError(f"unknown row filter {raw[bad - 1, 0]} in row {bad - 1}")
    return out


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int, window=None) -> np.ndarray:
    """(H, W[, C]) → (out_h, out_w[, C]) float64, half-pixel centres; or only
    ``window`` = (y, x, h, w) of it, computed alone. Equal to
    ``augmentor.resize_bilinear_plain`` bit for bit."""
    src = np.ascontiguousarray(img, np.float32)
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    y, x, h, w = (0, 0, out_h, out_w) if window is None else window
    if (src.ndim != 3 or min(src.shape) < 1 or min(h, w) < 1 or y < 0 or x < 0
            or y + h > out_h or x + w > out_w):
        raise ValueError(f"cannot resize an image of shape {img.shape} to {out_h}x{out_w}"
                         f" in the window {window}")
    H, W, C = src.shape
    out = np.empty((h, w, C), np.float64)
    if lib().tcs_resize_bilinear(src.ctypes.data, H, W, C, out.ctypes.data, out_h, out_w,
                                 y, x, h, w):
        raise MemoryError("the host core could not allocate its resize taps")
    return out[..., 0] if squeeze else out


def color_jitter(img: np.ndarray, order, factors, gamma: float, gain: float) -> np.ndarray:
    """Brightness, contrast, saturation and hue ``factors`` applied in
    ``order`` (a permutation of 0..3), then gamma and gain, to a uint8
    (..., 3) image; uint8 out, rounded half to even."""
    src = np.ascontiguousarray(img, np.uint8)
    if src.shape[-1] != 3:
        raise ValueError(f"colour jitter takes RGB images, not shape {img.shape}")
    order = np.ascontiguousarray(order, np.int32)
    if sorted(order.tolist()) != [0, 1, 2, 3]:
        raise ValueError(f"order {order} is not a permutation of 0..3")
    work = np.empty(src.shape, np.float32)
    out = np.empty(src.shape, np.uint8)
    lib().tcs_color_jitter(src.ctypes.data, work.ctypes.data, out.ctypes.data,
                           src.size // 3, order.ctypes.data, *map(float, factors),
                           float(gamma), float(gain))
    return out
