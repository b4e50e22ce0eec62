"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``tcs_tpu_torch/csrc/`` expose a plain C interface. At first
use they are compiled for Hopper (``sm_90a``) with ``nvcc``, one process per
source started together, linked into ``tcs_tpu_torch/_build/libtcs_kernels.so``
and loaded with ``ctypes``. The library is rebuilt when the hash of the
sources or flags changes. A missing ``nvcc`` or a failed build raises.

``launches`` counts, per kernel, the launches its wrapper made; a run resets
it with :func:`reset_launches` to show which kernels a path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
SOURCES = ("corr_lookup.cu", "corr_lookup_bwd.cu", "softsplat.cu",
           "softsplat_bwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches = {"corr_lookup": 0, "corr_lookup_bwd": 0, "splat_sum": 0,
            "splat_sum_bwd": 0}

_lib = None
_lock = threading.Lock()
build_log = ""  # nvcc's output (registers, spills) of the last build
build_seconds = None  # wall time of the last build, None if loaded as built


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of tcs_tpu_torch are "
                       "built at first use and need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in SOURCES:
        h.update((_CSRC / s).read_bytes())
    return h.hexdigest()


def _build(lib_path: Path, digest: str) -> None:
    global build_log, build_seconds
    nvcc = _nvcc()
    t0 = time.perf_counter()
    _BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        objs, procs = [], []
        for s in SOURCES:
            obj = Path(tmp) / (Path(s).stem + ".o")
            objs.append(str(obj))
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(_CSRC / s), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        build_log = "\n".join(logs)
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], *objs,
                               "-o", str(tmp_lib)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    (_BUILD / "libtcs_kernels.sha256").write_text(digest)
    build_seconds = time.perf_counter() - t0


def _declare(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tcs_corr_lookup.argtypes = [ctypes.POINTER(vp), i32, i32, vp, vp, i32,
                                    i32, i32, vp]
    lib.tcs_corr_lookup.restype = i32
    lib.tcs_corr_lookup_bwd.argtypes = [ctypes.POINTER(vp), i32, i32, vp, vp,
                                        i32, i32, i32, vp]
    lib.tcs_corr_lookup_bwd.restype = i32
    lib.tcs_splat_sum_scratch_ints.argtypes = [ctypes.c_longlong]
    lib.tcs_splat_sum_scratch_ints.restype = ctypes.c_longlong
    lib.tcs_splat_sum.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, vp]
    lib.tcs_splat_sum.restype = i32
    lib.tcs_splat_sum_bwd.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, vp]
    lib.tcs_splat_sum_bwd.restype = i32


def lib():
    """The loaded kernel library, built first where it is missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            lib_path = _BUILD / "libtcs_kernels.so"
            stamp = _BUILD / "libtcs_kernels.sha256"
            digest = _digest()
            if not (lib_path.exists() and stamp.exists()
                    and stamp.read_text() == digest):
                _build(lib_path, digest)
            loaded = ctypes.CDLL(str(lib_path))
            _declare(loaded)
            _lib = loaded
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {err}")
