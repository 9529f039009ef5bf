"""Build and load the package's CUDA kernels (kanzi_tpu_torch/csrc).

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, which is loaded with ctypes; no PyTorch headers are compiled, so
a build takes seconds.  The library is named by a hash of the sources and
the flags, ``_build/libkanzi_ans0_<hash>.so``, so an edited source never
loads a stale build.  Builds happen at first use, never at import, and are
serialised across threads and processes by a file lock in ``_build/``.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
build_log = ""          # nvcc's output of the last build (ptxas resource usage)
build_seconds = 0.0     # wall time of the last load(), build included

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # chunks, freq, n, stream
    "kz_ans0_hist_norm": [_P, _P, _I, _P],
    # chunks, tables, words, flags, states, n, c, stream
    "kz_ans0_encode_scan": [_P, _P, _P, _P, _P, _I, _I, _P],
    # words, flags, payload, n_emit, n, c, stream
    "kz_ans0_compact": [_P, _P, _P, _P, _I, _I, _P],
    # payload, pitch, lengths, states, freq, cum, out, consumed, n, stream
    "kz_ans0_decode": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P, _I, _P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources() -> tuple[list[str], str]:
    files = sorted(glob.glob(os.path.join(SRC_DIR, "*.cu"))
                   + glob.glob(os.path.join(SRC_DIR, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        with open(f, "rb") as fh:
            h.update(os.path.basename(f).encode() + b"\0" + fh.read())
    return [f for f in files if f.endswith(".cu")], h.hexdigest()[:16]


def _build(so: str, units: list[str]) -> None:
    global build_log
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *units]
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
    os.replace(tmp, so)


def load() -> ctypes.CDLL:
    """Return the kernel library, building it first if needed."""
    global _LIB, build_seconds
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        t0 = time.perf_counter()
        units, digest = _sources()
        so = os.path.join(BUILD_DIR, f"libkanzi_ans0_{digest}.so")
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            if not os.path.exists(so):
                _build(so, units)
        lib = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        build_seconds = time.perf_counter() - t0
        _LIB = lib
        return lib
