"""Build and load the package's CUDA kernels (kanzi_tpu_torch/csrc).

One ``nvcc`` per ``csrc/*.cu``, all started together, compiles each source
to an object; one more links them into a shared library with a plain C
interface, which is loaded with ctypes.  No PyTorch headers are compiled, so
a build takes seconds.  The library is named by a hash of the sources (the
``*.cuh`` headers included) and the flags, ``_build/libkanzi_torch_<hash>.so``,
so an edited source never loads a stale build.  Builds happen at first use,
never at import, and are serialised across threads and processes by a file
lock in ``_build/``.
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
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

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
    # chunks, hist, n, stream
    "kz_huffman_hist": [_P, _P, _I, _P],
    # chunks, tbl, words, n_words, acc, nbits, n, stream
    "kz_huffman_encode": [_P, _P, _P, _P, _P, _P, _I, _P],
    # pay, bnd, adj, perm, syms, used, n, stream
    "kz_huffman_decode": [_P, _P, _P, _P, _P, _P, _I, _P],
    # bufs, w0, w1, w2, w3, nb, n, stream
    "kz_lz_words": [_P, _P, _P, _P, _P, _I, _I, _P],
    # chunks, packed, emit, states, n, c, lr, stream
    "kz_ans1_scan": [_P, _P, _P, _P, _I, _I, _I, _P],
    # lk, out, cycles, steps, lr, stream (a measurement, on no codec path)
    "kz_ans1_scan_chain": [_P, _P, _P, _I, _I, _P],
    # counts, lr, stream (the reciprocal's exhaustive check, on no codec path)
    "kz_ans1_recip_check": [_P, _I, _P],
    # blocks, threads, stream (an empty kernel, the floor of a measurement)
    "kz_empty": [_I, _I, _P],
    # e, payload, counts, m, nb, stream
    "kz_ans1_compact": [_P, _P, _P, _I, _I, _P],
    # data, nops, nk, b, n, schedule (host int32 rows), rows, stream
    "kz_ksort": [_P, _I, _I, _I, _I, _P, _I, _P],
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


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; return their output, or raise with it
    if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    bad = [(c, p.returncode) for c, p in zip(cmds, procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"nvcc failed: {bad}:\n{log}")
    return log


def _build(so: str, units: list[str]) -> None:
    global build_log
    tag = f"{os.getpid()}.{threading.get_ident()}.tmp"
    nvcc = _nvcc()
    objs = [f"{so}.{os.path.basename(u)}.{tag}.o" for u in units]
    try:
        build_log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, u]
                              for u, o in zip(units, objs)])
        tmp = f"{so}.{tag}"
        build_log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, so)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)


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
        so = os.path.join(BUILD_DIR, f"libkanzi_torch_{digest}.so")
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
