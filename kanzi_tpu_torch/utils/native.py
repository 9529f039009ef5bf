"""Loader for the C++ native runtime library.

Compiles the repository's ``native/*.cpp`` (shared with the JAX package,
which builds its own copy under ``native/_build``) and this package's own
``hostsrc/*.cpp`` on first use with g++ -O3 into this package's
``_build/libkanzi_native.so``, again whenever a source is newer.  All
native entry points are optional: every caller has a pure-Python/NumPy
fallback so the framework still works (slowly) without a toolchain.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
_SRCS = [os.path.join(_ROOT, "native", f)
         for f in ("kanzi_native.cpp", "coders.cpp", "transforms.cpp", "lz.cpp",
                   "bwt.cpp", "text.cpp", "exe.cpp", "rolz.cpp", "ans.cpp",
                   "huffman.cpp")] + [
    os.path.join(_PKG, "hostsrc", f) for f in ("ans0_wire.cpp",)]
_BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(_BUILD_DIR, "libkanzi_native.so")


def _build() -> str | None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # one build at a time across processes (test workers start together)
    with open(os.path.join(_BUILD_DIR, "native.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        return _build_locked()


def _build_locked() -> str | None:
    srcs = [s for s in _SRCS if os.path.exists(s)]
    if os.path.exists(_SO) and all(os.path.getmtime(_SO) >= os.path.getmtime(s) for s in srcs):
        return _SO
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-o", _SO + ".tmp"] + srcs
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(_SO + ".tmp", _SO)
        return _SO
    except Exception:
        # retry without -march=native (portability)
        try:
            cmd.remove("-march=native")
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
            os.replace(_SO + ".tmp", _SO)
            return _SO
        except Exception:
            return None


def get_lib():
    """Return the loaded ctypes library, or None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        if os.environ.get("KANZI_TPU_NO_NATIVE"):
            _TRIED = True
            return None
        so = _build()
        if so is None:
            _TRIED = True
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            _TRIED = True
            return None
        c = ctypes
        u8p = c.POINTER(c.c_uint8)
        lib.kz_xxhash32.restype = c.c_uint32
        lib.kz_xxhash32.argtypes = [c.c_char_p, c.c_int64, c.c_uint32]
        lib.kz_xxhash64.restype = c.c_uint64
        lib.kz_xxhash64.argtypes = [c.c_char_p, c.c_int64, c.c_uint64]
        if hasattr(lib, "kz_cm_encode"):
            for fn in (lib.kz_cm_encode, lib.kz_fpaq_encode):
                fn.restype = c.c_int64
                fn.argtypes = [u8p, c.c_int64, u8p, c.c_int64]
            for fn in (lib.kz_cm_decode, lib.kz_fpaq_decode):
                fn.restype = c.c_int64
                fn.argtypes = [u8p, c.c_int64, u8p, c.c_int64, c.POINTER(c.c_int64)]
            lib.kz_tpaq_encode.restype = c.c_int64
            lib.kz_tpaq_encode.argtypes = [u8p, c.c_int64, u8p, c.c_int64,
                                           c.c_int32, c.c_int64, c.c_int64]
            lib.kz_tpaq_decode.restype = c.c_int64
            lib.kz_tpaq_decode.argtypes = [u8p, c.c_int64, u8p, c.c_int64,
                                           c.POINTER(c.c_int64), c.c_int32,
                                           c.c_int64, c.c_int64]
            lib.kz_tpaq_set_tables.restype = None
            lib.kz_tpaq_set_tables.argtypes = [u8p, u8p, c.POINTER(c.c_int32),
                                               c.POINTER(c.c_int32)]
            # push the TPAQ wire tables (single source of truth in Python)
            import numpy as np
            from ..models._tpaq_tables import MATCH_PRED, STATE_MAP, STATE_TRANSITIONS
            t0 = np.ascontiguousarray(STATE_TRANSITIONS[0], dtype=np.uint8)
            t1 = np.ascontiguousarray(STATE_TRANSITIONS[1], dtype=np.uint8)
            sm = np.ascontiguousarray(STATE_MAP, dtype=np.int32)
            mp = np.ascontiguousarray(MATCH_PRED, dtype=np.int32)
            lib.kz_tpaq_set_tables(
                t0.ctypes.data_as(u8p), t1.ctypes.data_as(u8p),
                sm.ctypes.data_as(c.POINTER(c.c_int32)),
                mp.ctypes.data_as(c.POINTER(c.c_int32)))
        _LIB = lib
        return _LIB


def as_u8p(arr):
    """ctypes uint8 pointer for a contiguous numpy array."""
    import ctypes
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
