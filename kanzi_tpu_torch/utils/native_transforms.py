"""Bridges from Python transforms to the C++ native kernels (None = fallback)."""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .native import as_u8p, get_lib

_FORCE_PY = bool(os.environ.get("KANZI_TPU_PURE_PY"))
_SIGS_DONE = False
_SIGS_LOCK = threading.Lock()


def _lib():
    if _FORCE_PY:
        return None
    lib = get_lib()
    if lib is None or not hasattr(lib, "kz_sbrt_forward"):
        return None
    global _SIGS_DONE
    if not _SIGS_DONE:
        # once, under a lock: the pool's first blocks arrive together, and
        # kz_text_set_dict rebuilding the dictionary under a running TEXT
        # forward changes that block's bytes
        with _SIGS_LOCK:
            if not _SIGS_DONE:
                _init_lib(lib)
                _SIGS_DONE = True
    return lib


def _init_lib(lib) -> None:
    """Declare the signatures and push the TEXT dictionary."""
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    lib.kz_sbrt_forward.restype = None
    lib.kz_sbrt_forward.argtypes = [u8p, u8p, c.c_int64, c.c_int32]
    lib.kz_sbrt_inverse.restype = None
    lib.kz_sbrt_inverse.argtypes = [u8p, u8p, c.c_int64, c.c_int32]
    lib.kz_srt_forward.restype = c.c_int64
    lib.kz_srt_forward.argtypes = [u8p, c.c_int64, u8p, c.c_int64]
    lib.kz_srt_inverse.restype = c.c_int64
    lib.kz_srt_inverse.argtypes = [u8p, c.c_int64, u8p, c.c_int64]
    lib.kz_lzx_forward.restype = c.c_int64
    lib.kz_lzx_forward.argtypes = [u8p, c.c_int64, u8p, c.c_int32, c.c_int32]
    lib.kz_lzx_inverse.restype = c.c_int64
    lib.kz_lzx_inverse.argtypes = [u8p, c.c_int64, u8p, c.c_int64]
    lib.kz_lzp_forward.restype = c.c_int64
    lib.kz_lzp_forward.argtypes = [u8p, c.c_int64, u8p, c.c_int64]
    lib.kz_lzp_inverse.restype = c.c_int64
    lib.kz_lzp_inverse.argtypes = [u8p, c.c_int64, u8p, c.c_int64]
    if hasattr(lib, "kz_zrlt_forward"):
        lib.kz_zrlt_forward.restype = c.c_int64
        lib.kz_zrlt_forward.argtypes = [u8p, c.c_int64, u8p, c.c_int64]
        lib.kz_zrlt_inverse.restype = c.c_int64
        lib.kz_zrlt_inverse.argtypes = [u8p, c.c_int64, u8p, c.c_int64]
    i32p = c.POINTER(c.c_int32)
    lib.kz_suffix_array.restype = None
    lib.kz_suffix_array.argtypes = [u8p, i32p, c.c_int64]
    lib.kz_bwt_forward.restype = c.c_int64
    lib.kz_bwt_forward.argtypes = [u8p, u8p, c.c_int64, i32p, c.c_int32]
    lib.kz_bwt_inverse.restype = c.c_int32
    lib.kz_bwt_inverse.argtypes = [u8p, u8p, c.c_int64, i32p, c.c_int32]
    lib.kz_bwt_inverse_mt.restype = c.c_int32
    lib.kz_bwt_inverse_mt.argtypes = [u8p, u8p, c.c_int64, i32p,
                                      c.c_int32, c.c_int32]
    if hasattr(lib, "kz_text_set_dict"):
        lib.kz_text_set_dict.restype = None
        lib.kz_text_set_dict.argtypes = [u8p, c.c_int64]
        lib.kz_text_forward.restype = c.c_int64
        lib.kz_text_forward.argtypes = [u8p, c.c_int64, u8p, c.c_int64,
                                        c.c_int32, c.c_int64, c.c_int32,
                                        c.c_int32, i32p]
        lib.kz_text_inverse.restype = c.c_int64
        lib.kz_text_inverse.argtypes = [u8p, c.c_int64, u8p, c.c_int64,
                                        c.c_int32, c.c_int64, c.c_int32,
                                        c.c_int32]
        from ..transforms._text_dict import DICT_EN_1024
        d = np.frombuffer(DICT_EN_1024, dtype=np.uint8).copy()
        lib.kz_text_set_dict(as_u8p(d), d.size)


def _i32p(arr):
    import ctypes
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def suffix_array_native(src: np.ndarray):
    lib = _lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(src)
    sa = np.empty(src.size, dtype=np.int32)
    lib.kz_suffix_array(as_u8p(s), _i32p(sa), src.size)
    return sa


def bwt_forward_native(src: np.ndarray, chunks: int, jobs: int = 1):
    lib = _lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(src)
    dst = np.empty(src.size, dtype=np.uint8)
    indexes = np.zeros(8, dtype=np.int32)
    if jobs > 1 and hasattr(lib, "kz_bwt_forward_mt"):
        if not getattr(lib, "_bwt_mt_sig", False):
            import ctypes as c
            u8p = c.POINTER(c.c_uint8)
            lib.kz_bwt_forward_mt.restype = c.c_int64
            lib.kz_bwt_forward_mt.argtypes = [u8p, u8p, c.c_int64,
                                              c.POINTER(c.c_int32),
                                              c.c_int32, c.c_int32]
            lib._bwt_mt_sig = True
        lib.kz_bwt_forward_mt(as_u8p(s), as_u8p(dst), src.size,
                              _i32p(indexes), chunks, jobs)
    else:
        lib.kz_bwt_forward(as_u8p(s), as_u8p(dst), src.size,
                           _i32p(indexes), chunks)
    return dst, indexes[:chunks]


def bwt_inverse_native(src: np.ndarray, primary_indexes, chunks: int,
                       jobs: int = 0):
    lib = _lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(src)
    dst = np.empty(src.size, dtype=np.uint8)
    indexes = np.zeros(8, dtype=np.int32)
    indexes[:len(primary_indexes)] = primary_indexes
    if jobs <= 0:
        import os
        jobs = min(os.cpu_count() or 1, 8)
    ok = lib.kz_bwt_inverse_mt(as_u8p(s), as_u8p(dst), src.size,
                               _i32p(indexes), chunks, jobs)
    if not ok:
        raise ValueError("BWT inverse failed")
    return dst


def _padded(src: np.ndarray, pad: int = 16) -> np.ndarray:
    out = np.zeros(src.size + pad, dtype=np.uint8)
    out[:src.size] = src
    return out


def lzx_forward_native(src: np.ndarray, extra: bool, min_match: int):
    lib = _lib()
    if lib is None:
        return None
    s = _padded(np.ascontiguousarray(src))
    cap = src.size + (src.size >> 6) + 1024
    dst = np.empty(cap + 32, dtype=np.uint8)
    n = lib.kz_lzx_forward(as_u8p(s), src.size, as_u8p(dst), 1 if extra else 0, min_match)
    if n < 0:
        return np.zeros(0, dtype=np.uint8)  # no gain -> skip
    return dst[:n].copy()


def lzx_inverse_native(src: np.ndarray, count: int):
    lib = _lib()
    if lib is None:
        return None
    s = _padded(np.ascontiguousarray(src))
    dst = np.empty(count + 32, dtype=np.uint8)
    n = lib.kz_lzx_inverse(as_u8p(s), src.size, as_u8p(dst), count)
    if n < 0:
        raise ValueError("LZX inverse failed")
    return dst[:n].copy()


def lzp_forward_native(src: np.ndarray):
    lib = _lib()
    if lib is None:
        return None
    s = _padded(np.ascontiguousarray(src))
    cap = src.size + (src.size >> 6) + 1024
    dst = np.empty(cap + 32, dtype=np.uint8)
    n = lib.kz_lzp_forward(as_u8p(s), src.size, as_u8p(dst), cap)
    if n < 0:
        return np.zeros(0, dtype=np.uint8)
    return dst[:n].copy()


def text_forward_native(src: np.ndarray, codec_type: int, block_size: int,
                        extra: bool, magic_found: bool):
    import ctypes
    lib = _lib()
    if lib is None or not hasattr(lib, "kz_text_forward"):
        return None, None
    s = np.ascontiguousarray(src)
    dst = np.empty(src.size + 16, dtype=np.uint8)
    dt = ctypes.c_int32(0)
    n = lib.kz_text_forward(as_u8p(s), src.size, as_u8p(dst), src.size,
                            codec_type, block_size, 1 if extra else 0,
                            1 if magic_found else 0, ctypes.byref(dt))
    if n < 0:
        return None, int(dt.value)
    return dst[:n].copy(), int(dt.value)


def text_inverse_native(src: np.ndarray, codec_type: int, block_size: int,
                        extra: bool, count: int | None,
                        legacy: bool = False):
    lib = _lib()
    if lib is None or not hasattr(lib, "kz_text_inverse"):
        return None
    s = np.ascontiguousarray(src)
    # the decoder needs slack beyond the exact output size (mirrors the
    # reference's oversized block buffers)
    cap = (count + 1024) if count is not None else src.size * 8 + 1024
    while cap <= (1 << 30) + 2048:
        dst = np.empty(cap + 16, dtype=np.uint8)
        n = lib.kz_text_inverse(as_u8p(s), src.size, as_u8p(dst), cap,
                                codec_type, block_size, 1 if extra else 0,
                                1 if legacy else 0)
        if n >= 0:
            return dst[:n].copy()
        if count is not None:
            raise ValueError("TEXT inverse failed")
        cap *= 4
    raise ValueError("TEXT inverse failed")


def exe_forward_native(src: np.ndarray):
    import ctypes
    lib = _lib()
    if lib is None or not hasattr(lib, "kz_exe_forward"):
        return None, None
    if not getattr(lib, "_exe_sigs", False):
        c = ctypes
        u8p = c.POINTER(c.c_uint8)
        lib.kz_exe_forward.restype = c.c_int64
        lib.kz_exe_forward.argtypes = [u8p, c.c_int64, u8p, c.c_int64,
                                       c.POINTER(c.c_int32)]
        lib.kz_exe_inverse.restype = c.c_int64
        lib.kz_exe_inverse.argtypes = [u8p, c.c_int64, u8p, c.c_int64]
        lib._exe_sigs = True
    s = np.ascontiguousarray(src)
    cap = src.size + (src.size >> 3) + 64
    dst = np.empty(cap + 16, dtype=np.uint8)
    dt = ctypes.c_int32(-1)
    n = lib.kz_exe_forward(as_u8p(s), src.size, as_u8p(dst), cap, ctypes.byref(dt))
    dtv = int(dt.value) if dt.value >= 0 else None
    if n < 0:
        return None, dtv
    return dst[:n].copy(), dtv


def exe_inverse_native(src: np.ndarray, count: int | None):
    lib = _lib()
    if lib is None or not hasattr(lib, "kz_exe_inverse"):
        return None
    exe_forward_native(np.zeros(0, dtype=np.uint8))  # ensure signatures
    s = np.ascontiguousarray(src)
    cap = (count + 1024) if count is not None else src.size * 2 + 4096
    dst = np.empty(cap + 16, dtype=np.uint8)
    n = lib.kz_exe_inverse(as_u8p(s), src.size, as_u8p(dst), cap)
    if n < 0:
        raise ValueError("EXE inverse failed")
    return dst[:n].copy()


def lzp_inverse_native(src: np.ndarray, count: int):
    lib = _lib()
    if lib is None:
        return None
    s = _padded(np.ascontiguousarray(src))
    dst = np.empty(count + 32, dtype=np.uint8)
    n = lib.kz_lzp_inverse(as_u8p(s), src.size, as_u8p(dst), count)
    if n < 0:
        raise ValueError("LZP inverse failed")
    return dst[:n].copy()


def zrlt_forward_native(src: np.ndarray):
    """Native ZRLT forward; None = no library, False = stage would expand
    (the caller raises TransformSkip, matching the Python spec)."""
    lib = _lib()
    if lib is None or not hasattr(lib, "kz_zrlt_forward"):
        return None
    src = np.ascontiguousarray(src)
    dst = np.empty(src.size, dtype=np.uint8)
    n = lib.kz_zrlt_forward(as_u8p(src), src.size, as_u8p(dst), src.size)
    if n < 0:
        return False
    return dst[:n].copy()


def zrlt_inverse_native(src: np.ndarray, count: int | None):
    """Native ZRLT inverse; None = no library; raises on invalid stream.
    Works without a known output size: the kernel returns the total
    decoded length, so an undersized first buffer triggers one exact-size
    retry (mirrors the Python path's build-then-truncate semantics)."""
    lib = _lib()
    if lib is None or not hasattr(lib, "kz_zrlt_inverse"):
        return None
    src = np.ascontiguousarray(src)
    cap = (max(int(count), src.size) if count is not None
           else src.size * 4) + 64
    for _ in range(2):
        dst = np.empty(cap, dtype=np.uint8)
        n = lib.kz_zrlt_inverse(as_u8p(src), src.size, as_u8p(dst), cap)
        if n < 0:
            raise ValueError("ZRLT inverse: invalid stream")
        if n <= cap:
            return dst[:n]
        # undersized buffer: the kernel reports the true total but wrote
        # (correctly) only the first cap bytes.  With a known count the
        # prefix is all the caller keeps — truncate like the Python
        # build-then-truncate spec.  Without one, retry exactly, capped at
        # the format's 1 GiB block bound so a corrupt stream of
        # near-2^41-zero runs cannot drive a huge allocation.
        if count is not None:
            return dst
        if n > (1 << 30) + (1 << 16):
            raise ValueError("ZRLT inverse: output exceeds block bound")
        cap = n  # exact retry
    raise ValueError("ZRLT inverse: buffer sizing failed")


def sbrt_native(mode: int, src: np.ndarray, forward: bool):
    lib = _lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src)
    dst = np.empty(src.size, dtype=np.uint8)
    fn = lib.kz_sbrt_forward if forward else lib.kz_sbrt_inverse
    fn(as_u8p(src), as_u8p(dst), src.size, mode)
    return dst


def srt_forward_native(src: np.ndarray):
    lib = _lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src)
    cap = src.size + 1024
    dst = np.empty(cap, dtype=np.uint8)
    n = lib.kz_srt_forward(as_u8p(src), src.size, as_u8p(dst), cap)
    if n < 0:
        return None
    return dst[:n]


def srt_inverse_native(src: np.ndarray):
    lib = _lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src)
    cap = src.size
    dst = np.empty(max(cap, 1), dtype=np.uint8)
    n = lib.kz_srt_inverse(as_u8p(src), src.size, as_u8p(dst), cap)
    if n < 0:
        raise ValueError("SRT inverse failed")
    return dst[:n]
