"""Bridges from the Python entropy coders to the C++ native kernels.

Each host coder's function returns False/None when the native library is
unavailable (or the coder state is not fresh), in which case the caller
falls back to the exact (slow) Python loop.  The native kernels produce
byte-identical streams to the Python spec; the block engine creates a fresh
coder per block, so the one-shot state assumption holds.  The ANS0 device
glue's parse and writer (``ans0_wire_native``, ``ans0_wire_write_native``)
have no Python loop: without the library they raise RuntimeError.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .native import as_u8p, get_lib

_FORCE_PY = bool(os.environ.get("KANZI_TPU_PURE_PY"))
# below this size the Python loop is fine and avoids ctypes overhead in tests
_MIN_NATIVE = 0


def _lib():
    if _FORCE_PY:
        return None
    lib = get_lib()
    if lib is None or not hasattr(lib, "kz_cm_encode"):
        return None
    return lib


def _run_encode(fn_args, block, bw) -> bool:
    """Shared native-encode helper: call fn, append bytes, mark disposed."""
    lib = _lib()
    if lib is None:
        return False
    fn, extra_args = fn_args
    src = np.ascontiguousarray(block)
    cap = block.size + (block.size >> 2) + 65536
    dst = np.empty(cap, dtype=np.uint8)
    n = fn(as_u8p(src), src.size, as_u8p(dst), cap, *extra_args)
    if n < 0:
        return False
    bw.write_bytes(dst[:n])
    return True


def _run_decode(fn, extra_args, count, br):
    lib = _lib()
    if lib is None:
        return None
    # hand the native decoder the remaining bytes; it reports consumption
    avail_bits = br.remaining
    nbytes = avail_bits >> 3
    pos = br.read_count
    src = br.read_bytes(nbytes)  # realigned copy
    br.seek(pos)
    src = np.ascontiguousarray(src)
    dst = np.empty(max(count, 1), dtype=np.uint8)
    consumed = ctypes.c_int64(0)
    n = fn(as_u8p(src), nbytes, as_u8p(dst), count, ctypes.byref(consumed), *extra_args)
    if n < 0:
        from ..core.errors import BitStreamError
        raise BitStreamError("native binary decode failed",
                             BitStreamError.INVALID_STREAM)
    br.seek(pos + int(consumed.value) * 8)
    return dst[:count]


# --- FPAQ -------------------------------------------------------------------

def fpaq_encode_native(enc, block, bw) -> bool:
    lib = _lib()
    if lib is None or block.size < _MIN_NATIVE:
        return False
    if _run_encode((lib.kz_fpaq_encode, ()), block, bw):
        enc._disposed = True
        return True
    return False


def fpaq_decode_native(dec, count, br):
    lib = _lib()
    if lib is None or count < _MIN_NATIVE:
        return None
    return _run_decode(lib.kz_fpaq_decode, (), count, br)


# --- ANS (order 0/1) ---------------------------------------------------------

def _ans_sigs(lib):
    if getattr(lib, "_ans_sigs", False):
        return True
    if not hasattr(lib, "kz_ans_encode"):
        return False
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    lib.kz_ans_encode.restype = c.c_int64
    lib.kz_ans_encode.argtypes = [u8p, c.c_int64, u8p, c.c_int64, c.c_int32,
                                  c.c_int64, c.c_int32]
    lib.kz_ans_decode.restype = c.c_int64
    lib.kz_ans_decode.argtypes = [u8p, c.c_int64, c.c_int64, u8p, c.c_int64,
                                  c.c_int32, c.c_int64]
    lib._ans_sigs = True
    return True


def ans_encode_native(block, bw, order: int, chunk_size: int, log_range: int) -> bool:
    from .native import as_u8p
    lib = _lib()
    if lib is None or not _ans_sigs(lib):
        return False
    src = np.ascontiguousarray(block)
    cap = block.size + (block.size >> 2) + 65536
    dst = np.zeros(cap, dtype=np.uint8)
    nbits = lib.kz_ans_encode(as_u8p(src), src.size, as_u8p(dst), cap, order,
                              chunk_size, log_range)
    if nbits < 0:
        return False
    bw.write_bytes(dst[:(nbits + 7) >> 3], nbits=int(nbits))
    return True


def ans_decode_native(count: int, br, order: int, chunk_size: int):
    from .native import as_u8p
    lib = _lib()
    if lib is None or not _ans_sigs(lib):
        return None
    dst = np.empty(max(count, 1), dtype=np.uint8)
    src = br._data
    consumed = lib.kz_ans_decode(as_u8p(np.ascontiguousarray(src)), br._nbits,
                                 br.read_count, as_u8p(dst), count, order,
                                 chunk_size)
    if consumed < 0:
        from ..core.errors import BitStreamError
        raise BitStreamError("native ANS decode failed", BitStreamError.INVALID_STREAM)
    br.seek(br.read_count + int(consumed))
    return dst[:count]


def _ans0_wire_lib():
    """The native library with hostsrc/ans0_wire.cpp's entry points typed;
    raises RuntimeError where it is unavailable."""
    lib = _lib()
    if lib is None or not hasattr(lib, "kz_ans0_wire_parse"):
        raise RuntimeError("the ANS0 device glue needs the port's native library "
                           "(kanzi_tpu_torch/_build/libkanzi_native.so, built from "
                           "hostsrc/ans0_wire.cpp), which is unavailable")
    if getattr(lib, "_ans0_wire_sigs", False):
        return lib
    c = ctypes
    u8p, i32p, i64p = c.POINTER(c.c_uint8), c.POINTER(c.c_int32), c.POINTER(c.c_int64)
    lib.kz_ans0_wire_parse.restype = c.c_int32
    lib.kz_ans0_wire_parse.argtypes = [u8p, c.c_int64, c.c_int64, c.c_int64, c.c_int32,
                                       c.c_int32, i32p, i32p, i32p, i64p, i32p, i64p,
                                       i32p, i64p]
    lib.kz_ans0_wire_gather.restype = None
    lib.kz_ans0_wire_gather.argtypes = [u8p, c.c_int64, i64p, i32p, c.c_int64, u8p]
    lib.kz_ans0_wire_write.restype = c.c_int64
    lib.kz_ans0_wire_write.argtypes = [i32p, i32p, c.POINTER(c.c_uint32),
                                       c.POINTER(c.c_uint16), c.c_int64, c.c_int64,
                                       c.c_int32, u8p, c.c_int64]
    lib._ans0_wire_sigs = True
    return lib


def ans0_wire_native(br, nfull: int, log_range: int, host_log_ranges: bool):
    """The headers of a block's ``nfull`` full order-0 chunks parsed from
    ``br`` in one native call (hostsrc/ans0_wire.cpp kz_ans0_wire_parse),
    and the rows' payloads gathered into one (n, p) uint8 buffer, p the
    longest payload rounded up to 16 bytes.  ``br`` is left after the parse.
    Returns (error code, row chunk indexes, freq, cum (n, 256) i32, states
    (n, 4) i64, lengths (n,) i32, payload, single (k, 2) i32 chunk indexes
    and symbols, the index of the chunk the host resumes at or -1); with a
    non-zero code the rest is what was parsed before the error."""
    lib = _ans0_wire_lib()
    c = ctypes
    i32p, i64p = c.POINTER(c.c_int32), c.POINTER(c.c_int64)
    data = np.ascontiguousarray(br._data)
    row_chunk = np.empty(nfull, dtype=np.int32)
    freq = np.empty((nfull, 256), dtype=np.int32)
    cum = np.empty((nfull, 256), dtype=np.int32)
    states = np.empty((nfull, 4), dtype=np.int64)
    lens = np.empty(nfull, dtype=np.int32)
    pay_bit = np.empty(nfull, dtype=np.int64)
    single = np.empty((nfull, 2), dtype=np.int32)
    info = np.zeros(4, dtype=np.int64)
    err = lib.kz_ans0_wire_parse(
        as_u8p(data), br._nbits, br.read_count, nfull, log_range,
        1 if host_log_ranges else 0, row_chunk.ctypes.data_as(i32p),
        freq.ctypes.data_as(i32p), cum.ctypes.data_as(i32p),
        states.ctypes.data_as(i64p), lens.ctypes.data_as(i32p),
        pay_bit.ctypes.data_as(i64p), single.ctypes.data_as(i32p),
        info.ctypes.data_as(i64p))
    n, k, resume, end = (int(v) for v in info)
    br.seek(end)
    lens = lens[:n]
    width = max(16, (int(lens.max(initial=0)) + 15) & ~15)
    pay = np.empty((n, width), dtype=np.uint8)
    if n and not err:
        lib.kz_ans0_wire_gather(as_u8p(data), n, pay_bit.ctypes.data_as(i64p),
                                lens.ctypes.data_as(i32p), width, as_u8p(pay))
    return (int(err), row_chunk[:n], freq[:n], cum[:n], states[:n], lens, pay,
            single[:k], resume)


def ans0_wire_write_native(freq, n_emit, states, payload, log_range: int):
    """The records of a block's full order-0 chunks from the device's rows
    (freq (n, 256), n_emit (n,), states (n, 4), payload (n, w) u16 with
    every n_emit in [0, w]), written in one native call
    (hostsrc/ans0_wire.cpp kz_ans0_wire_write): (packed bytes, bit count),
    bit for bit what kanzi_tpu's device glue (kanzi_tpu/ops/ans_block.py)
    writes."""
    lib = _ans0_wire_lib()
    c = ctypes
    freq = np.ascontiguousarray(freq, dtype=np.int32)
    n_emit = np.ascontiguousarray(n_emit, dtype=np.int32)
    states = np.ascontiguousarray(np.asarray(states).astype(np.uint32))
    payload = np.ascontiguousarray(payload, dtype=np.uint16)
    n, width = payload.shape
    if freq.shape != (n, 256) or n_emit.shape != (n,) or states.shape != (n, 4):
        raise ValueError(f"ANS0 rows of shapes {freq.shape}, {n_emit.shape}, "
                         f"{states.shape}, {payload.shape}")
    if n and not 0 <= int(n_emit.min()) <= int(n_emit.max()) <= width:
        raise ValueError(f"ANS0 payload lengths outside [0, {width}]")
    # the writer's bound a record: a header of at most 1,100 bytes, 21 of
    # size and states, the payload
    cap = n * 1200 + 2 * int(n_emit.sum()) + 16
    dst = np.empty(cap, dtype=np.uint8)
    nbits = lib.kz_ans0_wire_write(
        freq.ctypes.data_as(c.POINTER(c.c_int32)), n_emit.ctypes.data_as(c.POINTER(c.c_int32)),
        states.ctypes.data_as(c.POINTER(c.c_uint32)),
        payload.ctypes.data_as(c.POINTER(c.c_uint16)), n, width, log_range, as_u8p(dst), cap)
    if nbits < 0:
        raise RuntimeError("kz_ans0_wire_write: the records overran their buffer")
    return dst[:(nbits + 7) >> 3], int(nbits)


# --- CM / TPAQ (hooked via predictor attributes) ----------------------------

def cm_encode_native(enc, block, bw) -> bool:
    lib = _lib()
    if lib is None or block.size < _MIN_NATIVE:
        return False
    if _run_encode((lib.kz_cm_encode, ()), block, bw):
        enc._disposed = True
        return True
    return False


def cm_decode_native(dec, count, br):
    lib = _lib()
    if lib is None or count < _MIN_NATIVE:
        return None
    return _run_decode(lib.kz_cm_decode, (), count, br)


def tpaq_encode_native(enc, block, bw, extra: bool, block_size: int, size: int) -> bool:
    lib = _lib()
    if lib is None or block.size < _MIN_NATIVE:
        return False
    if _run_encode((lib.kz_tpaq_encode, (1 if extra else 0, block_size, size)), block, bw):
        enc._disposed = True
        return True
    return False


def tpaq_decode_native(dec, count, br, extra: bool, block_size: int, size: int):
    lib = _lib()
    if lib is None or count < _MIN_NATIVE:
        return None
    return _run_decode(lib.kz_tpaq_decode, (1 if extra else 0, block_size, size),
                       count, br)


_HUF_SIG = False


def huffman_decode_native(packed: np.ndarray, nbits: int, nsym: int,
                          sym_lut: np.ndarray, len_lut: np.ndarray):
    """Native canonical-Huffman stream decode (native/huffman.cpp
    kz_huffman_decode).  Returns (symbols u8[nsym], end_bit_pos) or None
    when the library is unavailable."""
    lib = _lib()
    if lib is None or not hasattr(lib, "kz_huffman_decode"):
        return None
    global _HUF_SIG
    import ctypes as c
    u8p = c.POINTER(c.c_uint8)
    if not _HUF_SIG:
        lib.kz_huffman_decode.restype = c.c_int64
        lib.kz_huffman_decode.argtypes = [u8p, c.c_int64, c.c_int64,
                                          u8p, u8p, u8p]
        _HUF_SIG = True

    def p(a):
        return a.ctypes.data_as(u8p)

    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    sl = np.ascontiguousarray(sym_lut, dtype=np.uint8)
    ll = np.ascontiguousarray(len_lut, dtype=np.uint8)
    out = np.empty(max(int(nsym), 1), dtype=np.uint8)
    end = lib.kz_huffman_decode(p(packed), int(nbits), int(nsym),
                                p(sl), p(ll), p(out))
    return out[:nsym], int(end)


_HUF_ENC_SIG = False


def huffman_block_encode_native(block: np.ndarray, chunk_size: int, bw):
    """Native whole-block Huffman encode (native/huffman.cpp
    kz_huffman_block_encode): per-chunk histogram, canonical table,
    alphabet + ExpGolomb length header and the 4 packed streams in one
    C++ call; appends (payload, nbits) to ``bw``.  Returns True when the
    native path ran, False to fall back."""
    lib = _lib()
    if lib is None or not hasattr(lib, "kz_huffman_block_encode"):
        return False
    global _HUF_ENC_SIG
    import ctypes as c
    u8p = c.POINTER(c.c_uint8)
    if not _HUF_ENC_SIG:
        lib.kz_huffman_block_encode.restype = c.c_int64
        lib.kz_huffman_block_encode.argtypes = [u8p, c.c_int64, c.c_int64,
                                                u8p, c.c_int64]
        _HUF_ENC_SIG = True
    src = np.ascontiguousarray(block)
    # worst case ~12 bits/symbol + per-chunk headers
    cap = block.size * 2 + (block.size // 1024 + 2) * 600 + 4096
    dst = np.zeros(cap, dtype=np.uint8)
    nbits = lib.kz_huffman_block_encode(as_u8p(src), src.size,
                                        int(chunk_size),
                                        dst.ctypes.data_as(u8p), cap)
    if nbits < 0:
        return False
    bw.write_bytes(dst[:(int(nbits) + 7) >> 3], nbits=int(nbits))
    return True


_HUF_BLK_SIG = False


def huffman_block_decode_native(br, count: int, chunk_size: int):
    """Native whole-block Huffman decode (native/huffman.cpp
    kz_huffman_block_decode): all chunk headers, canonical tables and the
    4 interleaved streams in one call, advancing ``br`` past the payload.
    Returns the decoded u8[count] or None when unavailable; raises
    BitStreamError / EOFError exactly like the Python per-chunk path."""
    lib = _lib()
    if lib is None or not hasattr(lib, "kz_huffman_block_decode"):
        return None
    global _HUF_BLK_SIG
    import ctypes as c
    u8p = c.POINTER(c.c_uint8)
    if not _HUF_BLK_SIG:
        lib.kz_huffman_block_decode.restype = c.c_int64
        lib.kz_huffman_block_decode.argtypes = [u8p, c.c_int64, c.c_int64,
                                                c.c_int64, c.c_int64, u8p]
        _HUF_BLK_SIG = True
    data = br._data
    # the 12-bit lookahead window needs 8 readable bytes past the payload
    pad = np.zeros(data.size + 8, dtype=np.uint8)
    pad[:data.size] = data
    out = np.empty(max(int(count), 1), dtype=np.uint8)
    end = lib.kz_huffman_block_decode(
        pad.ctypes.data_as(u8p), int(br._nbits), int(br.read_count),
        int(count), int(chunk_size), out.ctypes.data_as(u8p))
    if end == -3:
        raise EOFError("bitstream exhausted")
    if end < 0:
        from ..core.errors import BitStreamError
        raise BitStreamError(
            "Huffman stream length mismatch" if end == -2
            else "invalid Huffman table", BitStreamError.INVALID_STREAM)
    br.seek(int(end))
    return out[:count]
