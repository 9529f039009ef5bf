"""ROLZ codec (reduced-offset LZ) with embedded ANS streams.

Wire format re-derived from K/transform/ROLZCodec.java:45-1014 (ROLZCodec1):
  u32be original size | flags byte (bit0 literal order, bits1-3 data-type
  hints, bits4-7 logPosChecks) | per 16 MiB chunk an inner byte-aligned
  bitstream: 4 x u32 stream lengths, ANS(litOrder) literals, ANS(order 0,
  32 KiB chunks) tokens + match lengths + match indexes | 4 raw tail bytes.

Match finding/tokenizing runs in C++ (native/rolz.cpp); this layer owns the
framing and the embedded ANS coders.  ROLZX (ROLZCodec2, adaptive binary
coder) is not implemented yet — it declines so chains fall back gracefully.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..core.bits import BitReader, BitWriter
from ..core.globals import DataType, detect_simple_type, histogram_order0
from ..core.types import TransformSkip
from ..entropy.ans import ANSRangeDecoder, ANSRangeEncoder
from ..utils.native import as_u8p, get_lib

CHUNK_SIZE = 16 * 1024 * 1024
MIN_BLOCK_SIZE = 64
MAX_BLOCK_SIZE = 1 << 30
LOG_POS_CHECKS = 4
MIN_MATCH3, MIN_MATCH4, MIN_MATCH7 = 3, 4, 7


def _lib():
    lib = get_lib()
    if lib is None or not hasattr(lib, "kz_rolz1_forward_chunk"):
        return None
    if not getattr(lib, "_rolz_sigs", False):
        c = ctypes
        u8p = c.POINTER(c.c_uint8)
        i32p = c.POINTER(c.c_int32)
        i64p = c.POINTER(c.c_int64)
        lib.kz_rolz1_forward_chunk.restype = c.c_int32
        lib.kz_rolz1_forward_chunk.argtypes = [u8p, c.c_int64, c.c_int64, c.c_int64,
                                               c.c_int32, c.c_int32, c.c_int32,
                                               i32p, i32p, u8p, u8p, u8p, u8p, i64p]
        lib.kz_rolz1_inverse_chunk.restype = c.c_int32
        lib.kz_rolz1_inverse_chunk.argtypes = [u8p, c.c_int64, c.c_int64, c.c_int64,
                                               c.c_int32, c.c_int32, c.c_int32,
                                               i32p, i32p, u8p, c.c_int64, u8p,
                                               c.c_int64, u8p, c.c_int64, u8p,
                                               c.c_int64, c.c_int32]
        lib.kz_rolz2_forward.restype = c.c_int64
        lib.kz_rolz2_forward.argtypes = [u8p, c.c_int64, u8p, c.c_int64,
                                         c.c_int32, c.c_int32, c.c_int32]
        lib.kz_rolz2_inverse.restype = c.c_int64
        lib.kz_rolz2_inverse.argtypes = [u8p, c.c_int64, u8p, c.c_int64,
                                         c.c_int32, c.c_int32, c.c_int32]
        lib._rolz_sigs = True
    return lib


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class ROLZCodec:
    def __init__(self, ctx: dict | None = None, extra: bool = False) -> None:
        self.ctx = ctx
        self.extra = extra
        self.bs_version = (ctx or {}).get("bsVersion", 7)

    def max_encoded_len(self, src_len: int) -> int:
        return src_len + 64 if src_len <= 512 else src_len

    def forward(self, src: np.ndarray) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        count = src.size
        if count == 0:
            return src.copy()
        if count < MIN_BLOCK_SIZE or count > MAX_BLOCK_SIZE:
            raise TransformSkip("ROLZ: block size out of range")
        lib = _lib()
        if self.extra:
            return self._forward_x(src, lib)

        src_end = count - 4
        lit_order = 0 if count < (1 << 17) else 1
        flags = lit_order
        min_match, delta = MIN_MATCH3, 2
        dt = (self.ctx or {}).get("dataType", DataType.UNDEFINED)
        if self.ctx is not None and dt == DataType.UNDEFINED:
            dt = detect_simple_type(count, histogram_order0(src))
            if dt != DataType.UNDEFINED:
                self.ctx["dataType"] = dt
        if dt == DataType.EXE:
            delta, flags = 3, flags | 8
        elif dt == DataType.MULTIMEDIA:
            min_match, delta, flags = MIN_MATCH4, 8, flags | 2
        elif dt == DataType.DNA:
            min_match, delta, flags = MIN_MATCH7, 8, flags | 4
        flags |= LOG_POS_CHECKS << 4

        bw_total = bytearray()
        bw_total += int(count).to_bytes(4, "big")
        bw_total.append(flags)

        spad = np.zeros(count + 16, dtype=np.uint8)
        spad[:count] = src
        sbytes = spad.tobytes() if lib is None else None
        counters = np.zeros(65536, dtype=np.int32)
        matches = np.zeros(65536 << LOG_POS_CHECKS, dtype=np.int32)
        start = 0
        while start < src_end:
            end = min(start + CHUNK_SIZE, src_end)
            size_chunk = end - start
            if lib is not None:
                lit = np.empty(size_chunk + 64, dtype=np.uint8)
                tk = np.empty(size_chunk // 2 + 64, dtype=np.uint8)
                lenb = np.empty(size_chunk // 2 + 64, dtype=np.uint8)
                midx = np.empty(size_chunk // 2 + 64, dtype=np.uint8)
                lens = np.zeros(4, dtype=np.int64)
                lib.kz_rolz1_forward_chunk(
                    as_u8p(spad), start, end, src_end, min_match, delta,
                    LOG_POS_CHECKS, _i32p(counters), _i32p(matches),
                    as_u8p(lit), as_u8p(tk), as_u8p(lenb), as_u8p(midx),
                    lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
                nlit, ntk, nlen, nmidx = (int(x) for x in lens)
            else:
                # pure-Python spec (KANZI_TPU_NO_NATIVE=1): same tokens
                from ._rolz_py import rolz1_forward_chunk_py
                lit_b, tk_b, lenb_b, midx_b = rolz1_forward_chunk_py(
                    sbytes, start, end, src_end, min_match, delta,
                    LOG_POS_CHECKS, counters, matches)
                lit = np.frombuffer(bytes(lit_b), np.uint8)
                tk = np.frombuffer(bytes(tk_b), np.uint8)
                lenb = np.frombuffer(bytes(lenb_b), np.uint8)
                midx = np.frombuffer(bytes(midx_b), np.uint8)
                nlit, ntk, nlen, nmidx = (len(lit_b), len(tk_b),
                                          len(lenb_b), len(midx_b))
            bw = BitWriter()
            bw.write_bits(nlit, 32)
            bw.write_bits(ntk, 32)
            bw.write_bits(nlen, 32)
            bw.write_bits(nmidx, 32)
            lit_enc = ANSRangeEncoder(bw, lit_order)
            lit_enc.encode(lit[:nlit])
            m_enc = ANSRangeEncoder(bw, 0, 32768)
            m_enc.encode(tk[:ntk])
            m_enc.encode(lenb[:nlen])
            m_enc.encode(midx[:nmidx])
            bw_total += bw.getvalue()
            start = end

        bw_total += src[src_end:].tobytes()
        if len(bw_total) >= count:
            raise TransformSkip("ROLZ: would expand")
        return np.frombuffer(bytes(bw_total), dtype=np.uint8).copy()

    def _dt_params(self, src: np.ndarray, count: int, for_x: bool):
        """(min_match, delta, flags) from the detected data type."""
        min_match, delta, flags = MIN_MATCH3, 2, 0
        dt = (self.ctx or {}).get("dataType", DataType.UNDEFINED)
        if self.ctx is not None and dt == DataType.UNDEFINED:
            dt = detect_simple_type(count, histogram_order0(src))
            if dt != DataType.UNDEFINED:
                self.ctx["dataType"] = dt
        if dt == DataType.EXE:
            delta, flags = 3, 8
        elif dt == DataType.MULTIMEDIA and not for_x:
            min_match, delta, flags = MIN_MATCH4, 8, 2
        elif dt == DataType.DNA:
            min_match, delta, flags = MIN_MATCH7, 8, 4
        return min_match, delta, flags

    def _forward_x(self, src: np.ndarray, lib) -> np.ndarray:
        """ROLZX: adaptive binary range coder (ROLZCodec2)."""
        count = src.size
        min_match, delta, flags = self._dt_params(src, count, True)
        if lib is None:
            # pure-Python spec fallback (KANZI_TPU_NO_NATIVE=1)
            from ._rolz_py import rolz2_forward_py
            res = rolz2_forward_py(src, min_match, delta, flags)
            if res is None:
                raise TransformSkip("ROLZX: no gain")
            return res
        spad = np.zeros(count + 16, dtype=np.uint8)
        spad[:count] = src
        cap = count + (count >> 5) + 4096
        dst = np.zeros(cap + 16, dtype=np.uint8)
        n = lib.kz_rolz2_forward(as_u8p(spad), count, as_u8p(dst), cap,
                                 min_match, delta, flags)
        if n < 0:
            raise TransformSkip("ROLZX: no gain")
        return dst[:n].copy()

    def _inverse_x(self, src: np.ndarray, count, lib) -> np.ndarray:
        flags = int(src[4])
        min_match, delta = MIN_MATCH3, 2
        if self.bs_version >= 4:
            if (flags & 0x0E) == 8:
                delta = 3
            elif (flags & 0x0E) == 4:
                min_match, delta = MIN_MATCH7, 8
        elif self.bs_version >= 3 and flags == 1:
            min_match = MIN_MATCH7  # ROLZCodec.java:1328
        sz_block = int.from_bytes(src[0:4].tobytes(), "big")
        first_lits = 2 if self.bs_version < 3 else 8
        if lib is None:
            # pure-Python spec fallback (KANZI_TPU_NO_NATIVE=1)
            from ._rolz_py import rolz2_inverse_py
            res = rolz2_inverse_py(src, min_match, delta, first_lits)
        else:
            out = np.zeros(sz_block + 16, dtype=np.uint8)
            spad = np.zeros(src.size + 16, dtype=np.uint8)
            spad[:src.size] = src
            n = lib.kz_rolz2_inverse(as_u8p(spad), src.size, as_u8p(out),
                                     sz_block, min_match, delta, first_lits)
            if n < 0:
                raise ValueError("ROLZX inverse failed")
            res = out[:n]
        if count is not None and res.size > count:
            res = res[:count]
        return res.copy()

    def inverse(self, src: np.ndarray, count: int | None = None) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        if src.size == 0:
            return src.copy()
        lib = _lib()
        if self.extra:
            return self._inverse_x(src, count, lib)
        n_in = src.size
        sz_block = int.from_bytes(src[0:4].tobytes(), "big") - 4
        if sz_block <= 0 or sz_block > MAX_BLOCK_SIZE:
            raise ValueError("ROLZ: invalid block size")
        flags = int(src[4])
        lit_order = flags & 1
        log_pos_checks = flags >> 4
        if not 2 <= log_pos_checks <= 8:
            raise ValueError("ROLZ: invalid logPosChecks")
        min_match, delta = MIN_MATCH3, 2
        if self.bs_version >= 4:
            mode = flags & 0x0E
            if mode == 2:
                min_match, delta = MIN_MATCH4, 8
            elif mode == 4:
                min_match, delta = MIN_MATCH7, 8
            elif mode == 8:
                delta = 3
        elif self.bs_version >= 3:
            if (flags & 0x06) == 0x02:
                min_match = MIN_MATCH4  # ROLZCodec.java:762-766
            elif (flags & 0x06) == 0x04:
                min_match = MIN_MATCH7

        out = np.zeros(sz_block + 4 + 16, dtype=np.uint8)
        counters = np.zeros(65536, dtype=np.int32)
        matches = np.zeros(65536 << log_pos_checks, dtype=np.int32)
        src_idx = 5
        start = 0
        dst_end = sz_block
        while start < dst_end:
            end = min(start + CHUNK_SIZE, dst_end)
            size_chunk = end - start
            br = BitReader(src[src_idx:])
            nlit = br.read_bits(32)
            ntk = br.read_bits(32)
            nlen = br.read_bits(32)
            nmidx = br.read_bits(32)
            first_lit = 2 if self.bs_version < 3 else min(size_chunk, 8)
            if nlit < first_lit or nlit > size_chunk or \
                    (ntk == 0 and nmidx != 0) or \
                    (self.bs_version >= 6 and ntk > 0 and nmidx + 1 != ntk):
                raise ValueError("ROLZ: invalid stream lengths")
            lit_dec = ANSRangeDecoder(br, lit_order, bs_version=self.bs_version)
            lit = np.ascontiguousarray(lit_dec.decode(nlit))
            m_dec = ANSRangeDecoder(br, 0, 32768, bs_version=self.bs_version)
            tk = np.ascontiguousarray(m_dec.decode(ntk))
            lenb = np.ascontiguousarray(np.concatenate(
                [m_dec.decode(nlen), np.zeros(8, dtype=np.uint8)]))
            midx = np.ascontiguousarray(m_dec.decode(nmidx))
            src_idx += (br.read_count + 7) >> 3
            if ntk == 0:
                if nlit != size_chunk:
                    raise ValueError("ROLZ: literal chunk size mismatch")
                out[start:end] = lit[:size_chunk]
                start = end
                continue
            if lib is not None:
                rc = lib.kz_rolz1_inverse_chunk(
                    as_u8p(out), start, end, dst_end, min_match, delta,
                    log_pos_checks, _i32p(counters), _i32p(matches),
                    as_u8p(lit), nlit, as_u8p(tk), ntk, as_u8p(lenb), nlen,
                    as_u8p(midx), nmidx, first_lit)
            else:
                # pure-Python spec fallback (KANZI_TPU_NO_NATIVE=1)
                from ._rolz_py import rolz1_inverse_chunk_py
                rc = rolz1_inverse_chunk_py(
                    out, start, end, dst_end, min_match, delta,
                    log_pos_checks, counters, matches,
                    lit, nlit, tk, ntk, lenb, nlen, midx, nmidx,
                    first_lit)
            if rc != 0:
                raise ValueError(f"ROLZ: chunk decode failed ({rc})")
            start = end
        if n_in - src_idx != 4:
            raise ValueError("ROLZ: bad tail")
        out[dst_end:dst_end + 4] = src[src_idx:src_idx + 4]
        res = out[:sz_block + 4]
        if count is not None and res.size > count:
            res = res[:count]
        return res.copy()
