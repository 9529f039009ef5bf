"""UTF-8 codepoint aliasing codec.

Wire format re-derived from K/transform/UTFCodec.java:31-566:
  [start byte][overshoot byte][n hi][n lo][n x 3-byte packed symbols, by
  decreasing frequency][start raw bytes][aliases: 1 byte for rank < 128,
  2 bytes (0x80|lo7, hi) otherwise][trailing raw bytes]
Packed symbol: 3-bit size class << 19 | payload bits (see pack/unpack).

Fully vectorized: symbol-start detection, packing, alias assignment and
emission are numpy array ops (the TPU kernel shares this dataflow).
"""

from __future__ import annotations

import numpy as np

from ..core.globals import DataType
from ..core.types import TransformSkip

MIN_BLOCK_SIZE = 1024
# symbol length by top-4 bits of the first byte
SIZES = np.array([1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 2, 2, 3, 4], dtype=np.int64)


def _validate(block: np.ndarray) -> bool:
    """Statistical UTF-8 validation (UTFCodec.java:330-430 final rules)."""
    f0 = np.bincount(block, minlength=256).astype(np.int64)
    if int(f0[0xC0] + f0[0xC1] + f0[0xF5:0x100].sum()) != 0:
        return False
    prev = block[:-1].astype(np.int64)
    cur = block[1:].astype(np.int64)
    f1 = np.bincount(prev * 256 + cur, minlength=65536).reshape(256, 256)
    # first-position bigram: prv starts at 0
    if block.size:
        f1[0, block[0]] += 1
    cont = np.zeros(256, dtype=bool)
    cont[0x80:0xC0] = True
    s1 = 0
    s1 += int(f1[0xE0][~((np.arange(256) >= 0xA0) & (np.arange(256) <= 0xBF))].sum())
    s1 += int(f1[0xED][~((np.arange(256) >= 0x80) & (np.arange(256) <= 0x9F))].sum())
    s1 += int(f1[0xF0][~((np.arange(256) >= 0x90) & (np.arange(256) <= 0xBF))].sum())
    s1 += int(f1[0xF4][~((np.arange(256) >= 0x80) & (np.arange(256) <= 0x8F))].sum())
    rows = list(range(0xC2, 0xE0)) + list(range(0xE1, 0xED)) + [0xF1, 0xF2, 0xF3, 0xEE, 0xEF]
    s1 += int(f1[np.array(rows)][:, ~cont].sum())
    if s1 != 0:
        return False
    s2 = int(f0[cont].sum())
    return s2 >= block.size // 8


class UTFCodec:
    def __init__(self, ctx: dict | None = None, **kw) -> None:
        self.ctx = ctx
        self.bs_version = (ctx or {}).get("bsVersion", 7)

    def max_encoded_len(self, src_len: int) -> int:
        return src_len + 8192

    def forward(self, src: np.ndarray) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        count = src.size
        if count < MIN_BLOCK_SIZE:
            raise TransformSkip("UTF: block too small")
        must_validate = True
        if self.ctx is not None:
            dt = self.ctx.get("dataType", DataType.UNDEFINED)
            if dt not in (DataType.UNDEFINED, DataType.UTF8):
                raise TransformSkip("UTF: wrong data type")
            must_validate = dt != DataType.UTF8
        src_end = count - 4
        s64 = src.astype(np.int64)
        if src[0] == 0xEF and src[1] == 0xBB and src[2] == 0xBF:
            start = 3
        else:
            start = 0
            while start < 4 and SIZES[src[start] >> 4] == 0:
                start += 1
        if must_validate and not _validate(src[start:src_end]):
            raise TransformSkip("UTF: not valid UTF-8")
        if self.ctx is not None:
            self.ctx["dataType"] = DataType.UTF8

        # symbol starts: non-continuation bytes in [start, src_end)
        lens_by_first = SIZES[s64[start:src_end] >> 4]
        is_start = lens_by_first > 0
        starts = np.flatnonzero(is_start) + start
        if starts.size == 0:
            raise TransformSkip("UTF: no symbols")
        slen = SIZES[s64[starts] >> 4]
        # spans must tile the region exactly (detects orphan continuations)
        ends = starts + slen
        if np.any(ends[:-1] != starts[1:]):
            raise TransformSkip("UTF: invalid sequence")
        # allow the final symbol to overshoot past src_end (truncation)
        # validate continuation bytes for 3/4-byte sequences
        b = np.concatenate([s64, np.zeros(4, dtype=np.int64)])
        third_ok = (slen != 3) | ((b[starts + 2] >= 0x80) & (b[starts + 2] <= 0xBF))
        val2 = (b[starts + 2] << 8) | b[starts + 3]
        fourth_ok = (slen != 4) | ((val2 & 0xC0C0) == 0x8080)
        if not (np.all(third_ok) and np.all(fourth_ok)):
            raise TransformSkip("UTF: invalid sequence")

        # pack symbols
        packed = np.empty(starts.size, dtype=np.int64)
        m1 = slen == 1
        m2 = slen == 2
        m3 = slen == 3
        m4 = slen == 4
        packed[m1] = b[starts[m1]]
        packed[m2] = (1 << 19) | (b[starts[m2]] << 8) | b[starts[m2] + 1]
        packed[m3] = (2 << 19) | ((b[starts[m3]] & 0x0F) << 12) | \
                     ((b[starts[m3] + 1] & 0x3F) << 6) | (b[starts[m3] + 2] & 0x3F)
        packed[m4] = (4 << 19) | ((b[starts[m4]] & 0x07) << 18) | \
                     ((b[starts[m4] + 1] & 0x3F) << 12) | \
                     ((b[starts[m4] + 2] & 0x3F) << 6) | (b[starts[m4] + 3] & 0x3F)

        syms, inv, freqs = np.unique(packed, return_inverse=True, return_counts=True)
        n = syms.size
        max_target = count - count // 10
        if n == 0 or n >= 32768 or (3 * n + 6) >= max_target:
            raise TransformSkip("UTF: map too large")
        order = np.lexsort((-syms, -freqs))  # decreasing freq, ties decreasing sym
        rank_of = np.empty(n, dtype=np.int64)
        rank_of[order] = np.arange(n)
        ranks = rank_of[inv]  # alias rank per symbol occurrence

        estimate = 10 + int(freqs[order][:128].sum()) + \
            2 * int(freqs[order][128:].sum())
        if estimate >= max_target:
            raise TransformSkip("UTF: estimated expansion")

        # header + map
        out = bytearray()
        overshoot = int(ends[-1]) - src_end  # 0..3
        out.append(start)
        out.append(overshoot & 0xFF)
        out.append((n >> 8) & 0xFF)
        out.append(n & 0xFF)
        smap = syms[order]
        map_bytes = np.empty(3 * n, dtype=np.uint8)
        map_bytes[0::3] = (smap >> 16) & 0xFF
        map_bytes[1::3] = (smap >> 8) & 0xFF
        map_bytes[2::3] = smap & 0xFF
        out += map_bytes.tobytes()
        out += src[:start].tobytes()
        # aliases
        two = ranks >= 128
        lens = np.where(two, 2, 1)
        offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
        abuf = np.empty(int(lens.sum()), dtype=np.uint8)
        abuf[offs] = np.where(two, 0x80 | (ranks & 0x7F), ranks).astype(np.uint8)
        abuf[offs[two] + 1] = ((ranks[two] >> 7) & 0xFF).astype(np.uint8)
        out += abuf.tobytes()
        # trailing raw bytes from the overshoot point to the end
        out += src[src_end + overshoot:].tobytes()
        if len(out) >= max_target:
            raise TransformSkip("UTF: expanded")
        return np.frombuffer(bytes(out), dtype=np.uint8).copy()

    def inverse(self, src: np.ndarray, count: int | None = None) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        n_in = src.size
        if n_in < 4:
            raise ValueError("UTF: truncated")
        s = src.astype(np.int64)
        start = int(s[0]) & 0x03
        adjust = int(s[1]) & 0x03
        n = (int(s[2]) << 8) | int(s[3])
        src_end = n_in - 4 + adjust
        if n == 0 or n >= 32768 or 3 * n >= n_in:
            raise ValueError("UTF: invalid map size")
        pos = 4
        raw = s[pos:pos + 3 * n]
        packed = (raw[0::3] << 16) | (raw[1::3] << 8) | raw[2::3]
        pos += 3 * n
        if self.bs_version < 4:
            # V0 packing: size class in bits 21-22 (UTFCodec.java:468-496)
            cls = (packed >> 21) + 1
            c0, c1, c2, c4 = cls == 1, cls == 2, cls == 3, cls == 4
            bad = cls > 4
        else:
            # V1 packing: size class in bits 19-21
            cls = packed >> 19
            c0, c1, c2, c4 = cls == 0, cls == 1, cls == 2, cls >= 4
            bad = cls == 3
        length = np.zeros(n, dtype=np.int64)
        value = np.zeros(n, dtype=np.int64)
        length[c0] = 1
        value[c0] = packed[c0]
        length[c1] = 2
        value[c1] = ((packed[c1] & 0xFF) << 8) | ((packed[c1] >> 8) & 0xFF)
        length[c2] = 3
        value[c2] = (((packed[c2] >> 12) & 0x0F) | 0xE0) | \
                    ((((packed[c2] >> 6) & 0x3F) | 0x80) << 8) | \
                    (((packed[c2] & 0x3F) | 0x80) << 16)
        length[c4] = 4
        value[c4] = (((packed[c4] >> 18) & 0x07) | 0xF0) | \
                    ((((packed[c4] >> 12) & 0x3F) | 0x80) << 8) | \
                    ((((packed[c4] >> 6) & 0x3F) | 0x80) << 16) | \
                    (((packed[c4] & 0x3F) | 0x80) << 24)
        if np.any(length == 0) or np.any(bad):
            raise ValueError("UTF: invalid packed symbol")

        head = src[pos:pos + start]
        pos += start
        # alias stream token resolution (first byte >= 0x80 consumes one more)
        astream = s[pos:src_end]
        hi = astream >= 0x80
        consumed = np.zeros(astream.size + 1, dtype=bool)
        hib = hi.astype(np.int8)
        change = np.flatnonzero(hib[1:] != hib[:-1]) + 1
        rstarts = np.concatenate([[0], change])
        rends = np.concatenate([change, [astream.size]])
        for st, en in zip(rstarts.tolist(), rends.tolist()):
            if hi[st]:
                consumed[st + 1:en + 1:2] = True
        consumed = consumed[:astream.size]
        tok = np.flatnonzero(~consumed)
        first = astream[tok]
        second = astream[np.minimum(tok + 1, astream.size - 1)]
        alias = np.where(first >= 128, (second << 7) + (first & 0x7F), first)
        if np.any(alias >= n):
            raise ValueError("UTF: alias out of range")
        vlen = length[alias]
        vval = value[alias]
        offs = np.concatenate([[0], np.cumsum(vlen)[:-1]])
        total = int(vlen.sum())
        body = np.zeros(total, dtype=np.uint8)
        for k, m in [(0, vlen >= 1), (1, vlen >= 2), (2, vlen >= 3), (3, vlen >= 4)]:
            body[offs[m] + k] = ((vval[m] >> (8 * k)) & 0xFF).astype(np.uint8)
        tail = src[src_end:]
        out = np.concatenate([head, body, tail])
        if count is not None and out.size > count:
            out = out[:count]
        return out
