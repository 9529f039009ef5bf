"""Alias codec (PACK / DNA): maps unused byte values to frequent digrams, or
bit-packs small alphabets.

Wire format re-derived from K/transform/AliasCodec.java:35-492:
  header byte n0:
    n0 >= 240 (i.e. 256-n0 symbols <= 16): small-alphabet bit packing —
      [n0][symbols][count&3 or count&1][remainder raw][packed 2- or 4-per-byte]
      (n0 == 255: [255][symbol][u32le count])
    else: digram aliasing — [n0][adjust flag][n0 x (hi, lo, alias)]
      [aliased stream][optional trailing byte]
Greedy digram substitution is resolved with vectorized pointer doubling.
"""

from __future__ import annotations

import numpy as np

from ..core.globals import DataType, detect_simple_type, histogram_order0
from ..core.types import TransformSkip

MIN_BLOCK_SIZE = 1024


def _orbit(next_pos: np.ndarray, start: int, limit: int) -> np.ndarray:
    """Positions visited iterating a strictly-increasing successor map from
    ``start`` while < ``limit``.  next_pos must have a fixpoint at its last
    index.  Pointer-doubling enumeration: O(n log n) gathers, no Python loop
    over positions."""
    acc = np.array([start], dtype=np.int64)
    j = next_pos
    while acc[-1] < limit:
        acc = np.concatenate([acc, j[acc]])
        if acc[-1] >= limit:
            break
        j = j[j]
    acc = acc[acc < limit]
    keep = np.ones(acc.size, dtype=bool)
    if acc.size > 1:
        keep[1:] = acc[1:] > acc[:-1]
    return acc[keep]


class AliasCodec:
    def __init__(self, ctx: dict | None = None, only_dna: bool = False, **kw) -> None:
        self.ctx = ctx
        self.only_dna = (ctx or {}).get("packOnlyDNA", only_dna)

    def max_encoded_len(self, src_len: int) -> int:
        return src_len + 1024

    def forward(self, src: np.ndarray) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        count = src.size
        if count < MIN_BLOCK_SIZE:
            raise TransformSkip("PACK: block too small")
        dt = DataType.UNDEFINED
        if self.ctx is not None:
            dt = self.ctx.get("dataType", DataType.UNDEFINED)
            if dt in (DataType.MULTIMEDIA, DataType.UTF8, DataType.EXE, DataType.BIN):
                raise TransformSkip("PACK: wrong data type")
            if self.only_dna and dt not in (DataType.UNDEFINED, DataType.DNA):
                raise TransformSkip("PACK: not DNA")
        freqs0 = histogram_order0(src)
        absent = np.flatnonzero(freqs0 == 0)
        n0 = absent.size
        if n0 < 16:
            raise TransformSkip("PACK: not enough free symbols")
        if dt == DataType.UNDEFINED:
            dt = detect_simple_type(count, freqs0)
            if self.ctx is not None and dt != DataType.UNDEFINED:
                self.ctx["dataType"] = dt
            if self.only_dna and dt != DataType.DNA:
                raise TransformSkip("PACK: not DNA")

        if n0 >= 240:
            return self._forward_small_alphabet(src, freqs0, n0)
        return self._forward_digram(src, freqs0, absent, n0)

    def _forward_small_alphabet(self, src: np.ndarray, freqs0, n0: int) -> np.ndarray:
        count = src.size
        out = bytearray([n0])
        if n0 == 255:
            out.append(int(src[0]))
            out += int(count).to_bytes(4, "little")
            return np.frombuffer(bytes(out), dtype=np.uint8).copy()
        present = np.flatnonzero(freqs0 != 0)
        map8 = np.zeros(256, dtype=np.uint8)
        map8[present] = np.arange(present.size, dtype=np.uint8)
        out += present.astype(np.uint8).tobytes()
        s = map8[src]
        if n0 >= 252:
            rem = count & 3
            out.append(rem)
            out += src[:rem].tobytes()
            q = s[rem:].reshape(-1, 4)
            packed = (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]
            out += packed.astype(np.uint8).tobytes()
        else:
            rem = count & 1
            out.append(rem)
            out += src[:rem].tobytes()
            q = s[rem:].reshape(-1, 2)
            packed = (q[:, 0] << 4) | q[:, 1]
            out += packed.astype(np.uint8).tobytes()
        res = np.frombuffer(bytes(out), dtype=np.uint8)
        if res.size >= count:
            raise TransformSkip("PACK: would expand")
        return res.copy()

    def _forward_digram(self, src: np.ndarray, freqs0, absent, n0: int) -> np.ndarray:
        count = src.size
        s = src.astype(np.int64)
        dig = (s[:-1] << 8) | s[1:]
        f1 = np.bincount(dig, minlength=65536)
        nz = np.flatnonzero(f1)
        if nz.size < n0:
            n0 = nz.size
            if n0 < 16:
                raise TransformSkip("PACK: not enough digrams")
        # top n0 digrams by (freq desc, value desc)
        order = np.lexsort((-nz, -f1[nz]))[:n0]
        top = nz[order]
        savings = int(f1[top].sum())
        if savings < count // 20:
            raise TransformSkip("PACK: not worth it")
        alias_of = np.full(65536, -1, dtype=np.int64)
        alias_of[top] = absent[:n0]

        out = bytearray([n0, 0])
        hdr = np.empty(3 * n0, dtype=np.uint8)
        hdr[0::3] = (top >> 8) & 0xFF
        hdr[1::3] = top & 0xFF
        hdr[2::3] = absent[:n0]
        out += hdr.tobytes()

        # greedy left-to-right walk with pointer doubling
        src_end = count - 1
        step = np.ones(count + 1, dtype=np.int64)
        aliased = alias_of[dig] >= 0
        step[:count - 1][aliased] = 2
        step[count] = 0  # fixpoint
        nxt = np.minimum(np.arange(count + 1, dtype=np.int64) + step, count)
        pos = _orbit(nxt, 0, src_end)
        emit_alias = np.zeros(count, dtype=bool)
        emit_alias[:-1] = aliased
        sel = emit_alias[pos]
        dig_pad = np.concatenate([dig, [0]])
        vals = np.where(sel, alias_of[dig_pad[pos]], s[pos])
        out += vals.astype(np.uint8).tobytes()
        # trailing byte if the walk stopped exactly at src_end
        final = int(pos[-1]) + (2 if emit_alias[pos[-1]] else 1) if pos.size else 0
        if final != src_end + 1:
            out[1] = 1
            out.append(int(src[src_end]))
        res = np.frombuffer(bytes(out), dtype=np.uint8)
        if res.size >= count:
            raise TransformSkip("PACK: would expand")
        return res.copy()

    def inverse(self, src: np.ndarray, count: int | None = None) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        n_in = src.size
        if n_in == 0:
            return src.copy()
        n = int(src[0])
        if n < 16:
            raise ValueError("PACK: invalid header")
        if n >= 240:
            return self._inverse_small(src, 256 - n, count)
        return self._inverse_digram(src, n, count)

    def _inverse_small(self, src: np.ndarray, n: int, count) -> np.ndarray:
        if n == 1:
            val = int(src[1])
            o_size = int.from_bytes(src[2:6].tobytes(), "little")
            return np.full(o_size, val, dtype=np.uint8)
        idx2symb = src[1:1 + n].astype(np.uint8)
        pos = 1 + n
        adjust = int(src[pos]); pos += 1
        if adjust >= 4:
            raise ValueError("PACK: invalid adjust")
        head = src[pos:pos + adjust]
        pos += adjust
        body = src[pos:].astype(np.int64)
        lut = np.zeros(256, dtype=np.uint8)
        lut[:len(idx2symb)] = idx2symb
        if n <= 4:
            a = lut[(body >> 6) & 3]
            b = lut[(body >> 4) & 3]
            c = lut[(body >> 2) & 3]
            d = lut[body & 3]
            out = np.stack([a, b, c, d], axis=1).reshape(-1).astype(np.uint8)
        else:
            a = lut[body >> 4]
            b = lut[body & 0x0F]
            out = np.stack([a, b], axis=1).reshape(-1).astype(np.uint8)
        res = np.concatenate([head, out])
        if count is not None and res.size > count:
            res = res[:count]
        return res

    def _inverse_digram(self, src: np.ndarray, n: int, count) -> np.ndarray:
        adjust = int(src[1])
        src_end = src.size - adjust
        pos = 2
        hdr = src[pos:pos + 3 * n].astype(np.int64)
        pos += 3 * n
        first = np.arange(256, dtype=np.int64)
        second = np.zeros(256, dtype=np.int64)
        length = np.ones(256, dtype=np.int64)
        al = hdr[2::3]
        first[al] = hdr[0::3]
        second[al] = hdr[1::3]
        length[al] = 2
        body = src[pos:src_end].astype(np.int64)
        ln = length[body]
        offs = np.concatenate([[0], np.cumsum(ln)[:-1]])
        total = int(ln.sum())
        out = np.zeros(total, dtype=np.uint8)
        out[offs] = first[body].astype(np.uint8)
        two = ln == 2
        out[offs[two] + 1] = second[body[two]].astype(np.uint8)
        if adjust:
            out = np.concatenate([out, src[src_end:src_end + 1]])
        if count is not None and out.size > count:
            out = out[:count]
        return out
