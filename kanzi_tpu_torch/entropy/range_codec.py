"""Static order-0 range coder (Subbotin style, 64-bit low/range).

Wire format re-derived from K/entropy/RangeEncoder.java:45-349 and
RangeDecoder.java:45-345:

  per 32 KiB chunk: alphabet, 3-bit logRange-8 (lowered for small chunks),
  grouped frequencies (same scheme as ANS but alphabet precedes logRange),
  then the arithmetic payload; 'low' is flushed as 60 bits at chunk end.
  Carry-less: when the top 28 bits of low and low+range agree they are
  emitted; if range dips below 2^16 it is clamped to -low & 0xFFFF.

This is a rare path (only selected via -e RANGE); the implementation favors
clarity over speed (per-byte Python loop).
"""

from __future__ import annotations

import numpy as np

from ..core.bits import BitReader, BitWriter
from ..core.errors import BitStreamError
from . import utils as eu

TOP_RANGE = 0x0FFFFFFFFFFFFFFF
BOTTOM_RANGE = 0x000000000000FFFF
RANGE_MASK = 0x0FFFFFFF00000000
DEFAULT_CHUNK_SIZE = 1 << 15
DEFAULT_LOG_RANGE = 12
MAX_CHUNK_SIZE = 1 << 30
_M64 = (1 << 64) - 1


def _write_freqs_header(bw: BitWriter, alphabet: np.ndarray, freqs: np.ndarray,
                        lr: int) -> None:
    eu.encode_alphabet(bw, alphabet)
    count = len(alphabet)
    if count == 0:
        return
    bw.write_bits(lr - 8, 3)
    chk = 8 if count >= 64 else 6
    llr = 3
    while (1 << llr) <= lr:
        llr += 1
    f = freqs[alphabet].astype(np.int64)
    i = 1
    while i < count:
        endj = min(i + chk, count)
        grp = f[i:endj] - 1
        log_max = int(grp.max()).bit_length() if grp.size else 0
        bw.write_bits(log_max, llr)
        if log_max > 0:
            bw.write_bits_vec(grp.astype(np.uint64),
                              np.full(grp.size, log_max, dtype=np.int64))
        i = endj


class RangeEncoder:
    def __init__(self, bw: BitWriter, chunk_size: int = DEFAULT_CHUNK_SIZE,
                 log_range: int = DEFAULT_LOG_RANGE) -> None:
        if not 1024 <= chunk_size <= MAX_CHUNK_SIZE:
            raise ValueError("invalid Range chunk size")
        if not 8 <= log_range <= 15:
            raise ValueError("invalid Range log range")
        self.bw = bw
        self.chunk_size = chunk_size
        self.log_range = log_range

    def encode(self, block: np.ndarray, bw: BitWriter | None = None) -> int:
        bw = bw or self.bw
        block = np.asarray(block, dtype=np.uint8)
        count = block.size
        start = 0
        while start < count:
            end = min(start + self.chunk_size, count)
            self._encode_chunk(block[start:end], bw)
            start = end
        return count

    def _encode_chunk(self, seg: np.ndarray, bw: BitWriter) -> None:
        lr = self.log_range
        while lr > 8 and (1 << lr) > seg.size:
            lr -= 1
        freqs = np.bincount(seg, minlength=256).astype(np.int64)
        alphabet = eu.normalize_frequencies(freqs, seg.size, 1 << lr)
        _write_freqs_header(bw, alphabet, freqs, lr)
        if len(alphabet) <= 1:
            return
        cum = [0] * 257
        for i in range(256):
            cum[i + 1] = cum[i] + int(freqs[i])
        low = 0
        rng = TOP_RANGE
        out_vals: list[int] = []
        for b in seg.tolist():
            cf = cum[b]
            fr = cum[b + 1] - cf
            rng >>= lr
            low = (low + cf * rng) & _M64
            rng = (rng * fr) & _M64
            while True:
                if ((low ^ (low + rng)) & RANGE_MASK) != 0:
                    if rng > BOTTOM_RANGE:
                        break
                    rng = (-low) & BOTTOM_RANGE
                out_vals.append((low >> 32) & ((1 << 28) - 1))
                rng = (rng << 28) & _M64
                low = (low << 28) & _M64
        if out_vals:
            bw.write_bits_vec(np.array(out_vals, dtype=np.uint64),
                              np.full(len(out_vals), 28, dtype=np.int64))
        bw.write_bits(low & ((1 << 60) - 1), 60)

    def dispose(self) -> None:
        pass


class RangeDecoder:
    def __init__(self, br: BitReader, chunk_size: int = DEFAULT_CHUNK_SIZE) -> None:
        if not 1024 <= chunk_size <= MAX_CHUNK_SIZE:
            raise ValueError("invalid Range chunk size")
        self.br = br
        self.chunk_size = chunk_size

    def decode(self, count: int, br: BitReader | None = None) -> np.ndarray:
        br = br or self.br
        out = np.empty(count, dtype=np.uint8)
        start = 0
        while start < count:
            end = min(start + self.chunk_size, count)
            self._decode_chunk(out, start, end, br)
            start = end
        return out

    def _decode_chunk(self, out: np.ndarray, start: int, end: int,
                      br: BitReader) -> None:
        alphabet = eu.decode_alphabet(br)
        count = len(alphabet)
        if count == 0:
            raise BitStreamError("empty Range alphabet", BitStreamError.INVALID_STREAM)
        freqs = np.zeros(256, dtype=np.int64)
        lr = 8 + br.read_bits(3)
        if not 8 <= lr <= 15:
            raise BitStreamError("invalid Range logRange", BitStreamError.INVALID_STREAM)
        if count == 1:
            out[start:end] = alphabet[0]
            return
        scale = 1 << lr
        chk = 8 if count >= 64 else 6
        llr = 3
        while (1 << llr) <= lr:
            llr += 1
        total = 0
        i = 1
        while i < count:
            log_max = br.read_bits(llr)
            if (1 << log_max) > scale:
                raise BitStreamError("invalid Range freq size", BitStreamError.INVALID_STREAM)
            endj = min(i + chk, count)
            if log_max == 0:
                vals = np.ones(endj - i, dtype=np.int64)
            else:
                vals = br.read_bits_vec(np.full(endj - i, log_max, dtype=np.int64)).astype(np.int64) + 1
            if np.any(vals <= 0) or np.any(vals >= scale):
                raise BitStreamError("invalid Range frequency", BitStreamError.INVALID_STREAM)
            freqs[alphabet[i:endj]] = vals
            total += int(vals.sum())
            i = endj
        if scale <= total:
            raise BitStreamError("invalid Range frequencies", BitStreamError.INVALID_STREAM)
        freqs[alphabet[0]] = scale - total
        cum = [0] * 257
        for k in range(256):
            cum[k + 1] = cum[k] + int(freqs[k])
        f2s = np.repeat(np.arange(256, dtype=np.int64), freqs).tolist()
        cumf = cum

        low = 0
        rng = TOP_RANGE
        code = br.read_bits(60)
        res = out[start:end]
        for i in range(end - start):
            rng >>= lr
            cnt = ((code - low) & _M64) // rng
            sym = f2s[cnt]
            cf = cumf[sym]
            fr = cumf[sym + 1] - cf
            low = (low + cf * rng) & _M64
            rng = (rng * fr) & _M64
            while True:
                if ((low ^ (low + rng)) & RANGE_MASK) != 0:
                    if rng > BOTTOM_RANGE:
                        break
                    rng = (-low) & BOTTOM_RANGE
                code = ((code << 28) | br.read_bits(28)) & _M64
                rng = (rng << 28) & _M64
                low = (low << 28) & _M64
            res[i] = sym
        out[start:end] = res

    def dispose(self) -> None:
        pass
