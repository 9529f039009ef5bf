"""rANS range codec (order 0 and order 1), 4 interleaved states per chunk.

Wire format re-derived from K/entropy/ANSRangeEncoder.java:37-498 and
ANSRangeDecoder.java:100-581:

  block: if count <= 32 raw bytes, else chunks of
    chunk_size (order0: 16 KiB default; order1: << 8, capped at 1<<27)
  per chunk:
    3 bits: logRange - 8   (order0: 12, order1: 11 by default)
    per context (1 for order0, 256 for order1):
      alphabet (EntropyUtils format)
      freqs-1 of alphabet[1:], in groups of 6 (or 8 if alphabet >= 64),
      each group prefixed by ceil(log2(logRange+1))-bit logMax;
      first frequency is inferred (scale - sum)
    [chunk skipped entirely after header if order0 and alphabet <= 1]
    varint: payload byte count
    4 x 32-bit final ANS states (st0..st3)
    payload: renorm byte pairs (hi,lo per emission) followed by the
    (chunk % 4) leftover raw bytes

  states start at ANS_TOP = 1<<15; symbol s with (freq, cum) under scale
  M = 1<<logRange advances st -> (st/freq)<<logRange + st%freq + cum after
  emitting the low 16 bits of st when st >= ((ANS_TOP>>logRange)<<16)*freq.
  Lane j encodes positions j' = 3-j (mod 4) (order0) or quarter j (order1,
  context = previous byte, first byte of each quarter under context 0 —
  the histogram applies the same context reset at quarter starts).

The implementation is two-pass and array-oriented: a vectorized scan over
all chunks at once computes states and emission flags, then prefix sums place
the emitted byte pairs.

``device``: None is the host path (native C++, else numpy); a torch device
runs, through ops/ans_block.py, the order-0 encode (default chunk size and
log range) and decode (default chunk size) of a block of at least four full
16 KiB chunks, and the order-1 encode of a block of at least one full 4 MiB
chunk (default chunk size and log range), on the CUDA kernels (``cuda``) or
their plain PyTorch versions (``cpu``); the minimums are the reference's.
Every other case is the host path whatever the device; order 1 decodes on
the host, as in the reference, which has no device decoder for it.
"""

from __future__ import annotations

import numpy as np

from ..core.bits import BitReader, BitWriter
from ..core.errors import BitStreamError
from . import utils as eu

ANS_TOP = 1 << 15
DEFAULT_ANS0_CHUNK_SIZE = 16384
DEFAULT_LOG_RANGE = 12
MIN_CHUNK_SIZE = 1024
MAX_CHUNK_SIZE = 1 << 27


def _order1_histogram(seg: np.ndarray) -> np.ndarray:
    """(256,256) context histogram with context reset to 0 at the 4 quarter
    starts (mirrors rebuildStatistics's 4x computeHistogramOrder1 calls)."""
    n = seg.size
    q = n >> 2
    prev = np.empty(n, dtype=np.int64)
    prev[1:] = seg[:-1]
    prev[0] = 0
    if q > 0:
        prev[[q, 2 * q, 3 * q]] = 0
    idx = prev * 256 + seg
    return np.bincount(idx, minlength=65536).reshape(256, 256)


def _write_freqs_header(bw: BitWriter, alphabet: np.ndarray, freqs: np.ndarray,
                        log_range: int) -> None:
    """Alphabet + grouped frequencies (ANSRangeEncoder.encodeHeader)."""
    eu.encode_alphabet(bw, alphabet)
    count = len(alphabet)
    if count <= 1:
        return
    chk = 8 if count >= 64 else 6
    llr = 3
    while (1 << llr) <= log_range:
        llr += 1
    f = freqs[alphabet].astype(np.int64)
    i = 1
    while i < count:
        endj = min(i + chk, count)
        grp = f[i:endj] - 1
        log_max = int(grp.max()).bit_length()
        bw.write_bits(log_max, llr)
        if log_max > 0:
            bw.write_bits_vec(grp.astype(np.uint64),
                              np.full(grp.size, log_max, dtype=np.int64))
        i = endj


def _read_freqs_header(br: BitReader, log_range: int) -> tuple[np.ndarray, np.ndarray]:
    """Returns (alphabet, freqs[256]) for one context."""
    scale = 1 << log_range
    alphabet = eu.decode_alphabet(br)
    count = len(alphabet)
    freqs = np.zeros(256, dtype=np.int64)
    if count == 0:
        return alphabet, freqs
    if count == 1:
        freqs[alphabet[0]] = scale
        return alphabet, freqs
    chk = 8 if count >= 64 else 6
    llr = 3
    while (1 << llr) <= log_range:
        llr += 1
    total = 0
    i = 1
    while i < count:
        log_max = br.read_bits(llr)
        if (1 << log_max) > scale:
            raise BitStreamError("invalid ANS frequency size", BitStreamError.INVALID_STREAM)
        endj = min(i + chk, count)
        if log_max == 0:
            vals = np.ones(endj - i, dtype=np.int64)
        else:
            vals = br.read_bits_vec(np.full(endj - i, log_max, dtype=np.int64)).astype(np.int64) + 1
        if np.any(vals <= 0) or np.any(vals >= scale):
            raise BitStreamError("invalid ANS frequency", BitStreamError.INVALID_STREAM)
        freqs[alphabet[i:endj]] = vals
        total += int(vals.sum())
        i = endj
    if scale <= total:
        raise BitStreamError("invalid ANS frequencies", BitStreamError.INVALID_STREAM)
    freqs[alphabet[0]] = scale - total
    return alphabet, freqs


def _lane_layout_order0(seg: np.ndarray) -> np.ndarray:
    """(steps, 4) symbol matrix in scan order: step t, lane j encodes
    seg[4*(q-1-t) + 3-j]."""
    q = seg.size >> 2
    g = seg[:4 * q].reshape(q, 4)
    return g[::-1, ::-1]


def _lane_layout_order1(seg: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(steps, 4) symbols + contexts for order 1 (lane j = quarter j,
    backward, final step has context 0)."""
    q = seg.size >> 2
    g = seg[:4 * q].reshape(4, q)
    syms = g[:, ::-1].T  # (q, 4): step t, lane j -> g[j, q-1-t]
    ctxs = np.zeros((q, 4), dtype=seg.dtype)
    if q > 1:
        ctxs[:q - 1] = g[:, ::-1].T[1:]  # context = preceding byte
    return syms, ctxs


class ANSRangeEncoder:
    def __init__(self, bw: BitWriter, order: int = 0,
                 chunk_size: int = DEFAULT_ANS0_CHUNK_SIZE,
                 log_range: int = DEFAULT_LOG_RANGE,
                 ctx: dict | None = None, *, device=None) -> None:
        self._ctx = ctx
        self.device = device
        if order not in (0, 1):
            raise ValueError("ANS order must be 0 or 1")
        if not MIN_CHUNK_SIZE <= chunk_size <= MAX_CHUNK_SIZE:
            raise ValueError("invalid ANS chunk size")
        if not 8 <= log_range <= 15:
            raise ValueError("invalid ANS log range")
        self.bw = bw
        self.order = order
        self._chunk_size0 = chunk_size
        self._log_range0 = log_range
        self.log_range = log_range if order == 0 else max(log_range - 1, 8)
        self.chunk_size = min(chunk_size << (8 * order), MAX_CHUNK_SIZE)

    def encode(self, block: np.ndarray, bw: BitWriter | None = None) -> int:
        bw = bw or self.bw
        block = np.asarray(block, dtype=np.uint8)
        count = block.size
        if (self.device is not None
                and self._chunk_size0 == DEFAULT_ANS0_CHUNK_SIZE
                and self._log_range0 == DEFAULT_LOG_RANGE
                and count >= (self.chunk_size if self.order else 4 * self.chunk_size)):
            from ..ops import ans_block
            if self.order == 0:
                return ans_block.ans0_encode(block, bw, self.device)
            return ans_block.ans1_encode(block, bw, self.device)
        from ..utils.native_coders import ans_encode_native
        if ans_encode_native(block, bw, self.order, self._chunk_size0,
                             self._log_range0):
            return count
        if count <= 32:
            bw.write_bytes(block.tobytes())
            return count
        start = 0
        while start < count:
            end = min(start + self.chunk_size, count)
            self._encode_chunk(block[start:end], bw)
            start = end
        return count

    def _encode_chunk(self, seg: np.ndarray, bw: BitWriter) -> None:
        lr = self.log_range
        scale = 1 << lr
        seg64 = seg.astype(np.int64)
        bw.write_bits(lr - 8, 3)

        if self.order == 0:
            hist = np.bincount(seg, minlength=256).astype(np.int64)
            alphabet = eu.normalize_frequencies(hist, seg.size, scale)
            _write_freqs_header(bw, alphabet, hist, lr)
            if len(alphabet) <= 1:
                return  # chunk skipped (decoder fills with single symbol)
            freq_tab = hist[None, :]  # (1, 256)
        else:
            q4 = seg.size & ~3
            hist2 = _order1_histogram(seg64[:q4]) if q4 > 0 else np.zeros((256, 256), dtype=np.int64)
            freq_tab = np.zeros((256, 256), dtype=np.int64)
            for k in range(256):
                total = int(hist2[k].sum())
                fk = hist2[k].copy()
                alpha = eu.normalize_frequencies(fk, total, scale)
                _write_freqs_header(bw, alpha, fk, lr)
                freq_tab[k] = fk

        cum_tab = np.concatenate([np.zeros((freq_tab.shape[0], 1), dtype=np.int64),
                                  np.cumsum(freq_tab, axis=1)[:, :-1]], axis=1)
        freq_cap = np.minimum(freq_tab, scale - 1)  # mirror Symbol.reset cap
        q = seg.size >> 2

        if self.order == 0:
            syms = _lane_layout_order0(seg64)            # (q, 4)
            ctxs = np.zeros_like(syms)
        else:
            syms, ctxs = _lane_layout_order1(seg64)

        st = np.full(4, ANS_TOP, dtype=np.int64)
        emit_vals = np.zeros((q, 4), dtype=np.uint16)
        emit_flags = np.zeros((q, 4), dtype=bool)
        top_shift = (ANS_TOP >> lr) << 16
        for t in range(q):
            f = freq_cap[ctxs[t], syms[t]]
            c = cum_tab[ctxs[t], syms[t]]
            xmax = top_shift * f
            em = st >= xmax
            emit_flags[t] = em
            emit_vals[t] = (st & 0xFFFF).astype(np.uint16)
            st = np.where(em, st >> 16, st)
            st = ((st // f) << lr) + (st % f) + c

        # forward payload: reverse scan order, lanes 3..0 within a step
        flags_fwd = emit_flags[::-1, ::-1].ravel()
        vals_fwd = emit_vals[::-1, ::-1].ravel()[flags_fwd]
        payload = vals_fwd.astype(">u2").tobytes() + seg[4 * q:].tobytes()

        eu.write_varint(bw, len(payload))
        for j in range(4):
            bw.write_bits(int(st[j]), 32)
        bw.write_bytes(payload)

    def dispose(self) -> None:
        pass


class ANSRangeDecoder:
    def __init__(self, br: BitReader, order: int = 0,
                 chunk_size: int = DEFAULT_ANS0_CHUNK_SIZE,
                 bs_version: int = 7, ctx: dict | None = None, *,
                 device=None) -> None:
        if order not in (0, 1):
            raise ValueError("ANS order must be 0 or 1")
        self._ctx = ctx
        self.device = device
        self.br = br
        self.order = order
        self.bs_version = bs_version
        if bs_version < 4:  # fixed 32 KiB chunks before bitstream v4
            chunk_size = 32768  # ANSRangeDecoder.java:130
        self._chunk_size0 = chunk_size
        self.chunk_size = min(chunk_size << (8 * order), MAX_CHUNK_SIZE)

    def decode(self, count: int, br: BitReader | None = None) -> np.ndarray:
        br = br or self.br
        if (self.device is not None and self.order == 0 and self.bs_version >= 4
                and self._chunk_size0 == DEFAULT_ANS0_CHUNK_SIZE
                and count >= 4 * self._chunk_size0):
            from ..ops import ans_block
            return ans_block.ans0_decode(count, br, self.device)
        if self.bs_version >= 4:
            from ..utils.native_coders import ans_decode_native
            res = ans_decode_native(count, br, self.order, self._chunk_size0)
            if res is not None:
                return res
        if count <= 32:
            return br.read_bytes(count)
        out = np.empty(count, dtype=np.uint8)
        start = 0
        while start < count:
            end = min(start + self.chunk_size, count)
            self._decode_chunk(out, start, end, br)
            start = end
        return out

    def _decode_chunk(self, out: np.ndarray, start: int, end: int,
                      br: BitReader, lr: int | None = None) -> None:
        if lr is None:
            lr = 8 + br.read_bits(3)
        if not 8 <= lr <= 15:
            raise BitStreamError("invalid ANS range", BitStreamError.INVALID_STREAM)
        scale = 1 << lr
        dim = 256 if self.order == 1 else 1
        freq_tab = np.zeros((dim, 256), dtype=np.int64)
        total_alpha = 0
        single_sym = -1
        for k in range(dim):
            alpha, fr = _read_freqs_header(br, lr)
            freq_tab[k] = fr
            total_alpha += len(alpha)
            if k == 0 and len(alpha) == 1:
                single_sym = int(alpha[0])
        if total_alpha == 0:
            raise BitStreamError("empty ANS alphabet", BitStreamError.INVALID_STREAM)
        if self.order == 0 and total_alpha == 1:
            out[start:end] = single_sym
            return

        cum_tab = np.concatenate([np.zeros((dim, 1), dtype=np.int64),
                                  np.cumsum(freq_tab, axis=1)[:, :-1]], axis=1)
        freq_cap = np.minimum(freq_tab, scale - 1)
        # freq -> symbol LUT per context
        f2s = np.zeros((dim, scale), dtype=np.int64)
        for k in range(dim):
            f2s[k] = np.repeat(np.arange(256), freq_tab[k]) if freq_tab[k].sum() == scale \
                else _fill_f2s(freq_tab[k], scale)

        if self.bs_version == 1:
            self._decode_chunk_v1(out, start, end, br, lr, f2s, freq_cap,
                                  cum_tab)
            return

        sz = eu.read_varint(br)
        if sz >= MAX_CHUNK_SIZE:
            raise BitStreamError("invalid ANS chunk size", BitStreamError.INVALID_STREAM)
        st = np.array([br.read_bits(32) for _ in range(4)], dtype=np.int64)
        buf = br.read_bytes(sz)
        buf = np.concatenate([buf, np.zeros(8, dtype=np.uint8)]).astype(np.int64)

        n = end - start
        n4 = n & ~3
        q = n4 >> 2
        mask = scale - 1
        ptr = 0
        if self.order == 0:
            res = np.empty((q, 4), dtype=np.uint8)
            for t in range(q):
                cur = f2s[0, st & mask]           # lanes 0..3
                res[t] = cur[::-1]                # block order: lane3 first
                f = freq_cap[0, cur]
                c = cum_tab[0, cur]
                st = f * (st >> lr) + (st & mask) - c
                need = st < ANS_TOP
                # consumption order: lane 3, 2, 1, 0
                offs_rev = np.cumsum(need[::-1]) - need[::-1]
                offs = offs_rev[::-1]
                pos = ptr + 2 * offs
                rd = (buf[pos] << 8) | buf[pos + 1]
                st = np.where(need, (st << 16) | rd, st)
                ptr += 2 * int(need.sum())
            out[start:start + 4 * q] = res.reshape(-1)
        else:
            res = np.empty((4, q), dtype=np.uint8)
            prv = np.zeros(4, dtype=np.int64)
            for t in range(q):
                cur = f2s[prv, st & mask]
                res[:, t] = cur
                f = freq_cap[prv, cur]
                c = cum_tab[prv, cur]
                st = f * (st >> lr) + (st & mask) - c
                need = st < ANS_TOP
                offs_rev = np.cumsum(need[::-1]) - need[::-1]
                offs = offs_rev[::-1]
                pos = ptr + 2 * offs
                rd = (buf[pos] << 8) | buf[pos + 1]
                st = np.where(need, (st << 16) | rd, st)
                ptr += 2 * int(need.sum())
                prv = cur.astype(np.int64)
            out[start:start + 4 * q] = res.reshape(-1)
        # leftover raw bytes
        for i in range(n4, n):
            out[start + i] = buf[ptr]
            ptr += 1
        if ptr != sz:
            raise BitStreamError("ANS payload size mismatch", BitStreamError.INVALID_STREAM)

    def _decode_chunk_v1(self, out: np.ndarray, start: int, end: int,
                         br: BitReader, lr: int, f2s: np.ndarray,
                         freq_cap: np.ndarray, cum_tab: np.ndarray) -> None:
        """Bitstream-v1 chunk body: 2 interleaved states (order 0) / 1 state
        (order 1), 16-bit renormalization (ANSRangeDecoder.java:245-322)."""
        mask = (1 << lr) - 1
        sz = eu.read_varint(br) & (MAX_CHUNK_SIZE - 1)
        st0 = br.read_bits(32)
        st1 = br.read_bits(32) if self.order == 0 else 0
        buf = br.read_bytes(sz) if sz else np.zeros(0, dtype=np.uint8)
        buf = np.concatenate([buf, np.zeros(8, dtype=np.uint8)]).astype(np.int64)
        n = 0
        if self.order == 0:
            end2 = (end & -2) - 1
            i = start
            while i < end2:
                cur1 = int(f2s[0, st1 & mask])
                out[i] = cur1
                cur0 = int(f2s[0, st0 & mask])
                out[i + 1] = cur0
                st1 = (int(freq_cap[0, cur1]) * (st1 >> lr)
                       + (st1 & mask) - int(cum_tab[0, cur1])) & 0xFFFFFFFF
                st0 = (int(freq_cap[0, cur0]) * (st0 >> lr)
                       + (st0 & mask) - int(cum_tab[0, cur0])) & 0xFFFFFFFF
                while st1 < ANS_TOP:
                    st1 = ((st1 << 16) | (int(buf[n]) << 8) | int(buf[n + 1])) & 0xFFFFFFFF
                    n += 2
                while st0 < ANS_TOP:
                    st0 = ((st0 << 16) | (int(buf[n]) << 8) | int(buf[n + 1])) & 0xFFFFFFFF
                    n += 2
                i += 2
            if end & 1:
                out[end - 1] = buf[sz - 1]
        else:
            prv = 0
            for i in range(start, end):
                cur = int(f2s[prv, st0 & mask])
                out[i] = cur
                st0 = (int(freq_cap[prv, cur]) * (st0 >> lr)
                       + (st0 & mask) - int(cum_tab[prv, cur])) & 0xFFFFFFFF
                while st0 < ANS_TOP:
                    st0 = ((st0 << 16) | (int(buf[n]) << 8) | int(buf[n + 1])) & 0xFFFFFFFF
                    n += 2
                prv = cur

    def dispose(self) -> None:
        pass


def _fill_f2s(freqs: np.ndarray, scale: int) -> np.ndarray:
    """freq->symbol map when freqs don't sum to scale (defensive)."""
    out = np.zeros(scale, dtype=np.int64)
    s = 0
    for i in range(256):
        f = int(freqs[i])
        if f:
            out[s:s + f] = i
            s += f
    return out
