"""Tangelo/PAQ-derived context-mixing predictor (TPAQ / TPAQX).

Re-derived from K/entropy/TPAQPredictor.java:39-557: 253-state bit-history
FSM over 6-7 hashed byte contexts, an LZ-like match model over a ring buffer
with a position hash table, per-context 8-input perceptron mixers with a
decaying learn rate, and 1-2 logistic SSE stages.  Table sizes derive from
the block size; TPAQX ("extra") adds ctx6, 4x bigger tables and a second SSE.

The generated constant tables live in _tpaq_tables.py.  This Python version
is the executable spec; large blocks use the C++ kernel (same state layout).
"""

from __future__ import annotations

import numpy as np

from ..core.globals import squash
from ._tpaq_tables import MATCH_PRED, STATE_MAP, STATE_TRANSITIONS

MAX_LENGTH = 88
BUFFER_SIZE = 64 * 1024 * 1024
HASH_SIZE = 16 * 1024 * 1024
MASK_80808080 = 0x80808080
MASK_F0F0F000 = 0xF0F0F000
MASK_4F4FFFFF = 0x4F4FFFFF
MASK_FFFF0000 = 0xFFFF0000
HASH_SEED = 0x7FEB352D
_M32 = 0xFFFFFFFF

BEGIN_LEARN_RATE = 60 << 7
END_LEARN_RATE = 11 << 7


def _i32(x: int) -> int:
    """wrap to signed 32-bit"""
    x &= _M32
    return x - (1 << 32) if x >= (1 << 31) else x


def _hash(x: int, y: int) -> int:
    h = (x * HASH_SEED ^ y * HASH_SEED) & _M32
    hs = _i32(h)
    return _i32((hs >> 1) ^ (hs >> 9) ^ (_i32(x) >> 2) ^ (_i32(y) >> 3) ^ HASH_SEED)


def _create_context(ctx_id: int, cx: int) -> int:
    cx = (cx * 987654323 + ctx_id) & _M32
    cx = ((cx << 16) | (cx >> 16)) & _M32
    return _i32((cx * 123456791 + ctx_id) & _M32)


def compute_sizes(ctx: dict | None, extra: bool,
                  bs_version: int = 7) -> tuple[int, int, int, int]:
    """(states, mixers, hash, buffer) sizes from block-size hints
    (TPAQPredictor.java:200-246).  Pre-v7 bitstreams keep non-power-of-two
    ring/hash sizes and index via (size-1) bit masks (TPAQPredictor.java:232)."""
    states_size = 1 << 28
    mixers_size = 1 << 12
    hash_size = HASH_SIZE
    buffer_size = BUFFER_SIZE
    if ctx is not None:
        rbsz = ctx.get("blockSize", 32768)
        if rbsz >= 64 * 1024 * 1024:
            states_size = 1 << 28
        elif rbsz >= 16 * 1024 * 1024:
            states_size = 1 << 27
        elif rbsz >= 4 * 1024 * 1024:
            states_size = 1 << 26
        else:
            states_size = 1 << 24 if rbsz >= 1024 * 1024 else 1 << 22
        absz = ctx.get("size", rbsz)
        if absz >= 32 * 1024 * 1024:
            mixers_size = 1 << 16
        elif absz >= 16 * 1024 * 1024:
            mixers_size = 1 << 15
        elif absz >= 8 * 1024 * 1024:
            mixers_size = 1 << 14
        elif absz >= 4 * 1024 * 1024:
            mixers_size = 1 << 13
        else:
            mixers_size = 1 << 11 if absz >= 1024 * 1024 else 1 << 8
        buffer_size = min(BUFFER_SIZE, rbsz)
        mxsz = absz * 16 if absz < (1 << 26) else 1 << 30
        hash_size = min(HASH_SIZE, mxsz)
    if bs_version > 6:  # v7: normalize to powers of two
        buffer_size = 1 << (max(buffer_size, 1).bit_length() - 1)
        hash_size = 1 << (max(hash_size, 1).bit_length() - 1)
    em = 2 if extra else 0
    mixers_size <<= em
    states_size <<= em
    hash_size = min(hash_size << em, 1024 * 1024 * 1024)
    return states_size, mixers_size, hash_size, buffer_size


class TPAQPredictor:
    native_id = 2

    def __init__(self, ctx: dict | None = None) -> None:
        self.extra = False
        bs_version = 7
        if ctx is not None:
            self.extra = ctx.get("entropy", "NONE") == "TPAQX"
            bs_version = ctx.get("bsVersion", 7)
        self._legacy = bs_version < 7
        self.use_logical_ctx6_shift = self.extra and bs_version >= 7
        self._used = False
        self._block_size = (ctx or {}).get("blockSize", 32768)
        self._size = (ctx or {}).get("size", self._block_size)
        states_size, mixers_size, hash_size, buffer_size = \
            compute_sizes(ctx, self.extra, bs_version)

        self.pr = 2048
        self.c0 = 1
        self.c4 = 0
        self.c8 = 0
        self.bpos = 8
        self.pos = 0
        self.bin_count = 0
        self.match_len = 0
        self.match_pos = 0
        self.hash = 0
        self._sizes = (states_size, mixers_size, hash_size, buffer_size)
        self._alloc_done = False

        self.cp = [0, 0, 0, 0, 0, 0, 0]
        self.ctxs = [0, 0, 0, 0, 0, 0, 0]

    def _ensure_alloc(self) -> None:
        """Heavy tables allocated lazily — skipped when the native kernel
        runs the whole block."""
        if self._alloc_done:
            return
        self._alloc_done = True
        states_size, mixers_size, hash_size, buffer_size = self._sizes
        self.big_states = np.zeros(states_size, dtype=np.uint8)
        self.small_states0 = np.zeros(1 << 16, dtype=np.uint8)
        self.small_states1 = np.zeros(1 << 24, dtype=np.uint8)
        self.hashes = np.zeros(hash_size, dtype=np.int32)
        self.buffer = np.zeros(buffer_size, dtype=np.uint8)
        self.states_mask = states_size - 1
        self.mixers_mask = (mixers_size - 1) & ~1
        self.hash_mask = hash_size - 1
        self.buffer_mask = buffer_size - 1

        from .apm import LogisticAdaptiveProbMap
        self.sse0 = LogisticAdaptiveProbMap(256, 6 if self.extra else 7)
        self.sse1 = LogisticAdaptiveProbMap(65536, 7) if self.extra else None

        # mixers as arrays: weights (n,8), inputs (8,), per-mixer skew/rate/pr
        self.mx_w = np.full((mixers_size, 8), 32768, dtype=np.int64)
        self.mx_skew = np.zeros(mixers_size, dtype=np.int64)
        self.mx_rate = np.full(mixers_size, BEGIN_LEARN_RATE, dtype=np.int64)
        self.mx_pr = np.full(mixers_size, 2048, dtype=np.int64)
        self.mx_in = np.zeros((mixers_size, 8), dtype=np.int64)
        self.mixer_idx = 0

    def native_encode(self, enc, block, bw) -> bool:
        if self._used or self._legacy:
            return False
        from ..utils.native_coders import tpaq_encode_native
        return tpaq_encode_native(enc, block, bw, self.extra,
                                  self._block_size, self._size)

    def native_decode(self, dec, count, br):
        if self._used or self._legacy:
            return None
        from ..utils.native_coders import tpaq_decode_native
        return tpaq_decode_native(dec, count, br, self.extra,
                                  self._block_size, self._size)

    # -- mixer ------------------------------------------------------------

    def _mixer_update(self, bit: int) -> None:
        # exact Java int32 wrap-around semantics
        m = self.mixer_idx
        err = (((bit << 12) - int(self.mx_pr[m])) * int(self.mx_rate[m])) >> 10
        if err == 0:
            return
        if END_LEARN_RATE - int(self.mx_rate[m]) < 0:
            self.mx_rate[m] -= 1
        self.mx_skew[m] = _i32(int(self.mx_skew[m]) + err)
        w = self.mx_w[m]
        pin = self.mx_in[m]
        for k in range(8):
            w[k] = _i32(int(w[k]) + (_i32(int(pin[k]) * err) >> 12))

    def _mixer_get(self, p: list[int]) -> int:
        m = self.mixer_idx
        self.mx_in[m] = p
        w = self.mx_w[m]
        acc = 0
        for k in range(8):
            acc += int(w[k]) * p[k]
        pr = squash(_i32((acc + int(self.mx_skew[m]) + 65536) & _M32) >> 17)
        self.mx_pr[m] = pr
        return pr

    # -- model ------------------------------------------------------------

    def get(self) -> int:
        return self.pr

    def update(self, bit: int) -> None:
        self._used = True
        self._ensure_alloc()
        self._mixer_update(bit)
        self.bpos -= 1
        self.c0 = (self.c0 << 1) | bit

        if self.c0 > 255:
            self.buffer[self.pos & self.buffer_mask] = self.c0 & 0xFF
            self.pos += 1
            self.c8 = ((self.c8 << 8) | ((self.c4 >> 24) & 0xFF)) & _M32
            self.c4 = ((self.c4 << 8) | (self.c0 & 0xFF)) & _M32
            self.hash = ((((self.hash * HASH_SEED) & _M32) << 4) + self.c4) & self.hash_mask
            self.c0 = 1
            self.bpos = 8
            self.bin_count += (self.c4 >> 7) & 1

            self.mixer_idx = (self.c4 & self.mixers_mask) | (1 if self.match_len != 0 else 0)

            c4s = _i32(self.c4)
            c8s = _i32(self.c8)
            self.ctxs[0] = (self.c4 & 0xFF) << 8
            self.ctxs[1] = (self.c4 & 0xFFFF) << 8
            self.ctxs[2] = _create_context(2, self.c4 & 0x00FFFFFF)
            self.ctxs[3] = _create_context(3, self.c4)
            if self.bin_count < (self.pos >> 2):
                # mostly text
                self.ctxs[4] = _create_context(self.ctxs[1], self.c4 ^ (self.c8 & 0xFFFF))
                self.ctxs[5] = _i32((self.c8 & MASK_F0F0F000) | ((self.c4 & MASK_F0F0F000) >> 4))
                if self.extra:
                    h1 = self.c4 & MASK_4F4FFFFF if (self.c4 & MASK_80808080) == 0 else self.c4 & MASK_80808080
                    h2 = self.c8 & MASK_4F4FFFFF if (self.c8 & MASK_80808080) == 0 else self.c8 & MASK_80808080
                    h2s = (h2 >> 2) if self.use_logical_ctx6_shift else (_i32(h2) >> 2)
                    self.ctxs[6] = _hash((h1 << 2) & _M32, h2s & _M32)
            else:
                # mostly binary
                self.ctxs[4] = _create_context(HASH_SEED + self.match_len,
                                               self.c4 ^ (self.c4 & 0x000FFFFF))
                self.ctxs[5] = _i32(self.ctxs[0] | ((self.c8 << 16) & _M32))
                if self.extra:
                    h2s = (self.c8 >> 16) if self.use_logical_ctx6_shift else (_i32(self.c8) >> 16)
                    self.ctxs[6] = _hash(self.c4 & MASK_FFFF0000, h2s & _M32)

            self._find_match()
            self.hashes[self.hash] = self.pos

        c = self.c0
        mask = self.states_mask
        table = STATE_TRANSITIONS[bit]
        bst = self.big_states
        sst0 = self.small_states0
        sst1 = self.small_states1
        cp = self.cp
        sst0[cp[0]] = table[sst0[cp[0]]]
        sst1[cp[1]] = table[sst1[cp[1]]]
        bst[cp[2]] = table[bst[cp[2]]]
        bst[cp[3]] = table[bst[cp[3]]]
        bst[cp[4]] = table[bst[cp[4]]]
        bst[cp[5]] = table[bst[cp[5]]]
        cp[0] = self.ctxs[0] + c
        p0 = int(STATE_MAP[sst0[cp[0]]])
        cp[1] = self.ctxs[1] + c
        p1 = int(STATE_MAP[sst1[cp[1]]])
        cp[2] = (self.ctxs[2] + c) & mask
        p2 = int(STATE_MAP[bst[cp[2]]])
        cp[3] = (self.ctxs[3] + c) & mask
        p3 = int(STATE_MAP[bst[cp[3]]])
        cp[4] = (self.ctxs[4] + c) & mask
        p4 = int(STATE_MAP[bst[cp[4]]])
        cp[5] = (self.ctxs[5] ^ c) & mask
        p5 = int(STATE_MAP[bst[cp[5]]])

        p7 = 0 if self.match_len == 0 else self._match_pred()

        if not self.extra:
            p = self._mixer_get([p0, p1, p2, p3, p4, p5, p7, p7])
            if self.bin_count < (self.pos >> 3):
                p = (3 * self.sse0.get(bit, p, self.c0) + p) >> 2
        else:
            bst[cp[6]] = table[bst[cp[6]]]
            cp[6] = (self.ctxs[6] + c) & mask
            p6 = int(STATE_MAP[bst[cp[6]]])
            p = self._mixer_get([p0, p1, p2, p3, p4, p5, p6, p7])
            if self.bin_count < (self.pos >> 3):
                p = self.sse1.get(bit, p, self.ctxs[0] + c)
            else:
                if self.bin_count >= (self.pos >> 2):
                    p = (3 * self.sse0.get(bit, p, self.c0) + p) >> 2
                p = (3 * self.sse1.get(bit, p, self.ctxs[0] + c) + p) >> 2

        # p + (p-2048)>>>31 : add 1 when p < 2048
        self.pr = p + (1 if p < 2048 else 0)

    def _find_match(self) -> None:
        if self.match_len > 0:
            if self.match_len < MAX_LENGTH:
                self.match_len += 1
            self.match_pos += 1
        else:
            self.match_pos = int(self.hashes[self.hash])
            if self.match_pos != 0 and self.pos - self.match_pos <= self.buffer_mask:
                r = self.match_len + 2
                s = self.pos - r
                t = self.match_pos - r
                buf = self.buffer
                bm = self.buffer_mask
                while r <= MAX_LENGTH:
                    if buf[(s - 1) & bm] != buf[(t - 1) & bm]:
                        break
                    if buf[s & bm] != buf[t & bm]:
                        break
                    r += 2
                    s -= 2
                    t -= 2
                self.match_len = r - 2

    def _match_pred(self) -> int:
        b = int(self.buffer[self.match_pos & self.buffer_mask])
        if self.c0 == ((b | 256) >> self.bpos):
            if (b >> (self.bpos - 1)) & 1:
                return int(MATCH_PRED[self.match_len - 1])
            return -int(MATCH_PRED[self.match_len - 1])
        self.match_len = 0
        return 0
