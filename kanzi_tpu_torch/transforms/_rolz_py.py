"""Pure-Python ROLZ chunk codec + ROLZX block codec — the executable
spec / no-native fallback (mirrors native/rolz.cpp forward and inverse
kernels, re-derived from K/transform/ROLZCodec.java:264-1772).

Serial per-byte loops: correctness over speed (the C++ path is the fast
one; this exists so KANZI_TPU_NO_NATIVE=1 can encode and decode every
level with the same wire bytes)."""

from __future__ import annotations

import numpy as np

HASH = 200002979
CHUNK_SIZE = 16 * 1024 * 1024
HASH_MASK = (~(CHUNK_SIZE - 1)) & 0xFFFFFFFF
_M64 = (1 << 64) - 1


def _key1(dst, idx):
    return int(dst[idx]) | (int(dst[idx + 1]) << 8)


def _key2(dst, idx):
    v = int.from_bytes(bytes(dst[idx:idx + 8]), "little")
    m = (v * HASH) & _M64
    if m >= 1 << 63:
        m -= 1 << 64
    return (m >> 40) & 0xFFFF


def rolz1_inverse_chunk_py(dst, chunk_start, chunk_end, dst_end, min_match,
                           delta, log_pos_checks, counters, matches,
                           lit, lit_len, tk, tk_len, lenb, len_len,
                           midx, midx_len, first_lits) -> int:
    """Mirror of kz_rolz1_inverse_chunk.  dst/counters/matches are numpy
    arrays mutated in place; returns 0 on success, negative on error.
    ``lenb`` must carry zero padding past ``len_len`` (multi-byte varints
    near the section end read ahead, exactly like the C++)."""
    mask_checks = (1 << log_pos_checks) - 1
    matches[:] = 0
    nlit = ntk = nlen = nmidx = 0
    k1 = min_match == 3
    dst_idx = chunk_start

    def read_length():
        nonlocal nlen
        nxt = int(lenb[nlen])
        nlen += 1
        length = nxt & 0x7F
        while nxt & 0x80:
            nxt = int(lenb[nlen])
            nlen += 1
            length = (length << 7) | (nxt & 0x7F)
        return length

    n = 2 if first_lits == 2 else min(dst_end - dst_idx, first_lits)
    for _ in range(n):
        dst[dst_idx] = lit[nlit]
        dst_idx += 1
        nlit += 1

    while dst_idx < chunk_end:
        if ntk >= tk_len:
            return -1
        token = int(tk[ntk])
        ntk += 1
        match_len = token & 0x07
        if match_len == 7:
            if nlen >= len_len:
                return -2
            match_len = read_length() + 7
        if token < 0xF8:
            lit_len_run = token >> 3
        else:
            if nlen >= len_len:
                return -3
            lit_len_run = read_length() + 31
        if lit_len_run > 0:
            if nlit + lit_len_run > lit_len or dst_idx + lit_len_run > dst_end:
                return -4
            n0 = dst_idx - chunk_start
            dst[dst_idx:dst_idx + lit_len_run] = lit[nlit:nlit + lit_len_run]
            src_inc = 0
            j = 0
            while j < lit_len_run:
                key = (_key1(dst, dst_idx + j - delta) if k1
                       else _key2(dst, dst_idx + j - delta))
                counters[key] = (counters[key] + 1) & mask_checks
                matches[(key << log_pos_checks) + counters[key]] = n0 + j
                j += (src_inc >> 6) + 1
                src_inc += 1
            nlit += lit_len_run
            dst_idx += lit_len_run
            if dst_idx >= chunk_end:
                if dst_idx == chunk_end:
                    break
                return -5
        if dst_idx + match_len + min_match > dst_end:
            return -6
        key = _key1(dst, dst_idx - delta) if k1 \
            else _key2(dst, dst_idx - delta)
        base = key << log_pos_checks
        if nmidx >= midx_len:
            return -7
        match_idx = int(midx[nmidx])
        nmidx += 1
        ref = chunk_start + int(
            matches[base + ((int(counters[key]) - match_idx) & mask_checks)])
        saved = dst_idx
        for _ in range(match_len + min_match):
            dst[dst_idx] = dst[ref]
            dst_idx += 1
            ref += 1
        counters[key] = (counters[key] + 1) & mask_checks
        matches[base + counters[key]] = saved - chunk_start
    if ntk != tk_len or nmidx != midx_len or nlit != lit_len \
            or nlen != len_len:
        return -8
    return 0


# ---------------- ROLZ1 forward (tokenizer) --------------------------------

MAX_MATCH3 = 3 + 65535


def _hash32f(buf, idx):
    v = int.from_bytes(buf[idx:idx + 4], "little")
    return ((v << 8) * HASH) & HASH_MASK


def _match_len(buf, r, pos, max_match):
    n = 0
    while n < max_match:
        a = int.from_bytes(buf[r + n:r + n + 8], "little")
        b = int.from_bytes(buf[pos + n:pos + n + 8], "little")
        diff = a ^ b
        if diff:
            n += ((diff & -diff).bit_length() - 1) >> 3
            break
        n += 8
    return n


def _find_match1(buf, chunk_start, chunk_end, pos, h32, counter, base,
                 matches, pos_checks, mask_checks, min_match):
    """Mirror of native/rolz.cpp find_match (newest-first probe over the
    context's position ring; -1 or (bestIdx << 16) | (len - min_match))."""
    best_len = 0
    best_idx = -1
    max_match = min(MAX_MATCH3, chunk_end - pos) - 8
    for i in range(counter, counter - pos_checks, -1):
        ref = int(matches[base + (i & mask_checks)])
        if (ref & HASH_MASK) != h32:
            continue
        r = (ref & ~HASH_MASK & 0xFFFFFFFF) + chunk_start
        if buf[r + best_len] != buf[pos + best_len]:
            continue
        n = _match_len(buf, r, pos, max_match)
        if n > best_len:
            best_idx = counter - i
            best_len = n
    return -1 if best_len < min_match else ((best_idx << 16)
                                            | (best_len - min_match))


def _emit_length(out: bytearray, length: int) -> None:
    if length >= 1 << 7:
        if length >= 1 << 14:
            if length >= 1 << 21:
                out.append((0x80 | (length >> 21)) & 0xFF)
            out.append((0x80 | (length >> 14)) & 0xFF)
        out.append((0x80 | (length >> 7)) & 0xFF)
    out.append(length & 0x7F)


def rolz1_forward_chunk_py(src, chunk_start, chunk_end, src_end, min_match,
                           delta, log_pos_checks, counters, matches):
    """Mirror of kz_rolz1_forward_chunk.  ``src`` must be bytes padded by
    >= 16 past src_end; ``counters`` persists across chunks (numpy i32),
    ``matches`` is reset here.  Returns (lit, tk, lenb, midx) bytearrays."""
    pos_checks = 1 << log_pos_checks
    mask_checks = pos_checks - 1
    matches[:] = 0
    matches = matches.view(np.uint32)  # C++ stores h32|pos as wrapped i32
    lit, tk, lenb, midx = bytearray(), bytearray(), bytearray(), bytearray()
    src_idx = chunk_start
    n = min(src_end - chunk_start, 8)
    lit += src[src_idx:src_idx + n]
    src_idx += n
    first_lit_idx = src_idx
    src_inc = 0
    k1 = min_match == 3

    while src_idx < chunk_end:
        key = _key1(src, src_idx - delta) if k1 \
            else _key2(src, src_idx - delta)
        base = key << log_pos_checks
        h32 = _hash32f(src, src_idx)
        counter = int(counters[key])
        match = _find_match1(src, chunk_start, chunk_end, src_idx, h32,
                             counter, base, matches, pos_checks, mask_checks,
                             min_match)
        counters[key] = (counter + 1) & mask_checks
        matches[base + ((counter + 1) & mask_checks)] = \
            h32 | (src_idx - chunk_start)
        if match == -1:
            src_idx += 1 + (src_inc >> 6)
            src_inc += 1
            continue
        # one-step lazy: a longer match at srcIdx+1 wins
        key = _key1(src, src_idx + 1 - delta) if k1 \
            else _key2(src, src_idx + 1 - delta)
        base2 = key << log_pos_checks
        h32 = _hash32f(src, src_idx + 1)
        counter = int(counters[key])
        match2 = _find_match1(src, chunk_start, chunk_end, src_idx + 1, h32,
                              counter, base2, matches, pos_checks,
                              mask_checks, min_match)
        if match2 >= 0 and (match2 & 0xFFFF) > (match & 0xFFFF):
            match = match2
            src_idx += 1
            counters[key] = (counter + 1) & mask_checks
            matches[base2 + ((counter + 1) & mask_checks)] = \
                h32 | (src_idx - chunk_start)
        lit_len = src_idx - first_lit_idx
        token = (lit_len << 3) if lit_len < 31 else 0xF8
        m_len = match & 0xFFFF
        if m_len >= 7:
            tk.append(token | 0x07)
            _emit_length(lenb, m_len - 7)
        else:
            tk.append(token | m_len)
        if lit_len >= 31:
            _emit_length(lenb, lit_len - 31)
        lit += src[first_lit_idx:first_lit_idx + lit_len]
        midx.append((match >> 16) & 0xFF)
        src_idx += m_len + min_match
        first_lit_idx = src_idx
        src_inc = 0

    lit_len = chunk_end - first_lit_idx
    if len(tk) != 0:
        token = 0xF8 if lit_len >= 31 else (lit_len << 3)
        tk.append(token)
    if lit_len >= 31:
        _emit_length(lenb, lit_len - 31)
    lit += src[first_lit_idx:first_lit_idx + lit_len]
    return lit, tk, lenb, midx


# ---------------- ROLZX (ROLZCodec2): adaptive binary range decoder --------

_TOPR = 0x00FFFFFFFFFFFFFF
_MASK_0_32 = 0xFFFFFFFF
_MASK_0_56 = 0x00FFFFFFFFFFFFFF
LIT_CTX, MATCH_CTX = 0, 1
LIT_FLAG, MATCH_FLAG = 1, 0
LOG_POS_CHECKS2 = 5


class _Decoder:
    def __init__(self, buf, lit_log, m_log):
        self.buf = buf
        self.cap = len(buf)
        self.idx = 0
        self.low = 0
        self.high = _TOPR
        self.probs = [None, None]
        self.probs[MATCH_CTX] = [0xFFFF >> 1] * (256 << m_log)
        self.probs[LIT_CTX] = [0xFFFF >> 1] * (256 << lit_log)
        self.log_sizes = [lit_log, m_log]
        self.c1 = 1
        self.ctx = 0
        self.p_idx = LIT_CTX
        self.current = 0
        for _ in range(8):
            self.current = (self.current << 8) | self.buf[self.idx]
            self.idx += 1

    def set_ctx(self, n, c):
        self.p_idx = n
        self.ctx = c << self.log_sizes[n]

    def dec_bit(self):
        probs = self.probs[self.p_idx]
        pi = self.ctx + self.c1
        p = probs[pi]
        mid = self.low + ((((self.high - self.low) >> 4) * (p >> 4)) >> 8)
        if mid >= self.current:
            bit = 1
            self.high = mid
            probs[pi] = p - (((p - 0xFFFF) >> 5) + 1)
            self.c1 += self.c1 + 1
        else:
            bit = 0
            self.low = mid + 1
            probs[pi] = p - (p >> 5)
            self.c1 += self.c1
        while ((self.low ^ self.high) >> 24) == 0:
            self.low = (self.low << 32) & _MASK_0_56
            self.high = ((self.high << 32) | _MASK_0_32) & _MASK_0_56
            v = 0
            if self.idx + 4 <= self.cap:
                v = int.from_bytes(bytes(self.buf[self.idx:self.idx + 4]),
                                   "big")
            self.current = ((self.current << 32) | v) & _MASK_0_56
            self.idx += 4
        return bit

    def dec9(self):
        self.c1 = 1
        for _ in range(9):
            self.dec_bit()
        return self.c1 & 0x1FF

    def dec_bits(self, n):
        self.c1 = 1
        mask = (1 << n) - 1
        for _ in range(n):
            self.dec_bit()
        return self.c1 & mask


_M64b = (1 << 64) - 1
MAX_MATCH2 = 3 + 255


class _Encoder:
    """Mirror of native/rolz.cpp rolzx::Coder (encode side).  All state is
    masked to 64 bits exactly where the C++ i64/u64 arithmetic wraps."""

    def __init__(self, lit_log, m_log, cap):
        self.out = bytearray(cap)
        self.cap = cap
        self.idx = 0
        self.low = 0
        self.high = _TOPR
        self.probs = [None, None]
        self.probs[MATCH_CTX] = [0xFFFF >> 1] * (256 << m_log)
        self.probs[LIT_CTX] = [0xFFFF >> 1] * (256 << lit_log)
        self.log_sizes = [lit_log, m_log]
        self.c1 = 1
        self.ctx = 0
        self.p_idx = LIT_CTX
        self.overflow = False

    def set_ctx(self, n, c):
        self.p_idx = n
        self.ctx = c << self.log_sizes[n]

    def enc_bit(self, bit):
        probs = self.probs[self.p_idx]
        pi = self.ctx + self.c1
        p = probs[pi]
        split = (((((self.high - self.low) & _M64b) >> 4)
                  * (p >> 4)) & _M64b) >> 8
        if bit == 0:
            self.low = (self.low + split + 1) & _M64b
            probs[pi] = p - (p >> 5)
            self.c1 += self.c1
        else:
            self.high = (self.low + split) & _M64b
            probs[pi] = p - (((p - 0xFFFF) >> 5) + 1)
            self.c1 += self.c1 + 1
        while ((self.low ^ self.high) >> 24) == 0:
            if self.idx + 4 > self.cap:
                self.overflow = True
                return
            v = (self.high >> 32) & 0xFFFFFFFF
            self.out[self.idx:self.idx + 4] = v.to_bytes(4, "big")
            self.idx += 4
            self.low = (self.low << 32) & _M64b
            self.high = ((self.high << 32) | _MASK_0_32) & _M64b

    def enc9(self, val):
        self.c1 = 1
        for k in range(8, -1, -1):
            self.enc_bit(1 if val & (1 << k) else 0)

    def enc_bits(self, val, n):
        self.c1 = 1
        while n:
            n -= 1
            self.enc_bit(1 if val & (1 << n) else 0)

    def dispose(self):
        if self.idx + 8 > self.cap:
            self.overflow = True
            return
        low = self.low
        for i in range(8):
            self.out[self.idx + i] = (low >> 56) & 0xFF
            low = (low << 8) & _M64b
        self.idx += 8


def _find_match2(buf, chunk_start, chunk_end, pos, key, counters, matches,
                 min_match):
    """Mirror of native/rolz.cpp rolzx::find_match2 (probes + inserts)."""
    base = key << LOG_POS_CHECKS2
    h32 = _hash32f(buf, pos)
    counter = int(counters[key])
    pos_checks = 1 << LOG_POS_CHECKS2
    mask_checks = pos_checks - 1
    best_len = 0
    best_idx = -1
    max_match = min(MAX_MATCH2, chunk_end - pos) - 8
    for i in range(counter, counter - pos_checks, -1):
        ref = int(matches[base + (i & mask_checks)])
        if (ref & HASH_MASK) != h32:
            continue
        r = (ref & ~HASH_MASK & 0xFFFFFFFF) + chunk_start
        if buf[r + best_len] != buf[pos + best_len]:
            continue
        n = _match_len(buf, r, pos, max_match)
        if n > best_len:
            best_idx = counter - i
            best_len = n
            if best_len == max_match:
                break
    counters[key] = (counter + 1) & mask_checks
    matches[base + ((counter + 1) & mask_checks)] = \
        h32 | (pos - chunk_start)
    return -1 if best_len < min_match else ((best_idx << 16)
                                            | (best_len - min_match))


def rolz2_forward_py(src: np.ndarray, min_match: int, delta: int,
                     flags: int):
    """Mirror of kz_rolz2_forward.  Returns the encoded bytes (numpy u8,
    incl. u32be size + flags) or None when the block declines."""
    arr = np.asarray(src, np.uint8)
    count = arr.size
    cap = count + (count >> 5) + 4096
    if count < 64:
        return None
    s = arr.tobytes() + b"\x00" * 16
    src_end = count - 4
    C = _Encoder(9, LOG_POS_CHECKS2, cap - 5)
    counters = np.zeros(65536, np.int32)
    matches = np.zeros(65536 << LOG_POS_CHECKS2, np.uint32)
    chunk_size = min(count, CHUNK_SIZE)
    k1 = min_match == 3
    start_chunk = 0
    src_idx = 0
    while start_chunk < src_end:
        matches[:] = 0
        end_chunk = min(start_chunk + chunk_size, src_end)
        src_idx = start_chunk
        n = min(src_end - start_chunk, 8)
        C.set_ctx(LIT_CTX, 0)
        for _ in range(n):
            C.enc9((LIT_FLAG << 8) | s[src_idx])
            src_idx += 1
        while src_idx < end_chunk and not C.overflow:
            C.set_ctx(LIT_CTX, s[src_idx - 1])
            key = _key1(s, src_idx - delta) if k1 \
                else _key2(s, src_idx - delta)
            match = _find_match2(s, start_chunk, end_chunk, src_idx, key,
                                 counters, matches, min_match)
            if match < 0:
                C.enc9((LIT_FLAG << 8) | s[src_idx])
                src_idx += 1
                continue
            match_len = match & 0xFFFF
            C.enc9((MATCH_FLAG << 8) | match_len)
            C.set_ctx(MATCH_CTX, s[src_idx - 1])
            C.enc_bits((match >> 16) & 0xFFFF, LOG_POS_CHECKS2)
            src_idx += match_len + min_match
        if C.overflow:
            return None
        start_chunk = end_chunk
    for _ in range(4):
        C.set_ctx(LIT_CTX, s[src_idx - 1])
        C.enc9((LIT_FLAG << 8) | s[src_idx])
        src_idx += 1
    C.dispose()
    if C.overflow:
        return None
    total = 5 + C.idx
    if total >= count:
        return None
    out = bytearray(total)
    out[0:4] = int(count).to_bytes(4, "big")
    out[4] = flags & 0xFF
    out[5:total] = C.out[:C.idx]
    return np.frombuffer(bytes(out), np.uint8).copy()


def rolz2_inverse_py(src: np.ndarray, min_match: int, delta: int,
                     first_lits: int) -> np.ndarray:
    """Mirror of kz_rolz2_inverse (whole block incl. u32be size + flags)."""
    s = bytes(np.asarray(src, np.uint8).tobytes())
    count = len(s)
    if count < 13:
        raise ValueError("ROLZX: truncated")
    sz_block = int.from_bytes(s[0:4], "big")
    if sz_block <= 0:
        raise ValueError("ROLZX: bad size")
    C = _Decoder(s[5:], 9, LOG_POS_CHECKS2)
    counters = np.zeros(65536, np.int32)
    matches = np.zeros(65536 << LOG_POS_CHECKS2, np.int32)
    mask_checks = (1 << LOG_POS_CHECKS2) - 1
    chunk_size = min(sz_block, CHUNK_SIZE)
    dst = bytearray(sz_block + 16)
    dst_end = sz_block
    k1 = min_match == 3
    start_chunk = 0
    out_index = 0
    while start_chunk < dst_end:
        matches[:] = 0
        end_chunk = min(start_chunk + chunk_size, dst_end)
        dst_idx = out_index
        n = 2 if first_lits == 2 else min(dst_end - start_chunk, first_lits)
        C.set_ctx(LIT_CTX, 0)
        for _ in range(n):
            val1 = C.dec9()
            if (val1 >> 8) == MATCH_FLAG:
                raise ValueError("ROLZX: bad stream")
            dst[dst_idx] = val1 & 0xFF
            dst_idx += 1
        while dst_idx < end_chunk:
            saved = dst_idx
            key = _key1(dst, dst_idx - delta) if k1 \
                else _key2(dst, dst_idx - delta)
            base = key << LOG_POS_CHECKS2
            C.set_ctx(LIT_CTX, dst[dst_idx - 1])
            val = C.dec9()
            if (val >> 8) == LIT_FLAG:
                dst[dst_idx] = val & 0xFF
                dst_idx += 1
            else:
                match_len = val & 0xFF
                if dst_idx + match_len + 3 > dst_end:
                    raise ValueError("ROLZX: bad match")
                C.set_ctx(MATCH_CTX, dst[dst_idx - 1])
                match_idx = C.dec_bits(LOG_POS_CHECKS2)
                ref = out_index + int(matches[
                    base + ((int(counters[key]) - match_idx) & mask_checks)])
                for _ in range(match_len + min_match):
                    dst[dst_idx] = dst[ref]
                    dst_idx += 1
                    ref += 1
            counters[key] = (counters[key] + 1) & mask_checks
            matches[base + counters[key]] = saved - out_index
        start_chunk = end_chunk
        out_index = dst_idx
    if 5 + C.idx != count:
        raise ValueError("ROLZX: stream length mismatch")
    return np.frombuffer(bytes(dst[:out_index]), np.uint8).copy()
