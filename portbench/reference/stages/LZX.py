"""Inverse LZX transform (kanzi's LZCodec.java LZXCodec, bitstream v6 and
later).

Layout: u32 little-endian end of the literal section, u32 token section
length, u32 distance section length, a mode byte (bit 0: 24-bit
distances allowed; bits 1-3: minimum match - 2), the literal section
(literals, and the lengths of long literal runs), the tokens, the
distances, the lengths of long matches.  A token LLLFFMMM: LLL literals
first (7: 7 + a length from the literal section); FF = 0 repeats a recent
distance (bit 2 picks the older one) with MM + min match bytes (MM = 3:
3 + min + a length); FF = 1, 2, 3: a new distance of 1, 2 or 3 bytes with
MMM + min match bytes (MMM = 7: 7 + min + a length).  A length is one
byte below 254; 254, then 2 bytes; 255, then 3.  The stream ends after
the literal run that comes within 13 bytes of the literal section's end;
it must end exactly there."""

from __future__ import annotations

import numpy as np


class LZXError(ValueError):
    pass


def _length(src: bytes, i: int) -> tuple[int, int]:
    v = src[i]
    if v < 254:
        return v, i + 1
    if v == 254:
        return 254 + (src[i + 1] << 8) + src[i + 2], i + 3
    return 255 + (src[i + 1] << 16) + (src[i + 2] << 8) + src[i + 3], i + 4


def inverse(data: np.ndarray, ctx: dict) -> np.ndarray:
    src = data.tobytes()
    n = len(src)
    if n < 13:
        raise LZXError("shorter than its header")
    lit_end = int.from_bytes(src[0:4], "little")
    tok_len = int.from_bytes(src[4:8], "little")
    dist_len = int.from_bytes(src[8:12], "little")
    if not 13 <= lit_end <= n or tok_len + dist_len > n - lit_end:
        raise LZXError("section lengths")
    max_dist = (1 << 24) - 2 if src[12] & 1 else (1 << 16) - 2
    min_match = ((src[12] >> 1) & 7) + 2
    lit = 13
    tok = lit_end
    tok_end = lit_end + tok_len
    dist_i = tok_end
    mlen_i = tok_end + dist_len
    rep0 = rep1 = n
    out = bytearray()
    while True:
        if tok >= tok_end:
            raise LZXError("tokens run out")
        t = src[tok]
        tok += 1
        if t >= 32:
            if t >= 0xE0:
                run, lit = _length(src, lit)
                run += 7
            else:
                run = t >> 5
            if lit + run > lit_end:
                raise LZXError("literals run out")
            out += src[lit:lit + run]
            lit += run
            if lit >= lit_end - 13:
                break
        if t & 0x18 == 0:
            m = t & 3
            if m == 3:
                ext, mlen_i = _length(src, mlen_i)
                m += ext
            m += min_match
            dist = rep1 if t & 4 else rep0
        else:
            m = t & 7
            if m == 7:
                ext, mlen_i = _length(src, mlen_i)
                m += ext
            m += min_match
            nb = (t & 0x18) >> 3
            dist = int.from_bytes(src[dist_i:dist_i + nb], "big")
            dist_i += nb
        rep1, rep0 = rep0, dist
        start = len(out) - dist
        if start < 0 or dist > max_dist or dist == 0:
            raise LZXError(f"distance {dist} at {len(out)}")
        if dist >= m:
            out += out[start:start + m]
        else:
            # an overlapping copy repeats the last ``dist`` bytes
            out += (out[start:] * (m // dist + 1))[:m]
    if lit != lit_end:
        raise LZXError("the literal section does not end with the stream")
    return np.frombuffer(bytes(out), np.uint8)
