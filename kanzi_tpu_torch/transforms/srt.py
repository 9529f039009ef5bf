"""Sorted Rank Transform.

Re-derived from K/transform/SRT.java:29-367: a 256-entry varint frequency
header, then per-symbol bucket streams of MTF-style ranks; symbols are
processed in frequency order (desc, ties by value asc).  Runs emit rank 0.

Serial per byte — routed to the C++ kernel; the Python loop is the spec.
"""

from __future__ import annotations

import numpy as np

MAX_HEADER_SIZE = 4 * 256


def _encode_header(freqs: list[int]) -> bytearray:
    out = bytearray()
    for f in freqs:
        while f >= 128:
            out.append(0x80 | (f & 0x7F))
            f >>= 7
        out.append(f)
    return out


def _decode_header(src: np.ndarray) -> tuple[list[int], int]:
    freqs = [0] * 256
    i = 0
    for k in range(256):
        val = int(src[i]); i += 1
        res = val & 0x7F
        shift = 7
        while val >= 128:
            val = int(src[i]); i += 1
            res |= (val & 0x7F) << shift
            if shift > 21:
                break
            shift += 7
        freqs[k] = res
    return freqs, i


def _sorted_symbols(freqs: list[int]) -> list[int]:
    """Symbols with freq>0, by (freq desc, value asc) — matches preprocess."""
    syms = [i for i in range(256) if freqs[i] > 0]
    syms.sort(key=lambda c: (-freqs[c], c))
    return syms


class SRT:
    def __init__(self, ctx: dict | None = None) -> None:
        self.ctx = ctx

    def max_encoded_len(self, src_len: int) -> int:
        return src_len + MAX_HEADER_SIZE

    def forward(self, src: np.ndarray) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        n = src.size
        if n == 0:
            return src.copy()
        from ..utils.native_transforms import srt_forward_native
        res = srt_forward_native(src)
        if res is not None:
            return res
        freqs = np.bincount(src, minlength=256).astype(np.int64).tolist()
        # first-occurrence ranks
        r2s = [0] * 256
        s2r = [0] * 256
        seen = 0
        order = []
        seen_set = [False] * 256
        for c in src.tolist():
            if not seen_set[c]:
                seen_set[c] = True
                r2s[seen] = c
                s2r[c] = seen
                seen += 1
        syms = _sorted_symbols(freqs)
        buckets = [0] * 256
        pos = 0
        for c in syms:
            buckets[c] = pos
            pos += freqs[c]
        header = _encode_header(freqs)
        out = np.empty(len(header) + n, dtype=np.uint8)
        out[:len(header)] = np.frombuffer(bytes(header), dtype=np.uint8)
        dst = out[len(header):]
        data = src.tolist()
        i = 0
        while i < n:
            c = data[i]
            r = s2r[c]
            p = buckets[c]
            dst[p] = r
            p += 1
            if r != 0:
                while r != 0:
                    r2s[r] = r2s[r - 1]
                    s2r[r2s[r]] = r
                    r -= 1
                r2s[0] = c
                s2r[c] = 0
            i += 1
            while i < n and data[i] == c:
                dst[p] = 0
                p += 1
                i += 1
            buckets[c] = p
        return out

    def inverse(self, src: np.ndarray, count: int | None = None) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        if src.size == 0:
            return src.copy()
        from ..utils.native_transforms import srt_inverse_native
        res = srt_inverse_native(src)
        if res is not None:
            if count is not None and res.size > count:
                res = res[:count]
            return res
        freqs, hdr = _decode_header(src)
        n = src.size - hdr
        body = src[hdr:]
        syms = _sorted_symbols(freqs)
        nb = len(syms)
        buckets = [0] * 256
        bucket_ends = [0] * 256
        r2s = [0] * 256
        pos = 0
        for c in syms:
            r2s[int(body[pos])] = c
            buckets[c] = pos + 1
            pos += freqs[c]
            bucket_ends[c] = pos
        c = r2s[0]
        out = np.empty(n, dtype=np.uint8)
        data = body.tolist()
        for i in range(n):
            out[i] = c
            if buckets[c] < bucket_ends[c]:
                r = data[buckets[c]]
                buckets[c] += 1
                if r == 0:
                    continue
                for s in range(r):
                    r2s[s] = r2s[s + 1]
                r2s[r] = c
                c = r2s[0]
            else:
                if nb == 1:
                    continue
                nb -= 1
                for s in range(nb):
                    r2s[s] = r2s[s + 1]
                c = r2s[0]
        if count is not None and out.size > count:
            out = out[:count]
        return out
