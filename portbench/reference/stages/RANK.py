"""Inverse sort-by-rank transform in rank mode (kanzi's SBRT.java, mode
RANK).

Each input byte is the rank of the output byte in a list of the 256 byte
values.  After symbol c at position i, its priority becomes
(i + previous position of c) >> 1 and it moves up past every symbol whose
priority is not above it.

A symbol's priority only grows (its new one is at least its last
position, which is above its old one), so the list stays ordered by
priority, highest first, ties in order of arrival, and the symbol's new
rank is where a binary search puts it."""

from __future__ import annotations

from bisect import bisect_left

import numpy as np


def inverse(data: np.ndarray, ctx: dict) -> np.ndarray:
    last = [0] * 256
    r2s = list(range(256))
    neg = [0] * 256                       # minus the priority, by rank
    out = bytearray(len(data))
    for i, r in enumerate(data.tolist()):
        c = r2s[r]
        out[i] = c
        q = (i + last[c]) >> 1
        last[c] = i
        k = bisect_left(neg, -q, 0, r)    # the first rank whose priority <= q
        if k < r:
            r2s[k + 1:r + 1] = r2s[k:r]
            neg[k + 1:r + 1] = neg[k:r]
            r2s[k] = c
        neg[k] = -q
    return np.frombuffer(bytes(out), np.uint8)
