"""Inverse Burrows-Wheeler transform with kanzi's block header
(BWTBlockCodec.java, BWT.java, bitstream v6 and later).

Header: one byte, log2(number of primary indexes) << 2 | (index bytes -
1), then each index minus one, big-endian.  A block of n >= 256 bytes has
8 indexes, a smaller one 1.  The body is the last column of the sorted
rotations of text + '$' with the '$' taken out at position index[0];
index[k] is the row of the rotation that starts at text position k * step,
step = ceil(n / 8).  The inverse puts the '$' back and walks the
last-to-first map from the row of '$' backwards through the text, and
checks every index against the row the walk finds."""

from __future__ import annotations

from array import array

import numpy as np


class BWTError(ValueError):
    pass


def inverse(data: np.ndarray, ctx: dict) -> np.ndarray:
    mode = int(data[0])
    chunks = 1 << ((mode >> 2) & 7)
    width = (mode & 3) + 1
    body = data[1 + chunks * width:]
    n = body.size
    if n == 0:
        return body.copy()
    if chunks != (8 if n >= 256 else 1):
        raise BWTError(f"{chunks} primary indexes for {n} bytes")
    idx = [int.from_bytes(data[1 + k * width:1 + (k + 1) * width].tobytes(), "big") + 1
           for k in range(chunks)]
    if n == 1:
        return body.copy()
    p = idx[0]
    if not 0 < p <= n:
        raise BWTError("primary index out of range")
    # last column with the sentinel back, as keys: '$' = 0, byte b = b + 1
    last = np.concatenate([body[:p].astype(np.int64) + 1, [0],
                           body[p:].astype(np.int64) + 1])
    lf = np.empty(n + 1, np.int64)
    lf[np.argsort(last, kind="stable")] = np.arange(n + 1)
    step = -(-n // chunks)
    # rows[k]: the row of the rotation that starts at text position n - k
    lf_a = array("q", lf.tobytes())
    rows_a = array("q", bytes(8 * (n + 1)))
    row = 0
    for k in range(1, n + 1):
        row = lf_a[row]
        rows_a[k] = row
    rows = np.frombuffer(rows_a, np.int64)
    keys = last[rows[:n]]                 # text[n - 1 - k] + 1
    if np.any(keys == 0) or last[rows[n]] != 0:
        raise BWTError("the walk meets the sentinel away from the text's start")
    for k in range(chunks):
        if rows[n - k * step] != idx[k]:
            raise BWTError(f"primary index {k}: {idx[k]}, row {rows[n - k * step]}")
    return (keys[::-1] - 1).astype(np.uint8)
