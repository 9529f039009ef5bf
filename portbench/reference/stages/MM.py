"""Inverse fixed-step delta transform, kanzi's MM (FSDCodec.java).

Body: a mode byte (0 delta, 1 XOR), a distance byte (1, 2, 3, 4, 8 or
16), then the first ``distance`` bytes as they are.  After them, in XOR
mode each byte is the output byte XOR the one ``distance`` before it.
In delta mode each output byte is a token: the zigzag code of its
difference from the byte ``distance`` before it (-127 to 127), or the
escape 0xFF followed by the output byte XOR that earlier byte."""

from __future__ import annotations

import numpy as np

DISTANCES = (1, 2, 3, 4, 8, 16)
ESCAPE = 0xFF


class MMError(ValueError):
    pass


def inverse(data: np.ndarray, ctx: dict) -> np.ndarray:
    if data.size == 0:
        return data.copy()
    if data.size < 2:
        raise MMError("no header")
    mode, dist = int(data[0]), int(data[1])
    if dist not in DISTANCES:
        raise MMError(f"distance {dist}")
    if data.size < 2 + dist:
        raise MMError("shorter than its distance")
    body = data[2:]
    if mode == 1:
        rows = -(-body.size // dist)
        grid = np.zeros(rows * dist, np.uint8)
        grid[:body.size] = body
        return np.bitwise_xor.accumulate(grid.reshape(rows, dist), axis=0) \
            .reshape(-1)[:body.size].copy()
    if mode != 0:
        raise MMError(f"mode {mode}")
    src = body.tolist()
    out = bytearray(src[:dist])
    i, n = dist, len(src)
    while i < n:
        t = src[i]
        if t == ESCAPE:
            if i + 1 == n:
                raise MMError("an escape with no byte after it")
            out.append(src[i + 1] ^ out[-dist])
            i += 2
        else:
            out.append((out[-dist] + ((t >> 1) ^ -(t & 1))) & 0xFF)
            i += 1
    return np.frombuffer(bytes(out), np.uint8)
