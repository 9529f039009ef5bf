"""Inverse zero run-length transform (kanzi's ZRLT.java).

Bytes 0 and 1 are the binary digits of R + 1 below its leading one, for a
run of R zeros; 0xFF is followed by b for the byte 0xFE + b (a 0xFF that
ends the input stands for nothing); any other byte v stands for v - 1."""

from __future__ import annotations

import numpy as np


def inverse(data: np.ndarray, ctx: dict) -> np.ndarray:
    src = data.tolist()
    n = len(src)
    out = bytearray()
    i = 0
    while i < n:
        v = src[i]
        if v <= 1:
            run = 1
            while i < n and src[i] <= 1:
                run = (run << 1) | src[i]
                i += 1
            out += bytes(run - 1)
            continue
        if v == 0xFF:
            if i + 1 < n:
                out.append(0xFE + src[i + 1])
            i += 2
            continue
        out.append(v - 1)
        i += 1
    return np.frombuffer(bytes(out), np.uint8)
