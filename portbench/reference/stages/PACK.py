"""Inverse PACK transform (kanzi's AliasCodec.java).

The first byte n0 picks the mode.  n0 >= 240: an alphabet of
s = 256 - n0 symbols, bit-packed.  s = 1: the symbol, then the length as
a u32 little-endian.  Else the s symbols (rank order), a count a of raw
bytes (< 4), those bytes, then the packed body, the highest bits first:
four 2-bit ranks a byte when s <= 4, else two 4-bit ranks.  16 <= n0 <
240: digram aliases.  A flag byte (1: the last byte is raw), n0 triples
(first, second, alias), then the body, where an alias byte stands for
its two bytes and any other byte for itself."""

from __future__ import annotations

import numpy as np


class PackError(ValueError):
    pass


def inverse(data: np.ndarray, ctx: dict) -> np.ndarray:
    n0 = int(data[0])
    if n0 < 16:
        raise PackError(f"header {n0}")
    if n0 >= 240:
        s = 256 - n0
        if s == 1:
            return np.full(int.from_bytes(data[2:6].tobytes(), "little"), data[1], np.uint8)
        symbols = data[1:1 + s]
        a = int(data[1 + s])
        if a >= 4:
            raise PackError(f"{a} raw bytes")
        raw = data[2 + s:2 + s + a]
        body = data[2 + s + a:]
        table = np.zeros(16, np.uint8)
        table[:s] = symbols
        if s <= 4:
            ranks = np.stack([body >> 6, (body >> 4) & 3, (body >> 2) & 3, body & 3], axis=1)
        else:
            ranks = np.stack([body >> 4, body & 15], axis=1)
        if np.any(ranks >= s):
            raise PackError("rank outside the alphabet")
        return np.concatenate([raw, table[ranks.reshape(-1)]])
    last_raw = int(data[1])
    if last_raw > 1:
        raise PackError(f"flag {last_raw}")
    triples = data[2:2 + 3 * n0].reshape(-1, 3)
    first = np.arange(256, dtype=np.uint8)
    second = np.zeros(256, np.uint8)
    pair = np.zeros(256, bool)
    first[triples[:, 2]] = triples[:, 0]
    second[triples[:, 2]] = triples[:, 1]
    pair[triples[:, 2]] = True
    body = data[2 + 3 * n0:data.size - last_raw]
    two = pair[body]
    at = np.cumsum(1 + two) - (1 + two)
    out = np.empty(int(body.size + two.sum()), np.uint8)
    out[at] = first[body]
    out[at[two] + 1] = second[body[two]]
    if last_raw:
        out = np.concatenate([out, data[-1:]])
    return out
