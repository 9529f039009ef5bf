"""Order-0 rANS decoding (kanzi's ANSRangeDecoder, order 0, v7 layout).

A block of ``count`` symbols is its raw bytes when ``count`` <= 32, else
16 KiB chunks, each: 3 bits of log range - 8; the alphabet
(``codes.read_alphabet``); the frequencies of all symbols but the first, minus
one, in groups of 6 (8 when the alphabet has 64 symbols or more), each
group led by its bit width; nothing more when the alphabet has one
symbol; else a varint payload length, four 32-bit final states, the
payload: 16-bit renormalisation words in the order the decoder takes
them, then the chunk's length mod 4 bytes raw.  Lane j of step t yields
chunk byte 4t + 3 - j; after a step, lanes 3, 2, 1, 0 that fell under
2^15 each take the next word in that order.

All chunks of a block decode together, one step of every chunk a numpy
operation.
"""

from __future__ import annotations

import numpy as np

from ..bits import Bits
from ..codes import read_alphabet, read_varint

CHUNK = 16384
TOP = 1 << 15


class ANSError(ValueError):
    pass


def _read_freqs(bits: Bits, lr: int) -> np.ndarray:
    scale = 1 << lr
    alphabet = read_alphabet(bits)
    freqs = np.zeros(256, np.int64)
    if alphabet.size == 0:
        raise ANSError("empty alphabet")
    if alphabet.size == 1:
        freqs[alphabet[0]] = scale
        return freqs
    group = 8 if alphabet.size >= 64 else 6
    width_bits = 3
    while (1 << width_bits) <= lr:
        width_bits += 1
    total = 0
    for i in range(1, alphabet.size, group):
        width = bits.read(width_bits)
        if (1 << width) > scale:
            raise ANSError("frequency width")
        for s in alphabet[i:i + group]:
            f = bits.read(width) + 1
            if f >= scale:
                raise ANSError("frequency")
            freqs[s] = f
            total += f
    if total >= scale:
        raise ANSError("frequencies over the scale")
    freqs[alphabet[0]] = scale - total
    return freqs


def decode(bits: Bits, count: int) -> np.ndarray:
    if count <= 32:
        return bits.read_bytes(count)
    out = np.empty(count, np.uint8)
    lens, lrs, tables, states, payloads, dense = [], [], [], [], [], []
    for start in range(0, count, CHUNK):
        n = min(CHUNK, count - start)
        lr = 8 + bits.read(3)
        freqs = _read_freqs(bits, lr)
        if np.count_nonzero(freqs) == 1:
            out[start:start + n] = int(np.flatnonzero(freqs)[0])
            continue
        size = read_varint(bits)
        st = [bits.read(32) for _ in range(4)]
        pay = bits.read_bytes(size)
        lens.append(n)
        lrs.append(lr)
        tables.append(freqs)
        states.append(st)
        payloads.append(pay)
        dense.append(start)
    if dense:
        _decode_chunks(out, dense, lens, lrs, tables, states, payloads)
    return out


def _decode_chunks(out, starts, lens, lrs, tables, states, payloads) -> None:
    c = len(starts)
    lens = np.array(lens, np.int64)
    lr = np.array(lrs, np.int64)[:, None]
    mask = (np.int64(1) << lr) - 1
    freq = np.stack(tables)                               # (c, 256)
    cum = np.cumsum(freq, axis=1) - freq
    # slot -> symbol, one row of 2^15 slots a chunk
    slot_sym = np.zeros((c, 1 << 15), np.uint8)
    for i in range(c):
        row = np.repeat(np.arange(256), freq[i])
        slot_sym[i, :row.size] = row
    sizes = np.array([p.size for p in payloads], np.int64)
    base = np.concatenate([[0], np.cumsum(sizes + 2)[:-1]])
    buf = np.zeros(int((sizes + 2).sum()) + 8, np.int64)
    for i, p in enumerate(payloads):
        buf[base[i]:base[i] + p.size] = p
    st = np.array(states, np.int64)                       # (c, 4)
    ptr = base.copy()
    steps = lens >> 2
    res = np.zeros((c, int(steps.max()), 4), np.uint8)
    rows = np.arange(c)[:, None]
    for t in range(int(steps.max())):
        live = steps > t
        sym = slot_sym[rows, st & mask]
        res[:, t, :] = sym[:, ::-1]
        st2 = freq[rows, sym] * (st >> lr) + (st & mask) - cum[rows, sym]
        need = st2 < TOP
        # lanes 3..0 take words in turn: lane j's word comes after those
        # of the needing lanes above it
        above = np.cumsum(need[:, ::-1], axis=1)[:, ::-1] - need
        pos = ptr[:, None] + 2 * above
        word = (buf[pos] << 8) | buf[pos + 1]
        st2 = np.where(need, (st2 << 16) | word, st2)
        st = np.where(live[:, None], st2, st)
        ptr = np.where(live, ptr + 2 * need.sum(axis=1), ptr)
    for i in range(c):
        q = int(steps[i])
        n = int(lens[i])
        seg = out[starts[i]:starts[i] + n]
        seg[:4 * q] = res[i, :q].reshape(-1)
        rest = n - 4 * q
        used = int(ptr[i] - base[i])
        if rest:
            seg[4 * q:] = buf[ptr[i]:ptr[i] + rest]
            used += rest
        if used != int(sizes[i]):
            raise ANSError(f"chunk {i}: payload {sizes[i]} B, {used} B used")
