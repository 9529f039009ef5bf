"""Canonical Huffman decoding (kanzi's HuffmanDecoder.java, bitstream v6
and later).

A block is cut into 16 KiB chunks.  A chunk under 32 bytes is raw.  Else:
the alphabet (``codes.read_alphabet``); each symbol's code length, as a
signed Exp-Golomb step from the previous length (from 2), 1 to 12 bits;
nothing more when the alphabet has one symbol; else four varints, the bit
lengths of four streams, then the streams, stream j holding chunk bytes
[j q, (j + 1) q), q = chunk length // 4; then the chunk's length mod 4
bytes raw.  Codes are canonical: symbols in order of (length, value) take
increasing codes, shifted left as the length grows.  A stream must end on
its stated bit length.

All streams of a block decode together through a 12-bit table, one symbol
of every stream a numpy operation."""

from __future__ import annotations

import numpy as np

from ..bits import Bits
from ..codes import read_alphabet, read_signed_expgolomb, read_varint

CHUNK = 16384
MAX_LEN = 12


class HuffmanError(ValueError):
    pass


def _table(alphabet: np.ndarray, lengths: dict) -> tuple[np.ndarray, np.ndarray]:
    order = sorted(alphabet.tolist(), key=lambda s: (lengths[s], s))
    sym = np.zeros(1 << MAX_LEN, np.int64)
    ln = np.zeros(1 << MAX_LEN, np.int64)
    code, cur = 0, lengths[order[0]]
    for s in order:
        code <<= lengths[s] - cur
        cur = lengths[s]
        lo = code << (MAX_LEN - cur)
        hi = (code + 1) << (MAX_LEN - cur)
        if hi > 1 << MAX_LEN:
            raise HuffmanError("code lengths over-subscribed")
        sym[lo:hi] = s
        ln[lo:hi] = cur
        code += 1
    return sym, ln


def decode(bits: Bits, count: int) -> np.ndarray:
    out = np.empty(count, np.uint8)
    streams = []            # (output offset, symbols, table index, Bits)
    tables = []
    for start in range(0, count, CHUNK):
        n = min(CHUNK, count - start)
        if n < 32:
            out[start:start + n] = bits.read_bytes(n)
            continue
        alphabet = read_alphabet(bits)
        if alphabet.size == 0:
            raise HuffmanError("empty alphabet")
        lengths, cur = {}, 2
        for s in alphabet.tolist():
            cur += read_signed_expgolomb(bits)
            if not 0 < cur <= MAX_LEN:
                raise HuffmanError(f"code length {cur}")
            lengths[s] = cur
        if alphabet.size == 1:
            out[start:start + n] = alphabet[0]
            continue
        tables.append(_table(alphabet, lengths))
        q = n // 4
        nbits = [read_varint(bits) for _ in range(4)]
        for j in range(4):
            streams.append((start + j * q, q, len(tables) - 1, bits.sub(nbits[j])))
        if n % 4:
            out[start + 4 * q:start + n] = bits.read_bytes(n % 4)
    if streams:
        _decode_streams(out, streams, tables)
    return out


def _decode_streams(out, streams, tables) -> None:
    m = len(streams)
    sym_t = np.stack([t[0] for t in tables])
    len_t = np.stack([t[1] for t in tables])
    which = np.array([s[2] for s in streams], np.int64)
    count = np.array([s[1] for s in streams], np.int64)
    ends = np.array([s[3].end for s in streams], np.int64)
    nbytes = (ends + 7) >> 3
    base = np.concatenate([[0], np.cumsum(nbytes + 4)[:-1]])
    buf = np.zeros(int((nbytes + 4).sum()) + 4, np.int64)
    for i, s in enumerate(streams):
        buf[base[i]:base[i] + nbytes[i]] = s[3].data[:nbytes[i]]
    pos = np.zeros(m, np.int64)                 # bit offset in each stream
    res = np.zeros((m, int(count.max())), np.uint8)
    for t in range(int(count.max())):
        live = count > t
        at = base + (pos >> 3)
        w = (buf[at] << 16) | (buf[at + 1] << 8) | buf[at + 2]
        # bits past a stream's end read as zero (``Bits.sub``, the gaps)
        w = (w >> (12 - (pos & 7))) & 0xFFF
        ln = len_t[which, w]
        res[:, t] = sym_t[which, w]
        pos = np.where(live, pos + ln, pos)
    if np.any(pos != ends):
        bad = int(np.flatnonzero(pos != ends)[0])
        raise HuffmanError(f"stream {bad} ends at bit {pos[bad]}, stated {ends[bad]}")
    for i, (off, q, _, _) in enumerate(streams):
        out[off:off + q] = res[i, :q]
