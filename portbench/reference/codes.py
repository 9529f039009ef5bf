"""Small wire codes shared by kanzi's entropy coders (EntropyUtils.java,
ExpGolombDecoder.java)."""

from __future__ import annotations

import numpy as np

from .bits import Bits


def read_alphabet(bits: Bits) -> np.ndarray:
    """The sorted symbol set: bit 0 then bit 1 = none, bit 0 then 0 = all
    256; bit 1: the index of the last 8-symbol mask (5 bits), then that many
    masks plus one, 8 bits each, symbol 8m + b present when bit b (from the
    least significant) of mask m is set."""
    if bits.read(1) == 0:
        return np.zeros(0, np.int64) if bits.read(1) else np.arange(256)
    last = bits.read(5)
    present = []
    for m in range(last + 1):
        mask = bits.read(8)
        present += [8 * m + b for b in range(8) if mask >> b & 1]
    return np.array(present, np.int64)


def read_varint(bits: Bits) -> int:
    """Little-endian base-128 varint of at most five bytes."""
    value, shift = 0, 0
    while True:
        b = bits.read(8)
        value |= (b & 0x7F) << shift
        if b < 128 or shift == 28:
            return value
        shift += 7


def read_signed_expgolomb(bits: Bits) -> int:
    """One signed Exp-Golomb value: '1' is 0; else k zeros up to a '1',
    then k + 1 bits r: magnitude (r >> 1) + 2^k - 1, negative when r is
    odd."""
    if bits.read(1):
        return 0
    k = 1
    while bits.read(1) == 0:
        k += 1
    r = bits.read(k + 1)
    mag = (r >> 1) + (1 << k) - 1
    return -mag if r & 1 else mag
