"""Exponential-Golomb byte coder (signed and unsigned).

Wire format re-derived from K/entropy/ExpGolombEncoder.java:25-141 and
ExpGolombDecoder.java:25-100.  Rather than copying the reference's cached
table, codewords are generated from the closed form; the generated table is
identical (including the reference's magnitude-wrapping quirk for unsigned
inputs > 128, where byte b > 128 encodes the magnitude 256-b):

  zero        -> single '1' bit
  unsigned v  -> k = floor(log2(v+1)); k zeros, '1', k bits of v-(2^k-1)
  signed  s   -> k = floor(log2(|s|+1)); k zeros, '1', k bits of |s|-(2^k-1),
                 then one sign bit
"""

from __future__ import annotations

import numpy as np

from ..core.bits import BitReader, BitWriter


def _build_tables(signed: bool) -> tuple[np.ndarray, np.ndarray]:
    vals = np.zeros(256, dtype=np.uint64)
    cnts = np.zeros(256, dtype=np.int64)
    vals[0], cnts[0] = 1, 1
    for i in range(1, 256):
        if signed:
            s = i - 256 if i >= 128 else i
            a = -s if s < 0 else s
            sgn = 1 if s < 0 else 0
            k = (a + 1).bit_length() - 1
            r = a - ((1 << k) - 1)
            vals[i] = (1 << (k + 1)) | (r << 1) | sgn
            cnts[i] = 2 * k + 2
        else:
            v = i if i <= 128 else 256 - i  # reference quirk: magnitude wrap
            k = (v + 1).bit_length() - 1
            r = v - ((1 << k) - 1)
            vals[i] = (1 << k) | r
            cnts[i] = 2 * k + 1
    return vals, cnts


_TABLES = {False: _build_tables(False), True: _build_tables(True)}


class ExpGolombEncoder:
    def __init__(self, bw: BitWriter, signed: bool) -> None:
        self.bw = bw
        self.signed = signed
        self._vals, self._cnts = _TABLES[signed]

    def encode_byte(self, val: int) -> None:
        i = val & 0xFF
        self.bw.write_bits(int(self._vals[i]), int(self._cnts[i]))

    def encode(self, block: np.ndarray, bw: BitWriter | None = None) -> int:
        """Vectorized bulk encode."""
        bw = bw or self.bw
        b = np.asarray(block, dtype=np.uint8)
        bw.write_bits_vec(self._vals[b], self._cnts[b])
        return b.size

    def dispose(self) -> None:
        pass


class ExpGolombDecoder:
    def __init__(self, br: BitReader, signed: bool) -> None:
        self.br = br
        self.signed = signed

    def decode_byte(self) -> int:
        """Returns the decoded byte (0..255, two's complement for signed)."""
        br = self.br
        if br.read_bit() == 1:
            return 0
        k = 1
        while br.read_bit() == 0:
            k += 1
        if self.signed:
            res = br.read_bits(k + 1)
            sgn = res & 1
            res = (res >> 1) + (1 << k) - 1
            return ((res - sgn) ^ -sgn) & 0xFF
        return ((1 << k) - 1 + br.read_bits(k)) & 0xFF

    def decode(self, count: int, br: BitReader | None = None) -> np.ndarray:
        br = br or self.br
        out = np.empty(count, dtype=np.uint8)
        for i in range(count):
            out[i] = self.decode_byte()
        return out

    def dispose(self) -> None:
        pass
