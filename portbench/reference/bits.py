"""MSB-first bit reader over a byte array: the bit order of the kanzi v7
bitstream (kanzi's DefaultInputBitStream)."""

from __future__ import annotations

import numpy as np


class Bits:
    """Reads ``end`` bits of ``data`` (all of it by default), most
    significant bit of each byte first."""

    def __init__(self, data, pos: int = 0, end: int | None = None) -> None:
        self.data = np.frombuffer(bytes(data), dtype=np.uint8) \
            if not isinstance(data, np.ndarray) else data
        self.pos = pos
        self.end = self.data.size * 8 if end is None else end

    def left(self) -> int:
        return self.end - self.pos

    def read(self, n: int) -> int:
        """The next ``n`` bits (0 to 64) as an unsigned integer."""
        if n == 0:
            return 0
        if n < 0 or n > 64 or self.pos + n > self.end:
            raise EOFError(f"read of {n} bits at {self.pos} past {self.end}")
        b0 = self.pos >> 3
        b1 = (self.pos + n + 7) >> 3
        word = int.from_bytes(self.data[b0:b1].tobytes(), "big")
        word >>= (b1 << 3) - (self.pos + n)
        self.pos += n
        return word & ((1 << n) - 1)

    def read_bytes(self, n: int) -> np.ndarray:
        """The next ``n`` whole bytes, at any bit alignment."""
        if n < 0 or self.pos + 8 * n > self.end:
            raise EOFError(f"read of {n} bytes at bit {self.pos} past {self.end}")
        b0, s = self.pos >> 3, self.pos & 7
        self.pos += 8 * n
        if s == 0:
            return self.data[b0:b0 + n].copy()
        a = self.data[b0:b0 + n + 1].astype(np.uint16)
        if a.size < n + 1:
            a = np.concatenate([a, np.zeros(n + 1 - a.size, np.uint16)])
        return (((a[:-1] << s) | (a[1:] >> (8 - s))) & 0xFF).astype(np.uint8)

    def sub(self, nbits: int) -> "Bits":
        """A reader over the next ``nbits`` bits, realigned to bit 0 and
        zero past them; this reader skips them."""
        if self.pos + nbits > self.end:
            raise EOFError(f"{nbits} bits at {self.pos} past {self.end}")
        head = self.read_bytes(nbits >> 3)
        rest = nbits & 7
        if rest:
            tail = np.array([self.read(rest) << (8 - rest)], np.uint8)
            head = np.concatenate([head, tail])
        return Bits(head, 0, nbits)
