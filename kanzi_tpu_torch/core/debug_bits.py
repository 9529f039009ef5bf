"""Debug decorators mirroring K/bitstream/DebugOutputBitStream.java:35 and
DebugInputBitStream.java:36 — wrap a BitWriter/BitReader and mirror every
bit-level operation to a print stream (inspection fake for tests/debugging)."""

from __future__ import annotations

import sys

import numpy as np

from .bits import BitReader, BitWriter


class DebugOutputBitStream:
    def __init__(self, delegate: BitWriter, out=None, width: int = 80,
                 show_byte: bool = False) -> None:
        self.delegate = delegate
        self.out = out or sys.stdout
        self.width = max(width, 8)
        self.show_byte = show_byte
        self._col = 0

    def _emit(self, value: int, count: int) -> None:
        s = format(value & ((1 << count) - 1), f"0{count}b") if count else ""
        for ch in s:
            self.out.write(ch)
            self._col += 1
            if self._col >= self.width:
                self.out.write("\n")
                self._col = 0

    def write_bit(self, bit: int) -> None:
        self._emit(bit & 1, 1)
        self.delegate.write_bit(bit)

    def write_bits(self, value: int, count: int) -> None:
        self._emit(value, count)
        self.delegate.write_bits(value, count)

    def write_bits_vec(self, values, counts) -> None:
        for v, c in zip(np.asarray(values).tolist(), np.asarray(counts).tolist()):
            self._emit(int(v), int(c))
        self.delegate.write_bits_vec(values, counts)

    def write_bytes(self, data, nbits=None) -> None:
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
        n = arr.size * 8 if nbits is None else nbits
        for b in np.unpackbits(arr)[:n].tolist():
            self._emit(b, 1)
        self.delegate.write_bytes(data, nbits)

    def write_bit_array(self, bits) -> None:
        for b in np.asarray(bits).tolist():
            self._emit(int(b), 1)
        self.delegate.write_bit_array(bits)

    def __getattr__(self, name):
        return getattr(self.delegate, name)


class DebugInputBitStream:
    def __init__(self, delegate: BitReader, out=None, width: int = 80) -> None:
        self.delegate = delegate
        self.out = out or sys.stdout
        self.width = max(width, 8)
        self._col = 0

    def _emit(self, value: int, count: int) -> None:
        s = format(value & ((1 << count) - 1), f"0{count}b") if count else ""
        for ch in s:
            self.out.write(ch)
            self._col += 1
            if self._col >= self.width:
                self.out.write("\n")
                self._col = 0

    def read_bit(self) -> int:
        b = self.delegate.read_bit()
        self._emit(b, 1)
        return b

    def read_bits(self, count: int) -> int:
        v = self.delegate.read_bits(count)
        self._emit(v, count)
        return v

    def read_bits_vec(self, counts):
        vals = self.delegate.read_bits_vec(counts)
        for v, c in zip(vals.tolist(), np.asarray(counts).tolist()):
            self._emit(int(v), int(c))
        return vals

    def read_bytes(self, nbytes: int):
        data = self.delegate.read_bytes(nbytes)
        for b in np.unpackbits(data).tolist():
            self._emit(b, 1)
        return data

    def read_bit_array(self, nbits: int):
        bits = self.delegate.read_bit_array(nbits)
        for b in bits.tolist():
            self._emit(int(b), 1)
        return bits

    def __getattr__(self, name):
        return getattr(self.delegate, name)
