"""Adaptive binary arithmetic coder over a Predictor.

Wire format re-derived from K/entropy/BinaryEntropyEncoder.java:41-256 and
BinaryEntropyDecoder.java:42-270:

  56-bit low/high range; split = ((high-low)>>4 * pred) >> 8 with pred in
  [0..4095]; when the top 32 bits (bits 24..55) of low and high agree they
  are flushed as 4 bytes.  Blocks are chunked (chunk = block size, split into
  8ths/16ths above 64 MiB); each chunk emits varint(payload bytes) followed
  by payload; the final 56-bit low (low | 0xFFFFFF) closes each chunk (the
  decoder's initial 56-bit window overlaps the payload, so the byte counts
  line up).

Used by CM/TPAQ/TPAQX via the factory.  The Python bit loop is the reference
spec; large blocks are routed to the C++ native kernel (native/binary_coder)
when the predictor has a native implementation.
"""

from __future__ import annotations

import numpy as np

from ..core.bits import BitReader, BitWriter
from ..core.errors import BitStreamError
from . import utils as eu

TOP = 0x00FFFFFFFFFFFFFF
MASK_24_56 = 0x00FFFFFFFF000000
MASK_0_24 = 0x0000000000FFFFFF
MASK_0_32 = 0x00000000FFFFFFFF
MASK_0_56 = 0x00FFFFFFFFFFFFFF
MAX_BLOCK_SIZE = 1 << 30
MAX_CHUNK_SIZE = 1 << 26


class BinaryEntropyEncoder:
    def __init__(self, bw: BitWriter, predictor) -> None:
        self.bw = bw
        self.predictor = predictor
        self.low = 0
        self.high = TOP
        self._out: list[int] = []  # flushed 32-bit words
        self._disposed = False

    def encode(self, block: np.ndarray, bw: BitWriter | None = None) -> int:
        bw = bw or self.bw
        block = np.asarray(block, dtype=np.uint8)
        count = block.size
        if count == 0:
            return 0
        if count > MAX_BLOCK_SIZE:
            raise ValueError("block too large")
        native = getattr(self.predictor, "native_encode", None)
        if native is not None and native(self, block, bw):
            return count
        length = 64 if count < 64 else count
        if count >= MAX_CHUNK_SIZE:
            length = count >> 3 if count < 8 * MAX_CHUNK_SIZE else count >> 4
        start = 0
        while start < count:
            chunk = min(length, count - start)
            self._out = []
            for i in range(start, start + chunk):
                self._encode_byte(int(block[i]))
            payload = np.array(self._out, dtype=">u4").tobytes()
            eu.write_varint(bw, len(payload))
            bw.write_bytes(payload)
            start += chunk
            if start < count:
                bw.write_bits(self.low | MASK_0_24, 56)
        return count

    def _encode_byte(self, val: int) -> None:
        for k in range(7, -1, -1):
            self._encode_bit((val >> k) & 1, self.predictor.get())

    def _encode_bit(self, bit: int, pred: int) -> None:
        split = (((self.high - self.low) >> 4) * pred) >> 8
        if bit == 0:
            self.low += split + 1
        else:
            self.high = self.low + split
        self.predictor.update(bit)
        while ((self.low ^ self.high) & MASK_24_56) == 0:
            self._out.append((self.high >> 24) & MASK_0_32)
            self.low = (self.low << 32) & MASK_0_56
            self.high = ((self.high << 32) | MASK_0_32) & MASK_0_56

    def dispose(self) -> None:
        if self._disposed:
            return
        self._disposed = True
        self.bw.write_bits(self.low | MASK_0_24, 56)


class BinaryEntropyDecoder:
    def __init__(self, br: BitReader, predictor) -> None:
        self.br = br
        self.predictor = predictor
        self.low = 0
        self.high = TOP
        self.current = 0
        self._buf = b""
        self._idx = 0
        self._limit = 0

    def decode(self, count: int, br: BitReader | None = None) -> np.ndarray:
        br = br or self.br
        if count == 0:
            return np.zeros(0, dtype=np.uint8)
        if count > MAX_BLOCK_SIZE:
            raise ValueError("block too large")
        native = getattr(self.predictor, "native_decode", None)
        if native is not None:
            res = native(self, count, br)
            if res is not None:
                return res
        out = np.empty(count, dtype=np.uint8)
        length = 64 if count < 64 else count
        if count >= MAX_CHUNK_SIZE:
            length = count >> 3 if count < 8 * MAX_CHUNK_SIZE else count >> 4
        start = 0
        while start < count:
            chunk = min(length, count - start)
            sz = eu.read_varint(br)
            max_sz = min(chunk << 5, (1 << 31) >> 3)
            if sz > max_sz:
                raise BitStreamError("invalid binary coder chunk size",
                                     BitStreamError.INVALID_STREAM)
            self.current = br.read_bits(56)
            self._buf = br.read_bytes(sz).tobytes() if sz else b""
            self._idx = 0
            self._limit = sz
            for i in range(start, start + chunk):
                out[i] = self._decode_byte()
                if self._idx > sz:
                    raise BitStreamError("binary coder payload overrun",
                                         BitStreamError.INVALID_STREAM)
            start += chunk
        return out

    def _decode_byte(self) -> int:
        v = 0
        for _ in range(8):
            v = (v << 1) | self._decode_bit(self.predictor.get())
        return v

    def _decode_bit(self, pred: int) -> int:
        split = ((((self.high - self.low) >> 4) * pred) >> 8) + self.low
        if split >= self.current:
            bit = 1
            self.high = split
        else:
            bit = 0
            self.low = split + 1
        self.predictor.update(bit)
        while ((self.low ^ self.high) & MASK_24_56) == 0:
            self.low = (self.low << 32) & MASK_0_56
            self.high = ((self.high << 32) | MASK_0_32) & MASK_0_56
            if self._idx + 4 > self._limit:
                self.current = (self.current << 32) & MASK_0_56
                self._idx = self._limit + 1
            else:
                val = int.from_bytes(self._buf[self._idx:self._idx + 4], "big")
                self.current = ((self.current << 32) | val) & MASK_0_56
                self._idx += 4
        return bit

    def dispose(self) -> None:
        pass
