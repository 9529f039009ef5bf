"""FPAQ order-0 bitwise arithmetic coder.

Wire format re-derived from K/entropy/FPAQEncoder.java:45-239 and
FPAQDecoder.java:45-330 (V2 path, bitstream >= 4): same 56-bit range coder
skeleton as the binary coder but with split shift >>8, fixed 4 MiB chunks,
and 4x256 probability tables selected by the top-2 bits of the previous
byte; per-bit context walks the byte's bit tree (ctx starts at 1).
Adaptation rate 6.
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
DEFAULT_CHUNK_SIZE = 4 * 1024 * 1024
MAX_BLOCK_SIZE = 1 << 30
PSCALE = 65536


class FPAQEncoder:
    def __init__(self, bw: BitWriter, legacy_v3: bool = False) -> None:
        self.bw = bw
        self.low = 0
        self.high = TOP
        self.probs = np.full((4, 256), PSCALE >> 1, dtype=np.int32)
        self._out: list[int] = []
        self._disposed = False
        # pre-v4 wire (12-bit split); only used to author legacy fixtures
        self._legacy_v3 = legacy_v3

    def encode(self, block: np.ndarray, bw: BitWriter | None = None) -> int:
        bw = bw or self.bw
        block = np.asarray(block, dtype=np.uint8)
        count = block.size
        if count == 0:
            return 0
        if count > MAX_BLOCK_SIZE:
            raise ValueError("block too large")
        if not self._legacy_v3:
            from ..utils.native_coders import fpaq_encode_native
            if fpaq_encode_native(self, block, bw):
                return count
        start = 0
        while start < count:
            chunk = min(DEFAULT_CHUNK_SIZE, count - start)
            self._out = []
            p = self.probs[0]
            for i in range(start, start + chunk):
                val = int(block[i])
                ctx = 1
                for k in range(7, -1, -1):
                    bit = (val >> k) & 1
                    self._encode_bit(bit, p, ctx)
                    ctx = (ctx << 1) | bit
                p = self.probs[val >> 6]
            payload = np.array(self._out, dtype=">u4").tobytes()
            eu.write_varint(bw, len(payload))
            bw.write_bytes(payload)
            start += chunk
            if start < count:
                bw.write_bits(self.low | MASK_0_24, 56)
        return count

    def _encode_bit(self, bit: int, p: np.ndarray, ctx: int) -> None:
        pv = int(p[ctx])
        if self._legacy_v3:
            split = (((self.high - self.low) >> 4) * (pv >> 4)) >> 8
        else:
            split = (((self.high - self.low) >> 8) * pv) >> 8
        if bit == 0:
            self.low += split + 1
            p[ctx] = pv - (pv >> 6)
        else:
            self.high = self.low + split
            p[ctx] = pv - ((pv - PSCALE + 64) >> 6)
        while ((self.low ^ self.high) & MASK_24_56) == 0:
            self._out.append((self.high >> 24) & MASK_0_32)
            self.low = (self.low << 32) & MASK_0_56
            self.high = ((self.high << 32) | MASK_0_32) & MASK_0_56

    def dispose(self) -> None:
        if self._disposed:
            return
        self._disposed = True
        self.bw.write_bits(self.low | MASK_0_24, 56)


class FPAQDecoder:
    def __init__(self, br: BitReader, ctx: dict | None = None) -> None:
        bs_version = (ctx or {}).get("bsVersion", 7)
        # pre-v4 split uses a 12-bit prediction (FPAQDecoder.java:145, :197)
        self._legacy_v3 = bs_version < 4
        self.br = br
        self.low = 0
        self.high = TOP
        self.current = 0
        self.probs = np.full((4, 256), PSCALE >> 1, dtype=np.int32)
        self._buf = b""
        self._idx = 0
        self._limit = 0

    def decode(self, count: int, br: BitReader | None = None) -> np.ndarray:
        br = br or self.br
        if count == 0:
            return np.zeros(0, dtype=np.uint8)
        if count > MAX_BLOCK_SIZE:
            raise ValueError("block too large")
        if not self._legacy_v3:
            from ..utils.native_coders import fpaq_decode_native
            res = fpaq_decode_native(self, count, br)
            if res is not None:
                return res
        out = np.empty(count, dtype=np.uint8)
        start = 0
        while start < count:
            chunk = min(DEFAULT_CHUNK_SIZE, count - start)
            sz = eu.read_varint(br)
            max_sz = min(chunk << 5, (1 << 31) >> 3)
            if sz > max_sz:
                raise BitStreamError("invalid FPAQ chunk size",
                                     BitStreamError.INVALID_STREAM)
            self.current = br.read_bits(56)
            self._buf = br.read_bytes(sz).tobytes() if sz else b""
            self._idx = 0
            self._limit = sz
            p = self.probs[0]
            for i in range(start, start + chunk):
                ctx = 1
                for _ in range(8):
                    ctx = (ctx << 1) | self._decode_bit(p, ctx)
                out[i] = ctx & 0xFF
                p = self.probs[(ctx & 0xFF) >> 6]
                if self._idx > sz:
                    raise BitStreamError("FPAQ payload overrun",
                                         BitStreamError.INVALID_STREAM)
            start += chunk
        return out

    def _decode_bit(self, p: np.ndarray, ctx: int) -> int:
        pv = int(p[ctx])
        if self._legacy_v3:
            split = ((((self.high - self.low) >> 4) * (pv >> 4)) >> 8) + self.low
        else:
            split = ((((self.high - self.low) >> 8) * pv) >> 8) + self.low
        if split >= self.current:
            bit = 1
            self.high = split
            p[ctx] = pv - ((pv - PSCALE + 64) >> 6)
        else:
            bit = 0
            self.low = split + 1
            p[ctx] = pv - (pv >> 6)
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
