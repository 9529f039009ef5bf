"""Raw byte passthrough codec (K/entropy/NullEntropyEncoder.java:1-110)."""

from __future__ import annotations

import numpy as np

from ..core.bits import BitReader, BitWriter


class NullEntropyEncoder:
    def __init__(self, bw: BitWriter) -> None:
        self.bw = bw

    def encode(self, block: np.ndarray, bw: BitWriter | None = None) -> int:
        bw = bw or self.bw
        block = np.asarray(block, dtype=np.uint8)
        bw.write_bytes(block.tobytes())
        return block.size

    def dispose(self) -> None:
        pass


class NullEntropyDecoder:
    def __init__(self, br: BitReader) -> None:
        self.br = br

    def decode(self, count: int, br: BitReader | None = None) -> np.ndarray:
        br = br or self.br
        return br.read_bytes(count)

    def dispose(self) -> None:
        pass
