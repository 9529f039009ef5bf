"""Huffman coders whose full 16 KiB chunks run on a torch device.

Subclasses of kanzi_tpu.entropy.huffman's coders.  The encoder's full chunks
(16 KiB chunk size, four or more of them) and the decoder's full chunks
(bit-stream version 6 or later, 16 KiB chunk size, a block of at least one
chunk) go through ops/huffman_block.py on the coder's device; every other
case is the parent's host path, as kanzi_tpu's own device gates fall back
to it.
"""

from __future__ import annotations

import numpy as np
import torch

from kanzi_tpu.core.bits import BitReader, BitWriter
from kanzi_tpu.entropy import huffman as hhuf

from ..ops import huffman_block


class HuffmanEncoder(hhuf.HuffmanEncoder):
    def __init__(self, bw: BitWriter, chunk_size: int = hhuf.MAX_CHUNK_SIZE, *,
                 device: torch.device) -> None:
        super().__init__(bw, chunk_size)
        self.device = device

    def _encode_full_chunks_tpu(self, block: np.ndarray, bw: BitWriter) -> int:
        # The name is the reference's seam: its encode() calls this method
        # and writes the rest of the block (the tail chunk) on the host from
        # the offset it returns, or the whole block natively on 0.
        if self.chunk_size != hhuf.MAX_CHUNK_SIZE:
            return 0
        return huffman_block.huffman_encode_full(block, bw, self.device)


class HuffmanDecoder(hhuf.HuffmanDecoder):
    def __init__(self, br: BitReader, chunk_size: int = hhuf.MAX_CHUNK_SIZE,
                 bs_version: int = 7, *, device: torch.device) -> None:
        super().__init__(br, chunk_size, bs_version)
        self.device = device

    def decode(self, count: int, br: BitReader | None = None) -> np.ndarray:
        if (self.bs_version >= 6 and self.chunk_size == hhuf.MAX_CHUNK_SIZE
                and count >= hhuf.MAX_CHUNK_SIZE):
            return huffman_block.huffman_decode(count, br or self.br, self.device)
        return super().decode(count, br)
