"""ANS coders whose order-0 stage runs on a torch device.

Subclasses of kanzi_tpu.entropy.ans's coders.  Order 0 with the default
chunk size and log range (and, on decode, bitstream v4 or later) goes
through ops/ans_block.py on the coder's device; every other case is the
parent's host path, as kanzi_tpu's own device gates fall back to it.
"""

from __future__ import annotations

import numpy as np
import torch

from kanzi_tpu.core.bits import BitReader, BitWriter
from kanzi_tpu.entropy import ans as hans

from ..ops import ans_block


class ANSRangeEncoder(hans.ANSRangeEncoder):
    def __init__(self, bw: BitWriter, order: int = 0,
                 chunk_size: int = hans.DEFAULT_ANS0_CHUNK_SIZE,
                 log_range: int = hans.DEFAULT_LOG_RANGE,
                 ctx: dict | None = None, *, device: torch.device) -> None:
        super().__init__(bw, order, chunk_size, log_range, ctx)
        self.device = device

    def encode(self, block: np.ndarray, bw: BitWriter | None = None) -> int:
        if (self.order == 0
                and self._chunk_size0 == hans.DEFAULT_ANS0_CHUNK_SIZE
                and self._log_range0 == hans.DEFAULT_LOG_RANGE):
            return ans_block.ans0_encode(block, bw or self.bw, self.device)
        return super().encode(block, bw)


class ANSRangeDecoder(hans.ANSRangeDecoder):
    def __init__(self, br: BitReader, order: int = 0,
                 chunk_size: int = hans.DEFAULT_ANS0_CHUNK_SIZE,
                 bs_version: int = 7, ctx: dict | None = None, *,
                 device: torch.device) -> None:
        super().__init__(br, order, chunk_size, bs_version, ctx)
        self.device = device

    def decode(self, count: int, br: BitReader | None = None) -> np.ndarray:
        if (self.order == 0 and self.bs_version >= 4
                and self._chunk_size0 == hans.DEFAULT_ANS0_CHUNK_SIZE):
            return ans_block.ans0_decode(count, br or self.br, self.device)
        return super().decode(count, br)
