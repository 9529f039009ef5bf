"""The null entropy codec (kanzi's NullEntropyDecoder.java): the block's
bytes as they are, ``count`` of them, read from the bitstream at whatever
bit they start."""

from __future__ import annotations

import numpy as np

from ..bits import Bits


def decode(bits: Bits, count: int) -> np.ndarray:
    return bits.read_bytes(count)
