"""Identity transform (K/transform/NullTransform.java:30)."""

from __future__ import annotations

import numpy as np


class NullTransform:
    def __init__(self, ctx: dict | None = None) -> None:
        pass

    def max_encoded_len(self, src_len: int) -> int:
        return src_len

    def forward(self, src: np.ndarray) -> np.ndarray:
        return np.asarray(src, dtype=np.uint8).copy()

    def inverse(self, src: np.ndarray, count: int | None = None) -> np.ndarray:
        return np.asarray(src, dtype=np.uint8).copy()
