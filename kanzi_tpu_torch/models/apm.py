"""Adaptive probability maps (SSE stages).

Re-derived from K/entropy/LogisticAdaptiveProbMap.java:34-92,
LinearAdaptiveProbMap.java:50-92, FastLogisticAdaptiveProbMap.java:52-90.
Each maps (prediction, context) -> refined prediction over 33/65/32 buckets
with per-bucket adaptation; wire-critical for CM/TPAQ streams.
"""

from __future__ import annotations

import numpy as np

from ..core.globals import SQUASH, STRETCH, squash


class LogisticAdaptiveProbMap:
    def __init__(self, n: int, rate: int) -> None:
        self.rate = rate
        self.index = 0
        base = np.array([squash((j - 16) << 7) << 4 for j in range(33)], dtype=np.int32)
        self.data = np.tile(base, max(n, 1))

    def get(self, bit: int, pr: int, ctx: int) -> int:
        d = self.data
        g = (-bit & 65528) + (bit << self.rate)
        i = self.index
        d[i] += (g - int(d[i])) >> self.rate
        d[i + 1] += (g - int(d[i + 1])) >> self.rate
        pr = int(STRETCH[pr])
        self.index = ((pr + 2048) >> 7) + (ctx << 5) + ctx
        w = pr & 127
        return (int(d[self.index]) * (128 - w) + int(d[self.index + 1]) * w) >> 11


class LinearAdaptiveProbMap:
    def __init__(self, n: int, rate: int) -> None:
        self.rate = rate
        self.index = 0
        base = np.array([(j << 6) << 4 for j in range(65)], dtype=np.int32)
        self.data = np.tile(base, max(n, 1))

    def get(self, bit: int, pr: int, ctx: int) -> int:
        d = self.data
        g = (-bit & 65528) + (bit << self.rate)
        i = self.index
        d[i] += (g - int(d[i])) >> self.rate
        d[i + 1] += (g - int(d[i + 1])) >> self.rate
        self.index = (pr >> 6) + (ctx << 6) + ctx
        w = pr & 127
        return (int(d[self.index]) * (128 - w) + int(d[self.index + 1]) * w) >> 11


class FastLogisticAdaptiveProbMap:
    def __init__(self, n: int, rate: int) -> None:
        self.rate = rate
        self.index = 0
        base = np.array([squash((j - 16) << 7) << 4 for j in range(32)], dtype=np.int32)
        self.data = np.tile(base, max(n, 1))

    def get(self, bit: int, pr: int, ctx: int) -> int:
        d = self.data
        g = (-bit & 65528) + (bit << self.rate)
        i = self.index
        d[i] += (g - int(d[i])) >> self.rate
        self.index = ((int(STRETCH[pr]) + 2048) >> 7) + (ctx << 5)
        return int(d[self.index]) >> 4
