"""BCM-style context-mixing bit predictor (used by the CM entropy stage).

Re-derived from K/entropy/CMPredictor.java:36-187: two counter banks —
counter1[256][257] (fast/medium rates keyed by bit context and previous
byte) and counter2[512][17] (slow rate, 16-bucket interpolation keyed by
bit context | run mask) — blended 13:13:6 then refined by the bucket pair.
All constants are wire-critical (they drive the arithmetic coder).
"""

from __future__ import annotations

import numpy as np

FAST_RATE = 2
MEDIUM_RATE = 4
SLOW_RATE = 6
PSCALE = 65536


class CMPredictor:
    native_id = 1  # predictor id understood by the native binary coder

    def __init__(self, ctx: dict | None = None) -> None:
        bs_version = (ctx or {}).get("bsVersion", 7)
        # pre-v4 streams use the interpolated SSE variant (CMPredictor.java:180)
        self._legacy_v3 = bs_version < 4
        self._used = False
        self.c1 = 0
        self.c2 = 0
        self.ctx = 1
        self.idx = 0
        self.run_mask = 0
        self.counter1 = np.full((256, 257), PSCALE >> 1, dtype=np.int32)
        c2 = np.zeros((512, 17), dtype=np.int32)
        c2[:, :16] = np.arange(16, dtype=np.int32) << 12
        c2[:, 16] = (15 << 12) if self._legacy_v3 else 65535
        self.counter2 = c2

    def native_encode(self, enc, block, bw) -> bool:
        if self._used or self._legacy_v3:
            return False  # state not fresh; use the Python spec path
        from ..utils.native_coders import cm_encode_native
        return cm_encode_native(enc, block, bw)

    def native_decode(self, dec, count, br):
        if self._used or self._legacy_v3:
            return None
        from ..utils.native_coders import cm_decode_native
        return cm_decode_native(dec, count, br)

    def get(self) -> int:
        pc1 = self.counter1[self.ctx]
        p = (13 * (int(pc1[256]) + int(pc1[self.c1])) + 6 * int(pc1[self.c2])) >> 5
        self.idx = p >> 12
        pc2 = self.counter2[self.ctx | self.run_mask]
        x1 = int(pc2[self.idx])
        x2 = int(pc2[self.idx + 1])
        if self._legacy_v3:
            ssep = x1 + (((x2 - x1) * (p & 4095)) >> 12)
            return (p + 3 * ssep + 32) >> 6
        return (p + p + 3 * (x1 + x2) + 64) >> 7

    def update(self, bit: int) -> None:
        self._used = True
        c1 = self.counter1[self.ctx]
        c2 = self.counter2[self.ctx | self.run_mask]
        i = self.idx
        if bit == 0:
            c1[256] -= int(c1[256]) >> FAST_RATE
            c1[self.c1] -= int(c1[self.c1]) >> MEDIUM_RATE
            c2[i] -= int(c2[i]) >> SLOW_RATE
            c2[i + 1] -= int(c2[i + 1]) >> SLOW_RATE
            self.ctx += self.ctx
        else:
            c1[256] -= (int(c1[256]) - PSCALE + 16) >> FAST_RATE
            c1[self.c1] -= (int(c1[self.c1]) - PSCALE + 16) >> MEDIUM_RATE
            c2[i] -= (int(c2[i]) - PSCALE + 16) >> SLOW_RATE
            c2[i + 1] -= (int(c2[i + 1]) - PSCALE + 16) >> SLOW_RATE
            self.ctx += self.ctx + 1
        if self.ctx > 255:
            self.c2 = self.c1
            self.c1 = self.ctx & 0xFF
            self.ctx = 1
            self.run_mask = 0x100 if self.c1 == self.c2 else 0
