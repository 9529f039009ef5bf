"""Sort-by-rank family SBR(alpha): MTF (alpha=0), RANK (alpha=1/2),
TIMESTAMP (alpha=1).

Re-derived from K/transform/SBRT.java:34-226: symbols are ranked by a
priority q(c) = ((i & m1) + (p[c] & m2)) >> s over previous-occurrence
positions; each input byte emits its current rank and is bubbled up.
Implements the transform ids MTFT and RANK (TransformFactory.java:300-309).

Serial per byte — routed to the C++ kernel; the Python loop is the spec.
"""

from __future__ import annotations

import numpy as np

MODE_MTF = 1
MODE_RANK = 2
MODE_TIMESTAMP = 3


class SBRT:
    def __init__(self, mode: int = MODE_RANK, ctx: dict | None = None) -> None:
        if ctx is not None and "sbrt" in ctx:
            mode = ctx["sbrt"]
        if mode not in (MODE_MTF, MODE_RANK, MODE_TIMESTAMP):
            raise ValueError("invalid SBRT mode")
        self.mode = mode

    def max_encoded_len(self, src_len: int) -> int:
        return src_len

    def _params(self) -> tuple[int, int, int]:
        m1 = 0 if self.mode == MODE_TIMESTAMP else -1
        m2 = 0 if self.mode == MODE_MTF else -1
        s = 1 if self.mode == MODE_RANK else 0
        return m1, m2, s

    def forward(self, src: np.ndarray) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        if src.size == 0:
            return src.copy()
        from ..utils.native_transforms import sbrt_native
        res = sbrt_native(self.mode, src, forward=True)
        if res is not None:
            return res
        m1, m2, s = self._params()
        p = [0] * 256
        q = [0] * 256
        s2r = list(range(256))
        r2s = list(range(256))
        out = np.empty(src.size, dtype=np.uint8)
        for i, c in enumerate(src.tolist()):
            r = s2r[c]
            out[i] = r
            qc = ((i & m1) + (p[c] & m2)) >> s
            p[c] = i
            q[c] = qc
            while r > 0 and q[r2s[r - 1]] <= qc:
                r2s[r] = r2s[r - 1]
                s2r[r2s[r]] = r
                r -= 1
            r2s[r] = c
            s2r[c] = r
        return out

    def inverse(self, src: np.ndarray, count: int | None = None) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        if src.size == 0:
            return src.copy()
        from ..utils.native_transforms import sbrt_native
        res = sbrt_native(self.mode, src, forward=False)
        if res is not None:
            return res
        m1, m2, s = self._params()
        p = [0] * 256
        q = [0] * 256
        r2s = list(range(256))
        out = np.empty(src.size, dtype=np.uint8)
        for i, r in enumerate(src.tolist()):
            c = r2s[r]
            out[i] = c
            qc = ((i & m1) + (p[c] & m2)) >> s
            p[c] = i
            q[c] = qc
            while r > 0 and q[r2s[r - 1]] <= qc:
                r2s[r] = r2s[r - 1]
                r -= 1
            r2s[r] = c
        return out
