"""Bijective BWT (Scott variant) — no primary index.

Re-derived from K/transform/BWTS.java:33-337: suffix array + in-place
Lyndon-word head rotations so every factor's rotation sorts into the global
order; inverse is a multi-cycle LF walk.  Not part of any level preset
(selected via -t BWTS); clarity over speed.
"""

from __future__ import annotations

import numpy as np

from .bwt import suffix_array

MAX_BLOCK_SIZE = 1024 * 1024 * 1024


class BWTS:
    def __init__(self, ctx: dict | None = None, **kw) -> None:
        pass

    def max_encoded_len(self, src_len: int) -> int:
        return src_len

    def forward(self, src: np.ndarray) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        count = src.size
        if count < 2:
            return src.copy()
        data = src.astype(np.int64)
        sa = suffix_array(src).astype(np.int64).tolist()
        isa = [0] * count
        for i, s in enumerate(sa):
            isa[s] = i
        d = data.tolist()

        def move_lyndon_word_head(start: int, size: int, rank: int) -> int:
            end = start + size
            while rank + 1 < count:
                next_start0 = sa[rank + 1]
                if next_start0 <= end:
                    break
                next_start = next_start0
                k = 0
                while k < size and next_start < count and d[start + k] == d[next_start]:
                    k += 1
                    next_start += 1
                if k == size and rank < isa[next_start]:
                    break
                if k < size and next_start < count and d[start + k] < d[next_start]:
                    break
                sa[rank] = next_start0
                isa[next_start0] = rank
                rank += 1
            sa[rank] = start
            isa[start] = rank
            return rank

        mn = isa[0]
        idx_min = 0
        i = 1
        while i < count and mn > 0:
            if isa[i] >= mn:
                i += 1
                continue
            ref_rank = move_lyndon_word_head(idx_min, i - idx_min, mn)
            for j in range(i - 1, idx_min, -1):
                test_rank = isa[j]
                start_rank = test_rank
                while test_rank < count - 1:
                    next_rank_start = sa[test_rank + 1]
                    if (j > next_rank_start or d[j] != d[next_rank_start]
                            or ref_rank < isa[next_rank_start + 1]):
                        break
                    sa[test_rank] = next_rank_start
                    isa[next_rank_start] = test_rank
                    test_rank += 1
                sa[test_rank] = j
                isa[j] = test_rank
                ref_rank = test_rank
                if start_rank == test_rank:
                    break
            mn = isa[i]
            idx_min = i
            i += 1

        out = np.empty(count, dtype=np.uint8)
        mn = count
        for i in range(count):
            if isa[i] >= mn:
                out[isa[i]] = d[i - 1]
                continue
            if mn < count:
                out[mn] = d[i - 1]
            mn = isa[i]
        out[0] = d[count - 1]
        return out

    def inverse(self, src: np.ndarray, count: int | None = None) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        n = src.size
        if n < 2:
            return src.copy()
        buckets = np.bincount(src, minlength=256).astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(buckets)[:-1]])
        # lf[i] = rank of src[i] among equal symbols (stable counting sort)
        order = np.argsort(src, kind="stable")
        lf = np.empty(n, dtype=np.int64)
        lf[order] = np.arange(n)
        lf_list = lf.tolist()
        data = src.tolist()
        out = np.empty(n, dtype=np.uint8)
        j = n - 1
        for i in range(n):
            if lf_list[i] < 0:
                continue
            p = i
            while True:
                out[j] = data[p]
                j -= 1
                t = lf_list[p]
                lf_list[p] = -1
                p = t
                if lf_list[p] < 0:
                    break
        return out
