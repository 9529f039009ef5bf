"""Zero Run-Length Transform (Wheeler) — post-BWT/MTF stage.

Wire format re-derived from K/transform/ZRLT.java:32-245:
  zero run of R: binary digits of (R+1) below the MSB, one byte per bit
  value 1..0xFD: val+1;  value 0xFE/0xFF: 0xFF, val-0xFE
Output must not exceed input length (otherwise the stage is skipped).

Both directions are fully vectorized (run extraction + prefix-sum scatter) —
the same dataflow as the TPU kernel.
"""

from __future__ import annotations

import numpy as np

from ..core.types import TransformSkip


def _runs(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(start_indices, lengths) of maximal equal-value runs."""
    n = arr.size
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    change = np.flatnonzero(arr[1:] != arr[:-1]) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])
    return starts, ends - starts


class ZRLT:
    def __init__(self, ctx: dict | None = None) -> None:
        self.ctx = ctx

    def max_encoded_len(self, src_len: int) -> int:
        return src_len

    def forward(self, src: np.ndarray) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        n = src.size
        if n == 0:
            return src.copy()
        from ..utils.native_transforms import zrlt_forward_native
        res = zrlt_forward_native(src)
        if res is False:
            raise TransformSkip("ZRLT would expand")
        if res is not None:
            return res
        starts, lengths = _runs(src)
        vals = src[starts].astype(np.int64)
        is_zero = vals == 0
        # output length per run
        rl = lengths + 1  # encoded value R+1
        # log2 floor of rl for zero runs
        zl = np.zeros_like(lengths)
        zr = rl[is_zero]
        if zr.size:
            zl_z = (np.floor(np.log2(zr.astype(np.float64)))).astype(np.int64)
            # guard against float rounding at exact powers of two
            zl_z = np.where((np.int64(1) << (zl_z + 1)) <= zr, zl_z + 1, zl_z)
            zl_z = np.where((np.int64(1) << zl_z) > zr, zl_z - 1, zl_z)
            zl[is_zero] = zl_z
        # non-zero runs: each byte costs 1 (val<0xFE) or 2 (val>=0xFE)
        per_byte = np.where(vals >= 0xFE, 2, 1)
        out_len_per_run = np.where(is_zero, zl, per_byte * lengths)
        total = int(out_len_per_run.sum())
        if total >= n:  # do not expand
            raise TransformSkip("ZRLT would expand")
        out = np.zeros(total, dtype=np.uint8)
        out_starts = np.concatenate([[0], np.cumsum(out_len_per_run)[:-1]])
        # zero runs: write bits of rl below MSB (vectorized scatter)
        zi = np.flatnonzero(is_zero)
        if zi.size:
            ks = zl[zi]
            pos_in = _intra(ks)
            kk = np.repeat(ks, ks)
            vv = np.repeat(rl[zi], ks)
            idx = np.repeat(out_starts[zi], ks) + pos_in
            out[idx] = ((vv >> (kk - 1 - pos_in)) & 1).astype(np.uint8)
        # non-zero runs, value < 0xFE: val+1 repeated
        ni = np.flatnonzero(~is_zero & (vals < 0xFE))
        if ni.size:
            reps = lengths[ni]
            idx = np.repeat(out_starts[ni], reps) + _intra(reps)
            out[idx] = np.repeat(vals[ni] + 1, reps).astype(np.uint8)
        # value >= 0xFE: pairs (0xFF, val-0xFE)
        hi = np.flatnonzero(vals >= 0xFE)
        if hi.size:
            reps = lengths[hi]
            base = np.repeat(out_starts[hi], reps) + 2 * _intra(reps)
            out[base] = 0xFF
            out[base + 1] = np.repeat(vals[hi] - 0xFE, reps).astype(np.uint8)
        return out

    def inverse(self, src: np.ndarray, count: int | None = None) -> np.ndarray:
        """Vectorized exact mirror of ZRLT.java:141-232.  ``count`` is the
        expected output length (known from the block header).

        Token resolution: a 0xFF token consumes the following byte (even a
        0/1 byte); maximal 0xFF runs always start token-aligned because the
        preceding byte is non-FF, so consumed positions are p+1, p+3, ...
        within each run (plus the byte after an odd-length run).
        """
        src = np.asarray(src, dtype=np.uint8)
        n = src.size
        if n == 0:
            return src.copy()
        from ..utils.native_transforms import zrlt_inverse_native
        res = zrlt_inverse_native(src, count)
        if res is not None:
            if count is not None:
                if res.size < count:
                    raise ValueError("ZRLT inverse underflow")
                return res[:count].copy()
            return res.copy()
        s64 = src.astype(np.int64)
        is_ff = s64 == 0xFF
        consumed = np.zeros(n + 1, dtype=bool)
        starts, lengths = _runs(is_ff.astype(np.uint8))
        for st, ln in zip(starts.tolist(), lengths.tolist()):
            if is_ff[st]:
                consumed[st + 1:st + ln + 1:2] = True
        consumed = consumed[:n]
        tok_pos = np.flatnonzero(~consumed)
        tok_val = s64[tok_pos]
        is_bit = tok_val <= 1
        tok_ff = tok_val == 0xFF

        # zero-run groups over consecutive bit tokens
        gstarts, glens = _runs(is_bit.astype(np.uint8))
        out_units_pos: list[np.ndarray] = []
        # literal/ff tokens become 1-byte units; bit groups become run units
        lit_idx = np.flatnonzero(~is_bit)
        # a trailing 0xFF with no pair byte emits nothing (ZRLT.java:198-201)
        lit_idx = lit_idx[~(tok_ff[lit_idx] & (tok_pos[lit_idx] == n - 1))]
        lit_out = np.where(tok_ff[lit_idx],
                           0xFE + s64[np.minimum(tok_pos[lit_idx] + 1, n - 1)],
                           tok_val[lit_idx] - 1)
        # bit-group reconstruction: value = (1<<k | bits) - 1 zeros
        bit_gsel = np.flatnonzero(is_bit[gstarts])
        bg_starts = gstarts[bit_gsel]
        bg_lens = glens[bit_gsel]
        if bg_starts.size:
            gid = np.repeat(np.arange(bg_starts.size), bg_lens)
            pos_in = _intra(bg_lens)
            k = np.repeat(bg_lens, bg_lens)
            bits = tok_val[np.repeat(bg_starts, bg_lens) + pos_in]
            weights = np.int64(1) << (k - 1 - pos_in)
            vals = np.bincount(gid, weights=(bits * weights).astype(np.float64),
                               minlength=bg_starts.size).astype(np.int64)
            # guard: groups longer than 62 bits would overflow — invalid stream
            if np.any(bg_lens > 40):
                raise ValueError("ZRLT inverse: zero run too long")
            zero_runs = ((np.int64(1) << bg_lens) | vals) - 1
        else:
            zero_runs = np.zeros(0, dtype=np.int64)

        # merge units in source order
        unit_pos = np.concatenate([tok_pos[lit_idx], tok_pos[bg_starts]]) \
            if bg_starts.size else tok_pos[lit_idx]
        unit_len = np.concatenate([np.ones(lit_idx.size, dtype=np.int64), zero_runs]) \
            if bg_starts.size else np.ones(lit_idx.size, dtype=np.int64)
        unit_val = np.concatenate([lit_out, np.zeros(zero_runs.size, dtype=np.int64)]) \
            if bg_starts.size else lit_out
        order = np.argsort(unit_pos, kind="stable")
        unit_len = unit_len[order]
        unit_val = unit_val[order]
        total = int(unit_len.sum())
        out = np.zeros(total, dtype=np.uint8)
        offs = np.concatenate([[0], np.cumsum(unit_len)[:-1]])
        ones = unit_len == 1
        out[offs[ones]] = unit_val[ones].astype(np.uint8)
        # zero runs are already zero in the output buffer
        if count is not None:
            if out.size < count:
                raise ValueError("ZRLT inverse underflow")
            out = out[:count]
        return out


def _intra(reps: np.ndarray) -> np.ndarray:
    """[0..r0), [0..r1), ... concatenated."""
    total = int(reps.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(reps)
    starts = ends - reps
    return np.arange(total, dtype=np.int64) - np.repeat(starts, reps)
