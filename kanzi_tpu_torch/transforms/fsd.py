"""Fixed-Step Delta codec (multimedia decorrelation).

Wire format re-derived from K/transform/FSDCodec.java:32-326:
  header: mode byte (0=delta, 1=xor), distance byte (1,2,3,4,8,16),
  then ``dist`` raw bytes, then per byte either zigzag(delta) when
  |delta| <= 127 or ESCAPE(0xFF) + (src ^ src[-dist]).
Forward only applies when sampled entropy improves (same candidate
selection as the reference); inverse is stride-chain scans: XOR mode is a
vectorized XOR-prefix-scan, delta mode a cumsum segmented at escapes.
"""

from __future__ import annotations

import numpy as np

from ..core import magic
from ..core.globals import DataType, detect_simple_type, first_order_entropy_1024
from ..core.types import TransformSkip

MIN_LENGTH = 1024
ESCAPE_TOKEN = 255
DELTA_CODING = 0
XOR_CODING = 1
DISTANCES = (0, 1, 2, 3, 4, 8, 16)


class FSDCodec:
    def __init__(self, ctx: dict | None = None) -> None:
        self.ctx = ctx

    def max_encoded_len(self, src_len: int) -> int:
        return src_len + max(64, src_len >> 4)

    def forward(self, src: np.ndarray) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        count = src.size
        if count == 0:
            return src.copy()
        if count < MIN_LENGTH:
            raise TransformSkip("FSD: block too small")
        if self.ctx is not None:
            dt = self.ctx.get("dataType", DataType.UNDEFINED)
            if dt not in (DataType.UNDEFINED, DataType.MULTIMEDIA, DataType.BIN):
                raise TransformSkip("FSD: wrong data type")
        m = magic.get_type(src[:8].tobytes())
        if m not in (magic.BMP_MAGIC, magic.RIFF_MAGIC, magic.PBM_MAGIC,
                     magic.PGM_MAGIC, magic.PPM_MAGIC, magic.NO_MAGIC):
            raise TransformSkip("FSD: unsupported magic")

        s = src.astype(np.int64)
        count10 = count // 10
        count5 = 2 * count10
        starts = [0, 2 * count5, 4 * count5]
        idx = np.concatenate([np.arange(count10, count5) + st for st in starts])
        ents = []
        hist0 = None
        for k, d in enumerate(DISTANCES):
            vals = (s[idx] ^ s[idx - d]) & 0xFF if d else s[idx]
            h = np.bincount(vals, minlength=256)
            if k == 0:
                hist0 = h
            ents.append(first_order_entropy_1024(3 * count10, h))
        min_idx = int(np.argmin(ents))
        if ents[min_idx] >= ents[0]:
            if self.ctx is not None:
                self.ctx["dataType"] = detect_simple_type(3 * count10, hist0)
            raise TransformSkip("FSD: no entropy gain")
        if self.ctx is not None:
            self.ctx["dataType"] = DataType.MULTIMEDIA
        dist = DISTANCES[min_idx]

        sample = np.arange(2 * count5, 3 * count5)
        deltas = s[sample] - s[sample - dist]
        large = int(((deltas < -127) | (deltas > 127)).sum())
        mode = XOR_CODING if large > (count5 >> 5) else DELTA_CODING

        head = np.array([mode, dist], dtype=np.uint8)
        if mode == XOR_CODING:
            body = (src[dist:] ^ src[:-dist])
            out = np.concatenate([head, src[:dist], body])
        else:
            d = s[dist:] - s[:-dist]
            esc = (d < -127) | (d > 127)
            zig = (((d >> 63) ^ (d << 1)) & 0xFF).astype(np.uint8)
            xorv = (src[dist:] ^ src[:-dist])
            lens = np.where(esc, 2, 1)
            offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
            body = np.empty(int(lens.sum()), dtype=np.uint8)
            body[offs[~esc]] = zig[~esc]
            body[offs[esc]] = ESCAPE_TOKEN
            body[offs[esc] + 1] = xorv[esc]
            out = np.concatenate([head, src[:dist], body])
        if out.size > self.max_encoded_len(count):
            raise TransformSkip("FSD: expanded too much")

        # extra sanity check mirroring the reference (entropy of output sample)
        start1 = 1 * count5
        start2 = 3 * count5
        sel = np.concatenate([out[start1:start1 + count10], out[start2:start2 + count10]])
        h = np.bincount(sel, minlength=256)
        if first_order_entropy_1024(count5, h) >= ents[0]:
            raise TransformSkip("FSD: output entropy check failed")
        return out

    def inverse(self, src: np.ndarray, count: int | None = None) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        n = src.size
        if n == 0:
            return src.copy()
        mode = int(src[0])
        dist = int(src[1])
        if dist < 1 or (dist > 4 and dist not in (8, 16)):
            raise ValueError("FSD: invalid distance")
        body = src[2:]
        if mode == XOR_CODING:
            out = body.copy()
            # XOR prefix-scan along stride `dist`
            m = out.size
            rows = (m + dist - 1) // dist
            pad = np.zeros(rows * dist, dtype=np.uint8)
            pad[:m] = out
            g = pad.reshape(rows, dist)
            g = np.bitwise_xor.accumulate(g, axis=0)
            return g.reshape(-1)[:m]
        if mode != DELTA_CODING:
            raise ValueError("FSD: invalid mode")
        return self._inverse_delta(src, dist, count)

    def _inverse_delta(self, src: np.ndarray, dist: int, count: int | None) -> np.ndarray:
        head = src[2:2 + dist]
        b = src[2 + dist:].astype(np.int64)
        is_ff = b == ESCAPE_TOKEN
        consumed = np.zeros(b.size + 1, dtype=bool)
        bb = is_ff.astype(np.int8)
        change = np.flatnonzero(bb[1:] != bb[:-1]) + 1
        rstarts = np.concatenate([[0], change])
        rends = np.concatenate([change, [b.size]])
        for st, en in zip(rstarts.tolist(), rends.tolist()):
            if is_ff[st]:
                consumed[st + 1:en + 1:2] = True
        consumed = consumed[:b.size]
        tok = np.flatnonzero(~consumed)
        tok_esc = is_ff[tok]
        if tok.size and tok_esc[-1] and tok[-1] == b.size - 1:
            tok = tok[:-1]
            tok_esc = tok_esc[:-1]
        pair = b[np.minimum(tok + 1, b.size - 1)]
        deltas = np.where(tok_esc, 0, ((b[tok] >> 1) ^ -(b[tok] & 1)))
        m = tok.size
        out = np.zeros(dist + m, dtype=np.int64)
        out[:dist] = head
        # chains: out[i] = out[i-dist] + delta (mod 256), escapes are XOR points
        esc_idx = np.flatnonzero(tok_esc)
        # process chain-wise with cumsum, fixing up at escape positions
        rows = (m + dist - 1) // dist
        dpad = np.zeros(rows * dist, dtype=np.int64)
        dpad[:m] = deltas
        grid = dpad.reshape(rows, dist)
        base = out[:dist].copy()
        acc = (np.cumsum(grid, axis=0) + base[None, :])
        res = acc.reshape(-1)[:m]
        if esc_idx.size == 0:
            out[dist:] = res & 0xFF
        else:
            # escapes break the cumsum; re-resolve sequentially per escape
            out[dist:] = res & 0xFF
            # for each chain, walk escape positions in order and re-offset
            for j in range(dist):
                chain_esc = esc_idx[(esc_idx % dist) == (j % dist)] if dist else esc_idx
                # recompute chain serially only if it has escapes
                if chain_esc.size == 0:
                    continue
                pos = j
                prev = int(head[j])
                k = j
                while k < m:
                    if tok_esc[k]:
                        prev = int(pair[k]) ^ prev
                    else:
                        prev = (prev + int(deltas[k])) & 0xFF
                    out[dist + k] = prev
                    k += dist
        res8 = out.astype(np.uint8)
        if count is not None and res8.size > count:
            res8 = res8[:count]
        return res8
