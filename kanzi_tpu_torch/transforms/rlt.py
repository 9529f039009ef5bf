"""Escaped run-length transform.

Wire format re-derived from K/transform/RLT.java:31-422:
  header: escape byte, first data byte (doubled with a 0 if == escape)
  run of L (>= 4 beyond first literal): literal, escape, runlen(L'-3) where
    L' counts repeats after one literal; run lengths use 1-3 bytes
    (RUN_LEN_ENCODE1=224, RUN_LEN_ENCODE2=7936... see emit/parse below)
  escape appearing as data: escape, 0
Forward is skipped for DNA/BASE64/UTF8 data and must shrink the input.

Encode chooses the same escape byte as the reference (least frequent, or
0xFB when an entropy stage follows) and emits an equivalent valid stream;
the decoder is an exact mirror of the reference.
"""

from __future__ import annotations

import numpy as np

from ..core.globals import DataType, detect_simple_type, histogram_order0
from ..core.types import TransformSkip

RUN_LEN_ENCODE1 = 224
RUN_LEN_ENCODE2 = (255 - RUN_LEN_ENCODE1) << 8
RUN_THRESHOLD = 3
MAX_RUN = 0xFFFF + RUN_LEN_ENCODE2 + RUN_THRESHOLD - 1
DEFAULT_ESCAPE = 0xFB


def _emit_run_length(out: list[int], run: int) -> None:
    run -= RUN_THRESHOLD
    if run >= RUN_LEN_ENCODE1:
        if run < RUN_LEN_ENCODE2:
            run -= RUN_LEN_ENCODE1
            out.append(RUN_LEN_ENCODE1 + (run >> 8))
        else:
            run -= RUN_LEN_ENCODE2
            out.append(0xFF)
            out.append((run >> 8) & 0xFF)
    out.append(run & 0xFF)


class RLT:
    def __init__(self, ctx: dict | None = None) -> None:
        self.ctx = ctx

    def max_encoded_len(self, src_len: int) -> int:
        return src_len + 32 if src_len <= 512 else src_len

    def forward(self, src: np.ndarray) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        n = src.size
        if n == 0:
            return src.copy()
        if n < 16:
            raise TransformSkip("RLT needs >= 16 bytes")
        dt = DataType.UNDEFINED
        find_best_escape = True
        if self.ctx is not None:
            dt = self.ctx.get("dataType", DataType.UNDEFINED)
            if dt in (DataType.DNA, DataType.BASE64, DataType.UTF8):
                raise TransformSkip("RLT not applicable to data type")
            ent = str(self.ctx.get("entropy", "NONE")).upper()
            if ent in ("NONE", "ANS0", "HUFFMAN", "RANGE"):
                find_best_escape = False
        escape = DEFAULT_ESCAPE
        if find_best_escape:
            freqs = histogram_order0(src)
            if dt == DataType.UNDEFINED:
                dt = detect_simple_type(n, freqs)
                if self.ctx is not None and dt != DataType.UNDEFINED:
                    self.ctx["dataType"] = dt
                if dt in (DataType.DNA, DataType.BASE64, DataType.UTF8):
                    raise TransformSkip("RLT not applicable to data type")
            escape = int(np.argmin(freqs))

        # vectorized run extraction; only runs needing run-coding or escape
        # doubling are visited in Python, the rest is bulk-copied
        change = np.flatnonzero(src[1:] != src[:-1]) + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [n]])
        lengths = ends - starts
        values = src[starts].astype(np.int64)
        rems = lengths.copy()
        rems[0] -= 1  # first byte goes into the header
        special = (rems >= 4) | ((values == escape) & (rems > 0))
        sp = np.flatnonzero(special)

        buf = src.tobytes()
        out = bytearray([escape, int(values[0])])
        if values[0] == escape:
            out.append(0)
        cap = n  # must shrink
        cursor = 1
        for ri in sp.tolist():
            start = int(starts[ri])
            L = int(lengths[ri])
            rem = int(rems[ri])
            v = int(values[ri])
            start_eff = start + (L - rem)
            out += buf[cursor:start_eff]
            cursor = start + L
            while rem > 0:
                chunk = min(rem, MAX_RUN)
                if chunk >= 4:
                    # one literal + escape + runlen: decodes to `chunk` bytes
                    out.append(v)
                    if v == escape:
                        out.append(0)
                    out.append(escape)
                    _emit_run_length(out, chunk)
                else:
                    if v == escape:
                        out.extend([escape, 0] * chunk)
                    else:
                        out.extend([v] * chunk)
                rem -= chunk
            if len(out) >= cap:
                raise TransformSkip("RLT would expand")
        out += buf[cursor:]
        if len(out) >= cap:
            raise TransformSkip("RLT would expand")
        return np.frombuffer(bytes(out), dtype=np.uint8).copy()

    def inverse(self, src: np.ndarray, count: int | None = None) -> np.ndarray:
        """Exact mirror of RLT.java:301-405."""
        src = np.asarray(src, dtype=np.uint8)
        n = src.size
        if n == 0:
            return src.copy()
        buf = src.tobytes()
        i = 0
        escape = buf[i]; i += 1
        out = bytearray()
        if i < n and buf[i] == escape:
            i += 1
            if i < n and buf[i] != 0:
                raise ValueError("RLT: invalid stream start")
            out.append(escape)
            i += 1
        # iterate escape positions only; bulk-copy literal spans
        esc_pos = np.flatnonzero(src == escape)
        for p in esc_pos.tolist():
            if p < i:
                continue
            out += buf[i:p]  # literals
            i = p + 1
            if i >= n:
                raise ValueError("RLT: truncated escape")
            run = buf[i]; i += 1
            if run == 0:
                out.append(escape)
                continue
            if run == 0xFF:
                if i >= n - 1:
                    raise ValueError("RLT: truncated run length")
                run = (buf[i] << 8) | buf[i + 1]
                i += 2
                run += RUN_LEN_ENCODE2
            elif run >= RUN_LEN_ENCODE1:
                if i >= n:
                    raise ValueError("RLT: truncated run length")
                run = ((run - RUN_LEN_ENCODE1) << 8) | buf[i]
                i += 1
                run += RUN_LEN_ENCODE1
            run += RUN_THRESHOLD - 1
            if run > MAX_RUN or not out:
                raise ValueError("RLT: invalid run")
            out.extend(out[-1:] * run)
        out += buf[i:]
        res = np.frombuffer(bytes(out), dtype=np.uint8)
        if count is not None and res.size != count:
            if res.size < count:
                raise ValueError("RLT inverse underflow")
            res = res[:count]
        return res.copy()
