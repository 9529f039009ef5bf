"""LZ codec facade: LZ/LZX (token-stream LZ77) and LZP (context-predicted).

Wire format re-derived from K/transform/LZCodec.java:125-1288 (see
native/lz.cpp for the layout).  The hot paths run in C++; Python fallback
decoders are exact mirrors (encoders skip the stage without the native lib,
which is always a valid choice thanks to per-stage skip flags).
"""

from __future__ import annotations

import os

import numpy as np

from ..core.globals import DataType
from ..core.types import TransformSkip
from ..utils import native_transforms as nt

MAX_DISTANCE1 = (1 << 16) - 2
MAX_DISTANCE2 = (1 << 24) - 2


class LZXCodec:
    """LZ (hash log 16) / LZX (hash log 19, extra match attempt)."""

    def __init__(self, ctx: dict | None = None, extra: bool = False) -> None:
        self.ctx = ctx
        self.extra = extra
        self.bs_version = (ctx or {}).get("bsVersion", 7)
        if ctx is not None:
            from .factory import LZ_TYPE, LZX_TYPE
            self.extra = ctx.get("lz", LZ_TYPE) == LZX_TYPE

    def max_encoded_len(self, src_len: int) -> int:
        return (src_len + 16 if src_len <= 1024 else src_len + (src_len >> 6)) + 2

    def forward(self, src: np.ndarray) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        count = src.size
        if count == 0:
            return src.copy()
        min_match = 0
        if self.ctx is not None:
            dt = self.ctx.get("dataType", DataType.UNDEFINED)
            if dt == DataType.DNA:
                min_match = 6
            elif dt == DataType.SMALL_ALPHABET:
                raise TransformSkip("LZX: small alphabet")
        # stream-engine batch hint: the block engine may have already run
        # the batched device parse for this exact block (io/stream.py
        # _device_lz_batch); honor it only when parameters agree
        hint = (self.ctx or {}).pop("_lz_hint", None)
        if hint is not None and hint[0] == (min_match or 4):
            if hint[1] is None:
                raise TransformSkip("LZX: no gain")
            return hint[1]
        # the device parse (ops/lz_sort.py) on the stream's torch device,
        # opt-in with KANZI_TPU_DEVICE_LZ; with no device (the host coders)
        # the variable is ignored
        device = (self.ctx or {}).get("_device")
        gate = os.environ.get("KANZI_TPU_DEVICE_LZ", "0")
        if device is not None and gate != "0" and count >= 4096:
            if gate == "legacy":
                raise NotImplementedError(
                    "KANZI_TPU_DEVICE_LZ=legacy: the v1 device LZ engine is "
                    "not ported (ROADMAP M8)")
            from ..ops.lz_sort import lzx_forward_device_v2
            res = lzx_forward_device_v2(src, self.extra, min_match,
                                        device=device)
            if res is None:
                raise TransformSkip("LZX: no gain")
            return res
        res = nt.lzx_forward_native(src, self.extra, min_match)
        if res is None:
            raise TransformSkip("LZX: native kernel unavailable")
        if res.size == 0:
            raise TransformSkip("LZX: no gain")
        return res

    def inverse(self, src: np.ndarray, count: int | None = None) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        if src.size == 0:
            return src.copy()
        if self.bs_version < 6:
            return _lzx_inverse_v5_py(src, count)
        if count is not None:
            res = nt.lzx_inverse_native(src, count)
            if res is not None:
                return res
            return _lzx_inverse_py(src, count)
        # unknown output size (mid-sequence): grow the buffer on demand
        cap = src.size * 4 + 65536
        while cap <= (1 << 30):
            try:
                res = nt.lzx_inverse_native(src, cap)
            except ValueError:
                res = None
            if res is not None:
                return res
            cap *= 4
        return _lzx_inverse_py(src, 1 << 30)

    def dispose(self) -> None:
        pass


class LZPCodec:
    """LZ-predict: order-4 context hash, match flag 0xFC, min match 64
    (96 before bitstream v4, LZCodec.java:1161)."""

    def __init__(self, ctx: dict | None = None) -> None:
        self.ctx = ctx
        self.bs_version = (ctx or {}).get("bsVersion", 7)

    def max_encoded_len(self, src_len: int) -> int:
        return src_len + 16 if src_len <= 1024 else src_len + (src_len >> 6)

    def forward(self, src: np.ndarray) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        if src.size == 0:
            return src.copy()
        res = nt.lzp_forward_native(src)
        if res is None:
            raise TransformSkip("LZP: native kernel unavailable")
        if res.size == 0:
            raise TransformSkip("LZP: no gain")
        return res

    def inverse(self, src: np.ndarray, count: int | None = None) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        if src.size == 0:
            return src.copy()
        if self.bs_version < 4:
            return _lzp_inverse_py(src, min_match=96)
        if count is not None:
            res = nt.lzp_inverse_native(src, count)
            if res is not None:
                return res
            return _lzp_inverse_py(src)
        cap = src.size * 4 + 65536
        while cap <= (1 << 30):
            try:
                res = nt.lzp_inverse_native(src, cap)
            except ValueError:
                res = None
            if res is not None:
                return res
            cap *= 4
        return _lzp_inverse_py(src)


class LZCodec:
    """Facade matching TransformFactory dispatch (LZCodec.java:32-122)."""

    def __init__(self, ctx: dict | None = None, lzp: bool = False) -> None:
        self._delegate = LZPCodec(ctx) if lzp else LZXCodec(ctx)

    def max_encoded_len(self, src_len: int) -> int:
        return self._delegate.max_encoded_len(src_len)

    def forward(self, src: np.ndarray) -> np.ndarray:
        return self._delegate.forward(src)

    def inverse(self, src: np.ndarray, count: int | None = None) -> np.ndarray:
        return self._delegate.inverse(src, count)


# --------------------------------------------------------------------------
# exact Python mirrors of the decoders (fallback / spec)
# --------------------------------------------------------------------------

def _read_len(src, idx: int) -> tuple[int, int]:
    res = int(src[idx]); idx += 1
    if res < 254:
        return res, idx
    if res == 254:
        res += int(src[idx]) << 8
        res += int(src[idx + 1])
        return res, idx + 2
    res += int(src[idx]) << 16
    res += int(src[idx + 1]) << 8
    res += int(src[idx + 2])
    return res, idx + 3


def _lzx_inverse_py(src: np.ndarray, count: int) -> np.ndarray:
    n = src.size
    if n < 13:
        raise ValueError("LZX: truncated")
    tk_len = int.from_bytes(src[0:4].tobytes(), "little")
    m_idx_len = int.from_bytes(src[4:8].tobytes(), "little")
    m_len_len = int.from_bytes(src[8:12].tobytes(), "little")
    if tk_len < 13 or tk_len > n or m_idx_len > n - tk_len or m_len_len > n - tk_len - m_idx_len:
        raise ValueError("LZX: bad section lengths")
    tk_idx = tk_len
    m_idx = tk_idx + m_idx_len
    m_len_idx = m_idx + m_len_len
    src_end = tk_len - 13
    lit_end = tk_len
    max_dist = MAX_DISTANCE1 if (src[12] & 1) == 0 else MAX_DISTANCE2
    min_match = ((int(src[12]) >> 1) & 0x07) + 2
    src_idx = 13
    dst = bytearray()
    repd0 = repd1 = n
    buf = src
    while True:
        token = int(buf[tk_idx]); tk_idx += 1
        if token >= 32:
            if token >= 0xE0:
                lit_len, src_idx = _read_len(buf, src_idx)
                lit_len += 7
            else:
                lit_len = token >> 5
            if lit_len > lit_end - src_idx:
                raise ValueError("LZX: literal overrun")
            dst += buf[src_idx:src_idx + lit_len].tobytes()
            src_idx += lit_len
            if src_idx >= src_end:
                break
        f = token & 0x18
        if f == 0:
            m_len = token & 0x03
            if m_len == 3:
                ext, m_len_idx = _read_len(buf, m_len_idx)
                m_len = 3 + min_match + ext
            else:
                m_len += min_match
            dist = repd0 if (token & 0x04) == 0 else repd1
        else:
            m_len = token & 0x07
            if m_len == 7:
                ext, m_len_idx = _read_len(buf, m_len_idx)
                m_len = 7 + min_match + ext
            else:
                m_len += min_match
            dist = int(buf[m_idx]); m_idx += 1
            if f == 0x18:
                dist = (dist << 8) | int(buf[m_idx]); m_idx += 1
                dist = (dist << 8) | int(buf[m_idx]); m_idx += 1
            elif f == 0x10:
                dist = (dist << 8) | int(buf[m_idx]); m_idx += 1
        repd1 = repd0
        repd0 = dist
        ref = len(dst) - dist
        if ref < 0 or dist > max_dist:
            raise ValueError("LZX: bad distance")
        for _ in range(m_len):
            dst.append(dst[ref])
            ref += 1
    if src_idx != src_end + 13:
        raise ValueError("LZX: stream mismatch")
    out = np.frombuffer(bytes(dst), dtype=np.uint8)
    return out[:count].copy()


def _lzx_inverse_v5_py(src: np.ndarray, count: int | None) -> np.ndarray:
    """Pre-v6 LZ/LZX block layout (LZCodec.java:768-900): token LLLFMMMM
    with 3-bit literal lengths, rep-distance selected by bit 0x10 when
    mLen == 15, distance width from the mode byte's low bit."""
    n = src.size
    if n < 13:
        raise ValueError("LZX: truncated")
    tk_len = int.from_bytes(src[0:4].tobytes(), "little")
    m_idx_len = int.from_bytes(src[4:8].tobytes(), "little")
    m_len_len = int.from_bytes(src[8:12].tobytes(), "little")
    if tk_len < 13 or tk_len > n or m_idx_len > n - tk_len \
            or m_len_len > n - tk_len - m_idx_len:
        raise ValueError("LZX: bad section lengths")
    tk_idx = tk_len
    m_idx = tk_idx + m_idx_len
    m_len_idx = m_idx + m_len_len
    src_end = tk_len - 13
    lit_end = tk_len
    mode = int(src[12])
    m_flag = mode & 1
    max_dist = MAX_DISTANCE2 if m_flag else MAX_DISTANCE1
    min_match = (4, 9, 6, 6)[(mode >> 1) & 0x03]
    src_idx = 13
    dst = bytearray()
    repd0 = repd1 = 0
    buf = src
    while True:
        token = int(buf[tk_idx]); tk_idx += 1
        if token >= 32:
            if token >= 0xE0:
                lit_len, src_idx = _read_len(buf, src_idx)
                lit_len += 7
            else:
                lit_len = token >> 5
            if lit_len > lit_end - src_idx:
                raise ValueError("LZX: literal overrun")
            dst += buf[src_idx:src_idx + lit_len].tobytes()
            src_idx += lit_len
            if src_idx >= src_end:
                break
        m_len = token & 0x0F
        if m_len == 15:
            ext, m_len_idx = _read_len(buf, m_len_idx)
            m_len = min_match + ext
            dist = repd0 if (token & 0x10) == 0 else repd1
        else:
            if m_len == 14:
                ext, m_len_idx = _read_len(buf, m_len_idx)
                m_len = 14 + ext
            m_len += min_match
            dist = int(buf[m_idx]); m_idx += 1
            if m_flag:
                dist = (dist << 8) | int(buf[m_idx]); m_idx += 1
            if token & 0x10:
                dist = (dist << 8) | int(buf[m_idx]); m_idx += 1
        repd1 = repd0
        repd0 = dist
        ref = len(dst) - dist
        if ref < 0 or dist > max_dist:
            raise ValueError("LZX: bad distance")
        for _ in range(m_len):
            dst.append(dst[ref])
            ref += 1
    if src_idx != src_end + 13:
        raise ValueError("LZX: stream mismatch")
    out = np.frombuffer(bytes(dst), dtype=np.uint8)
    return out[:count].copy() if count is not None else out.copy()


def _lzp_inverse_py(src: np.ndarray, min_match: int = 64) -> np.ndarray:
    n = src.size
    if n < 4:
        raise ValueError("LZP: truncated")
    hashes = [0] * (1 << 16)
    dst = bytearray(src[:4].tobytes())
    ctx = int.from_bytes(dst[:4], "little")
    i = 4
    while i < n:
        h = ((0x7FEB352D * ctx) & 0xFFFFFFFF) >> 16
        ref = hashes[h]
        hashes[h] = len(dst)
        if ref == 0 or src[i] != 0xFC:
            dst.append(int(src[i]))
            ctx = ((ctx << 8) | dst[-1]) & 0xFFFFFFFF
            i += 1
            continue
        i += 1
        if i >= n:
            raise ValueError("LZP: truncated match")
        if src[i] == 0xFF:
            dst.append(0xFC)
            ctx = ((ctx << 8) | 0xFC) & 0xFFFFFFFF
            i += 1
            continue
        m_len = min_match
        while i < n and src[i] == 0xFE:
            i += 1
            m_len += 254
        if i >= n:
            raise ValueError("LZP: truncated match length")
        m_len += int(src[i]); i += 1
        ref_pos = ref
        for _ in range(m_len):
            dst.append(dst[ref_pos])
            ref_pos += 1
        ctx = int.from_bytes(dst[-4:], "little")
    return np.frombuffer(bytes(dst), dtype=np.uint8).copy()
