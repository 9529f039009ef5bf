"""EXE codec: x86/ARM64 branch-target rewriting (relative -> absolute).

Wire format re-derived from K/transform/EXECodec.java:35-1013 — see
native/exe.cpp.  Detects the architecture from PE/ELF/Mach-O headers or
jump-opcode histograms; skipped when the native library is missing.
"""

from __future__ import annotations

import numpy as np

from ..core.globals import DataType
from ..core.types import TransformSkip
from ..utils import native_transforms as nt

MIN_BLOCK_SIZE = 4096


class EXECodec:
    def __init__(self, ctx: dict | None = None, **kw) -> None:
        self.ctx = ctx
        self.bs_version = (ctx or {}).get("bsVersion", 7)

    def max_encoded_len(self, src_len: int) -> int:
        return src_len + 32 if src_len <= 256 else src_len + (src_len >> 3)

    def forward(self, src: np.ndarray) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        if src.size < MIN_BLOCK_SIZE:
            raise TransformSkip("EXE: block too small")
        if self.ctx is not None:
            dt = self.ctx.get("dataType", DataType.UNDEFINED)
            if dt not in (DataType.UNDEFINED, DataType.EXE, DataType.BIN):
                raise TransformSkip("EXE: wrong data type")
        res, dt_ord = nt.exe_forward_native(src)
        if self.ctx is not None and dt_ord is not None and dt_ord > 0:
            self.ctx["dataType"] = DataType(dt_ord)
        if res is None:
            raise TransformSkip("EXE: not executable code or no native kernel")
        return res

    def inverse(self, src: np.ndarray, count: int | None = None) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        if src.size == 0:
            return src.copy()
        if self.bs_version < 3:
            return _inverse_v2(src)
        res = nt.exe_inverse_native(src, count)
        if res is None:
            res = _exe_inverse_py(src, count)  # pure-Python spec fallback
        return res


def _i32(x: int) -> int:
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _exe_inverse_py(src: np.ndarray, count_hint: int | None) -> np.ndarray:
    """Pure-Python mirror of native/exe.cpp kz_exe_inverse (v3+ layout:
    mode byte + LE32 codeStart/codeEnd header, x86 E8/JCC and ARM64
    B/BL rel32 targets restored from the 0xF0F0F0F0-masked absolutes)."""
    s = bytes(np.asarray(src, dtype=np.uint8).tobytes())
    count = len(s)
    if count < 9:
        raise ValueError("EXE: truncated")
    mode = s[0]
    cap = count_hint if count_hint is not None else count + (count >> 3) + 64
    dst = bytearray(cap)
    code_start = int.from_bytes(s[1:5], "little")
    code_end = int.from_bytes(s[5:9], "little")
    si, di = 9, 0
    if not (0 <= code_start <= cap and si <= code_end <= count
            and code_start <= code_end - 9):
        raise ValueError("EXE: bad header")
    if mode == 0x40:  # X86
        if code_start > 0:
            dst[0:code_start] = s[9:9 + code_start]
            si += code_start
            di += code_start
        while si < code_end:
            c = s[si]
            if c == 0x0F:  # two-byte prefix
                if si + 1 >= code_end:
                    dst[di] = c
                    di += 1
                    si += 1
                    break
                dst[di] = c
                di += 1
                si += 1
                if (s[si] & 0xF0) != 0x80:  # not JCC
                    if s[si] == 0x9B:  # escape
                        si += 1
                        if si >= code_end:
                            raise ValueError("EXE: truncated")
                    dst[di] = s[si]
                    di += 1
                    si += 1
                    continue
            elif (c & 0xFE) != 0xE8:  # not CALL/JMP
                if c == 0x9B:
                    si += 1
                    if si >= code_end:
                        raise ValueError("EXE: truncated")
                dst[di] = s[si]
                di += 1
                si += 1
                continue
            if si + 4 >= code_end or di + 5 > cap:
                raise ValueError("EXE: truncated")
            addr = _i32(int.from_bytes(s[si + 1:si + 5], "big")
                        ^ 0xF0F0F0F0)
            offset = addr - di
            enc = offset if offset >= 0 else -((-offset) & 0x00FFFFFF)
            dst[di] = s[si]
            di += 1
            si += 1
            dst[di:di + 4] = (enc & 0xFFFFFFFF).to_bytes(4, "little")
            si += 4
            di += 4
        dst[di:di + count - si] = s[si:]
        return np.frombuffer(bytes(dst[:di + count - si]), np.uint8).copy()
    if mode != 0x20:  # ARM64
        raise ValueError("EXE: bad mode")
    if code_start > 0:
        dst[0:code_start] = s[9:9 + code_start]
        si += code_start
        di += code_start
    B_ADDR = (1 << 26) - 1
    while si < code_end:
        if si + 4 > code_end or di + 4 > cap:
            raise ValueError("EXE: truncated")
        instr = _i32(int.from_bytes(s[si:si + 4], "little"))
        op1 = _i32(instr & ~B_ADDR)
        if op1 not in (0x14000000, _i32(0x94000000)):  # B / BL
            dst[di:di + 4] = s[si:si + 4]
            si += 4
            di += 4
            continue
        addr = (instr & B_ADDR) << 2
        offset = _i32(addr - di) >> 2
        val = _i32(op1 | (offset & B_ADDR))
        if addr == 0:
            if si + 8 > code_end:
                raise ValueError("EXE: truncated")
            dst[di:di + 4] = s[si + 4:si + 8]
            si += 8
            di += 4
            continue
        dst[di:di + 4] = (val & 0xFFFFFFFF).to_bytes(4, "little")
        si += 4
        di += 4
    dst[di:di + count - si] = s[si:]
    return np.frombuffer(bytes(dst[:di + count - si]), np.uint8).copy()


def _inverse_v2(src: np.ndarray) -> np.ndarray:
    """Pre-v3 x86 layout: no mode byte, 0xF5 escape after E8/E9, address
    bytes XORed with 0xF0 and stored big-endian-ish (EXECodec.java:498-560)."""
    n = src.size
    out = bytearray()
    i = 0
    end = n - 8
    while i < end:
        out.append(int(src[i])); i += 1
        if (int(src[i - 1]) & 0xFE) != 0xE8:
            continue
        if int(src[i]) == 0xF5:
            i += 1  # escape: not an encoded address
            continue
        sgn = int(src[i]) - 1
        if sgn not in (0, -1):
            continue
        addr = ((0xF0 ^ int(src[i + 3]))
                | ((0xF0 ^ int(src[i + 2])) << 8)
                | ((0xF0 ^ int(src[i + 1])) << 16)
                | ((sgn & 0xFF) << 24))
        addr -= len(out)
        out.append(addr & 0xFF)
        out.append((addr >> 8) & 0xFF)
        out.append((addr >> 16) & 0xFF)
        out.append(sgn & 0xFF)
        i += 4
    while i < n:
        out.append(int(src[i])); i += 1
    return np.frombuffer(bytes(out), dtype=np.uint8).copy()
