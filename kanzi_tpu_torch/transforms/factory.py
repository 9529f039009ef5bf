"""Transform registry and sequence runner.

Re-derived from K/transform/TransformFactory.java:29-451 and
Sequence.java:27-257.  Transform chains are up to 8 six-bit tokens packed
into a 48-bit descriptor (first transform in the highest bits); per-block
skip flags (bit 7-i set = stage i skipped) record which stages actually ran.
"""

from __future__ import annotations

import numpy as np

from ..core.types import TransformSkip

ONE_SHIFT = 6
MAX_SHIFT = 7 * ONE_SHIFT
MASK = (1 << ONE_SHIFT) - 1

NONE_TYPE = 0
BWT_TYPE = 1
BWTS_TYPE = 2
LZ_TYPE = 3
SNAPPY_TYPE = 4  # obsolete
RLT_TYPE = 5
ZRLT_TYPE = 6
MTFT_TYPE = 7
RANK_TYPE = 8
EXE_TYPE = 9
DICT_TYPE = 10
ROLZ_TYPE = 11
ROLZX_TYPE = 12
SRT_TYPE = 13
LZP_TYPE = 14
MM_TYPE = 15
LZX_TYPE = 16
UTF_TYPE = 17
PACK_TYPE = 18
DNA_TYPE = 19

_NAME_TO_TYPE = {
    "TEXT": DICT_TYPE, "BWT": BWT_TYPE, "BWTS": BWTS_TYPE, "LZ": LZ_TYPE,
    "LZX": LZX_TYPE, "LZP": LZP_TYPE, "ROLZ": ROLZ_TYPE, "ROLZX": ROLZX_TYPE,
    "SRT": SRT_TYPE, "RANK": RANK_TYPE, "MTFT": MTFT_TYPE, "ZRLT": ZRLT_TYPE,
    "UTF": UTF_TYPE, "RLT": RLT_TYPE, "EXE": EXE_TYPE, "MM": MM_TYPE,
    "PACK": PACK_TYPE, "DNA": DNA_TYPE, "NONE": NONE_TYPE,
}
_TYPE_TO_NAME = {v: k for k, v in _NAME_TO_TYPE.items()}


def get_type(name: str) -> int:
    """Packed 48-bit chain descriptor from 'A+B+C' names."""
    if "+" not in name:
        return _token_of(name) << MAX_SHIFT
    tokens = name.split("+")
    if len(tokens) > 8:
        raise ValueError(f"only 8 transforms allowed: {name}")
    res = 0
    shift = MAX_SHIFT
    for tk in tokens:
        t = _token_of(tk)
        if t != NONE_TYPE:
            res |= t << shift
            shift -= ONE_SHIFT
    return res


def _token_of(name: str) -> int:
    try:
        return _NAME_TO_TYPE[name.upper()]
    except KeyError:
        raise ValueError(f"unknown transform type: {name}")


def get_name(function_type: int) -> str:
    """Chain descriptor back to 'A+B+C' string."""
    parts = []
    for i in range(8):
        t = (function_type >> (MAX_SHIFT - ONE_SHIFT * i)) & MASK
        if t != NONE_TYPE:
            parts.append(_TYPE_TO_NAME.get(t, "NONE"))
    return "+".join(parts) if parts else "NONE"


def new_function_token(ctx: dict, function_type: int):
    ctx = ctx if ctx is not None else {}
    if function_type == DICT_TYPE:
        from .text import TextCodec
        ent = str(ctx.get("entropy", "NONE")).upper()
        ctx["textcodec"] = 2 if ent in ("NONE", "ANS0", "HUFFMAN", "RANGE") else 1
        return TextCodec(ctx)
    if function_type in (ROLZ_TYPE, ROLZX_TYPE):
        from .rolz import ROLZCodec
        return ROLZCodec(ctx, extra=(function_type == ROLZX_TYPE))
    if function_type == BWT_TYPE:
        from .bwt import BWTBlockCodec
        return BWTBlockCodec(ctx)
    if function_type == BWTS_TYPE:
        from .bwts import BWTS
        return BWTS(ctx)
    if function_type == RANK_TYPE:
        from .sbrt import MODE_RANK, SBRT
        ctx["sbrt"] = MODE_RANK
        return SBRT(ctx=ctx)
    if function_type == SRT_TYPE:
        from .srt import SRT
        return SRT(ctx)
    if function_type == MTFT_TYPE:
        from .sbrt import MODE_MTF, SBRT
        ctx["sbrt"] = MODE_MTF
        return SBRT(ctx=ctx)
    if function_type == ZRLT_TYPE:
        from .zrlt import ZRLT
        return ZRLT(ctx)
    if function_type == UTF_TYPE:
        from .utf import UTFCodec
        return UTFCodec(ctx)
    if function_type == RLT_TYPE:
        from .rlt import RLT
        return RLT(ctx)
    if function_type in (LZ_TYPE, LZX_TYPE):
        from .lz import LZCodec
        ctx["lz"] = function_type
        return LZCodec(ctx)
    if function_type == LZP_TYPE:
        from .lz import LZCodec
        ctx["lz"] = LZP_TYPE
        return LZCodec(ctx, lzp=True)
    if function_type == EXE_TYPE:
        from .exe import EXECodec
        return EXECodec(ctx)
    if function_type == MM_TYPE:
        from .fsd import FSDCodec
        return FSDCodec(ctx)
    if function_type == PACK_TYPE:
        from .alias import AliasCodec
        return AliasCodec(ctx)
    if function_type == DNA_TYPE:
        from .alias import AliasCodec
        ctx["packOnlyDNA"] = True
        return AliasCodec(ctx)
    if function_type == NONE_TYPE:
        from .null_transform import NullTransform
        return NullTransform(ctx)
    raise ValueError(f"unknown transform type: {function_type}")


class Sequence:
    """Runs up to 8 transforms; a failed forward stage is reverted and
    recorded in skip_flags (Sequence.java semantics, functional style)."""

    SKIP_MASK = 0xFF

    def __init__(self, transforms: list, ctx: dict | None = None) -> None:
        if not 1 <= len(transforms) <= 8:
            raise ValueError("only 1 to 8 transforms allowed")
        self.transforms = transforms
        self.skip_flags = self.SKIP_MASK
        self._ctx = ctx

    def max_encoded_len(self, src_len: int) -> int:
        req = src_len
        for t in self.transforms:
            req = max(req, t.max_encoded_len(req))
        return req

    def forward(self, src: np.ndarray) -> np.ndarray:
        self.skip_flags = self.SKIP_MASK
        data = np.asarray(src, dtype=np.uint8)
        if data.size == 0:
            return data
        start = 0
        # chain-prefix cache: a caller that already ran the first k stages
        # of this chain on this exact block (e.g. the mesh l5 pipeline's
        # pass A, which needs the TEXT+UTF output to batch suffix arrays)
        # supplies {(size, xxhash64): (output, skip_flags, k)} via ctx so
        # the writer does not recompute them.  Flag bits for the prefix
        # stages are copied verbatim (same positions 7..8-k).
        pre = (self._ctx or {}).get("_chain_prefix")
        if pre is not None:
            from ..utils.xxhash import xxhash64
            hit = pre.get((data.size, xxhash64(data.tobytes(), 0)))
            if hit is not None:
                pdata, pflags, k = hit
                pmask = (0xFF00 >> k) & 0xFF       # bits of stages 0..k-1
                self.skip_flags = (self.SKIP_MASK & ~pmask) | (pflags & pmask)
                data = np.asarray(pdata, dtype=np.uint8)
                start = k
        for i in range(start, len(self.transforms)):
            try:
                out = self.transforms[i].forward(data)
            except TransformSkip:
                continue
            self.skip_flags &= ~(1 << (7 - i)) & 0xFF
            data = out
        if self.skip_flags == self.SKIP_MASK:
            raise TransformSkip("all stages skipped")
        return data

    def inverse(self, src: np.ndarray, count: int | None = None) -> np.ndarray:
        data = np.asarray(src, dtype=np.uint8)
        if data.size == 0:
            return data
        if self.skip_flags == self.SKIP_MASK:
            return data.copy()
        n = len(self.transforms)
        for i in range(n - 1, -1, -1):
            if self.skip_flags & (1 << (7 - i)):
                continue
            expected = count if i == 0 else None
            data = self.transforms[i].inverse(data, count=expected)
        if count is not None and data.size != count:
            raise ValueError(f"sequence inverse size mismatch: {data.size} != {count}")
        return data


def new_function(ctx: dict, function_type: int) -> Sequence:
    """Build a Sequence from a packed 48-bit descriptor
    (TransformFactory.java:240-264)."""
    nbtr = 0
    for i in range(8):
        if (function_type >> (MAX_SHIFT - ONE_SHIFT * i)) & MASK != NONE_TYPE:
            nbtr += 1
    if nbtr == 0:
        nbtr = 1
    transforms = []
    for i in range(8):
        t = (function_type >> (MAX_SHIFT - ONE_SHIFT * i)) & MASK
        if t != NONE_TYPE or i == 0:
            if len(transforms) < nbtr:
                transforms.append(new_function_token(ctx, t))
    return Sequence(transforms, ctx)
