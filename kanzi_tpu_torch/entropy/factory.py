"""Entropy codec registry (re-derived from K/entropy/EntropyCodecFactory.java:30-289).

Stream header stores a 5-bit entropy type id; names map 1:1 to the CLI/API
strings.  CM/TPAQ/TPAQX share the binary arithmetic coder with different
predictors.

``device`` (keyword, required): None builds the host coders; a torch device
gives the ANS and Huffman coders their device stage (entropy/ans.py,
entropy/huffman.py).  The other coders run on the host whatever it is.
"""

from __future__ import annotations

from ..core.bits import BitReader, BitWriter

NONE_TYPE = 0
HUFFMAN_TYPE = 1
FPAQ_TYPE = 2
PAQ_TYPE = 3  # obsolete
RANGE_TYPE = 4
ANS0_TYPE = 5
CM_TYPE = 6
TPAQ_TYPE = 7
ANS1_TYPE = 8
TPAQX_TYPE = 9

_NAMES = {
    NONE_TYPE: "NONE",
    HUFFMAN_TYPE: "HUFFMAN",
    FPAQ_TYPE: "FPAQ",
    PAQ_TYPE: "PAQ",
    RANGE_TYPE: "RANGE",
    ANS0_TYPE: "ANS0",
    CM_TYPE: "CM",
    TPAQ_TYPE: "TPAQ",
    ANS1_TYPE: "ANS1",
    TPAQX_TYPE: "TPAQX",
}
_IDS = {v: k for k, v in _NAMES.items()}


def get_name(entropy_type: int) -> str:
    try:
        return _NAMES[entropy_type]
    except KeyError:
        raise ValueError(f"unsupported entropy codec type: {entropy_type}")


def get_type(name: str) -> int:
    try:
        return _IDS[name.upper()]
    except KeyError:
        raise ValueError(f"unsupported entropy codec name: {name}")


def new_encoder(bw: BitWriter, ctx: dict, entropy_type: int, *, device):
    if entropy_type == HUFFMAN_TYPE:
        from .huffman import HuffmanEncoder
        return HuffmanEncoder(bw, device=device)
    if entropy_type == ANS0_TYPE:
        from .ans import ANSRangeEncoder
        return ANSRangeEncoder(bw, 0, ctx=ctx, device=device)
    if entropy_type == ANS1_TYPE:
        from .ans import ANSRangeEncoder
        return ANSRangeEncoder(bw, 1, ctx=ctx, device=device)
    if entropy_type == RANGE_TYPE:
        from .range_codec import RangeEncoder
        return RangeEncoder(bw)
    if entropy_type == FPAQ_TYPE:
        from .fpaq import FPAQEncoder
        return FPAQEncoder(bw)
    if entropy_type == CM_TYPE:
        from .binary import BinaryEntropyEncoder
        from ..models.cm import CMPredictor
        return BinaryEntropyEncoder(bw, CMPredictor(ctx))
    if entropy_type in (TPAQ_TYPE, TPAQX_TYPE):
        from .binary import BinaryEntropyEncoder
        from ..models.tpaq import TPAQPredictor
        return BinaryEntropyEncoder(bw, TPAQPredictor(ctx))
    if entropy_type == NONE_TYPE:
        from .null_codec import NullEntropyEncoder
        return NullEntropyEncoder(bw)
    raise ValueError(f"unsupported entropy codec type: {entropy_type}")


def new_decoder(br: BitReader, ctx: dict, entropy_type: int, *, device):
    bs_version = ctx.get("bsVersion", 7) if ctx else 7
    if entropy_type == HUFFMAN_TYPE:
        from .huffman import HuffmanDecoder
        return HuffmanDecoder(br, bs_version=bs_version, device=device)
    if entropy_type == ANS0_TYPE:
        from .ans import ANSRangeDecoder
        return ANSRangeDecoder(br, 0, bs_version=bs_version, ctx=ctx,
                               device=device)
    if entropy_type == ANS1_TYPE:
        from .ans import ANSRangeDecoder
        return ANSRangeDecoder(br, 1, bs_version=bs_version, ctx=ctx,
                               device=device)
    if entropy_type == RANGE_TYPE:
        from .range_codec import RangeDecoder
        return RangeDecoder(br)
    if entropy_type == FPAQ_TYPE:
        from .fpaq import FPAQDecoder
        return FPAQDecoder(br, ctx)
    if entropy_type == CM_TYPE:
        from .binary import BinaryEntropyDecoder
        from ..models.cm import CMPredictor
        return BinaryEntropyDecoder(br, CMPredictor(ctx))
    if entropy_type in (TPAQ_TYPE, TPAQX_TYPE):
        from .binary import BinaryEntropyDecoder
        from ..models.tpaq import TPAQPredictor
        return BinaryEntropyDecoder(br, TPAQPredictor(ctx))
    if entropy_type == NONE_TYPE:
        from .null_codec import NullEntropyDecoder
        return NullEntropyDecoder(br)
    raise ValueError(f"unsupported entropy codec type: {entropy_type}")
