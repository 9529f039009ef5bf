"""Entropy codec factory of the port: ANS0 and Huffman coders on the given
device, every other type from kanzi_tpu.entropy.factory (the host coders)."""

from __future__ import annotations

import torch

from kanzi_tpu.core.bits import BitReader, BitWriter
from kanzi_tpu.entropy import factory as _host
from kanzi_tpu.entropy.factory import ANS0_TYPE, HUFFMAN_TYPE, NONE_TYPE

from .ans import ANSRangeDecoder, ANSRangeEncoder
from .huffman import HuffmanDecoder, HuffmanEncoder

__all__ = ["ANS0_TYPE", "HUFFMAN_TYPE", "NONE_TYPE", "new_decoder", "new_encoder"]


def new_encoder(bw: BitWriter, ctx: dict, entropy_type: int, *,
                device: torch.device):
    if entropy_type == ANS0_TYPE:
        return ANSRangeEncoder(bw, 0, ctx=ctx, device=device)
    if entropy_type == HUFFMAN_TYPE:
        return HuffmanEncoder(bw, device=device)
    return _host.new_encoder(bw, ctx, entropy_type)


def new_decoder(br: BitReader, ctx: dict, entropy_type: int, *,
                device: torch.device):
    bs_version = ctx.get("bsVersion", 7) if ctx else 7
    if entropy_type == ANS0_TYPE:
        return ANSRangeDecoder(br, 0, bs_version=bs_version, ctx=ctx,
                               device=device)
    if entropy_type == HUFFMAN_TYPE:
        return HuffmanDecoder(br, bs_version=bs_version, device=device)
    return _host.new_decoder(br, ctx, entropy_type)
