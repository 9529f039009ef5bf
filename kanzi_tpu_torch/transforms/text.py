"""TEXT codec: dictionary word substitution (TextCodec1/TextCodec2).

Wire format re-derived from K/transform/TextCodec.java:31-1647 — see
native/text.cpp for the full description.  The variant is picked by the
entropy stage (ctx['textcodec']): 1 for bit-oriented coders (escape tokens
0x0F/0x0E + 5/7/7-bit varint), 2 for Huffman/ANS0/Range/None (high-bit-mask
indexes).  Output header byte carries MASK_NOT_TEXT/CRLF/XML_HTML.

The per-byte scan runs in C++; without the native library the stage is
skipped (valid — skip flags make every transform optional).
"""

from __future__ import annotations

import numpy as np

from ..core import magic
from ..core.globals import DataType
from ..core.types import TransformSkip
from ..utils import native_transforms as nt


MASK_TEXT_CODEC = 0x10  # TextCodec.java:51


class TextCodec:
    def __init__(self, ctx: dict | None = None, **kw) -> None:
        self.ctx = ctx
        self.codec_type = (ctx or {}).get("textcodec", 1)
        self.block_size = (ctx or {}).get("blockSize", 4 * 1024 * 1024)
        self.extra = (ctx or {}).get("entropy", "") == "TPAQX"
        self.bs_version = (ctx or {}).get("bsVersion", 7)

    def max_encoded_len(self, src_len: int) -> int:
        return src_len

    def forward(self, src: np.ndarray) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        if src.size < 1024:  # MIN_BLOCK_SIZE
            raise TransformSkip("TEXT: block too small")
        if self.ctx is not None:
            dt = self.ctx.get("dataType", DataType.UNDEFINED)
            if dt not in (DataType.UNDEFINED, DataType.TEXT, DataType.BIN):
                raise TransformSkip("TEXT: wrong data type")
        magic_found = magic.get_type(src[:4].tobytes()) != magic.NO_MAGIC
        res, dt_ord = nt.text_forward_native(src, self.codec_type, self.block_size,
                                             self.extra, magic_found)
        if res is None and dt_ord is None:  # no native library: python spec
            from ._text_py import text_forward_py
            res, dt_ord = text_forward_py(src, self.codec_type,
                                          self.block_size, self.extra,
                                          magic_found)
        if self.ctx is not None and dt_ord is not None and dt_ord != 0:
            self.ctx["dataType"] = DataType(dt_ord)
        if res is None:
            raise TransformSkip("TEXT: not text")
        # v7: the header byte records which variant wrote the block
        # (TextCodec.java:496-501)
        if self.codec_type == 1:
            res[0] &= ~MASK_TEXT_CODEC & 0xFF
        else:
            res[0] |= MASK_TEXT_CODEC
        return res

    def inverse(self, src: np.ndarray, count: int | None = None) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        if src.size == 0:
            return src.copy()
        codec_type = self.codec_type
        if self.bs_version >= 7:
            # pick the variant from the header bit (TextCodec.java:523-528)
            codec_type = 2 if (int(src[0]) & MASK_TEXT_CODEC) else 1
        legacy = self.bs_version < 6 and codec_type == 2
        res = nt.text_inverse_native(src, codec_type, self.block_size,
                                     self.extra, count, legacy=legacy)
        if res is None:
            # pure-Python spec fallback (KANZI_TPU_NO_NATIVE=1)
            from ._text_py import text_inverse_py
            res = text_inverse_py(src, codec_type, self.block_size,
                                  self.extra, count, legacy)
        return res
