"""Plain reader of the kanzi v7 bitstream: the benchmark's reference.

Written from kanzi's format (CompressedInputStream.java, the block layout
of CompressedOutputStream.java), in NumPy and Python, with no code of the
program under test.  It reads what the program wrote and judges it:

* ``parse`` reads the stream header and the framing of every block
  (the per-block bit length, each block header and its 8-bit checksum,
  the end-of-stream block) and checks them against the configuration;
* ``decode_block`` decodes one block through the entropy stage and the
  inverse transforms the block's skip flags name, each stage from a file
  ``stages/<NAME>.py`` found by the stage's kanzi name.

A stage with no file there is reported as unsupported, never skipped.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field

import numpy as np

from .bits import Bits

MAGIC = 0x4B414E5A            # "KANZ"
VERSION = 7
COPY_BLOCK = 0x80
TRANSFORMS_MASK = 0x10
SMALL_BLOCK_SIZE = 15
_HASH = 0x1E35A7BD
_M32 = 0xFFFFFFFF

# kanzi's type ids (TransformFactory.java, EntropyCodecFactory.java)
TRANSFORM_IDS = {"NONE": 0, "BWT": 1, "BWTS": 2, "LZ": 3, "SNAPPY": 4,
                 "RLT": 5, "ZRLT": 6, "MTFT": 7, "RANK": 8, "EXE": 9,
                 "TEXT": 10, "ROLZ": 11, "ROLZX": 12, "SRT": 13, "LZP": 14,
                 "MM": 15, "LZX": 16, "UTF": 17, "PACK": 18, "DNA": 19}
ENTROPY_IDS = {"NONE": 0, "HUFFMAN": 1, "FPAQ": 2, "PAQ": 3, "RANGE": 4,
               "ANS0": 5, "CM": 6, "TPAQ": 7, "ANS1": 8, "TPAQX": 9}
_TRANSFORM_NAMES = {v: k for k, v in TRANSFORM_IDS.items()}
_ENTROPY_NAMES = {v: k for k, v in ENTROPY_IDS.items()}


class StreamError(ValueError):
    """The stream breaks the format or the configuration."""


def _mix(ck: int, value: int) -> int:
    ck ^= (_HASH * (~value & _M32)) & _M32
    ck = ((ck << 13) | (ck >> 19)) & _M32
    return (ck * 5 + 0x52DCE729) & _M32


def chain_descriptor(names: list[str]) -> int:
    """The 48-bit transform field: six bits a stage, first in the top."""
    desc, shift = 0, 42
    for name in names:
        if name != "NONE":
            desc |= TRANSFORM_IDS[name] << shift
            shift -= 6
    return desc


def chain_names(desc: int) -> list[str]:
    names = []
    for i in range(8):
        t = (desc >> (42 - 6 * i)) & 63
        if t:
            names.append(_TRANSFORM_NAMES.get(t, f"type{t}"))
    return names or ["NONE"]


@dataclass
class Block:
    index: int              # 0-based position in the stream
    bits: Bits              # the block's payload, realigned
    nbits: int
    mode: int
    skip_flags: int
    post_len: int           # length after the forward transforms
    copy: bool
    transformed_copy: bool
    payload_pos: int        # bit offset of the entropy payload in ``bits``


@dataclass
class Stream:
    entropy: str
    transforms: list[str]
    block_size: int
    checksum_bits: int
    original_size: int
    blocks: list[Block] = field(default_factory=list)


def parse(buf, expect: dict | None = None) -> Stream:
    """Header and framing of a whole stream; raises StreamError on any
    departure from the format or, with ``expect``, from the configuration
    (keys ``entropy``, ``transform`` ('A+B+C'), ``block_size``, ``size``)."""
    br = Bits(buf)
    try:
        if br.read(32) != MAGIC:
            raise StreamError("not a kanzi stream")
        version = br.read(4)
        if version != VERSION:
            raise StreamError(f"bitstream version {version}, not {VERSION}")
        chk = br.read(2)
        if chk == 3:
            raise StreamError("checksum size 3")
        entropy = br.read(5)
        desc = br.read(48)
        block_size = br.read(28) << 4
        sz_mask = br.read(2)
        size = br.read(16 * sz_mask) if sz_mask else 0
        br.read(15)
        header_ck = br.read(24)
    except EOFError as e:
        raise StreamError(f"truncated stream header: {e}") from None
    ck = (_HASH * ((0x01030507 * VERSION) & _M32)) & _M32
    for v in (chk, entropy, (desc >> 32) & _M32, desc & _M32, block_size):
        ck = _mix(ck, v)
    if sz_mask:
        ck = _mix(_mix(ck, (size >> 32) & _M32), size & _M32)
    if header_ck != ((ck >> 23) ^ (ck >> 3)) & 0xFFFFFF:
        raise StreamError("stream header checksum")
    st = Stream(_ENTROPY_NAMES.get(entropy, f"type{entropy}"),
                chain_names(desc), block_size, {0: 0, 1: 32, 2: 64}[chk], size)
    if expect is not None:
        want = {"entropy": expect["entropy"],
                "transforms": [t for t in expect["transform"].split("+") if t != "NONE"] or ["NONE"],
                "block_size": expect["block_size"], "checksum_bits": 0,
                "original_size": expect["size"]}
        for k, v in want.items():
            if getattr(st, k) != v:
                raise StreamError(f"header {k} {getattr(st, k)!r}, configured {v!r}")
    nb_functions = len(st.transforms)
    while True:
        try:
            lw = br.read(5) + 3
            nbits = br.read(lw)
        except EOFError:
            raise StreamError("no end-of-stream block") from None
        if nbits == 0:
            break
        try:
            bits = br.sub(nbits)
        except EOFError:
            raise StreamError(f"block {len(st.blocks)} truncated") from None
        st.blocks.append(_block_header(len(st.blocks), bits, nbits, nb_functions,
                                       st.checksum_bits))
    if br.left() >= 8:
        raise StreamError(f"{br.left()} bits after the end-of-stream block")
    if expect is not None:
        want_blocks = -(-expect["size"] // expect["block_size"])
        if len(st.blocks) != want_blocks:
            raise StreamError(f"{len(st.blocks)} blocks, {want_blocks} due")
    return st


def _block_header(index: int, bits: Bits, nbits: int, nb_functions: int,
                  checksum_bits: int) -> Block:
    mode = bits.read(8)
    copy = bool(mode & COPY_BLOCK)
    transformed_copy = copy and bool(mode & TRANSFORMS_MASK)
    explicit = (transformed_copy and nb_functions > 4) or \
        (not copy and bool(mode & TRANSFORMS_MASK))
    if explicit:
        skip = bits.read(8)
        header_skip = skip
    else:
        skip = ((mode << 4) | 0x0F) & 0xFF
        header_skip = 0 if (copy and not transformed_copy) else skip
    data_size = 1 + ((mode >> 5) & 3)
    post_len = bits.read(8 * data_size)
    ck = (_HASH * 0x01030507) & _M32
    for v in (mode, header_skip, post_len, (nbits >> 32) & _M32, nbits & _M32):
        ck = _mix(ck, v)
    if bits.read(8) != ((ck >> 23) ^ (ck >> 3)) & 0xFF:
        raise StreamError(f"block {index} header checksum")
    bits.read(checksum_bits)
    return Block(index, bits, nbits, mode, skip, post_len, copy,
                 transformed_copy, bits.pos)


def _stage(name: str):
    try:
        return importlib.import_module(f"{__package__}.stages.{name}")
    except ModuleNotFoundError:
        raise StreamError(f"stage {name} has no reference") from None


def decode_block(st: Stream, blk: Block) -> np.ndarray:
    """The block's original bytes, by the reference's own decoders."""
    bits = Bits(blk.bits.data, blk.payload_pos, blk.nbits)
    if blk.copy and not blk.transformed_copy:
        return bits.read_bytes(blk.post_len)
    if blk.post_len == 0:
        return np.zeros(0, np.uint8)
    if blk.transformed_copy:
        data = bits.read_bytes(blk.post_len)
    else:
        data = _stage(st.entropy).decode(bits, blk.post_len)
        if data.size != blk.post_len:
            raise StreamError(f"block {blk.index}: entropy stage gave {data.size} B")
    ctx = {"block_size": st.block_size}
    if blk.skip_flags != 0xFF:
        for i in range(len(st.transforms) - 1, -1, -1):
            if not blk.skip_flags & (1 << (7 - i)):
                data = _stage(st.transforms[i]).inverse(data, ctx)
    return data
