"""Compressed streams whose entropy stages (ANS0, Huffman) run on a torch
device.

``encode_block``/``decode_block`` are kanzi_tpu.io.stream's, line for line,
except that they build their entropy coders with the port's factory and pass
it the device, and that the encoder's LZ/LZX stages parse on the host only
(_host_lz); a later change may fold the two copies into one once the port
is whole.  ``CompressedOutputStream``/``CompressedInputStream`` subclass
kanzi_tpu's and override only the constructor (a required ``device``), the
two methods that call the block codec and the writer's device LZ hints;
header, framing, ordered commit and the thread pool are inherited.

The device is explicit: ``cuda`` runs the kernels, ``cpu`` their plain
versions, and ``cuda`` without a card raises.
"""

from __future__ import annotations

from typing import BinaryIO

import numpy as np
import torch

from kanzi_tpu.core import magic
from kanzi_tpu.core.bits import BitReader, BitWriter
from kanzi_tpu.core.errors import Error, IOError_
from kanzi_tpu.core.events import Event, EventType, notify
from kanzi_tpu.core.globals import DataType, first_order_entropy_1024, histogram_order0, log2
from kanzi_tpu.core.types import TransformSkip
from kanzi_tpu.entropy import utils as eu
from kanzi_tpu.io import stream as _host
from kanzi_tpu.io.stream import (BITSTREAM_FORMAT_VERSION, BITSTREAM_TYPE,
                                 COPY_BLOCK_MASK, MAX_BITSTREAM_BLOCK_SIZE,
                                 SMALL_BLOCK_SIZE, TRANSFORMS_MASK,
                                 _block_header_checksum)
from kanzi_tpu.transforms import factory as transform_factory
from kanzi_tpu.transforms import lz as _lz
from kanzi_tpu.utils import native_transforms as _nt
from kanzi_tpu.utils.xxhash import xxhash32, xxhash64

from ..entropy import factory as entropy_factory
from ..utils.device import check_device


class _HostLZXCodec(_lz.LZXCodec):
    """kanzi_tpu's LZ/LZX forward with its host C++ parse only.  The parent's
    forward reads KANZI_TPU_DEVICE_LZ and then imports jax for its device
    engine; the port's device LZ engine arrives with the LZX slice (ROADMAP
    M4).  The port never hands it a device hint (see _device_lz_batch)."""

    def forward(self, src: np.ndarray) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        if src.size == 0:
            return src.copy()
        min_match = 0
        dt = (self.ctx or {}).get("dataType", DataType.UNDEFINED)
        if dt == DataType.DNA:
            min_match = 6
        elif dt == DataType.SMALL_ALPHABET:
            raise TransformSkip("LZX: small alphabet")
        res = _nt.lzx_forward_native(src, self.extra, min_match)
        if res is None:
            raise TransformSkip("LZX: native kernel unavailable")
        if res.size == 0:
            raise TransformSkip("LZX: no gain")
        return res


def _host_lz(seq) -> None:
    """Give every LZ/LZX stage of ``seq`` (from kanzi_tpu's transform
    factory) the host-only forward of _HostLZXCodec."""
    for t in seq.transforms:
        if type(getattr(t, "_delegate", None)) is _lz.LZXCodec:
            t._delegate.__class__ = _HostLZXCodec


def encode_block(block: np.ndarray, transform_type: int, entropy_type: int,
                 ctx: dict, listeners=(), block_id: int = 0, *,
                 device: torch.device) -> tuple[np.ndarray, int]:
    """Encode one block; returns (packed payload bytes, bit count)."""
    block_length = block.size
    checksum = 0
    chk = ctx.get("checksum", 0)
    if chk == 32:
        checksum = xxhash32(block.tobytes(), BITSTREAM_TYPE)
    elif chk == 64:
        checksum = xxhash64(block.tobytes(), BITSTREAM_TYPE)
    notify(listeners, Event(EventType.BEFORE_TRANSFORM, block_id, block_length,
                            checksum if chk else None))
    mode = 0
    if block_length <= SMALL_BLOCK_SIZE:
        transform_type = transform_factory.NONE_TYPE
        entropy_type = entropy_factory.NONE_TYPE
        mode |= COPY_BLOCK_MASK
    elif ctx.get("skipBlocks", False):
        skip = magic.is_compressed(magic.get_type(block[:4].tobytes()))
        if not skip:
            histo = histogram_order0(block)
            skip = first_order_entropy_1024(block_length, histo) >= eu.INCOMPRESSIBLE_THRESHOLD
        if skip:
            transform_type = transform_factory.NONE_TYPE
            entropy_type = entropy_factory.NONE_TYPE
            mode |= COPY_BLOCK_MASK

    ctx = dict(ctx)
    ctx["size"] = block_length
    if block_length >= 4:
        m = magic.get_type(block[:4].tobytes())
        if magic.is_compressed(m):
            ctx["dataType"] = DataType.BIN
        elif magic.is_multimedia(m):
            ctx["dataType"] = DataType.MULTIMEDIA
        elif magic.is_executable(m):
            ctx["dataType"] = DataType.EXE

    seq = transform_factory.new_function(ctx, transform_type)
    _host_lz(seq)
    try:
        buf = seq.forward(block)
    except TransformSkip:
        buf = block
    skip_flags = seq.skip_flags
    nb_functions = len(seq.transforms)
    post_len = buf.size
    ctx["size"] = post_len
    data_size = 1 if post_len < 256 else (log2(post_len) >> 3) + 1
    if data_size > 4:
        raise IOError_("invalid block data length", Error.ERR_WRITE_FILE)
    mode |= ((data_size - 1) & 0x03) << 5
    notify(listeners, Event(EventType.AFTER_TRANSFORM, block_id, post_len,
                            checksum if chk else None))

    # entropy encode into its own writer to learn the payload bit count
    notify(listeners, Event(EventType.BEFORE_ENTROPY, block_id, post_len,
                            checksum if chk else None))
    ebw = BitWriter()
    ee = entropy_factory.new_encoder(ebw, ctx, entropy_type, device=device)
    ee.encode(buf)
    ee.dispose()
    payload_bits = ebw.written

    def assemble(mode_b: int, with_skip_byte: bool, payload_writer) -> tuple[np.ndarray, int]:
        hdr_bits = 8 + (8 if with_skip_byte else 0) + 8 * data_size + 8
        cs_bits = 32 if chk == 32 else (64 if chk == 64 else 0)
        total = hdr_bits + cs_bits + payload_writer.written
        if with_skip_byte:
            hsf = skip_flags
        elif mode_b & COPY_BLOCK_MASK:
            hsf = 0 if not (mode_b & TRANSFORMS_MASK) else ((mode_b << 4) | 0x0F) & 0xFF
        else:
            hsf = ((mode_b << 4) | 0x0F) & 0xFF
        if (mode_b & COPY_BLOCK_MASK) and not (mode_b & TRANSFORMS_MASK):
            hsf = 0
        hcs = _block_header_checksum(mode_b, hsf, post_len, total)
        bw = BitWriter()
        bw.write_bits(mode_b, 8)
        if with_skip_byte:
            bw.write_bits(skip_flags, 8)
        bw.write_bits(post_len, 8 * data_size)
        bw.write_bits(hcs, 8)
        if chk == 32:
            bw.write_bits(checksum, 32)
        elif chk == 64:
            bw.write_bits(checksum, 64)
        bw.extend(payload_writer)
        return bw.getvalue_packed()

    use_skip_byte = not (mode & COPY_BLOCK_MASK) and nb_functions > 4
    if use_skip_byte:
        mode |= TRANSFORMS_MASK
    else:
        mode |= (skip_flags >> 4) & 0x0F

    if not (mode & COPY_BLOCK_MASK):
        raw_payload_bytes = post_len
        entropy_payload_bytes = (payload_bits + 7) >> 3
        if raw_payload_bytes < entropy_payload_bytes:
            # transformed copy: raw transformed bytes beat the entropy stage
            copy_mode = mode | COPY_BLOCK_MASK | TRANSFORMS_MASK
            cbw = BitWriter()
            cbw.write_bytes(buf)
            arr, nbits = assemble(copy_mode, nb_functions > 4, cbw)
            notify(listeners, Event(EventType.AFTER_ENTROPY, block_id,
                                    (nbits + 7) >> 3, checksum if chk else None))
            return arr, nbits

    arr, nbits = assemble(mode, use_skip_byte, ebw)
    notify(listeners, Event(EventType.AFTER_ENTROPY, block_id,
                            (nbits + 7) >> 3, checksum if chk else None))
    return arr, nbits


def decode_block(payload: np.ndarray, nbits: int, transform_type: int,
                 entropy_type: int, block_size: int, ctx: dict,
                 listeners=(), block_id: int = 0, *,
                 device: torch.device) -> np.ndarray:
    """Decode one block payload (byte array + bit length) to raw data."""
    br = BitReader(payload, nbits=nbits)
    bs_version = int(ctx.get("bsVersion", BITSTREAM_FORMAT_VERSION))
    mode = br.read_bits(8)
    chk = ctx.get("checksum", 0)
    skip_flags = 0
    has_skip_flags = False
    transformed_copy = False
    copy_block = bool(mode & COPY_BLOCK_MASK)
    if copy_block:
        # transformed-copy blocks exist from bitstream version 7
        if bs_version >= 7 and (mode & TRANSFORMS_MASK):
            transformed_copy = True
            nb_functions = len(transform_factory.new_function(dict(ctx), transform_type).transforms)
            if nb_functions > 4:
                has_skip_flags = True
            else:
                skip_flags = ((mode << 4) | 0x0F) & 0xFF
    elif mode & TRANSFORMS_MASK:
        has_skip_flags = True
    else:
        skip_flags = ((mode << 4) | 0x0F) & 0xFF
    if has_skip_flags:
        skip_flags = br.read_bits(8)
    data_size = 1 + ((mode >> 5) & 0x03)
    pre_len = br.read_bits(8 * data_size)
    if bs_version >= 7:
        # the 8-bit block-header checksum is verified before any payload
        # allocation
        header_checksum = br.read_bits(8)
        hsf = skip_flags if has_skip_flags else (
            0 if (copy_block and not transformed_copy) else ((mode << 4) | 0x0F) & 0xFF)
        expect = _block_header_checksum(mode, hsf, pre_len, nbits)
        if header_checksum != expect:
            raise IOError_("block header checksum mismatch", Error.ERR_CRC_CHECK)
    if pre_len == 0:
        return np.zeros(0, dtype=np.uint8)
    max_transform_length = min(max(block_size + block_size // 2, 2048),
                               MAX_BITSTREAM_BLOCK_SIZE)
    if pre_len > max_transform_length:
        raise IOError_(f"invalid compressed block length {pre_len}", Error.ERR_READ_FILE)

    checksum1 = 0
    if chk == 32:
        checksum1 = br.read_bits(32)
    elif chk == 64:
        checksum1 = br.read_bits(64)

    ctx = dict(ctx)
    ctx["size"] = pre_len
    notify(listeners, Event(EventType.BEFORE_ENTROPY, block_id, (nbits + 7) >> 3,
                            checksum1 if chk else None))
    if copy_block and not transformed_copy:
        transform_type = transform_factory.NONE_TYPE
        entropy_type = entropy_factory.NONE_TYPE
    if transformed_copy:
        buf = br.read_bytes(pre_len)
    else:
        ed = entropy_factory.new_decoder(br, ctx, entropy_type, device=device)
        buf = ed.decode(pre_len)
        ed.dispose()
    notify(listeners, Event(EventType.AFTER_ENTROPY, block_id, pre_len,
                            checksum1 if chk else None))
    notify(listeners, Event(EventType.BEFORE_TRANSFORM, block_id, pre_len,
                            checksum1 if chk else None))

    seq = transform_factory.new_function(ctx, transform_type)
    seq.skip_flags = skip_flags
    data = seq.inverse(buf)
    notify(listeners, Event(EventType.AFTER_TRANSFORM, block_id, data.size,
                            checksum1 if chk else None))

    if chk == 32 and xxhash32(data.tobytes(), BITSTREAM_TYPE) != checksum1:
        raise IOError_("corrupted bitstream: block checksum mismatch", Error.ERR_CRC_CHECK)
    if chk == 64 and xxhash64(data.tobytes(), BITSTREAM_TYPE) != checksum1:
        raise IOError_("corrupted bitstream: block checksum mismatch", Error.ERR_CRC_CHECK)
    return data


class CompressedOutputStream(_host.CompressedOutputStream):
    """kanzi_tpu's stream writer with the entropy stages (ANS0, Huffman) on
    ``device``."""

    def __init__(self, os_: BinaryIO, ctx: dict, *, device) -> None:
        self.device = check_device(device)
        super().__init__(os_, ctx)

    def _device_lz_batch(self, chunks):
        """No device LZ hints: the port's device LZ engine arrives with the
        LZX slice (ROADMAP M4); until then LZ and LZX run in kanzi_tpu's host
        transforms.  kanzi_tpu's own method would import jax and run its JAX
        engine under KANZI_TPU_DEVICE_LZ=1."""
        return None

    def _process(self, nblocks: int) -> None:
        """kanzi_tpu's _process; its job calls this module's encode_block."""
        self._write_header()
        chunks = []
        for _ in range(nblocks):
            if not self._pending:
                break
            chunk = self._pending[:self.block_size]
            del self._pending[:self.block_size]
            chunks.append(np.frombuffer(bytes(chunk), dtype=np.uint8))
        if not chunks:
            self._drain(block=False)
            return

        lz_hints = self._device_lz_batch(chunks)

        nchunks = max(1, len(chunks))

        def job(blk, bid, hint):
            ctx = dict(self.ctx)
            # fair split of the thread budget over this batch's blocks
            ctx["jobs"] = max(1, self.jobs // min(self.jobs, nchunks))
            if hint is not None:
                ctx["_lz_hint"] = hint
            return encode_block(blk, self.transform_type, self.entropy_type,
                                ctx, self.listeners, bid, device=self.device)

        for i, blk in enumerate(chunks):
            bid = self._block_id + i + 1
            hint = lz_hints[i] if lz_hints is not None else None
            if self._pool is not None:
                self._inflight.append(self._pool.submit(job, blk, bid, hint))
            else:
                res = job(blk, bid, hint)
                self._commit(res)
        self._block_id += len(chunks)
        # commit all finished heads now; apply backpressure (bounded memory)
        # only beyond 2*jobs outstanding blocks
        self._drain(block=False)
        while len(self._inflight) > 2 * self.jobs:
            self._commit(self._inflight.popleft().result())
        self._flush_bits(False)


class CompressedInputStream(_host.CompressedInputStream):
    """kanzi_tpu's stream reader with the entropy stages (ANS0, Huffman) on
    ``device``."""

    def __init__(self, is_: BinaryIO, ctx: dict, *, device) -> None:
        self.device = check_device(device)
        super().__init__(is_, ctx)

    def _decode_job(self, framed):
        """kanzi_tpu's _decode_job calling this module's decode_block."""
        bid, payload, nbits = framed
        ctx = dict(self.ctx)
        # fair split of the thread budget, from the declared stream size
        if self.output_size:
            nblocks = max(1, -(-self.output_size // self.block_size))
        else:
            nblocks = self.jobs        # unknown size: assume enough blocks
        ctx["jobs"] = max(1, self.jobs // min(self.jobs, nblocks))
        return decode_block(payload, nbits, self.transform_type,
                            self.entropy_type, self.block_size, ctx,
                            self.listeners, bid, device=self.device)
