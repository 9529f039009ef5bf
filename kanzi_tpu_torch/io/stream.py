"""Block stream engine: kanzi bitstream format v7 writer/reader.

Re-derived from K/io/CompressedOutputStream.java:74-1154 and
CompressedInputStream.java:67-1438.

Stream header (unless headerless):
  "KANZ" u32 | version 4b | checksum-type 2b | entropy 5b | transform 48b |
  blockSize>>4 28b | szMask 2b [+ 16*szMask bits inputSize] | 15b pad |
  24b mix32 header checksum

Per block (outer framing): 5 bits (lw-3), lw bits of payload bit-length,
then the payload bits.  End of stream = zero-length block (lw=3, len=0).

Block payload:
  mode byte: 0x80 copy | (dataSize-1)<<5 | 0x10 separate-skip-flags |
             low nibble = skipFlags>>4 (when <= 4 transforms)
  [skipFlags byte when mode&0x10]
  postTransformLength (dataSize bytes)
  8-bit header checksum (mode, headerSkipFlags, length, bit-length)
  [32/64-bit XXHash of the raw block when enabled]
  entropy-coded payload (or raw transformed bytes for transformed-copy)

Blocks are independent; encode/decode fan out over a thread pool (the C++
kernels release the GIL) and results are committed in block order — the
Python equivalent of the reference's lock-free processedBlockId spin-wait.

The device is explicit: both streams take a required ``device``.  ``cuda``
runs the device stages on the CUDA kernels, ``cpu`` runs them on the
kernels' plain PyTorch versions, and ``cuda`` without a card raises.
``None`` runs the host coders (native C++, else numpy) and no device stage.
The device stages are the ANS0 and Huffman entropy coders and, under
KANZI_TPU_DEVICE_LZ (off by default), the LZ/LZX parse (ops/lz_sort.py).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from collections import deque as _deque
from dataclasses import dataclass, field
from typing import BinaryIO, Optional

import numpy as np

from ..core import magic
from ..core.bits import BitReader, BitWriter, append_packed
from ..core.errors import Error, IOError_
from ..core.events import Event, EventType, HeaderInfo, block_context, notify
from ..core.globals import (DataType, first_order_entropy_1024, histogram_order0, log2)
from ..core.types import TransformSkip
from ..entropy import factory as entropy_factory
from ..entropy import utils as eu
from ..transforms import factory as transform_factory
from ..utils.device import check_device
from ..utils.xxhash import xxhash32, xxhash64

BITSTREAM_TYPE = 0x4B414E5A  # "KANZ"
BITSTREAM_FORMAT_VERSION = 7
COPY_BLOCK_MASK = 0x80
TRANSFORMS_MASK = 0x10
MIN_BITSTREAM_BLOCK_SIZE = 1024
MAX_BITSTREAM_BLOCK_SIZE = 1024 * 1024 * 1024
SMALL_BLOCK_SIZE = 15
MAX_CONCURRENCY = 64
_HASH = 0x1E35A7BD
_M32 = 0xFFFFFFFF


def _mix32(checksum: int, value: int) -> int:
    checksum ^= (_HASH * (~value & _M32)) & _M32
    checksum &= _M32
    checksum = ((checksum << 13) | (checksum >> 19)) & _M32
    return (checksum * 5 + 0x52DCE729) & _M32


def _mix32_v6(checksum: int, value: int) -> int:
    """Header-checksum mixer of bitstream versions 5-6
    (CompressedInputStream.java:128-130)."""
    return (checksum ^ ((_HASH * (~value & _M32)) & _M32)) & _M32


def _header_checksum(chk_size: int, entropy_type: int, transform_type: int,
                     block_size: int, input_size: int, sz_mask: int) -> int:
    cksum = (_HASH * (0x01030507 * BITSTREAM_FORMAT_VERSION & _M32)) & _M32
    cksum = _mix32(cksum, chk_size)
    cksum = _mix32(cksum, entropy_type)
    cksum = _mix32(cksum, (transform_type >> 32) & _M32)
    cksum = _mix32(cksum, transform_type & _M32)
    cksum = _mix32(cksum, block_size)
    if sz_mask > 0:
        cksum = _mix32(cksum, (input_size >> 32) & _M32)
        cksum = _mix32(cksum, input_size & _M32)
    return ((cksum >> 23) ^ (cksum >> 3)) & 0xFFFFFF


def _block_header_checksum(mode: int, header_skip_flags: int,
                           post_len: int, written: int) -> int:
    cksum = (_HASH * 0x01030507) & _M32
    cksum = _mix32(cksum, mode & 0xFF)
    cksum = _mix32(cksum, header_skip_flags & 0xFF)
    cksum = _mix32(cksum, post_len & _M32)
    cksum = _mix32(cksum, (written >> 32) & _M32)
    cksum = _mix32(cksum, written & _M32)
    return ((cksum >> 23) ^ (cksum >> 3)) & 0xFF


# ---------------------------------------------------------------------------
# block encode / decode (pure functions run on worker threads)
# ---------------------------------------------------------------------------

def _emit(listeners, etype: EventType, block_id: int, size: int, hash_value) -> None:
    """notify, with the Event built only when there are listeners."""
    if listeners:
        notify(listeners, Event(etype, block_id, size, hash_value))


def encode_block(block: np.ndarray, transform_type: int, entropy_type: int,
                 ctx: dict, listeners=(), block_id: int = 0, *,
                 device) -> tuple[np.ndarray, int]:
    """Encode one block on ``device`` (see the module docstring); returns
    (packed payload bytes, bit count).  The block's listeners also get the
    device glue's spans (core/events.py ``span``)."""
    with block_context(listeners, block_id):
        return _encode_block(block, transform_type, entropy_type, ctx, listeners,
                             block_id, device)


def _encode_block(block, transform_type, entropy_type, ctx, listeners, block_id,
                  device) -> tuple[np.ndarray, int]:
    block_length = block.size
    checksum = 0
    chk = ctx.get("checksum", 0)
    if chk == 32:
        checksum = xxhash32(block.tobytes(), BITSTREAM_TYPE)
    elif chk == 64:
        checksum = xxhash64(block.tobytes(), BITSTREAM_TYPE)
    _emit(listeners, EventType.BEFORE_TRANSFORM, block_id, block_length,
          checksum if chk else None)
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
    ctx["_device"] = device
    if block_length >= 4:
        m = magic.get_type(block[:4].tobytes())
        if magic.is_compressed(m):
            ctx["dataType"] = DataType.BIN
        elif magic.is_multimedia(m):
            ctx["dataType"] = DataType.MULTIMEDIA
        elif magic.is_executable(m):
            ctx["dataType"] = DataType.EXE

    seq = transform_factory.new_function(ctx, transform_type)
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
    _emit(listeners, EventType.AFTER_TRANSFORM, block_id, post_len,
          checksum if chk else None)

    # entropy encode into its own writer to learn the payload bit count
    _emit(listeners, EventType.BEFORE_ENTROPY, block_id, post_len,
          checksum if chk else None)
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
            _emit(listeners, EventType.AFTER_ENTROPY, block_id,
                  (nbits + 7) >> 3, checksum if chk else None)
            return arr, nbits

    arr, nbits = assemble(mode, use_skip_byte, ebw)
    _emit(listeners, EventType.AFTER_ENTROPY, block_id,
          (nbits + 7) >> 3, checksum if chk else None)
    return arr, nbits


def decode_block(payload: np.ndarray, nbits: int, transform_type: int,
                 entropy_type: int, block_size: int, ctx: dict,
                 listeners=(), block_id: int = 0, *, device) -> np.ndarray:
    """Decode one block payload (byte array + bit length) to raw data on
    ``device`` (see the module docstring), reporting to the block's
    listeners as encode_block does."""
    with block_context(listeners, block_id):
        return _decode_block(payload, nbits, transform_type, entropy_type, block_size,
                             ctx, listeners, block_id, device)


def _decode_block(payload, nbits, transform_type, entropy_type, block_size, ctx,
                  listeners, block_id, device) -> np.ndarray:
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
        # (CompressedInputStream.java:111, :1037)
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
        # the 8-bit block-header checksum is a v7 addition, verified before
        # any payload allocation (CompressedInputStream.java:1076-1091)
        header_checksum = br.read_bits(8)
        hsf = skip_flags if has_skip_flags else (
            0 if (copy_block and not transformed_copy) else ((mode << 4) | 0x0F) & 0xFF)
        expect = _block_header_checksum(mode, hsf, pre_len, nbits)
        if header_checksum != expect:
            raise IOError_("block header checksum mismatch", Error.ERR_CRC_CHECK)
    if pre_len == 0:
        return np.zeros(0, dtype=np.uint8)
    # not capped at MAX_BITSTREAM_BLOCK_SIZE: a transform may add its
    # header to a block of the largest size (the BWT's 33 B at 2^30), and
    # kanzi_tpu, which caps it, refuses the 1 GiB blocks its writer wrote so
    max_transform_length = max(block_size + block_size // 2, 2048)
    if pre_len > max_transform_length:
        raise IOError_(f"invalid compressed block length {pre_len}", Error.ERR_READ_FILE)

    checksum1 = 0
    if chk == 32:
        checksum1 = br.read_bits(32)
    elif chk == 64:
        checksum1 = br.read_bits(64)

    ctx = dict(ctx)
    ctx["size"] = pre_len
    _emit(listeners, EventType.BEFORE_ENTROPY, block_id, (nbits + 7) >> 3,
          checksum1 if chk else None)
    if copy_block and not transformed_copy:
        transform_type = transform_factory.NONE_TYPE
        entropy_type = entropy_factory.NONE_TYPE
    if transformed_copy:
        buf = br.read_bytes(pre_len)
    else:
        ed = entropy_factory.new_decoder(br, ctx, entropy_type, device=device)
        buf = ed.decode(pre_len)
        ed.dispose()
    _emit(listeners, EventType.AFTER_ENTROPY, block_id, pre_len,
          checksum1 if chk else None)
    _emit(listeners, EventType.BEFORE_TRANSFORM, block_id, pre_len,
          checksum1 if chk else None)

    seq = transform_factory.new_function(ctx, transform_type)
    seq.skip_flags = skip_flags
    data = seq.inverse(buf)
    _emit(listeners, EventType.AFTER_TRANSFORM, block_id, data.size,
          checksum1 if chk else None)

    if chk == 32 and xxhash32(data.tobytes(), BITSTREAM_TYPE) != checksum1:
        raise IOError_("corrupted bitstream: block checksum mismatch", Error.ERR_CRC_CHECK)
    if chk == 64 and xxhash64(data.tobytes(), BITSTREAM_TYPE) != checksum1:
        raise IOError_("corrupted bitstream: block checksum mismatch", Error.ERR_CRC_CHECK)
    return data


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

class CompressedOutputStream:
    """java.io-style compressed stream writer (library embed API)."""

    def __init__(self, os_: BinaryIO, ctx: dict, *, device) -> None:
        self.device = None if device is None else check_device(device)
        entropy_codec = str(ctx.get("entropy", "NONE"))
        transform = str(ctx.get("transform", "NONE"))
        tasks = int(ctx.get("jobs", 1))
        if not 0 < tasks <= MAX_CONCURRENCY:
            raise ValueError(f"jobs must be in [1..{MAX_CONCURRENCY}]")
        b_size = int(ctx.get("blockSize", 4 * 1024 * 1024))
        if b_size > MAX_BITSTREAM_BLOCK_SIZE or b_size < MIN_BITSTREAM_BLOCK_SIZE:
            raise ValueError("invalid block size")
        if b_size & 15:
            raise ValueError("block size must be a multiple of 16")
        self.os = os_
        self.entropy_type = entropy_factory.get_type(entropy_codec)
        self.transform_type = transform_factory.get_type(transform)
        self.block_size = b_size
        self.input_size = int(ctx.get("fileSize", 0))
        self.checksum = int(ctx.get("checksum", 0))
        self.jobs = tasks
        self.headless = bool(ctx.get("headerless", False))
        self.ctx = dict(ctx)
        self.ctx["bsVersion"] = BITSTREAM_FORMAT_VERSION
        self.ctx["checksum"] = self.checksum
        self.listeners: list = []
        self._pending = bytearray()
        self._header_written = False
        self._closed = False
        self._block_id = 0
        self._pool = cf.ThreadPoolExecutor(max_workers=tasks) if tasks > 1 else None
        self._inflight: _deque = _deque()
        self._written_bits = 0

    def add_listener(self, lst) -> bool:
        self.listeners.append(lst)
        return True

    def remove_listener(self, lst) -> bool:
        try:
            self.listeners.remove(lst)
            return True
        except ValueError:
            return False

    @property
    def written(self) -> int:
        """Bytes written so far (approximate until close)."""
        return (self._written_bits + 7) >> 3

    def _write_header(self) -> None:
        if self.headless or self._header_written:
            return
        self._header_written = True
        bw = BitWriter()
        bw.write_bits(BITSTREAM_TYPE, 32)
        bw.write_bits(BITSTREAM_FORMAT_VERSION, 4)
        chk_size = 1 if self.checksum == 32 else (2 if self.checksum == 64 else 0)
        bw.write_bits(chk_size, 2)
        bw.write_bits(self.entropy_type, 5)
        bw.write_bits(self.transform_type, 48)
        bw.write_bits(self.block_size >> 4, 28)
        sz_mask = 0
        if self.input_size != 0 and self.input_size < (1 << 48):
            if self.input_size >= (1 << 32):
                sz_mask = 3
            else:
                isz = self.input_size
                if isz > (1 << 30):
                    isz >>= 4
                    sz_mask += 1
                sz_mask += (log2(isz) >> 4) + 1
        bw.write_bits(sz_mask, 2)
        if sz_mask > 0:
            bw.write_bits(self.input_size, 16 * sz_mask)
        bw.write_bits(0, 15)
        cksum = _header_checksum(chk_size, self.entropy_type, self.transform_type,
                                 self.block_size, self.input_size, sz_mask)
        bw.write_bits(cksum, 24)
        self._bits_out(*bw.getvalue_packed())

    def _bits_out(self, arr: np.ndarray, nbits: int) -> None:
        """Queue a packed segment (bytes + bit count) for output."""
        self._seg_buffer = getattr(self, "_seg_buffer", [])
        self._seg_buffer.append((arr, nbits))
        self._written_bits += nbits

    def _flush_bits(self, final: bool) -> None:
        segs = getattr(self, "_seg_buffer", [])
        tail_byte = getattr(self, "_tail_byte", 0)
        tail_bits = getattr(self, "_tail_bits", 0)
        if not segs and not (final and tail_bits):
            return
        total = tail_bits + sum(n for _, n in segs)
        out = np.zeros((total + 7) >> 3, dtype=np.uint8)
        if tail_bits:
            out[0] = tail_byte
        bitpos = tail_bits
        for arr, n in segs:
            bitpos = append_packed(out, bitpos, arr, n)
        self._seg_buffer = []
        if final:
            self.os.write(out.tobytes())
            self._tail_byte = 0
            self._tail_bits = 0
        else:
            whole = total >> 3
            self.os.write(out[:whole].tobytes())
            self._tail_bits = total & 7
            self._tail_byte = int(out[whole]) if self._tail_bits else 0

    def write(self, data) -> int:
        if self._closed:
            raise IOError_("stream closed", Error.ERR_WRITE_FILE)
        self._pending += bytes(data)
        while len(self._pending) >= self.jobs * self.block_size:
            self._process(self.jobs)
        return len(data)

    def _process(self, nblocks: int) -> None:
        """Submit up to ``nblocks`` pending blocks, then commit completed
        blocks in order WITHOUT a batch barrier: a slow block never blocks
        the submission of its successors, only their commit — the pipelined
        analogue of the reference's per-block spin-wait ordered commit
        (CompressedOutputStream.java:987-1002)."""
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

        # device pre-transform: when the chain STARTS with LZ/LZX and the
        # device gate is on, run the batched sort engine over ALL blocks in
        # one dispatch (ops/lz_sort) and hand each block its result as a
        # hint; LZXCodec.forward uses it only if its effective parameters
        # match (wire behavior is identical either way)
        lz_hints = self._device_lz_batch(chunks)

        nchunks = max(1, len(chunks))

        def job(blk, bid, hint):
            ctx = dict(self.ctx)
            # fair split of the thread budget over this batch's blocks —
            # a lone block keeps the whole budget (its BWT/SA threads),
            # a full batch gives each block one core (reference ctx
            # plumbing: jobs flow into the per-task transforms)
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

    def _drain(self, block: bool) -> None:
        """Commit completed in-order heads; with ``block`` wait for all."""
        while self._inflight and (block or self._inflight[0].done()):
            self._commit(self._inflight.popleft().result())

    def _commit(self, result) -> None:
        arr, nbits = result
        written = nbits
        lw = 3 if written < 8 else log2(written >> 3) + 4
        fb = BitWriter()
        fb.write_bits(lw - 3, 5)
        fb.write_bits(written, lw)
        self._bits_out(*fb.getvalue_packed())
        self._bits_out(arr, nbits)

    def _device_lz_batch(self, chunks):
        """One batched device LZX dispatch over all pending blocks, or None
        when there is no device, the gate is off, or the chain does not
        start with LZ/LZX.  Any gate but "" and "0" runs it, "legacy" too,
        as kanzi_tpu's writer does: the v1 engine is the codec's own
        dispatch (blocks this batch's hints do not cover).  A failure
        raises: nothing falls back to the host parse."""
        if getattr(self, "_lz_hint_fn", None) is not None:
            # a caller that ran the per-block LZ stage itself hands each
            # block its result
            return self._lz_hint_fn(chunks)
        gate = os.environ.get("KANZI_TPU_DEVICE_LZ", "0")
        if self.device is None or gate in ("", "0"):
            return None
        from ..transforms.factory import (LZ_TYPE, LZX_TYPE, MASK,
                                          MAX_SHIFT)
        first = (self.transform_type >> MAX_SHIFT) & MASK
        if first not in (LZ_TYPE, LZX_TYPE):
            return None
        from ..ops.lz_sort import lzx_forward_device_batch
        res = lzx_forward_device_batch(chunks, first == LZX_TYPE, 4,
                                       device=self.device)
        return [(4, r) for r in res]

    def close(self) -> None:
        if self._closed:
            return
        self._write_header()
        while self._pending:
            self._process(self.jobs)
        self._drain(block=True)
        self._closed = True
        eb = BitWriter()
        eb.write_bits(0, 5)
        eb.write_bits(0, 3)
        self._bits_out(*eb.getvalue_packed())
        self._flush_bits(True)
        if self._pool is not None:
            self._pool.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class _BitSource:
    """Incremental MSB-first bit source over a file object.

    Keeps a bounded sliding window: bytes are pulled from the underlying
    stream in chunks as bits are requested and the consumed prefix is
    dropped, so a stream of any size is read with O(block) memory — the
    analogue of the reference's buffered DefaultInputBitStream feeding
    CompressedInputStream.java:613-681 one block batch at a time."""

    __slots__ = ("_is", "_chunk", "_data", "_bitpos")

    def __init__(self, is_: BinaryIO, chunk: int = 1 << 20) -> None:
        self._is = is_
        self._chunk = chunk
        self._data = np.zeros(0, dtype=np.uint8)
        self._bitpos = 0

    def _ensure(self, nbits: int) -> None:
        while self._data.size * 8 - self._bitpos < nbits:
            b = self._is.read(max(self._chunk, (nbits + 7) >> 3))
            if not b:
                raise EOFError("bitstream exhausted")
            self._data = np.concatenate(
                [self._data, np.frombuffer(b, dtype=np.uint8)])

    def _compact(self) -> None:
        drop = self._bitpos >> 3
        if drop >= (64 << 10):
            self._data = self._data[drop:]
            self._bitpos -= drop << 3

    def read_bit(self) -> int:
        return self.read_bits(1)

    def read_bits(self, count: int) -> int:
        self._ensure(count)
        br = BitReader(self._data, bitpos=self._bitpos)
        v = br.read_bits(count)
        self._bitpos = br.read_count
        return v

    def read_packed(self, nbits: int):
        self._compact()
        self._ensure(nbits)
        br = BitReader(self._data, bitpos=self._bitpos)
        arr = br.read_packed(nbits)
        self._bitpos = br.read_count
        return arr


class CompressedInputStream:
    """java.io-style compressed stream reader.

    Streaming: at most ``jobs`` blocks are framed + in flight at any time;
    ``read(n)`` decodes only until n bytes are buffered (the reference's
    batch-of-jobs DecodingTask scheme, CompressedInputStream.java:613-681,
    1106-1123), so memory stays bounded by O(jobs * blockSize) regardless
    of archive size."""

    def __init__(self, is_: BinaryIO, ctx: dict, *, device) -> None:
        self.device = None if device is None else check_device(device)
        self.ctx = dict(ctx or {})
        self.jobs = int(self.ctx.get("jobs", 1))
        self.listeners: list = []
        self.headless = bool(self.ctx.get("headerless", False))
        self._br = _BitSource(is_)
        self._out = bytearray()
        self._pos = 0
        self._eos = False
        self._next_block_id = 1
        self._inflight: _deque = _deque()
        self.checksum = 0
        self._pool = cf.ThreadPoolExecutor(max_workers=self.jobs) if self.jobs > 1 else None
        if self.headless:
            self.bs_version = int(self.ctx.get("bsVersion", BITSTREAM_FORMAT_VERSION))
            self.entropy_type = entropy_factory.get_type(self.ctx.get("entropy", "NONE"))
            self.transform_type = transform_factory.get_type(self.ctx.get("transform", "NONE"))
            self.block_size = int(self.ctx.get("blockSize", 4 * 1024 * 1024))
            self.checksum = int(self.ctx.get("checksum", 0))
            self.output_size = int(self.ctx.get("outputSize", 0))
        else:
            self._read_header()
        self.ctx["bsVersion"] = self.bs_version
        self.ctx["checksum"] = self.checksum
        self.ctx["blockSize"] = self.block_size
        # transforms pick variants based on the entropy stage (e.g. TEXT)
        self.ctx["entropy"] = entropy_factory.get_name(self.entropy_type)
        self.ctx["transform"] = transform_factory.get_name(self.transform_type)

    def add_listener(self, lst) -> bool:
        self.listeners.append(lst)
        return True

    def _read_header(self) -> None:
        """Stream-header parse with back-compat for bitstream versions 1..7
        (CompressedInputStream.java:359-515).  Block bodies of every version
        decode: the per-codec legacy wire variants (ANS V1 chunks, pre-v4
        FPAQ/CM/LZP, pre-v6 Huffman/BWT/LZX, pre-v3 EXE/ROLZ) are handled by
        the codecs themselves via ctx["bsVersion"]."""
        br = self._br
        if br.read_bits(32) != BITSTREAM_TYPE:
            raise IOError_("invalid stream type", Error.ERR_INVALID_FILE)
        self.bs_version = v = br.read_bits(4)
        if v > BITSTREAM_FORMAT_VERSION:
            raise IOError_(f"unsupported bitstream version {v}",
                           Error.ERR_STREAM_VERSION)
        if v >= 6:
            chk_size = br.read_bits(2)
            if chk_size == 3:
                raise IOError_("invalid block checksum size",
                               Error.ERR_INVALID_FILE)
        else:
            chk_size = br.read_bit()
        self.checksum = {0: 0, 1: 32, 2: 64}.get(chk_size, 0)
        self.entropy_type = br.read_bits(5)
        self.transform_type = br.read_bits(48)
        self.block_size = br.read_bits(28) << 4
        if not MIN_BITSTREAM_BLOCK_SIZE <= self.block_size <= MAX_BITSTREAM_BLOCK_SIZE:
            raise IOError_("invalid block size in header", Error.ERR_BLOCK_SIZE)
        self.output_size = 0
        sz_mask = 0
        if v >= 5:
            sz_mask = br.read_bits(2)
            if sz_mask:
                self.output_size = br.read_bits(16 * sz_mask)
            if v >= 6:
                br.read_bits(15)  # padding
                crc_size = 24
                seed = (0x01030507 * v) & _M32
            else:
                crc_size = 16
                seed = v
            cksum1 = br.read_bits(crc_size)
            mix = _mix32 if v >= 7 else _mix32_v6
            ck = (_HASH * seed) & _M32
            if v >= 6:
                ck = mix(ck, chk_size)
            ck = mix(ck, self.entropy_type)
            ck = mix(ck, (self.transform_type >> 32) & _M32)
            ck = mix(ck, self.transform_type & _M32)
            ck = mix(ck, self.block_size)
            if sz_mask:
                ck = mix(ck, (self.output_size >> 32) & _M32)
                ck = mix(ck, self.output_size & _M32)
            ck = ((ck >> 23) ^ (ck >> 3)) & ((1 << crc_size) - 1)
            if cksum1 != ck:
                raise IOError_("invalid stream: header checksum mismatch",
                               Error.ERR_CRC_CHECK)
        elif v >= 3:
            nb_blocks = br.read_bits(6)
            self.nb_input_blocks = 65536 if nb_blocks == 0 else nb_blocks
            cksum1 = br.read_bits(4)
            ck = (_HASH * v) & _M32
            ck ^= (_HASH * self.entropy_type) & _M32
            ck ^= (_HASH * ((self.transform_type >> 32) & _M32)) & _M32
            ck ^= (_HASH * (self.transform_type & _M32)) & _M32
            ck ^= (_HASH * self.block_size) & _M32
            ck ^= (_HASH * self.nb_input_blocks) & _M32
            ck = ((ck >> 23) ^ (ck >> 3)) & 0x0F
            if cksum1 != ck:
                raise IOError_("invalid stream: corrupted header",
                               Error.ERR_CRC_CHECK)
        else:
            self.nb_input_blocks = br.read_bits(6)
            br.read_bits(4)  # reserved
        if self.listeners:
            notify(self.listeners, Event(
                EventType.AFTER_HEADER_DECODING, 0, 0,
                header=HeaderInfo(self.bs_version, self.checksum, self.block_size,
                                  entropy_factory.get_name(self.entropy_type),
                                  transform_factory.get_name(self.transform_type),
                                  self.output_size or -1)))

    def _frame_next(self):
        """Read one block's framing + payload from the bit source; returns
        (block_id, payload, nbits) for an in-range block, None for a skipped
        one, and sets _eos at the end-of-stream / --to boundary."""
        br = self._br
        from_blk = int(self.ctx.get("from", 0))
        to_blk = int(self.ctx.get("to", 1 << 30))
        try:
            lw = br.read_bits(5) + 3
            nbits = br.read_bits(lw)
        except EOFError:
            raise IOError_("truncated stream: missing end-of-stream block",
                           Error.ERR_READ_FILE)
        if nbits == 0:
            self._eos = True
            return None
        try:
            # payloads are bit-packed: consume exactly nbits
            payload = br.read_packed(nbits)
        except EOFError:
            raise IOError_("truncated stream: incomplete block payload",
                           Error.ERR_READ_FILE)
        bid = self._next_block_id
        self._next_block_id += 1
        if bid >= to_blk:
            self._eos = True  # nothing past --to is ever decoded
            return None
        if bid < from_blk:
            return None
        return bid, payload, nbits

    def _decode_job(self, framed):
        bid, payload, nbits = framed
        ctx = dict(self.ctx)
        # fair split of the thread budget over concurrently-decoding blocks
        # (the reference threads the remaining jobs into each task's ctx so
        # a lone big block still multi-threads its BWT inversion while many
        # blocks in flight get one core each — CompressedInputStream.java
        # ctx plumbing + BWT.java:568-674).  Computed DETERMINISTICALLY
        # from the declared stream size: sampling the live in-flight count
        # here raced with _fill's submissions (the first block would claim
        # the whole budget while later blocks were already starting).
        if self.output_size:
            nblocks = max(1, -(-self.output_size // self.block_size))
        else:
            nblocks = self.jobs        # unknown size: assume enough blocks
        ctx["jobs"] = max(1, self.jobs // min(self.jobs, nblocks))
        return decode_block(payload, nbits, self.transform_type,
                            self.entropy_type, self.block_size, ctx,
                            self.listeners, bid, device=self.device)

    def _advance(self) -> None:
        """Top the in-flight window up to ``jobs`` framed blocks, then
        commit the (in-order) head into the output buffer."""
        while not self._eos and len(self._inflight) < self.jobs:
            framed = self._frame_next()
            if framed is None:
                continue
            if self._pool is not None:
                self._inflight.append(self._pool.submit(self._decode_job, framed))
            else:
                self._inflight.append(framed)
        if self._inflight:
            head = self._inflight.popleft()
            r = head.result() if self._pool is not None else self._decode_job(head)
            self._out += r.tobytes()

    def _fill(self, need: int) -> None:
        while (len(self._out) - self._pos) < need and \
                not (self._eos and not self._inflight):
            self._advance()

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            self._fill(1 << 62)
        else:
            self._fill(n)
        if n < 0:
            n = len(self._out) - self._pos
        res = bytes(self._out[self._pos:self._pos + n])
        self._pos += len(res)
        # drop the consumed prefix so long streams read in bounded memory
        if self._pos >= (8 << 20):
            del self._out[:self._pos]
            self._pos = 0
        return res

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
