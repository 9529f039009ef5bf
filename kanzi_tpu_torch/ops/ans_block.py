"""Host glue of the ANS stages on a torch device: the exact ANSRangeEncoder
wire bytes (entropy/ans.py), with the order-0 statistics, scan and
compaction in the kernels of ops/ans_cuda.py, and the order-1 lookup, scan
and compaction in those of ops/ans1_cuda.py.

Counterpart of kanzi_tpu/ops/ans_block.py (its order-0 record writer,
ans0_encode, ans0_decode, ans1_encode).  The device/host split is the
reference's:

  host:   wire headers and varints; blocks of at most 32 bytes (raw bytes);
          the tail chunk (order 0: < 16 KiB; order 1: < 4 MiB); the order-1
          context histograms and their normalisation; on decode,
          single-symbol chunks (header only) and every chunk from the first
          with a non-default log range
  device: order 0: histogram + normalisation, the encode scan and compaction
          of the full chunks (single-symbol chunks included, then skipped by
          the wire), and the decode of the full chunks; order 1: the table
          lookup, the encode scan and the per-tile compaction of the full
          4 MiB chunks (order 1 decodes on the host, as in the reference)

Four differences: a chunk header with an empty alphabet raises, as the
host decoder does (entropy/ans.py), where kanzi_tpu's device glue filled
zeros; an order-1 tail of more than 32 bytes is written by the native host
coder, which writes the same bytes (tests/test_torch_ans1.py) as the
reference's numpy loop of one Python step per 4 bytes; on order-0 encode, a
block's full-chunk records are written from the device's rows by the port's
native writer (hostsrc/ans0_wire.cpp), one call a block with the GIL
released and after GLUE_LOCK is released (the lock covers the device rows
alone), and a tail of more than 32 bytes by the native host coder; on
order-0 decode, a block's full-chunk headers are parsed and their payloads
gathered by the port's native parse (hostsrc/ans0_wire.cpp), one call a
block with the GIL released, and the host's chunks of more than 32 bytes
together are decoded by the native host coder.  The native writer and parse
are the only order-0 glue: without the native library they raise
RuntimeError.  They write and read kanzi_tpu's bytes
(tests/test_torch_ans0_wire_write.py, tests/test_torch_ans0_wire.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.bits import BitReader, BitWriter
from ..core.errors import BitStreamError
from ..entropy import ans as hans
from ..entropy import utils as eu

from ..utils.native_coders import (ans0_wire_native, ans0_wire_write_native,
                                   ans_decode_native, ans_encode_native)
from . import ans1_cuda, ans_cuda
from .glue import glue_lock, write_locked
from . import launch
from .launch import to_device, to_host

CHUNK = ans_cuda.CHUNK
LOG_RANGE = ans_cuda.LOG_RANGE
CHUNK1 = ans1_cuda.CHUNK1
LOG_RANGE1 = ans1_cuda.LOG_RANGE1

# blocks whose full-chunk headers the decode parsed, and blocks whose
# full-chunk records the encode wrote, in the port's native code
launch.register(("ans0_wire_native", "ans0_wire_write_native"))


def ans0_encode(block: np.ndarray, bw: BitWriter, device: torch.device) -> int:
    """ANSRangeEncoder(order=0).encode with the full chunks on ``device``.
    GLUE_LOCK is held around the device rows alone (upload, kernels and
    fetches share the card's stream); the records and the tail are written
    from the block's own arrays after its release."""
    def rows(chunks: np.ndarray):
        with glue_lock():
            return _device_rows(chunks, device)
    return encode_ans0_wire(block, bw, rows)


def _device_rows(chunks: np.ndarray, device: torch.device):
    """The order-0 stage of full chunks on ``device``, fetched to the host:
    (freq, payload (n, w) u16, n_emit, states), only the populated payload
    prefix (a power-of-two width w) copied back."""
    freq_t, pay_t, ne_t, st_t = ans_cuda.encode_chunks_tensors(to_device(chunks, device))
    n_emit = to_host(ne_t)
    w = min(1 << max(int(n_emit.max(initial=0)) - 1, 1).bit_length(), chunks.shape[1])
    return (to_host(freq_t), to_host(pay_t[:, :w].contiguous()).view(np.uint16),
            n_emit, to_host(st_t))


def encode_ans0_wire(block: np.ndarray, bw: BitWriter, rows, chunk: int = CHUNK) -> int:
    """ANSRangeEncoder(order=0, chunk_size=chunk).encode of ``block`` into
    ``bw``, the full chunks through ``rows``: rows(chunks uint8 (n, chunk))
    -> (freq (n, 256), payload (n, w) u16 with w at or above every length,
    n_emit (n,), states (n, 4)), numpy.  One device (``_device_rows``) or
    the ranks of a mesh (parallel/engine.py) run the rows.  The full
    chunks' records are written by one call of the port's native writer
    (hostsrc/ans0_wire.cpp; ``launches["ans0_wire_write_native"]``), with
    the GIL released, and appended as one segment.  Blocks of at most 32
    bytes and the tail chunk are written on the host (encode_tail)."""
    block = np.asarray(block, dtype=np.uint8)
    count = block.size
    if count <= 32:
        bw.write_bytes(block.tobytes())
        return count
    nfull = count // chunk
    tail = count - nfull * chunk
    if nfull > 0:
        freq, payload, n_emit, states = rows(block[:nfull * chunk].reshape(nfull, chunk))
        arr, nbits = ans0_wire_write_native(freq, n_emit, states, payload, LOG_RANGE)
        launch.count("ans0_wire_write_native")
        bw.write_bytes(arr, nbits=nbits)
    if tail:
        encode_tail(block[nfull * chunk:], bw, 0, chunk)
    return count


def order1_tables(chunks: np.ndarray):
    """(freq, cum) (N, 256, 256) int64 of full order-1 chunks: each chunk's
    context histogram (quarter starts under context 0), each context row
    normalised to 2048 as the host coder normalises it."""
    n = chunks.shape[0]
    freq = np.zeros((n, 256, 256), dtype=np.int64)
    for i in range(n):
        h2 = hans._order1_histogram(chunks[i].astype(np.int64))
        freq[i] = eu.normalize_frequencies_batch(h2, h2.sum(axis=1), 1 << LOG_RANGE1)
    return freq, np.cumsum(freq, axis=2) - freq


def ans1_encode(block: np.ndarray, bw: BitWriter, device: torch.device) -> int:
    """ANSRangeEncoder(order=1).encode with the full 4 MiB chunks on
    ``device``; the block's wire, thousands of small header segments, written
    and packed into one segment under GLUE_LOCK (glue.write_locked)."""
    return write_locked(bw, lambda wire: _encode1(block, wire, device))


def _encode1(block: np.ndarray, bw: BitWriter, device: torch.device) -> int:
    block = np.asarray(block, dtype=np.uint8)
    count = block.size
    if count <= 32:
        bw.write_bytes(block.tobytes())
        return count
    nfull = count // CHUNK1
    tail = count - nfull * CHUNK1
    if nfull > 0:
        chunks = block[:nfull * CHUNK1].reshape(nfull, CHUNK1)
        freq, cum = order1_tables(chunks)
        pay_t, cnt_t, st_t = ans1_cuda.ans1_encode_chunks_tensors(
            to_device(chunks, device), to_device(freq, device, np.int32),
            to_device(cum, device, np.int32))
        words = ans1_cuda.stitch(to_host(pay_t).view(np.uint16), to_host(cnt_t))
        states = to_host(st_t)
        for i in range(nfull):
            bw.write_bits(LOG_RANGE1 - 8, 3)
            for k in range(256):
                alpha = np.flatnonzero(freq[i, k]).astype(np.int32)
                hans._write_freqs_header(bw, alpha, freq[i, k], LOG_RANGE1)
            pay = words[i].astype(">u2").tobytes()
            eu.write_varint(bw, len(pay))
            for j in range(4):
                bw.write_bits(int(states[i, j]), 32)
            bw.write_bytes(pay)
    if tail:
        encode_tail(block[nfull * CHUNK1:], bw, 1)
    return count


def encode_tail(seg: np.ndarray, bw: BitWriter, order: int, chunk: int = CHUNK) -> None:
    """One chunk of ``order`` shorter than a full one (order 0: ``chunk``
    bytes; order 1: 4 MiB), as the reference writes it
    (ANSRangeEncoder._encode_chunk); above 32 bytes the native coder writes
    the same chunk (a block of one chunk; at 32 bytes and under it would
    write the block raw)."""
    if seg.size > 32 and ans_encode_native(seg, bw, order, chunk, LOG_RANGE):
        return
    hans.ANSRangeEncoder(bw, order, chunk_size=chunk)._encode_chunk(seg, bw)


def ans0_decode(count: int, br: BitReader, device: torch.device) -> np.ndarray:
    """ANSRangeDecoder(order=0).decode with the full chunks on ``device``."""
    with glue_lock():
        return _decode(count, br, device)


def _decode(count: int, br: BitReader, device: torch.device) -> np.ndarray:
    def rows(pay, lens, states, freq, cum):
        return ans_cuda.ans0_decode_chunks(pay, states, freq, cum, device, lengths=lens)
    return decode_ans0_wire(count, br, rows)


def decode_ans0_wire(count: int, br: BitReader, rows, chunk: int = CHUNK,
                     host_log_ranges: bool = True) -> np.ndarray:
    """ANSRangeDecoder(order=0, chunk_size=chunk).decode of ``count`` bytes
    from ``br``, the payloads of the full chunks through ``rows``:
    rows(payload uint8 (n, p), lengths (n,) i32, states (n, 4) i64, freq
    (n, 256) i32, cum (n, 256) i32) -> (out uint8 (n, chunk), consumed
    (n,)), numpy.  The headers are parsed in stream order (parse_ans0_wire);
    single-symbol chunks and the tail decode on the host.  A chunk with
    another log range than the kernels' 12 decodes on the host with every
    later chunk, or, with ``host_log_ranges`` false (kanzi_tpu's mesh rule),
    raises.  An empty alphabet, a chunk size at or over the maximum or a
    consumed count that differs from the payload's raise BitStreamError."""
    if count <= 32:
        return br.read_bytes(count)
    out = np.empty(count, dtype=np.uint8)
    nfull = count // chunk
    wire = parse_ans0_wire(br, nfull, host_log_ranges)
    if len(wire.rows):
        res, consumed = rows(wire.payload, wire.lens, wire.states, wire.freq, wire.cum)
        if not np.array_equal(consumed, wire.lens):
            raise BitStreamError("ANS payload size mismatch (device decode)",
                                 BitStreamError.INVALID_STREAM)
        out[:nfull * chunk].reshape(nfull, chunk)[wire.rows] = res
    for i, sym in wire.single:
        out[i * chunk:(i + 1) * chunk] = sym
    start = nfull * chunk if wire.resume is None else wire.resume * chunk
    if start < count:
        decode_host(out, start, count, br, chunk)
    return out


class Ans0Wire(NamedTuple):
    """The full chunks of an order-0 block, parsed: a row for each chunk of
    two symbols or more (``rows`` its chunk index; ``freq``, ``cum`` (n, 256)
    i32; ``states`` (n, 4) i64; ``lens`` (n,) i32 payload bytes; ``payload``
    (n, p) uint8, zero past each length, p a multiple of 16), ``single`` (k, 2)
    i32 the chunk index and symbol of each single-symbol chunk, and ``resume``
    the chunk from which the host decodes the rest of the block (the reader
    at its first bit), None where the parse reached the tail."""
    rows: np.ndarray
    freq: np.ndarray
    cum: np.ndarray
    states: np.ndarray
    lens: np.ndarray
    payload: np.ndarray
    single: np.ndarray
    resume: int | None


# the codes of hostsrc/ans0_wire.cpp's parse, raised as the host decoder
# (entropy/ans.py) raises them
_WIRE_ERRORS = {
    2: "mesh decode: non-default log range",
    3: "invalid ANS range",
    4: "empty ANS alphabet",
    5: "invalid ANS frequency size",
    6: "invalid ANS frequency",
    7: "invalid ANS frequencies",
    8: "invalid ANS chunk size",
}
_WIRE_EOF = 1


def parse_ans0_wire(br: BitReader, nfull: int, host_log_ranges: bool = True) -> Ans0Wire:
    """The headers of a block's ``nfull`` full chunks from ``br`` in stream
    order, and their payloads: one call of the port's native parse
    (hostsrc/ans0_wire.cpp; ``launches["ans0_wire_native"]``), which leaves
    ``br`` after the last parsed chunk.  A header with a log range other than
    LOG_RANGE stops the parse there (``resume``), or, with
    ``host_log_ranges`` false, raises."""
    err, rows, freq, cum, states, lens, payload, single, resume = ans0_wire_native(
        br, nfull, LOG_RANGE, host_log_ranges)
    launch.count("ans0_wire_native")
    if err == _WIRE_EOF:
        raise EOFError("bitstream exhausted")
    if err:
        raise BitStreamError(_WIRE_ERRORS[err], BitStreamError.INVALID_STREAM)
    return Ans0Wire(rows, freq, cum, states, lens, payload, single,
                    None if resume < 0 else resume)


def decode_host(out: np.ndarray, start: int, count: int, br: BitReader,
                chunk: int = CHUNK) -> None:
    """The block's chunks from byte ``start`` (a chunk's first) to ``count``
    on the host into ``out[start:]``.  Above 32 bytes they are the wire of a
    block of that many bytes, which the native coder decodes in one call;
    32 bytes and under, without the native library, or where the native
    coder refuses the stream, numpy decodes chunk by chunk (and raises what
    the stream gives it to raise)."""
    if count - start > 32:
        pos = br.read_count
        try:
            res = ans_decode_native(count - start, br, 0, chunk)
        except BitStreamError:
            br.seek(pos)
            res = None
        if res is not None:
            out[start:] = res
            return
    dec = hans.ANSRangeDecoder(br, 0, chunk_size=chunk)
    for s in range(start, count, chunk):
        dec._decode_chunk(out, s, min(s + chunk, count), br)
