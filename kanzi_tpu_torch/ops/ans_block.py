"""Host glue of the ANS stages on a torch device: the exact ANSRangeEncoder
wire bytes (entropy/ans.py), with the order-0 statistics, scan and
compaction in the kernels of ops/ans_cuda.py, and the order-1 lookup, scan
and compaction in those of ops/ans1_cuda.py.

Counterpart of kanzi_tpu/ops/ans_block.py (assemble_ans0_wire, ans0_encode,
ans0_decode, ans1_encode), written again in numpy.  The device/host split is
the reference's:

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

Two differences: a chunk header with an empty alphabet raises, as the host
decoder does (entropy/ans.py), where kanzi_tpu's device glue filled zeros;
an order-1 tail of more than 32 bytes is written by the native host coder,
which writes the same bytes (tests/test_torch_ans1.py) as the reference's
numpy loop of one Python step per 4 bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bits import BitReader, BitWriter
from ..core.errors import BitStreamError
from ..entropy import ans as hans
from ..entropy import utils as eu

from ..utils.native_coders import ans_encode_native
from . import ans1_cuda, ans_cuda
from .glue import glue_lock, read_windowed
from .launch import to_device, to_host

CHUNK = ans_cuda.CHUNK
LOG_RANGE = ans_cuda.LOG_RANGE
CHUNK1 = ans1_cuda.CHUNK1
LOG_RANGE1 = ans1_cuda.LOG_RANGE1


def assemble_ans0_wire(bw: BitWriter, freq: np.ndarray, nsym: np.ndarray,
                       alphabets: list, n_emit: np.ndarray,
                       states: np.ndarray, payload: np.ndarray,
                       rowmap: np.ndarray) -> None:
    """Serialize per-chunk ANS0 wire records (lr, freq header, varint size,
    4x32-bit states, big-endian u16 payload) from device-produced arrays.
    ``rowmap[i]`` is the payload row for chunk ``i`` (single-symbol chunks
    have no payload and are skipped)."""
    for i in range(len(nsym)):
        bw.write_bits(LOG_RANGE - 8, 3)
        hans._write_freqs_header(bw, alphabets[i], freq[i], LOG_RANGE)
        if nsym[i] <= 1:
            continue  # skipped chunk (single symbol)
        k = rowmap[i]
        ne = int(n_emit[k])
        pay = payload[k, :ne].astype(">u2").tobytes()
        eu.write_varint(bw, len(pay))
        for j in range(4):
            bw.write_bits(int(states[k, j]), 32)
        bw.write_bytes(pay)


def ans0_encode(block: np.ndarray, bw: BitWriter, device: torch.device) -> int:
    """ANSRangeEncoder(order=0).encode with the full chunks on ``device``.
    The block's wire is packed into one segment under the lock, so that the
    caller's writer does not pack its thousands of small header segments
    outside it."""
    with glue_lock():
        wire = BitWriter()
        count = _encode(block, wire, device)
        arr, nbits = wire.getvalue_packed()
    bw.write_bytes(arr, nbits=nbits)
    return count


def _encode(block: np.ndarray, bw: BitWriter, device: torch.device) -> int:
    return encode_ans0_wire(block, bw, lambda chunks: _device_rows(chunks, device))


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
    n_emit (n,), states (n, 4)), numpy.  Blocks of at most 32 bytes and the
    tail chunk are written on the host.  One device (``_device_rows``) or
    the ranks of a mesh (parallel/engine.py) run the rows."""
    block = np.asarray(block, dtype=np.uint8)
    count = block.size
    if count <= 32:
        bw.write_bytes(block.tobytes())
        return count
    nfull = count // chunk
    tail = count - nfull * chunk
    if nfull > 0:
        freq, payload, n_emit, states = rows(block[:nfull * chunk].reshape(nfull, chunk))
        freq = np.asarray(freq, dtype=np.int64)
        nz = freq > 0
        alphabets = [np.flatnonzero(nz[i]).astype(np.int32) for i in range(nfull)]
        assemble_ans0_wire(bw, freq, nz.sum(axis=1), alphabets, n_emit, states,
                           payload, np.arange(nfull))
    if tail:
        hans.ANSRangeEncoder(bw, 0, chunk_size=chunk)._encode_chunk(
            block[nfull * chunk:], bw)
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
    ``device``; one packed wire segment per block, as ans0_encode."""
    with glue_lock():
        wire = BitWriter()
        count = _encode1(block, wire, device)
        arr, nbits = wire.getvalue_packed()
    bw.write_bytes(arr, nbits=nbits)
    return count


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
        encode1_tail(block[nfull * CHUNK1:], bw)
    return count


def encode1_tail(seg: np.ndarray, bw: BitWriter) -> None:
    """One order-1 chunk shorter than 4 MiB, as the reference writes it
    (ANSRangeEncoder._encode_chunk); above 32 bytes the native coder writes
    the same chunk (a block of one chunk at the default sizes)."""
    if seg.size > 32 and ans_encode_native(seg, bw, 1, hans.DEFAULT_ANS0_CHUNK_SIZE,
                                           hans.DEFAULT_LOG_RANGE):
        return
    hans.ANSRangeEncoder(bw, 1)._encode_chunk(seg, bw)


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
    (n, 256) i64, cum (n, 256) i64) -> (out uint8 (n, chunk), consumed
    (n,)), numpy.  The headers are parsed here in stream order; single-symbol
    chunks and the tail decode on the host.  A chunk with another log range
    than the kernels' 12 decodes on the host with every later chunk, or, with
    ``host_log_ranges`` false (kanzi_tpu's mesh rule), raises.  An empty
    alphabet, a chunk size at or over the maximum or a consumed count that
    differs from the payload's raise BitStreamError."""
    if count <= 32:
        return br.read_bytes(count)
    out = np.empty(count, dtype=np.uint8)
    nfull = count // chunk
    tail = count - nfull * chunk
    # stage 1 (host, sequential): parse per-chunk headers and slice payloads
    full = []     # (start, freqs, states, payload bytes)
    single = []   # (start, symbol)
    host_resume = None  # (first host chunk index, its already-read log range)
    for i in range(nfull):
        lr = 8 + br.read_bits(3)
        if lr != LOG_RANGE:
            if not host_log_ranges:
                raise BitStreamError("mesh decode: non-default log range",
                                     BitStreamError.INVALID_STREAM)
            # valid streams may use any lr in [8, 15]; the kernels are
            # specialised to the default 12, so the rest decodes on the host
            if not 8 <= lr <= 15:
                raise BitStreamError("invalid ANS range",
                                     BitStreamError.INVALID_STREAM)
            host_resume = (i, lr)
            break
        alpha, freqs = read_windowed(br, hans._read_freqs_header, lr)
        if len(alpha) == 0:
            raise BitStreamError("empty ANS alphabet",
                                 BitStreamError.INVALID_STREAM)
        if len(alpha) == 1:
            single.append((i * chunk, int(alpha[0])))
            continue
        sz = eu.read_varint(br)
        if sz >= hans.MAX_CHUNK_SIZE:
            raise BitStreamError("invalid ANS chunk size",
                                 BitStreamError.INVALID_STREAM)
        states = [br.read_bits(32) for _ in range(4)]
        full.append((i * chunk, freqs, states, br.read_bytes(sz)))
    if full:
        lens = np.array([len(m[3]) for m in full], dtype=np.int32)
        pay = np.zeros((len(full), max(int(lens.max()), 1)), dtype=np.uint8)
        freq = np.zeros((len(full), 256), dtype=np.int64)
        states = np.zeros((len(full), 4), dtype=np.int64)
        for k, m in enumerate(full):
            pay[k, :lens[k]] = m[3]
            freq[k] = m[1]
            states[k] = m[2]
        cum = np.cumsum(freq, axis=1) - freq
        res, consumed = rows(pay, lens, states, freq, cum)
        if not np.array_equal(consumed, lens):
            raise BitStreamError("ANS payload size mismatch (device decode)",
                                 BitStreamError.INVALID_STREAM)
        for k, m in enumerate(full):
            out[m[0]:m[0] + chunk] = res[k]
    for start, sym in single:
        out[start:start + chunk] = sym
    dec = hans.ANSRangeDecoder(br, 0, chunk_size=chunk)
    if host_resume is not None:
        i0, lr0 = host_resume
        dec._decode_chunk(out, i0 * chunk, min((i0 + 1) * chunk, count),
                          br, lr=lr0)
        for i in range(i0 + 1, nfull):
            dec._decode_chunk(out, i * chunk, (i + 1) * chunk, br)
    if tail:
        dec._decode_chunk(out, nfull * chunk, count, br)
    return out
