"""Host glue of the Huffman stage on a torch device: the exact
HuffmanEncoder/HuffmanDecoder wire (entropy/huffman.py), with the
histograms, the code packing and the decode of the full 16 KiB chunks in the
kernels of ops/huffman_cuda.py.

Counterpart of kanzi_tpu's HuffmanEncoder._encode_full_chunks_tpu, of the
device branch of its HuffmanDecoder.decode with _device_decode_batch, and of
ops/huffman_decode_pallas.build_decode_tables, written again here.  The
device/host split is the reference's:

  host:   code tables (entropy/huffman.py build_tables_batch, native C++), chunk
          headers and varints; the tail chunk (< 16 KiB); on decode, the
          header parse and single-symbol chunks
  device: the histograms and the code packing of the full chunks, and the
          decode of every full chunk with two or more symbols

Differences from the reference's device path, none on a valid stream: a
header whose code lengths oversubscribe the 12-bit code space raises
(the decode tables pack 16-bit boundaries); each block's wire is packed
into one segment under the glue lock (glue.write_locked).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bits import BitReader, BitWriter
from ..core.errors import BitStreamError
from ..entropy import huffman as hhuf
from ..entropy import utils as eu
from ..entropy.expgolomb import ExpGolombEncoder

from . import huffman_cuda
from .glue import glue_lock, write_locked
from .launch import to_device, to_host

CHUNK = huffman_cuda.CHUNK
MAX_SYMBOL_SIZE = huffman_cuda.MAX_SYMBOL_SIZE
_MAX_STREAM_BITS = MAX_SYMBOL_SIZE * huffman_cuda.STREAM


def build_decode_tables(sizes_list, alphabets):
    """kanzi_tpu.ops.huffman_decode_pallas.build_decode_tables in numpy, for
    all chunks at once.  ``sizes_list[i]`` holds 256 code lengths, of which
    those of ``alphabets[i]`` (the present symbols, ascending) count.
    Returns (bnd (N, 128) i32: boundary[l] = sum_{k <= l} count[k] << (12 - k)
    for l = 1..12, two 16-bit entries per word; adj (N, 128) i32:
    adj[L] = offset[L] - first[L] + 8192 at L = 1..12; perm (N, 256) i32: the
    present symbols in (length, value) order)."""
    n = len(alphabets)
    bnd = np.zeros((n, 128), np.int32)
    adj = np.zeros((n, 128), np.int32)
    perm = np.zeros((n, 256), np.int32)
    if n == 0:
        return bnd, adj, perm
    sym = np.arange(256)
    present = np.zeros((n, 256), bool)
    for i, a in enumerate(alphabets):
        present[i, np.asarray(a, np.int64)] = True
    sizes = np.stack([np.asarray(s, np.int64) for s in sizes_list])
    key = np.where(present, sizes * 256 + sym, np.iinfo(np.int64).max)
    order = np.argsort(key, axis=1, kind="stable")
    perm[:] = np.where(sym < present.sum(1)[:, None], order, 0)
    lvl = np.arange(1, MAX_SYMBOL_SIZE + 1)
    count = ((sizes[:, :, None] == lvl) & present[:, :, None]).sum(1)   # (N, 12)
    boundary = np.cumsum(count << (MAX_SYMBOL_SIZE - lvl), axis=1)
    offset = np.concatenate([np.zeros((n, 1), np.int64), np.cumsum(count, axis=1)],
                            axis=1)[:, :MAX_SYMBOL_SIZE]
    prev_b = np.concatenate([np.zeros((n, 1), np.int64), boundary[:, :-1]], axis=1)
    first = prev_b >> (MAX_SYMBOL_SIZE - lvl)
    bnd[:, :6] = (boundary[:, 0::2] | (boundary[:, 1::2] << 16)).astype(np.int32)
    adj[:, 1:13] = (offset - first + 8192).astype(np.int32)
    return bnd, adj, perm


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def huffman_encode_full(block: np.ndarray, bw: BitWriter, device: torch.device) -> int:
    """HuffmanEncoder._encode_full_chunks_tpu on ``device``: write the wire of
    every full 16 KiB chunk of ``block`` to ``bw`` and return the offset from
    which the caller encodes the rest on the host; 0 (nothing written) for
    fewer than four full chunks, as in the reference."""
    block = np.asarray(block, dtype=np.uint8)
    nfull = block.size // CHUNK
    if nfull < 4:
        return 0
    chunks = block[:nfull * CHUNK].reshape(nfull, CHUNK)
    write_locked(bw, lambda wire: _encode_full(chunks, wire, device))
    return nfull * CHUNK


def _encode_full(chunks: np.ndarray, bw: BitWriter, device: torch.device) -> None:
    x = to_device(chunks, device)
    hists = to_host(huffman_cuda.hist(x)).astype(np.int64)
    sizes, codes, nsym = hhuf.build_tables_batch(hists)
    # len << 12 | code per symbol; as int32 words, symbol 2k in the low half
    tbl = ((sizes << 12) | codes).astype(np.uint16).view(np.int32)
    words_t, n_words_t, acc_t, nbits_t = huffman_cuda.encode_streams(
        x, to_device(tbl, device))
    n_words = to_host(n_words_t)
    acc = to_host(acc_t)
    nbits = to_host(nbits_t)
    # fetch only the populated prefix of the words (power-of-two width)
    mw = int(n_words.max(initial=1))
    mw = min(1 << max(mw - 1, 1).bit_length(), huffman_cuda.STREAM)
    words = to_host(words_t[:, :mw].contiguous()).view(np.uint16)
    eg = ExpGolombEncoder(bw, True)
    for i in range(len(chunks)):
        alphabet = np.flatnonzero(hists[i])
        eu.encode_alphabet(bw, alphabet)
        if len(alphabet):
            deltas = np.diff(np.concatenate([[2], sizes[i][alphabet]]))
            eg.encode(deltas.astype(np.uint8))
        if nsym[i] <= 1:
            continue               # header only: the decoder fills the symbol
        rows = range(4 * i, 4 * i + 4)
        for r in rows:
            eu.write_varint(bw, int(n_words[r]) * 16 + int(nbits[r]))
        for r in rows:
            w = int(n_words[r])
            p = int(nbits[r])
            data = words[r, :w].astype(">u2").tobytes()
            if p:
                nby = (p + 7) // 8
                data += ((int(acc[r]) & ((1 << p) - 1)) << (8 * nby - p)).to_bytes(nby, "big")
            bw.write_bytes(data, 16 * w + p)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def huffman_decode(count: int, br: BitReader, device: torch.device) -> np.ndarray:
    """HuffmanDecoder.decode (bit-stream version 6 and later, 16 KiB chunks)
    with every full chunk of two or more symbols decoded on ``device``."""
    with glue_lock():
        return _decode(count, br, device)


def _decode(count: int, br: BitReader, device: torch.device) -> np.ndarray:
    out = np.empty(count, dtype=np.uint8)
    dec = hhuf.HuffmanDecoder(br)   # keeps the lengths from chunk to chunk
    queue = []                      # (start, sz_bits, streams, sizes, alphabet)
    for start in range(0, count, CHUNK):
        sz = min(CHUNK, count - start)
        if sz < 32:
            out[start:start + sz] = br.read_bytes(sz)
            continue
        n_sym = dec._read_lengths()   # into dec.alphabet and dec.sizes, from br
        if n_sym == 0:
            raise BitStreamError("empty Huffman alphabet",
                                 BitStreamError.INVALID_STREAM)
        if n_sym == 1:
            out[start:start + sz] = dec.alphabet[0]
        elif sz == CHUNK:
            sz_bits = [eu.read_varint(br) for _ in range(4)]
            # a stream carries 4096 symbols of <= 12 bits; more is corrupt
            if any(b > _MAX_STREAM_BITS for b in sz_bits):
                raise BitStreamError("Huffman stream size out of range",
                                     BitStreamError.INVALID_STREAM)
            lens = dec.sizes[dec.alphabet]
            if int(np.sum(1 << (MAX_SYMBOL_SIZE - lens))) > 1 << MAX_SYMBOL_SIZE:
                raise BitStreamError("oversubscribed Huffman code lengths",
                                     BitStreamError.INVALID_STREAM)
            streams = [br.read_packed(b) for b in sz_bits]
            queue.append((start, sz_bits, streams, dec.sizes.copy(),
                          dec.alphabet.copy()))
        else:
            dec._decode_chunk(out, start, sz, br)
    if queue:
        _decode_batch(queue, out, device)
    return out


def _decode_batch(queue: list, out: np.ndarray, device: torch.device) -> None:
    """_device_decode_batch: decode the queued full chunks on ``device`` and
    scatter them into ``out``."""
    stride = huffman_cuda.PAY_STRIDE
    pay = np.zeros((len(queue), huffman_cuda.PAY_WIDTH), np.uint8)
    for i, (_, _, streams, _, _) in enumerate(queue):
        for j, sb in enumerate(streams):
            pay[i, j * stride:j * stride + len(sb)] = sb
    bnd, adj, perm = build_decode_tables([q[3] for q in queue], [q[4] for q in queue])
    syms, used = huffman_cuda.huffman_decode_chunks(pay, bnd, adj, perm, device)
    for i, (start, sz_bits, _, _, _) in enumerate(queue):
        if list(used[i]) != list(sz_bits):
            raise BitStreamError("Huffman stream length mismatch",
                                 BitStreamError.INVALID_STREAM)
        out[start:start + CHUNK] = syms[i]
