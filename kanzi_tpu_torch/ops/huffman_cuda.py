"""Canonical Huffman kernels on the H100, beside their plain PyTorch versions.

Counterpart of kanzi_tpu/ops/huffman_pallas.py, kanzi_tpu/ops/
huffman_decode_pallas.py and the histogram of kanzi_tpu/ops/ans_pallas.py.
Three hand-written CUDA kernels (kanzi_tpu_torch/csrc/huffman.cu) cover the
TPU's kernels on this path:

  hist     _hist16 (XLA)                       per-chunk byte histogram
  encode   _hscan_fused_kernel + _compact_kernel (its Huffman use)
                                               code lookup + MSB-first packing
  decode   _decode_kernel + _lookup_kernel (its Huffman use)
                                               canonical decode straight to bytes

Each wrapper runs its plain version (``*_ref``, same signature) when its
tensors lie on the CPU, and launches its kernel when they lie on a CUDA
device, or raises: there is no fallback.  Each launch adds one to the
kernel's count in ``launches`` (ops/launch.py).

The numpy-contract entry points take and return the layouts of
``huffman_encode_streams`` and ``huffman_decode_chunks_pallas``: chunks
(N, 16384) u8; code tables (N, 128) i32 holding two ``len << 12 | code``
entries per word (symbol 2k in the low half); words (4N, 4096) u16 with
rows ordered ``4 * chunk + stream``; payloads (N, 4 * 6656) u8, stream j's
bytes at ``j * 6656``.  Inside torch, 16-bit words travel as int16 bit
patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import check_device
from .launch import i16, launch, register, require, stream, to_device, to_host

CHUNK = 16384
STREAM = CHUNK // 4                 # symbols per quarter-stream
MAX_SYMBOL_SIZE = 12
PAY_STRIDE = 26 * 256               # bytes per stream segment (_PAY_ROWS_PER_STREAM * 256)
PAY_WIDTH = 4 * PAY_STRIDE
_SEG_WORDS16 = PAY_STRIDE // 2

KERNELS = ("huffman_hist", "huffman_encode", "huffman_decode")
register(KERNELS)


# ---------------------------------------------------------------------------
# kernel 1: histogram
# ---------------------------------------------------------------------------

def hist_ref(chunks: torch.Tensor) -> torch.Tensor:
    """chunks (N, 16384) uint8 -> byte counts (N, 256) int32."""
    hist = torch.zeros((chunks.shape[0], 256), dtype=torch.int64,
                       device=chunks.device)
    hist.scatter_add_(1, chunks.long(), torch.ones_like(chunks, dtype=torch.int64))
    return hist.to(torch.int32)


def hist(chunks: torch.Tensor) -> torch.Tensor:
    if chunks.device.type == "cpu":
        return hist_ref(chunks)
    require(chunks, torch.uint8, (None, CHUNK))
    n = chunks.shape[0]
    out = torch.empty((n, 256), dtype=torch.int32, device=chunks.device)
    if n:
        with torch.cuda.device(chunks.device):
            launch("huffman_hist", chunks.data_ptr(), out.data_ptr(), n,
                   stream(chunks))
    return out


# ---------------------------------------------------------------------------
# kernel 2: encode (code lookup + packing)
# ---------------------------------------------------------------------------

def encode_streams_ref(chunks: torch.Tensor, tbl: torch.Tensor):
    """chunks (N, 16384) uint8, tbl (N, 128) int32 -> (words (4N, 4096)
    int16, n_words (4N,), acc (4N,), nbits (4N,) int32).

    Stream ``4 * i + j`` is the MSB-first concatenation of the codes of
    chunk i's bytes ``[4096 j, 4096 (j + 1))``; entry ``e`` of a byte gives
    ``len = e >> 12`` and ``code = e & 0xFFF``, masked to ``len`` bits.  The
    full 16-bit words come first, zeros after them; ``acc`` holds the
    ``nbits < 16`` leftover bits, LSB-aligned.  Vectorised: a code (at most
    15 bits) starting at bit ``off`` lies in the big-endian 32-bit window of
    words ``off >> 4`` and ``(off >> 4) + 1``, so two scatter-adds of
    disjoint bits place every code."""
    n = chunks.shape[0]
    dev = chunks.device
    t = tbl.long()
    t16 = torch.stack([t & 0xFFFF, (t >> 16) & 0xFFFF], dim=2).reshape(n, 256)
    e = t16.gather(1, chunks.long()).reshape(4 * n, STREAM)
    ln = e >> 12
    code = e & 0xFFF & ((1 << ln) - 1)
    end = torch.cumsum(ln, dim=1)
    off = end - ln
    total = end[:, -1]
    val = code << (32 - (off & 15) - ln)
    w0 = off >> 4
    buf = torch.zeros((4 * n, STREAM + 1), dtype=torch.int64, device=dev)
    buf.scatter_add_(1, w0, val >> 16)
    buf.scatter_add_(1, w0 + 1, val & 0xFFFF)
    n_words = total >> 4
    nbits = total & 15
    acc = buf.gather(1, n_words[:, None])[:, 0] >> (16 - nbits)
    words = torch.where(torch.arange(STREAM, device=dev) < n_words[:, None],
                        buf[:, :STREAM], 0)
    return (i16(words), n_words.to(torch.int32), acc.to(torch.int32),
            nbits.to(torch.int32))


def encode_streams(chunks: torch.Tensor, tbl: torch.Tensor):
    if chunks.device.type == "cpu":
        return encode_streams_ref(chunks, tbl)
    require(chunks, torch.uint8, (None, CHUNK))
    n = chunks.shape[0]
    require(tbl, torch.int32, (n, 128))
    dev = chunks.device
    words = torch.empty((4 * n, STREAM), dtype=torch.int16, device=dev)
    n_words, acc, nbits = (torch.empty((4 * n,), dtype=torch.int32, device=dev)
                           for _ in range(3))
    if n:
        with torch.cuda.device(dev):
            launch("huffman_encode", chunks.data_ptr(), tbl.data_ptr(),
                   words.data_ptr(), n_words.data_ptr(), acc.data_ptr(),
                   nbits.data_ptr(), n, stream(chunks))
    return words, n_words, acc, nbits


# ---------------------------------------------------------------------------
# kernel 3: decode
# ---------------------------------------------------------------------------

def _window_tables(bnd: torch.Tensor, adj: torch.Tensor, perm: torch.Tensor):
    """(N, 4096) code length and symbol of every 12-bit window v:
    L = 1 + #{l in 1..12 : boundary[l] <= v}; for L <= 12 the symbol is
    perm[(adj[L] - 8192 + (v >> (12 - L))) & 255] & 255, for L = 13 (a
    window past the last code) it is 0."""
    dev = bnd.device
    lvl = torch.arange(MAX_SYMBOL_SIZE, device=dev)
    b = (bnd.long()[:, lvl >> 1] >> (16 * (lvl & 1))) & 0xFFFF          # (N, 12)
    v = torch.arange(1 << MAX_SYMBOL_SIZE, device=dev)
    ln = 1 + (b[:, None, :] <= v[None, :, None]).sum(2)                  # (N, 4096)
    lc = torch.clamp(ln, max=MAX_SYMBOL_SIZE)
    rank = adj.long().gather(1, lc) - 8192 + (v >> (MAX_SYMBOL_SIZE - lc))
    sym = perm.long().gather(1, rank & 255) & 255
    return ln, torch.where(ln <= MAX_SYMBOL_SIZE, sym, 0)


def decode_chunks_ref(pay: torch.Tensor, bnd: torch.Tensor, adj: torch.Tensor,
                      perm: torch.Tensor):
    """pay (N, 4 * 6656) uint8, bnd/adj (N, 128) int32, perm (N, 256) int32
    -> (syms (N, 16384) uint8, used (N, 4) int32).

    Each stream decodes 4,096 symbols from the 12-bit MSB-first window at
    its bit position, which advances by the window's code length (13 past
    the last code); bits past the stream's 6,656-byte segment read as 0.
    ``used`` is each stream's final bit position.  A lockstep loop over the
    4,096 steps, all 4N streams at once."""
    n = pay.shape[0]
    dev = pay.device
    ln, sym = _window_tables(bnd, adj, perm)
    ln = ln.repeat_interleave(4, dim=0)                      # row 4 * chunk + j
    sym = sym.repeat_interleave(4, dim=0)
    seg = pay.reshape(4 * n, PAY_STRIDE).long()
    words = torch.zeros((4 * n, _SEG_WORDS16 + 2), dtype=torch.int64, device=dev)
    words[:, :_SEG_WORDS16] = (seg[:, 0::2] << 8) | seg[:, 1::2]
    bp = torch.zeros((4 * n, 1), dtype=torch.int64, device=dev)
    out = torch.empty((4 * n, STREAM), dtype=torch.int64, device=dev)
    for t in range(STREAM):
        wp = bp >> 4
        v32 = (words.gather(1, wp) << 16) | words.gather(1, wp + 1)
        v = (v32 >> (20 - (bp & 15))) & 0xFFF
        out[:, t:t + 1] = sym.gather(1, v)
        bp = bp + ln.gather(1, v)
    return (out.reshape(n, CHUNK).to(torch.uint8),
            bp.reshape(n, 4).to(torch.int32))


def decode_chunks(pay: torch.Tensor, bnd: torch.Tensor, adj: torch.Tensor,
                  perm: torch.Tensor):
    if pay.device.type == "cpu":
        return decode_chunks_ref(pay, bnd, adj, perm)
    n = pay.shape[0]
    require(pay, torch.uint8, (n, PAY_WIDTH))
    for t, shape in ((bnd, (n, 128)), (adj, (n, 128)), (perm, (n, 256))):
        require(t, torch.int32, shape)
    dev = pay.device
    syms = torch.empty((n, CHUNK), dtype=torch.uint8, device=dev)
    used = torch.empty((n, 4), dtype=torch.int32, device=dev)
    if n:
        with torch.cuda.device(dev):
            launch("huffman_decode", pay.data_ptr(), bnd.data_ptr(),
                   adj.data_ptr(), perm.data_ptr(), syms.data_ptr(),
                   used.data_ptr(), n, stream(pay))
    return syms, used


# ---------------------------------------------------------------------------
# numpy-contract entry points (the kanzi_tpu signatures plus a device)
# ---------------------------------------------------------------------------

def huffman_encode_streams(chunks: np.ndarray, tbl: np.ndarray, device):
    """kanzi_tpu.ops.huffman_pallas.huffman_encode_streams on ``device``:
    (words u16 (4N, 4096), n_words, acc, nbits i32 (4N,))."""
    dev = check_device(device)
    words, n_words, acc, nbits = encode_streams(to_device(chunks, dev, np.uint8),
                                                to_device(tbl, dev, np.int32))
    return (to_host(words).view(np.uint16), to_host(n_words), to_host(acc),
            to_host(nbits))


def huffman_decode_chunks(pay: np.ndarray, bnd: np.ndarray, adj: np.ndarray,
                          perm: np.ndarray, device):
    """kanzi_tpu.ops.huffman_decode_pallas.huffman_decode_chunks_pallas on
    ``device``: (syms u8 (N, 16384), used i32 (N, 4)).  ``pay`` rows are
    zero-padded or cut to the 4 x 6656-byte layout."""
    dev = check_device(device)
    n = pay.shape[0]
    p = np.zeros((n, PAY_WIDTH), np.uint8)
    w = min(pay.shape[1], PAY_WIDTH)
    p[:, :w] = pay[:, :w]
    syms, used = decode_chunks(to_device(p, dev), to_device(bnd, dev, np.int32),
                               to_device(adj, dev, np.int32),
                               to_device(perm, dev, np.int32))
    return to_host(syms), to_host(used)
