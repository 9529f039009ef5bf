"""Order-1 rANS (ANS1) encode kernels on the H100, beside their plain PyTorch
versions.

Counterpart of kanzi_tpu/ops/ans_pallas.py (the order-1 parts:
``ans1_encode_chunks_pallas`` and the kernels it runs) and of
kanzi_tpu/ops/ans.py ``ans1_encode_chunks``.  Three hand-written CUDA kernels
(kanzi_tpu_torch/csrc/ans1.cu) replace the TPU's three:

  lookup1   _lookup1_kernel   packed f | cum << 11 at ctx * 256 + sym
  scan      _scan_kernel      the lockstep rANS state scan, one lane a chain
  compact   _compact_kernel   per-tile stable partition of the emitted words

Each wrapper runs its plain version (``*_ref``, same signature) when its
tensors lie on the CPU, and launches its kernel when they lie on a CUDA
device, or raises: there is no fallback.  Each launch adds one to the
kernel's count in ``launches`` (ops/launch.py).

A 4 MiB order-1 wire chunk is coded by four states, state k walking quarter
k backward (entropy/ans.py ``_lane_layout_order1``); the context of a byte
is the byte before it, 0 at each quarter start.  The forward payload orders
the emissions by step, from the last step back, lanes 3..0 within a step:
word (p, 3 - k) for byte p of quarter k.  The TPU emits into 128-lane
step-major rows (``_scan``'s contract, kept by ``scan`` for the tests); the
main path's ``scan_chunks`` runs only the 4N real lanes and stores each word
straight at its forward position, so no relayout pass follows it.

The numpy-contract entry points take and return the layouts of kanzi_tpu's:
chunks (N, C) u8 with C a multiple of 16384 (4 MiB on the wire; the tests
use narrower chunks), freq/cum (N, 256, 256) (context, symbol), payload
u16, states (N, 4).  Inside torch, 16-bit words travel as int16 bit
patterns.  Valid tables (f >= 1 for every coded pair, cum + f <= 2048) keep
every state below 2^31, as int32 on the TPU and uint32 in the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import check_device
from . import ans_cuda
from .launch import i16, launch, register, require, stream, to_device

ANS_TOP = 1 << 15
LOG_RANGE1 = 11                  # order-1 logRange (ANSRangeEncoder.java:125)
SCALE1 = 1 << LOG_RANGE1
CHUNK = 16384                    # a compaction tile: 128 blocks of 128 words
CHUNK1 = CHUNK << 8              # 4 MiB wire chunks (ANSRangeEncoder.java:126)

KERNELS = ("ans1_lookup", "ans1_scan", "ans1_compact")
register(KERNELS)


def pack_tables(freq: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """freq/cum (N, 256, 256) -> the lookup's (N, 65536) int32 table
    min(freq, 2047) | cum << 11 at ctx * 256 + sym; the cap is the
    reference's (a single-symbol context has freq 2048 == scale)."""
    packed = torch.clamp(freq.long(), max=SCALE1 - 1) | (cum.long() << LOG_RANGE1)
    return packed.to(torch.int32).reshape(freq.shape[0], 65536)


# ---------------------------------------------------------------------------
# kernel 1: order-1 table lookup
# ---------------------------------------------------------------------------

def lookup1_ref(chunks: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """chunks (N, C) uint8 (C % 16 == 0), packed (N, 65536) int32 ->
    (N, C) int32: packed[n, ctx * 256 + sym] with ctx the byte before, 0 at
    each quarter start (p % (C / 4) == 0)."""
    n, c = chunks.shape
    sym = chunks.long()
    pos = torch.arange(c, device=chunks.device)
    ctx = torch.where(pos % (c // 4) == 0, 0, torch.roll(sym, 1, dims=1))
    return packed.gather(1, ctx * 256 + sym)


def lookup1(chunks: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    if chunks.device.type == "cpu":
        return lookup1_ref(chunks, packed)
    n, c = chunks.shape
    if c % 16:
        raise ValueError("chunk width must be a multiple of 16")
    require(chunks, torch.uint8, (None, None))
    require(packed, torch.int32, (n, 65536))
    out = torch.empty((n, c), dtype=torch.int32, device=chunks.device)
    if n:
        with torch.cuda.device(chunks.device):
            launch("ans1_lookup", chunks.data_ptr(), packed.data_ptr(),
                   out.data_ptr(), n, c, stream(chunks))
    return out


# ---------------------------------------------------------------------------
# kernel 2: the rANS state scan
# ---------------------------------------------------------------------------

def scan_ref(lk: torch.Tensor, lr: int = LOG_RANGE1):
    """``_scan``'s contract: lk (S, ...) int32, step-major, each lane's
    entry packed f | cum << lr -> (emit (S, ...) int32 flag << 16 | val, 0
    where nothing was emitted; final states (...) int32).  States start at
    ANS_TOP; a lane emits its low 16 bits when st >> (31 - lr) >= f."""
    s = lk.shape[0]
    x = lk.reshape(s, -1).long()
    f_all = x & ((1 << lr) - 1)
    c_all = x >> lr
    g_all = (1 << lr) - f_all
    st = torch.full((x.shape[1],), ANS_TOP, dtype=torch.int64, device=lk.device)
    pre = torch.empty(x.shape, dtype=torch.int64, device=lk.device)
    for t in range(s):
        # each step as few tensor ops as it can be: the emission flag is
        # recomputed from the states before the steps, after the loop, and
        # (q << lr) + (st - q * f) + cm == st + cm + q * (2^lr - f)
        pre[t] = st
        st = st >> (((st >> (31 - lr)) >= f_all[t]) * 16)
        st = torch.addcmul(st + c_all[t], st // f_all[t], g_all[t])
    em = (pre >> (31 - lr)) >= f_all
    emit = torch.where(em, (pre & 0xFFFF) | (1 << 16), 0)
    return emit.to(torch.int32).reshape(lk.shape), st.to(torch.int32).reshape(lk.shape[1:])


def scan(lk: torch.Tensor, lr: int = LOG_RANGE1):
    if lk.device.type == "cpu":
        return scan_ref(lk, lr)
    s = lk.shape[0]
    lanes = lk.numel() // s if s else 0
    require(lk, torch.int32, tuple(None for _ in lk.shape))
    emit = torch.empty_like(lk)
    states = torch.empty(lk.shape[1:], dtype=torch.int32, device=lk.device)
    if lanes:
        _launch_scan(lk, emit, states, lanes, s, lr, chunked=False)
    return emit, states


def scan_chunks_ref(lk: torch.Tensor, lr: int = LOG_RANGE1):
    """The main path's scan: lk (N, C) int32, lookup1's output in byte
    order -> (emit (N, C) int32 in forward wire order, states (N, 4)):
    lane 4n + k walks quarter k of chunk n backward, and its word at step t
    lands at 4 * (C/4 - 1 - t) + 3 - k."""
    n, c = lk.shape
    q = c // 4
    flat = lk.view(n, 4, q).flip(2).permute(2, 0, 1).reshape(q, 4 * n)
    emit, st = scan_ref(flat, lr)
    e = emit.view(q, n, 4).permute(1, 0, 2).flip(1).flip(2).reshape(n, c)
    return e.contiguous(), st.view(n, 4)


def scan_chunks(lk: torch.Tensor, lr: int = LOG_RANGE1):
    if lk.device.type == "cpu":
        return scan_chunks_ref(lk, lr)
    n, c = lk.shape
    if c % 4:
        raise ValueError("chunk width must be a multiple of 4")
    require(lk, torch.int32, (None, None))
    emit = torch.empty_like(lk)
    states = torch.empty((n, 4), dtype=torch.int32, device=lk.device)
    if n and c:
        _launch_scan(lk, emit, states, 4 * n, c // 4, lr, chunked=True)
    return emit, states


def _launch_scan(lk, emit, states, lanes: int, steps: int, lr: int,
                 chunked: bool) -> None:
    if not 8 <= lr <= 15:
        raise ValueError("log range must lie in [8, 15]")
    with torch.cuda.device(lk.device):
        launch("ans1_scan", lk.data_ptr(), emit.data_ptr(), states.data_ptr(),
               lanes, steps, lr, int(chunked), stream(lk))


# ---------------------------------------------------------------------------
# kernel 3: per-tile compaction
# ---------------------------------------------------------------------------

def compact_ref(e: torch.Tensor):
    """``_compact``'s contract: e (M, nb, 128) int32 flag << 16 | val, nb a
    power of two <= 128 -> (payload (M, nb, 128) int16: each tile's flagged
    words moved to its front in order, zeros after them; counts (M, nb)
    int32 of flagged words per 128-word block)."""
    m, nb, _ = e.shape
    x = e.reshape(m, nb * 128)
    fl = (x >> 16) != 0
    words = i16(x & 0xFFFF)
    payload, _ = ans_cuda.compact_ref(words, fl.to(torch.uint8))
    counts = fl.view(m, nb, 128).sum(2, dtype=torch.int32)
    return payload.view(m, nb, 128), counts


def compact(e: torch.Tensor):
    if e.device.type == "cpu":
        return compact_ref(e)
    m, nb, _ = e.shape
    if nb < 1 or nb > 128 or nb & (nb - 1):
        raise ValueError("nb must be a power of two <= 128")
    require(e, torch.int32, (None, None, 128))
    payload = torch.empty((m, nb, 128), dtype=torch.int16, device=e.device)
    counts = torch.empty((m, nb), dtype=torch.int32, device=e.device)
    if m:
        with torch.cuda.device(e.device):
            launch("ans1_compact", e.data_ptr(), payload.data_ptr(),
                   counts.data_ptr(), m, nb, stream(e))
    return payload, counts


# ---------------------------------------------------------------------------
# the encode, and the numpy-contract entry points
# ---------------------------------------------------------------------------

def ans1_encode_chunks_tensors(chunks: torch.Tensor, freq: torch.Tensor,
                               cum: torch.Tensor):
    """Lookup, scan and compaction on ``chunks``' device: (payload (N, C)
    int16 in 16 KiB tiles, each tile's words at its front; tile counts
    (N, C // 16384, 128) int32; states (N, 4) int32)."""
    n, c = chunks.shape
    if c % CHUNK:
        raise ValueError("chunk width must be a multiple of 16384")
    lk = lookup1(chunks, pack_tables(freq, cum))
    emit, states = scan_chunks(lk)
    payload, counts = compact(emit.view(n * (c // CHUNK), 128, 128))
    return payload.view(n, c), counts.view(n, c // CHUNK, 128), states


def stitch(payload: np.ndarray, counts: np.ndarray) -> list[np.ndarray]:
    """Each chunk's words: its tiles' populated prefixes, in tile order.
    payload (N, C) u16 in 16 KiB tiles, counts (N, C // 16384, 128)."""
    n, c = payload.shape
    tot = counts.sum(axis=2)
    keep = np.arange(CHUNK)[None, None, :] < tot[:, :, None]
    tiles = payload.reshape(n, c // CHUNK, CHUNK)
    return [tiles[i][keep[i]] for i in range(n)]


def ans1_encode_chunks_pallas(chunks: np.ndarray, freq: np.ndarray,
                              cum: np.ndarray, device):
    """kanzi_tpu.ops.ans_pallas.ans1_encode_chunks_pallas on ``device``:
    (payload u16 (N, C) in 16 KiB tiles, tile counts i32 (N, C // 16384,
    128), states i32 (N, 4))."""
    dev = check_device(device)
    pay, cnt, st = ans1_encode_chunks_tensors(to_device(chunks, dev, np.uint8),
                                              to_device(freq, dev, np.int32),
                                              to_device(cum, dev, np.int32))
    return pay.cpu().numpy().view(np.uint16), cnt.cpu().numpy(), st.cpu().numpy()


def ans1_encode_chunks(chunks: np.ndarray, freq: np.ndarray, cum: np.ndarray,
                       device):
    """kanzi_tpu.ops.ans.ans1_encode_chunks on ``device``: (payload u16
    (N, C) with each chunk's words stitched to its front, n_emit i32 (N,),
    states i32 (N, 4)).  Words past n_emit are 0."""
    pay, cnt, st = ans1_encode_chunks_pallas(chunks, freq, cum, device)
    out = np.zeros_like(pay)
    words = stitch(pay, cnt)
    for i, w in enumerate(words):
        out[i, :w.size] = w
    return out, np.array([w.size for w in words], dtype=np.int32), st
