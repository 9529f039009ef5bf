"""Order-1 rANS (ANS1) encode kernels on the H100, beside their plain PyTorch
versions.

Counterpart of kanzi_tpu/ops/ans_pallas.py (the order-1 parts:
``ans1_encode_chunks_pallas`` and the kernels it runs) and of
kanzi_tpu/ops/ans.py ``ans1_encode_chunks``.  Two hand-written CUDA kernels
(kanzi_tpu_torch/csrc/ans1.cu) replace the TPU's three:

  scan      _lookup1_kernel   packed f | cum << 11 at ctx * 256 + sym, and
            + _scan_kernel    the rANS state scan on it, one lane a chain
  compact   _compact_kernel   per-tile stable partition of the emitted words

Each wrapper runs its plain version when its tensors lie on the CPU
(``scan_chunks``: ``scan_chunks_ref(lookup1_ref(...))``; ``compact``:
``compact_ref``), and launches its kernel when they lie on a CUDA device, or
raises: there is no fallback.  Each launch adds one to the kernel's count in
``launches`` (ops/launch.py).

A 4 MiB order-1 wire chunk is coded by four states, state k walking quarter
k backward (entropy/ans.py ``_lane_layout_order1``); the context of a byte
is the byte before it, 0 at each quarter start.  The forward payload orders
the emissions by step, from the last step back, lanes 3..0 within a step:
word (p, 3 - k) for byte p of quarter k.  The TPU emits into 128-lane
step-major rows (``_scan``'s contract, kept by ``scan_ref`` for the tests);
the kernel runs only the 4N real lanes and stores each word straight at its
forward position, so no relayout pass follows it.

The kernel's step divides by a per-frequency reciprocal, not by ``/``:
``recip_table`` and ``ans_step_recip_ref`` are its arithmetic in PyTorch,
which the tests hold against the exact ``//`` of ``scan_ref``.

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

KERNELS = ("ans1_scan", "ans1_compact")
register(KERNELS)


def pack_tables(freq: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """freq/cum (N, 256, 256) -> the lookup's (N, 65536) int32 table
    min(freq, 2047) | cum << 11 at ctx * 256 + sym; the cap is the
    reference's (a single-symbol context has freq 2048 == scale)."""
    packed = torch.clamp(freq.long(), max=SCALE1 - 1) | (cum.long() << LOG_RANGE1)
    return packed.to(torch.int32).reshape(freq.shape[0], 65536)


# ---------------------------------------------------------------------------
# kernel 1: the order-1 lookup and the rANS state scan, fused
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


def scan_chunks(chunks: torch.Tensor, packed: torch.Tensor, lr: int = LOG_RANGE1):
    """The main path's lookup and scan: chunks (N, C) uint8, packed
    (N, 65536) int32 (``pack_tables``, f | cum << lr) -> (emit (N, C) int32
    in forward wire order, states (N, 4) int32), as
    ``scan_chunks_ref(lookup1_ref(chunks, packed), lr)``."""
    if chunks.device.type == "cpu":
        return scan_chunks_ref(lookup1_ref(chunks, packed), lr)
    n, c = chunks.shape
    if c % 256:
        raise ValueError("chunk width must be a multiple of 256")
    if not 8 <= lr <= 11:   # the kernel's shared tables fit the default 48 KiB up to 11
        raise ValueError("log range must lie in [8, 11]")
    require(chunks, torch.uint8, (None, None))
    require(packed, torch.int32, (n, 65536))
    emit = torch.empty((n, c), dtype=torch.int32, device=chunks.device)
    states = torch.empty((n, 4), dtype=torch.int32, device=chunks.device)
    if n and c:
        with torch.cuda.device(chunks.device):
            launch("ans1_scan", chunks.data_ptr(), packed.data_ptr(), emit.data_ptr(),
                   states.data_ptr(), n, c, lr, stream(chunks))
    return emit, states


def recip_table(lr: int):
    """The kernel's reciprocals, (rcp, shift) int64 (2^lr,) indexed by f:
    for f >= 1, shift = ceil(log2 f) and rcp = ceil(2^(31 + shift) / f), in
    [2^31, 2^32), so that umulhi(2x, rcp) >> shift == x // f for every
    x < 2^31, f = 1 included (rcp 2^31, shift 0).  This is the
    Granlund-Montgomery form of F. Giesen's rans_byte.h, umulhi(x, rcp) >>
    (shift - 1), with the dividend doubled instead of the shift cut by one,
    which leaves f = 1 no case of its own.  Entry 0 is unused (0, 0)."""
    f = torch.arange(1 << lr, dtype=torch.int64)
    shift = torch.tensor([max(v - 1, 0).bit_length() for v in range(1 << lr)])
    rcp = torch.zeros_like(f)
    rcp[1:] = ((torch.ones_like(f[1:]) << (31 + shift[1:])) + f[1:] - 1) // f[1:]
    return rcp, shift


def umulhi_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The high 32 bits of a * b for a, b in [0, 2^32) held in int64, in
    16-bit halves of b so that no product passes 2^48."""
    return (a * (b >> 16) + ((a * (b & 0xFFFF)) >> 16)) >> 16


def ans_step_recip_ref(st2: torch.Tensor, e: torch.Tensor, lr: int, rcp: torch.Tensor,
                       shift: torch.Tensor):
    """One step of the kernel's chain on int64 tensors, on the doubled state
    st2 = 2 st (st < 2^31, so st2 fits 32 bits and is the reciprocal's
    dividend as it is): entry e = f | cm << lr -> (word flag << 16 | val, 0
    where nothing was emitted; the next doubled state).  With h = umulhi(st2,
    rcp), h >> shift is st // f and h >> (shift + 16) is (st >> 16) // f,
    the quotient of the renormalised state when st emits; with x that state
    and q = x // f, (q << lr) + (x - q * f) + cm == x + cm + q * (2^lr - f),
    doubled throughout."""
    f = e & ((1 << lr) - 1)
    em = st2 >= f << (32 - lr)
    word = torch.where(em, ((st2 >> 1) & 0xFFFF) | (1 << 16), 0)
    q = umulhi_ref(st2, rcp[f]) >> torch.where(em, shift[f] + 16, shift[f])
    x2 = torch.where(em, (st2 >> 17) << 1, st2)
    return word, q * (((1 << lr) - f) << 1) + x2 + ((e >> lr) << 1)


# ---------------------------------------------------------------------------
# kernel 2: per-tile compaction
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
    """Lookup and scan, then compaction, on ``chunks``' device: (payload (N, C)
    int16 in 16 KiB tiles, each tile's words at its front; tile counts
    (N, C // 16384, 128) int32; states (N, 4) int32)."""
    n, c = chunks.shape
    if c % CHUNK:
        raise ValueError("chunk width must be a multiple of 16384")
    emit, states = scan_chunks(chunks, pack_tables(freq, cum))
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
