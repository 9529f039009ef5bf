"""Order-0 rANS (ANS0) kernels on the H100, beside their plain PyTorch versions.

Counterpart of kanzi_tpu/ops/ans_pallas.py (order-0 parts) and
kanzi_tpu/ops/ans.py.  Four hand-written CUDA kernels
(kanzi_tpu_torch/csrc/ans0.cu) cover the TPU's five Pallas kernels and one
XLA op on this path:

  hist_norm     _hist16 + _norm_kernel      byte histogram + exact normalisation
  encode_scan   _scan_sub_fused_kernel      the 4-state rANS encode scan
  compact       _compact2_kernel            stable partition of the emitted words
  decode        _decode_kernel + _lookup_kernel   rANS decode straight to bytes

Each wrapper runs its plain version (``*_ref``, same signature) when its
tensors lie on the CPU, and launches its kernel when they lie on a CUDA
device, or raises: there is no fallback.  Each launch adds one to the
wrapper's count in ``launches`` (ops/launch.py, shared by every kernel
of the port).

The port's public op functions take and return the same numpy layouts and
dtypes as their kanzi_tpu counterparts (chunks (N, C) u8, freq/cum (N, 256),
payload (N, C) u16 words, n_emit (N,), states (N, 4)), so the tests feed
both the same numpy arrays and compare the outputs directly.

Inside torch, 16-bit words travel as int16 bit patterns (torch.uint16 has
few ops).  Encoder states are int32 (always below 2^31); decoder input
states are the stream's 32-bit unsigned values, int64 in torch and uint32
in the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import check_device
# launches, reset_launches and _count are re-exported for the callers that
# read or reset the counts through this module
from .launch import (count as _count, i16 as _i16, launch as _launch,  # noqa: F401
                     launches, register, require as _require, reset_launches,
                     stream as _stream, to_device)

ANS_TOP = 1 << 15
LOG_RANGE = 12
SCALE = 1 << LOG_RANGE
CHUNK = 16384
TOTAL_SHIFT = 14                 # full chunks: histogram rows sum to 2^14

KERNELS = ("ans0_hist_norm", "ans0_encode_scan", "ans0_compact", "ans0_decode")
register(KERNELS)


def _i32(v: torch.Tensor) -> torch.Tensor:
    """Values in [0, 2^32) as int32 bit patterns."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


# ---------------------------------------------------------------------------
# kernel 1: histogram + normalisation
# ---------------------------------------------------------------------------

def _normalize_ref(hist: torch.Tensor) -> torch.Tensor:
    """kanzi_tpu.ops.ans_pallas._normalize_freqs_jax for rows summing to
    2^14, in int64: half-up scaling, first max, five bounded rounds."""
    total = 1 << TOTAL_SHIFT
    nz = hist > 0
    sf = hist * SCALE
    scaled = torch.where(sf <= total, 1, (sf + (total >> 1)) >> TOTAL_SHIFT)
    scaled = torch.where(nz, scaled, 0)
    idx_max = torch.argmax(scaled, dim=1, keepdim=True)          # first max
    oh_max = torch.arange(256, device=hist.device) == idx_max
    sum_scaled = scaled.sum(1)
    single = nz.sum(1) == 1
    f = torch.where(single[:, None], torch.where(nz, SCALE, 0), scaled)
    active = ~single & (sum_scaled != SCALE)
    delta = sum_scaled - SCALE
    err_thr = scaled.gather(1, idx_max)[:, 0] >> 4
    small = active & (delta.abs() <= err_thr)
    f = f - torch.where(small[:, None] & oh_max, delta[:, None], 0)
    big = active & ~small
    neg = big & (delta < 0)
    pos = big & (delta > 0)
    f = f + torch.where(neg[:, None] & oh_max, err_thr[:, None], 0)
    f = f - torch.where(pos[:, None] & oh_max, err_thr[:, None], 0)
    d = torch.where(neg, delta + err_thr, torch.where(pos, delta - err_thr, 0))
    inc = torch.where(d > 0, -1, 1)
    d = d.abs()
    live = big
    for _ in range(5):      # bounded error-spreading rounds, symbol order
        elig = nz & (f > 2) & live[:, None]
        adj = elig & (torch.cumsum(elig.long(), 1) <= d[:, None])
        nadj = adj.sum(1)
        f = f + adj.long() * inc[:, None]
        d = d - torch.minimum(nadj, d)
        live = live & (d > 0) & (nadj > 0)
    fmax = f.gather(1, idx_max)[:, 0]
    return torch.where(big[:, None] & oh_max,
                       torch.clamp(fmax - d, min=1)[:, None], f)


def hist_norm_ref(chunks: torch.Tensor) -> torch.Tensor:
    """chunks (N, 16384) uint8 -> normalised freq (N, 256) int32 (sum 4096)."""
    hist = torch.zeros((chunks.shape[0], 256), dtype=torch.int64,
                       device=chunks.device)
    hist.scatter_add_(1, chunks.long(), torch.ones_like(chunks, dtype=torch.int64))
    return _normalize_ref(hist).to(torch.int32)


def hist_norm(chunks: torch.Tensor) -> torch.Tensor:
    if chunks.device.type == "cpu":
        return hist_norm_ref(chunks)
    _require(chunks, torch.uint8, (None, CHUNK))
    n = chunks.shape[0]
    freq = torch.empty((n, 256), dtype=torch.int32, device=chunks.device)
    if n:
        with torch.cuda.device(chunks.device):
            _launch("ans0_hist_norm", chunks.data_ptr(), freq.data_ptr(), n,
                    _stream(chunks))
    return freq


def pack_tables(freq: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """The encode scan's tables: min(freq, 4095) | cum << 12, int32."""
    return (torch.clamp(freq, max=SCALE - 1) | (cum << LOG_RANGE)).to(torch.int32)


def make_tables(freq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """freq (N, 256) -> (cum (N, 256) int32 exclusive prefix sums, packed
    encode tables)."""
    f = freq.to(torch.int32)
    cum = torch.cumsum(f, dim=1, dtype=torch.int32) - f
    return cum, pack_tables(f, cum)


# ---------------------------------------------------------------------------
# kernel 2: encode scan
# ---------------------------------------------------------------------------

def encode_scan_ref(chunks: torch.Tensor, tables: torch.Tensor):
    """chunks (N, C) uint8 (C % 4 == 0), tables (N, 256) int32 packed
    f | cum << 12 -> (words (N, C) int16, flags (N, C) uint8, states (N, 4)
    int32).  Substep t encodes byte C-1-t into state t & 3; the word and
    flag of an emission sit at the byte's position (wire order)."""
    n, c = chunks.shape
    steps = c // 4
    lk = tables.long().gather(1, chunks.long())
    # step q, lane u <- byte 4 * (steps-1-q) + 3 - u
    lk = lk.view(n, steps, 4).flip(1).flip(2)
    f_all = (lk & (SCALE - 1)).permute(1, 0, 2)
    c_all = (lk >> LOG_RANGE).permute(1, 0, 2)
    st = torch.full((n, 4), ANS_TOP, dtype=torch.int64, device=chunks.device)
    em_all = torch.empty((steps, n, 4), dtype=torch.bool, device=chunks.device)
    val_all = torch.empty((steps, n, 4), dtype=torch.int64, device=chunks.device)
    for q in range(steps):
        f = f_all[q]
        em = (st >> (31 - LOG_RANGE)) >= f
        em_all[q] = em
        val_all[q] = st & 0xFFFF
        st = torch.where(em, st >> 16, st)
        st = ((st // f) << LOG_RANGE) + st % f + c_all[q]
    em = em_all.permute(1, 0, 2).flip(1).flip(2).reshape(n, c)
    val = val_all.permute(1, 0, 2).flip(1).flip(2).reshape(n, c)
    words = _i16(torch.where(em, val, 0))
    return words, em.to(torch.uint8), st.to(torch.int32)


def encode_scan(chunks: torch.Tensor, tables: torch.Tensor):
    if chunks.device.type == "cpu":
        return encode_scan_ref(chunks, tables)
    n, c = chunks.shape
    if c % 4:
        raise ValueError("chunk width must be a multiple of 4")
    _require(chunks, torch.uint8, (None, None))
    _require(tables, torch.int32, (n, 256))
    dev = chunks.device
    words = torch.empty((n, c), dtype=torch.int16, device=dev)
    flags = torch.empty((n, c), dtype=torch.uint8, device=dev)
    states = torch.empty((n, 4), dtype=torch.int32, device=dev)
    if n:
        with torch.cuda.device(dev):
            _launch("ans0_encode_scan", chunks.data_ptr(), tables.data_ptr(),
                    words.data_ptr(), flags.data_ptr(), states.data_ptr(), n, c,
                    _stream(chunks))
    return words, flags, states


# ---------------------------------------------------------------------------
# kernel 3: compaction
# ---------------------------------------------------------------------------

def compact_ref(words: torch.Tensor, flags: torch.Tensor):
    """words (N, C) int16, flags (N, C) uint8 -> (payload (N, C) int16 with
    the flagged words moved to the front in order and zeros after them,
    n_emit (N,) int32)."""
    n, c = words.shape
    fl = flags != 0
    idx = torch.where(fl, torch.cumsum(fl.long(), 1) - 1, c)
    out = torch.zeros((n, c + 1), dtype=torch.int16, device=words.device)
    out.scatter_(1, idx, words)     # column c collects the unflagged words
    return out[:, :c].contiguous(), fl.sum(1).to(torch.int32)


def compact(words: torch.Tensor, flags: torch.Tensor):
    if words.device.type == "cpu":
        return compact_ref(words, flags)
    n, c = words.shape
    _require(words, torch.int16, (None, None))
    _require(flags, torch.uint8, (n, c))
    payload = torch.empty((n, c), dtype=torch.int16, device=words.device)
    n_emit = torch.empty((n,), dtype=torch.int32, device=words.device)
    if n:
        with torch.cuda.device(words.device):
            _launch("ans0_compact", words.data_ptr(), flags.data_ptr(),
                    payload.data_ptr(), n_emit.data_ptr(), n, c, _stream(words))
    return payload, n_emit


# ---------------------------------------------------------------------------
# kernel 4: decode
# ---------------------------------------------------------------------------

def decode_ref(payload: torch.Tensor, lengths: torch.Tensor,
               states: torch.Tensor, freq: torch.Tensor, cum: torch.Tensor):
    """Decode full 16 KiB chunks.  payload (N, P) uint8 renorm byte pairs,
    lengths (N,) the real payload bytes of each row (a read at or past it
    gives 0), states (N, 4) the stream's 32-bit unsigned states, freq/cum
    (N, 256).  Slot s decodes to the first symbol whose bound cum + freq
    (running max, uncapped) exceeds s, 255 past the last bound.  Returns
    (out (N, 16384) uint8, consumed (N,) int32 bytes)."""
    n, p = payload.shape
    dev = payload.device
    freq = freq.long() & 0x1FFF      # 13-bit fields, as in the kernel's table
    cum = cum.long() & 0x1FFF        # (valid tables hold at most 4096)
    bounds = torch.cummax(cum + freq, dim=1).values.contiguous()
    slots = torch.arange(SCALE, device=dev).expand(n, SCALE).contiguous()
    lut = torch.clamp(torch.searchsorted(bounds, slots, right=True), max=255)
    tab = (torch.clamp(freq, max=SCALE - 1) << 13) | cum
    # big-endian words at every even byte offset; bytes at or past the row's
    # length read as 0, and so does the spare last word
    nw = (p + 1) // 2 + 1
    pay = torch.zeros((n, 2 * nw), dtype=torch.int64, device=dev)
    pay[:, :p] = payload
    pay = torch.where(torch.arange(2 * nw, device=dev) < lengths.long()[:, None],
                      pay, 0)
    words = (pay[:, 0::2] << 8) | pay[:, 1::2]
    st = states.long() & 0xFFFFFFFF
    ptr = torch.zeros((n, 1), dtype=torch.int64, device=dev)   # in words
    syms = torch.empty((CHUNK // 4, n, 4), dtype=torch.int64, device=dev)
    for t in range(CHUNK // 4):
        slot = st & (SCALE - 1)
        cur = lut.gather(1, slot)
        syms[t] = cur
        e = tab.gather(1, cur)
        st = ((e >> 13) * (st >> LOG_RANGE) + slot - (e & 0x1FFF)) & 0xFFFFFFFF
        need = st < ANS_TOP
        cs = torch.cumsum(need.long(), 1)
        tot = cs[:, 3:]
        # lane 3 consumes first: lane j reads after the needing lanes above it
        rd = words.gather(1, torch.clamp(ptr + tot - cs, max=nw - 1))
        st = torch.where(need, (st << 16) | rd, st)
        ptr = ptr + tot
    out = syms.permute(1, 0, 2).flip(2).reshape(n, CHUNK).to(torch.uint8)
    return out, (2 * ptr[:, 0]).to(torch.int32)


def decode_tables_ref(freq: torch.Tensor, cum: torch.Tensor):
    """The decode kernel's per-chunk tables, indexed by the slot alone:
    (sym (N, 4096) uint8, f (N, 4096) int64, d (N, 4096) int64), where slot
    s belongs to symbol sym, f = min(freq[sym] & 0x1FFF, 4095) and
    d = (s - (cum[sym] & 0x1FFF)) mod 2^32, so that a step is
    st' = f (st >> 12) + d mod 2^32 (the kernel keeps sym in the top byte
    of f's word).  Symbol k takes the slots from the running maximum of the
    bounds cum + freq before it up to its own (none if its bound is not
    above that maximum), and the slots past the last bound go to 255:
    decode_ref's searchsorted rule, built here range by range."""
    n = freq.shape[0]
    dev = freq.device
    fr = freq.long() & 0x1FFF
    cm = cum.long() & 0x1FFF
    bounds = torch.clamp(torch.cummax(cm + fr, dim=1).values, max=SCALE)
    widths = torch.diff(bounds, dim=1, prepend=torch.zeros((n, 1), dtype=torch.int64,
                                                             device=dev))
    syms = torch.arange(256, device=dev)
    sym = torch.full((n, SCALE), 255, dtype=torch.int64, device=dev)
    for r in range(n):
        run = torch.repeat_interleave(syms, widths[r])
        sym[r, :run.numel()] = run
    f = torch.clamp(fr, max=SCALE - 1).gather(1, sym)
    d = (torch.arange(SCALE, device=dev) - cm.gather(1, sym)) & 0xFFFFFFFF
    return sym.to(torch.uint8), f, d


def decode(payload: torch.Tensor, lengths: torch.Tensor, states: torch.Tensor,
           freq: torch.Tensor, cum: torch.Tensor):
    if payload.device.type == "cpu":
        return decode_ref(payload, lengths, states, freq, cum)
    n = payload.shape[0]
    _require(payload, torch.uint8, (n, None))
    p = payload.shape[1]
    if p % 16 or p == 0:
        # the kernel stages whole 16-byte lines of a row; bytes past the
        # payload's width read as 0 either way
        payload = torch.nn.functional.pad(payload, (0, 16 - p % 16))
    st32 = _i32(states).contiguous()
    for t, dt, shape in ((lengths, torch.int32, (n,)), (st32, torch.int32, (n, 4)),
                         (freq, torch.int32, (n, 256)), (cum, torch.int32, (n, 256))):
        _require(t, dt, shape)
    dev = payload.device
    out = torch.empty((n, CHUNK), dtype=torch.uint8, device=dev)
    consumed = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        with torch.cuda.device(dev):
            _launch("ans0_decode", payload.data_ptr(), payload.shape[1],
                    lengths.data_ptr(), st32.data_ptr(), freq.data_ptr(),
                    cum.data_ptr(), out.data_ptr(), consumed.data_ptr(), n,
                    _stream(payload))
    return out, consumed


# ---------------------------------------------------------------------------
# numpy-contract entry points (the kanzi_tpu signatures plus a device)
# ---------------------------------------------------------------------------

def encode_chunks_tensors(chunks: torch.Tensor):
    """Statistics + scan + compaction on ``chunks``' device: (freq, payload,
    n_emit, states) tensors."""
    freq = hist_norm(chunks)
    _, tables = make_tables(freq)
    words, flags, states = encode_scan(chunks, tables)
    payload, n_emit = compact(words, flags)
    return freq, payload, n_emit, states


def ans0_encode_chunks(chunks: np.ndarray, freq: np.ndarray, cum: np.ndarray,
                       device):
    """kanzi_tpu.ops.ans.ans0_encode_chunks on ``device``: (payload u16
    (N, C), n_emit i32 (N,), states i32 (N, 4)).  Words past n_emit are 0."""
    dev = check_device(device)
    x = to_device(chunks, dev, np.uint8)
    f = to_device(freq, dev, np.int32)
    c = to_device(cum, dev, np.int32)
    words, flags, states = encode_scan(x, pack_tables(f, c))
    payload, n_emit = compact(words, flags)
    return (payload.cpu().numpy().view(np.uint16), n_emit.cpu().numpy(),
            states.cpu().numpy())


def ans0_encode_device(chunks: np.ndarray, device):
    """kanzi_tpu.ops.ans_pallas.ans0_encode_device on ``device``: (freq i32
    (N, 256), payload u16 (N, C), n_emit i32 (N,), states i32 (N, 4))."""
    x = to_device(chunks, check_device(device), np.uint8)
    freq, payload, n_emit, states = encode_chunks_tensors(x)
    return (freq.cpu().numpy(), payload.cpu().numpy().view(np.uint16),
            n_emit.cpu().numpy(), states.cpu().numpy())


def ans0_decode_chunks(payload: np.ndarray, states: np.ndarray,
                       freq: np.ndarray, cum: np.ndarray, device,
                       lengths: np.ndarray | None = None):
    """kanzi_tpu.ops.ans.ans0_decode_chunks on ``device`` for full 16 KiB
    chunks: (out u8 (N, 16384), consumed i32 (N,)).  ``lengths`` bounds each
    row's reads (default: the whole zero-padded row)."""
    dev = check_device(device)
    n, p = payload.shape
    if lengths is None:
        lengths = np.full(n, p, dtype=np.int32)
    out, consumed = decode(to_device(payload, dev, np.uint8),
                           to_device(lengths, dev, np.int32),
                           to_device(states, dev, np.int64),
                           to_device(freq, dev, np.int32),
                           to_device(cum, dev, np.int32))
    return out.cpu().numpy(), consumed.cpu().numpy()
