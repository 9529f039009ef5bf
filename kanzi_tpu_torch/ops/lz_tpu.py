"""The v1 device LZX engine, in PyTorch on an explicit device.

Counterpart of kanzi_tpu/ops/lz_tpu.py, which kanzi_tpu runs for per-block
LZX under ``KANZI_TPU_DEVICE_LZ=legacy`` (level 3's LZX after MM, and DNA
blocks, whose min match of 6 the writer's batch hint does not cover).  The
reference has no Pallas kernel here: ``_analyze`` is plain XLA, and each of
its steps becomes tensor code that runs alike on ``cpu`` and ``cuda``
tensors:

  - the hash LADDER (window lengths mm, 8, 16, 32, 64, 128; a later, longer
    level overwrites): one stable sort of each level's hashes gives every
    position its nearest previous occurrence; levels above mm keep a
    candidate only when the first and last words of the window agree;
  - the EXTENSION: 31 lockstep rounds of 4-byte XOR compares (matches of at
    most 4 + 4 * 31 = 128 bytes; longer repeats go on as chained tokens that
    the emission merges);
  - the PARSE: one-step lazy selection, the next kept match by a reverse
    cumulative min, and the token chain by pointer doubling;
  - the EMISSION: ops/lz_emit.py's ``_emit``, numpy on the host, the same
    code as the reference's.

The reference's arithmetic is int32 that wraps; here every 32-bit word and
hash is held as its unsigned value in int64 (masked to 32 bits), which is
well defined on both devices and gives the same bits.  The shifts
(``jnp.roll``) wrap the buffer round as the reference's do: when a block
fills its bucket, the windows near its end read its first bytes, and a zero
pad would give other tokens.  Stable sorts on the hashes make the result
unique: only which positions share a hash, and their order, matter, not
how distinct hashes order, so the sort key is the hash shifted into int32's
range.

Each analysis costs one ``.item()`` (the token count), a sync with the
device's current stream, and is counted in ``launch.launches["lz_v1"]`` on
either device (the engine has no kernel of its own).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import check_device
from . import launch
from .lz_emit import MAX_DISTANCE1, MIN_BLOCK_LENGTH, _emit

__all__ = ["lzx_forward_device", "MAX_DISTANCE1", "MAX_DISTANCE2"]

MAX_DISTANCE2 = (1 << 24) - 2
EXT_ROUNDS = 31              # max match = 4 + 4*31 = 128 bytes per token
_MIX = (-1640531527, -2048144789, -1028477379, 668265263, 374761393,
        -1886788817, 2034077037, -1525255075)
_M32 = 0xFFFFFFFF

launch.register(["lz_v1"])


def _pad_bucket(n: int) -> int:
    m = 1 << max(n - 1, 1).bit_length()
    return max(m, 1024)


def _words(src_pad: torch.Tensor) -> torch.Tensor:
    """The big-endian 4-byte window at each position, wrapping round the
    buffer's end, as its unsigned value in int64."""
    b = src_pad.to(torch.int64)
    return ((b << 24) | (torch.roll(b, -1) << 16) | (torch.roll(b, -2) << 8)
            | torch.roll(b, -3))


def _nearest_prev(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """For each position, the nearest earlier position with the same hash,
    or -1: one stable sort, the sorted neighbour is the hit."""
    hs, ids = torch.sort((h - (1 << 31)).to(torch.int32), stable=True)
    same = (hs == torch.roll(hs, 1)) & (idx > 0)
    prev = torch.where(same, torch.roll(ids, 1), -1)
    out = torch.empty_like(prev)
    out[ids] = prev
    return out


def _ladder(w: torch.Tensor, mm: int, max_dist: int) -> torch.Tensor:
    """The match candidate of each position (-1: none) from the hash ladder."""
    n = w.numel()
    idx = torch.arange(n, device=w.device)
    w_ext = torch.cat([w, w.new_zeros(1)])

    def wat(off: int) -> torch.Tensor:
        return torch.roll(w, -off)

    def mix(x: torch.Tensor, j: int) -> torch.Tensor:
        return (x * _MIX[j % 8]) & _M32

    cand = torch.full((n,), -1, dtype=torch.int64, device=w.device)
    for lv in [lv for lv in (mm, 8, 16, 32, 64, 128) if lv >= mm]:
        nw = (lv + 3) // 4
        h = mix(wat(0), 0)
        for j in range(1, nw - 1):
            h = h ^ mix(wat(4 * j), j)
        if nw > 1:
            h = h ^ mix(wat(lv - 4), nw - 1)
        c = _nearest_prev(h, idx)
        okc = (c >= 0) & (idx - c <= max_dist)
        if lv > mm:
            # plausibility probe: the first and last words of the window
            # agree (byte-exact truth comes from the extension)
            c0 = torch.clamp(c, min=0)
            okc &= ((w_ext[torch.clamp(idx, max=n)] == w_ext[torch.clamp(c0, max=n)])
                    & (w_ext[torch.clamp(idx + lv - 4, max=n)]
                       == w_ext[torch.clamp(c0 + lv - 4, max=n)]))
        cand = torch.where(okc, c, cand)
    return cand


def _extend(w: torch.Tensor, cand: torch.Tensor, src_end: int, mm: int):
    """(mlen, dist): each candidate's match length by lockstep 4-byte
    compares (0 below mm or past src_end), and its distance."""
    n = w.numel()
    idx = torch.arange(n, device=w.device)
    ok = (cand >= 0) & (idx < src_end)
    l = torch.zeros(n, dtype=torch.int64, device=w.device)
    active = ok
    cnd = torch.clamp(cand, min=0)
    for _ in range(EXT_ROUNDS):
        x = w[torch.clamp(idx + l, max=n - 1)] ^ w[torch.clamp(cnd + l, max=n - 1)]
        eq = x == 0
        lead = (x < (1 << 24)).long() + (x < (1 << 16)).long() + (x < (1 << 8)).long()
        l = l + torch.where(active, torch.where(eq, 4, lead), 0)
        active = active & eq
    l = torch.minimum(l, torch.clamp(src_end - idx, min=0))
    return torch.where(ok & (l >= mm), l, 0), idx - cand


def _parse(mlen: torch.Tensor, dist: torch.Tensor, mm: int):
    """The one-step lazy greedy parse: (tok_pos, tok_len, tok_dist, n_tok),
    the tokens padded to n // mm + 1, the first n_tok real.  One sync."""
    n = mlen.numel()
    dev = mlen.device
    idx = torch.arange(n, device=dev)
    sentinel = torch.full((1,), n, dtype=torch.int64, device=dev)
    # drop a match when the next position matches longer
    mlen_next = torch.roll(mlen, -1)
    mlen_next[n - 1] = 0
    kept = (mlen > 0) & ~(mlen_next > mlen)
    # the next kept position at or after i (sentinel n): reverse cummin
    nxt = torch.cummin(torch.where(kept, idx, n).flip(0), 0).values.flip(0)
    nxt_ext = torch.cat([nxt, sentinel])
    # from token p jump to the first kept match after its end
    jump = nxt_ext[torch.clamp(idx + torch.clamp(mlen, min=mm), max=n)]
    # token t's position = jump^t(start), by pointer doubling
    tmax = n // mm + 1
    t_iota = torch.arange(tmax, device=dev)
    p = nxt_ext[:1].expand(tmax)
    J = torch.cat([jump, sentinel])
    bit = 1
    while bit < tmax:
        p = torch.where((t_iota & bit) != 0, J[torch.clamp(p, max=n)], p)
        J = J[torch.clamp(J, max=n)]
        bit <<= 1
    valid = p < n
    n_tok = int(valid.sum())
    pc = torch.clamp(p, max=n - 1)
    return torch.where(valid, p, 0), mlen[pc], dist[pc], n_tok


def _analyze(src_pad: torch.Tensor, src_end: int, mm: int, max_dist: int):
    """(tok_pos, tok_len, tok_dist, n_tok) of the padded block ``src_pad``
    (uint8, on its device) for the greedy one-step-lazy parse; the token
    tensors stay on the device."""
    launch.count("lz_v1")
    w = _words(src_pad)
    mlen, dist = _extend(w, _ladder(w, mm, max_dist), src_end, mm)
    return _parse(mlen, dist, mm)


def _fetch(tok_pos, tok_len, tok_dist, k: int) -> np.ndarray:
    """The first ``k`` tokens on the host, one copy: int64 (3, k)."""
    return torch.stack([tok_pos[:k], tok_len[:k], tok_dist[:k]]).cpu().numpy()


def lzx_forward_device(src: np.ndarray, extra: bool = False, min_match: int = 4,
                       *, device) -> np.ndarray | None:
    """LZX forward with match finding and parse selection on ``device``
    (``cuda``: the card, which must be there; ``cpu``: the same tensor code
    on the host).  A valid v7 LZX section stream (decodable by the host
    inverse); None when the block is skipped (under 24 bytes, or no gain),
    as kanzi_tpu's.  ``extra`` (LZ or LZX) does not change the parse."""
    dev = check_device(device)
    src = np.asarray(src, dtype=np.uint8)
    count = src.size
    if count < MIN_BLOCK_LENGTH:
        return None
    src_end = count - 16 - 2
    max_dist = MAX_DISTANCE1 if src_end < 4 * MAX_DISTANCE1 else MAX_DISTANCE2
    mm = min_match if min_match > 0 else 4
    pad = np.zeros(_pad_bucket(count), dtype=np.uint8)
    pad[:count] = src
    *toks, k = _analyze(torch.from_numpy(pad).to(dev), src_end, mm, max_dist)
    pos, ln, dist = _fetch(*toks, k)
    return _emit(src, count, mm, max_dist, pos, ln, dist)
