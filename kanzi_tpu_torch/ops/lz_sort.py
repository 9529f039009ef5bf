"""LZX encode on a torch device: the batched content-sort match finder.

Counterpart of kanzi_tpu/ops/lz_sort.py (the sort engine of level 1's LZX
stage), in PyTorch on an explicit device, with its one TPU kernel, the word
builder (K9), as the CUDA kernel of ops/lz_words_cuda.py.  The stages, the
constants, the bucketing and the dispatch grouping are the reference's:

  1. blocks up to MAX_FLAT stack whole on a batch axis (the flat engine);
     larger blocks split into overlapping 256 KiB rows (192 KiB stride,
     64 KiB context window)
  2. two tier sorts order positions by exact 8-byte window content: tier A
     by the 8 bytes (w0, w1) over the whole row, tier B (stable, one key:
     w0) per SEG_B segment, so its radius probes find the most recent
     same-4-byte predecessors.  Radius-1..RADIUS probes read sorted
     neighbours; the first differing carried word bounds the exact match
     length, capped at MAX_MLEN = 16
  3. the probe results return to position order
  4. exact one-step-lazy greedy parse with no serial walk: windowed
     entry-state maps composed by a prefix scan (see _parse_stage)
  5. an order-keeping compaction of the chosen tokens for the host fetch
  6. wire emission: native/lz.cpp kz_lzx_emit_tokens (fuse+extend+emit),
     else ops/lz_emit.py in numpy

How each XLA step of the reference is translated, so that the tokens are
the same bit for bit:
  - tier A's ``lax.sort((w0^S, w1^S, ...), num_keys=2, is_stable=True)`` is
    a stable torch.sort of the int64 key ``(w0^S) << 32 | (w1 as u32)``,
    with the payload gathered by the returned permutation; tier B's
    one-key stable sort is a stable torch.sort of ``w0^S``;
  - the unsort sort (its key is a permutation) is a scatter to the sorted
    indices; the compaction sort is a ``nonzero`` of the kept groups;
  - the parse's two ``lax.scan`` walks are loops and its
    ``lax.associative_scan`` of composed integer maps is a Hillis-Steele
    scan with torch.gather (composition is exact and associative);
  - unsigned word compares are done in int64 masked to 32 bits.
Any other handling of ties gives valid LZX that differs from the
reference's bytes.  The decode is the host's (transforms/lz.py).
"""

from __future__ import annotations

import concurrent.futures as cf

import numpy as np
import torch

from ..utils.device import check_device
from .lz_emit import MAX_DISTANCE1, MIN_BLOCK_LENGTH, _emit
from .lz_words_cuda import lz_words

ROW = 1 << 18                 # 256 KiB rows
STRIDE = 3 * (1 << 16)        # 192 KiB of token positions per row
OV = ROW - STRIDE             # 64 KiB context window (max match distance)
MAX_MLEN = 16                 # device match-length cap: 4 content words
EDGE = 16                     # no claims this close to a row end (padding)
TIERB_WORDS = 2               # content words carried by the tier-B sort
RADIUS = 3                    # sorted-neighbourhood probe radius (both tiers)
_SIGN = -0x80000000           # two's-complement sign flip: u32 sort order
SEG_B = 1 << 18               # tier-B scope: 256 Ki position segments
MAX_FLAT = 1 << 24            # blocks beyond 16 Mi use the windowed rows
GROUP_ROWS = 24               # rows per windowed dispatch
FLAT_GROUP = 8                # blocks per flat dispatch
MAX_DISPATCH = 1 << 26        # positions per dispatch: pos << mlen_bits < 2^31
PARSE_W = 64                  # parse window


def _mlen_bits() -> int:
    """Bits for mlen-4 in the packed tokens (MAX_MLEN 8 -> 3, 12/16 -> 4)."""
    return max(3, (MAX_MLEN - 4).bit_length())


def _unpack_tokens(pk: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host unpack of the parse's packed (pos << bits | mlen-4) tokens."""
    bits = _mlen_bits()
    pk = pk.astype(np.int64)
    return pk >> bits, (pk & ((1 << bits) - 1)) + 4


def _rolled(x: torch.Tensor, r: int) -> torch.Tensor:
    """Sorted predecessor at radius r (row-local shift, zero-filled)."""
    return torch.cat([x.new_zeros((x.shape[0], r)), x[:, :-r]], dim=1)


def _probe_sorted(ws_s, sidx, col, mask_fn):
    """Radius-1..RADIUS predecessor probe in the current sort order.
    ``ws_s`` are the sorted content words, ``sidx`` the row position of each
    sorted entry, ``col`` the column index.  A predecessor equal in all
    words shares >= 4*len(ws_s) bytes; the first differing carried word
    bounds the exact match length via its leading equal bytes."""
    cand = torch.zeros_like(sidx)
    mlen = torch.zeros_like(sidx)
    k0 = ws_s[0]
    for r in range(RADIUS, 0, -1):  # nearest radius wins
        eq0 = (k0 == _rolled(k0, r)) & (col >= r)  # guard the prefix
        c = _rolled(sidx, r)
        base = eq0 & mask_fn(sidx, c)
        # exact length from the first differing word, capped 4*len(ws_s)
        acc = None
        for j in range(len(ws_s) - 1, 0, -1):
            x = (ws_s[j] ^ _rolled(ws_s[j], r)).to(torch.int64) & 0xFFFFFFFF
            lj = 4 * j + ((x < (1 << 24)).long() + (x < (1 << 16)).long()
                          + (x < (1 << 8)).long())
            acc = torch.where(x == 0, 4 * (j + 1) if acc is None else acc, lj)
        cand = torch.where(base, c, cand)
        mlen = torch.where(base, acc, mlen)
    return cand, mlen


def _unsort_results(sidx, cand, mlen):
    """Back to position order, (nrows, n): the entry sorted to column i
    belongs to row position sidx[:, i], so a scatter there undoes the sort.
    Returns (dist, mlen), 0 where no match."""
    has = mlen > 0
    dist = torch.empty_like(cand).scatter_(1, sidx, torch.where(has, sidx - cand, 0))
    return dist, torch.empty_like(mlen).scatter_(1, sidx, mlen)


def _probe_tiers(ws, mask_fn, shape):
    """Two-tier sorted-neighbourhood probe shared by the flat and windowed
    engines.  ``ws`` are the position-order content words (int32),
    ``mask_fn(sidx, c)`` the engine's candidate-validity mask (distance
    budget, row edges); it is called at any row split of the (nrows, n)
    shape (tier B probes per segment), and repeats its per-row constants
    to match.  Returns (dist, mlen) per tier in position order."""
    nrows, n = shape
    dev = ws[0].device
    # tier A: content order over the full row, by the exact 8-byte window
    key = (((ws[0] ^ _SIGN).to(torch.int64) << 32)
           | (ws[1].to(torch.int64) & 0xFFFFFFFF))
    _, sidx_a = torch.sort(key, dim=1, stable=True)
    del key
    ws_a = [w.gather(1, sidx_a) for w in ws]
    col = torch.arange(n, device=dev)
    cand_a, ml_a = _probe_sorted(ws_a, sidx_a, col, mask_fn)
    del ws_a
    t_a = _unsort_results(sidx_a, cand_a, ml_a)
    del sidx_a, cand_a, ml_a
    # tier B: position order within equal 4-byte prefixes, per segment
    nseg = max(1, n // SEG_B)
    segn = n // nseg

    def seg(x):
        return x.reshape(nrows * nseg, segn)

    _, perm_b = torch.sort(seg(ws[0] ^ _SIGN), dim=1, stable=True)
    ws_b = [seg(w).gather(1, perm_b) for w in ws[:TIERB_WORDS]]
    offs = (torch.arange(nrows * nseg, device=dev) % nseg * segn)[:, None]
    sidx_b = perm_b + offs                 # row positions
    cand_b, ml_b = _probe_sorted(ws_b, sidx_b, torch.arange(segn, device=dev),
                                 mask_fn)
    t_b = _unsort_results(sidx_b.reshape(nrows, n), cand_b.reshape(nrows, n),
                          ml_b.reshape(nrows, n))
    return t_a, t_b


def _merge_tiers(t_a, t_b):
    """Longer wins, ties prefer the shorter distance; a len-4 match is
    uneconomic at 3-byte distances (token + 3 > the 4 literals)."""
    (dist_a, mlen_a), (dist_b, mlen_b) = t_a, t_b
    better = (mlen_b > mlen_a) | ((mlen_b == mlen_a) & (dist_b < dist_a))
    mlen_p = torch.where(better, mlen_b, mlen_a)
    dist_p = torch.where(better, dist_b, dist_a)
    mlen_p = torch.where((dist_p >= 65536) & (mlen_p <= 4), 0, mlen_p)
    return dist_p, mlen_p


def _per_row(v: torch.Tensor, nrows: int, sidx: torch.Tensor) -> torch.Tensor:
    """Per-row constants (nrows,) repeated to the row split of ``sidx``."""
    return v.repeat_interleave(sidx.shape[0] // nrows)[:, None]


def _match_flat(bufs, src_end, max_dist, mm: int):
    """Whole-block match finding: each batch row is one zero-padded block,
    so candidates reach anywhere earlier in the block, the full 24-bit
    distance budget of the format (LZCodec.java:152-153).  bufs (B, N)
    uint8; src_end (B,) = count-18 per block; max_dist (B,) = 65534 or
    2^24-2 by the reference's block-size rule.  Returns flat position-order
    (mlen, dist) of B*N entries."""
    nb, n = bufs.shape
    ws = lz_words(bufs)

    def mask_fn(sidx, c):
        d = sidx - c
        return ((sidx < _per_row(src_end, nb, sidx)) & (d > 0)
                & (d <= _per_row(max_dist, nb, sidx)))

    t_a, t_b = _probe_tiers(ws, mask_fn, (nb, n))
    del ws
    dist_p, mlen_p = _merge_tiers(t_a, t_b)
    col = torch.arange(n, device=bufs.device)
    mlen2 = torch.minimum(mlen_p, (src_end[:, None] - col).clamp_min(0))
    mlen2 = torch.where(mlen2 >= max(mm, 4), mlen2, 0)
    return mlen2.reshape(-1), dist_p.reshape(-1)


def _match_stage(rows, vend, isfirst, mdrow, mm: int):
    """Two-tier match finding over a batch of independent rows (possibly
    spanning several blocks).  rows (B, ROW) uint8; vend (B,) = number of
    valid token positions in the row's token region (clips match ends at
    the block's src_end); isfirst (B,) bool = the row's left context is
    zero padding (block start), so candidates must not reach into it;
    mdrow (B,) = the owning block's distance budget.  Returns flat
    position-order (mlen, dist) of B*STRIDE entries."""
    nrows = rows.shape[0]
    ws = lz_words(rows)

    def mask_fn(sidx, c):
        d = sidx - c
        return ((sidx <= ROW - EDGE) & (~_per_row(isfirst, nrows, sidx) | (c >= OV))
                & (d > 0) & (d <= _per_row(mdrow, nrows, sidx)))

    t_a, t_b = _probe_tiers(ws, mask_fn, (nrows, ROW))
    del ws
    dist_p, mlen_p = _merge_tiers(t_a, t_b)
    # token region of row g = local [OV, ROW); clip match ends at the row's
    # valid-position budget (block src_end)
    loc = torch.arange(STRIDE, device=rows.device)
    mlen2 = torch.minimum(mlen_p[:, OV:], (vend[:, None] - loc).clamp_min(0))
    mlen2 = torch.where(mlen2 >= max(mm, 4), mlen2, 0)
    return mlen2.reshape(-1), dist_p[:, OV:].reshape(-1)


def _compose_prefix(maps: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix composition of the windows' entry->exit maps:
    out[i][e] = maps[i][...maps[0][e]] (Hillis-Steele, log2(nwin) rounds)."""
    p = maps
    d = 1
    while d < p.shape[0]:
        p = torch.cat([p[:d], p[d:].gather(1, p[:-d])])
        d <<= 1
    return p


def _parse_stage(mlen, dist, mm: int):
    """Exact one-step-lazy greedy cover, fully parallel over windows.

    The greedy walk 'take the match at p, jump to p+len, else advance 1' is
    cut into windows of PARSE_W positions.  A token is <= MAX_MLEN bytes,
    so the walk enters any window at overhang 0..MAX_MLEN: SMAX entry
    states.  Phase A runs the in-window walk for all entry states at once
    (PARSE_W steps over (nwin, SMAX)), giving each window's entry->exit
    map; the maps compose by a prefix scan, giving every window's true
    entry state.  Phase B re-runs the walk once with the known entry,
    marking the kept tokens, which are then compacted in position order.

    Returns (pk, dist, n_tok): the packed tokens (pos << mlen_bits | mlen-4)
    and their distances, n_tok of each in position order, and n_tok."""
    n = mlen.shape[0]
    w = PARSE_W
    smax = MAX_MLEN + 1    # overhang states (entry >= W would skip the window)
    nwin = n // w
    dev = mlen.device
    ok = mlen >= max(mm, 4)
    mnext = torch.cat([mlen[1:], mlen.new_zeros(1)])
    take = ok & ~(mnext > mlen)            # one-step lazy
    take_t = take.reshape(nwin, w).T.contiguous()   # (W, nwin): a column a step
    ml_t = mlen.reshape(nwin, w).T.contiguous()

    # phase A: entry->exit maps for all SMAX states
    p = torch.arange(smax, device=dev).expand(nwin, smax)
    for t in range(w):
        jump = torch.where(take_t[t], t + ml_t[t], t + 1)[:, None]
        p = torch.where(p == t, jump, p)
    maps = p - w                           # (nwin, SMAX) in [0, MAX_MLEN]

    prefix = _compose_prefix(maps)
    entry = torch.cat([prefix.new_zeros(1), prefix[:-1, 0]])  # walk starts at 0

    # phase B: one walk with the true entry state, marking kept tokens
    kept_t = torch.empty((w, nwin), dtype=torch.bool, device=dev)
    for t in range(w):
        at = entry == t
        kept_t[t] = at & take_t[t]
        entry = torch.where(at, torch.where(take_t[t], t + ml_t[t], t + 1), entry)
    kept = kept_t.T.reshape(-1)

    # compaction: tokens are >= 4 positions apart, so each aligned 4-group
    # holds at most one; keep the groups with a token, in order
    bits = _mlen_bits()
    pos = torch.arange(n, device=dev)
    pk_g = torch.where(kept, (pos << bits) | (mlen - 4), -1).reshape(-1, 4).amax(1)
    dist_g = torch.where(kept, dist, 0).reshape(-1, 4).amax(1)
    sel = torch.nonzero(pk_g >= 0).squeeze(1)
    return pk_g[sel], dist_g[sel], int(sel.numel())


def _fetch_tokens(pk, dist):
    """Device tokens to host (pos, len, dist) int64 arrays."""
    p, l_ = _unpack_tokens(pk.cpu().numpy())
    return p, l_, dist.cpu().numpy().astype(np.int64)


def _flat_bucket(n: int) -> int:
    """Padded whole-block length: a few fixed shapes."""
    b = 1 << 18
    while b < n:
        b <<= 1
    return b


def _extend_tokens_host(src: np.ndarray, p: np.ndarray, l: np.ndarray,
                        d: np.ndarray, src_end: int):
    """Byte-exact vectorized host extension of device-capped matches, in
    16-byte rounds.  A token may only extend into the literal gap before
    the next token (never into the next token's coverage)."""
    if p.size == 0:
        return l
    nxt = np.empty_like(p)
    nxt[:-1] = p[1:]
    nxt[-1] = src_end
    room = np.minimum(nxt, src_end) - (p + l)
    grow = l == MAX_MLEN
    while True:
        sel = np.flatnonzero(grow & (room > 0))
        if sel.size == 0:
            break
        step = np.minimum(room[sel], 16).astype(np.int64)
        # ragged compare of src[p+l : p+l+step] vs the match source
        total = int(step.sum())
        tid = np.repeat(np.arange(sel.size), step)
        intra = np.arange(total) - np.repeat(np.cumsum(step) - step, step)
        a = src[(p[sel] + l[sel])[tid] + intra]
        c = src[(p[sel] + l[sel] - d[sel])[tid] + intra]
        eq = a == c
        # per-token leading-equal count
        neq = np.flatnonzero(~eq)
        firsts = np.full(sel.size, -1, np.int64)
        if neq.size:
            tid_neq = tid[neq]
            off_neq = intra[neq]
            order = np.lexsort((off_neq, tid_neq))
            t_sorted = tid_neq[order]
            first_mask = np.empty(t_sorted.size, bool)
            first_mask[0] = True
            first_mask[1:] = t_sorted[1:] != t_sorted[:-1]
            firsts[t_sorted[first_mask]] = off_neq[order][first_mask]
        adv = np.where(firsts >= 0, firsts, step)
        l[sel] += adv
        room[sel] -= adv
        grow[:] = False
        grow[sel] = (firsts < 0) & (step == 16)
    return l


def _block_rows(src: np.ndarray):
    """Host layout of one block: zero-left-padded buffer + overlapped row
    view (free as_strided), per-row valid-token budgets, first-row flag,
    per-row distance budget (the owning block's wire distance mode)."""
    count = src.size
    nb = -(-count // STRIDE)
    buf = np.zeros(OV + nb * STRIDE, dtype=np.uint8)
    buf[OV:OV + count] = src
    rows = np.lib.stride_tricks.as_strided(
        buf, (nb, ROW), (STRIDE, 1), writeable=False)
    src_end = count - 16 - 2
    vend = np.clip(src_end - STRIDE * np.arange(nb), 0, STRIDE)
    isfirst = np.zeros(nb, bool)
    isfirst[0] = True
    mdrow = np.full(nb, _block_max_dist(count), np.int64)
    return rows, vend.astype(np.int64), isfirst, mdrow


def _row_buckets(nb: int):
    """Pad a row count to one of a few fixed shapes (4/12/24)."""
    for b in (4, 12, GROUP_ROWS):
        if nb <= b:
            return b
    return GROUP_ROWS


def _block_max_dist(count: int) -> int:
    """The reference's distance-mode rule (LZCodec.java:152-153)."""
    return MAX_DISTANCE1 if count - 18 < 4 * MAX_DISTANCE1 \
        else (1 << 24) - 2


def _emit_block(src: np.ndarray, mm: int, p, l, d):
    """The LZX section stream of one block from its tokens (native emitter,
    else numpy); None when the block gains nothing."""
    md = _block_max_dist(src.size)
    res = _emit_native(src, mm, p, l, d, md)
    if res is False:  # no native library: numpy path
        l = _extend_tokens_host(src, p, l, d, src.size - 18)
        res = _emit(src, src.size, mm, md, p, l, d)
    return res


def lzx_forward_device_batch(blocks, extra: bool = False,
                             min_match: int = 4, *, device):
    """Batched LZX forward on ``device`` (``cuda``: the lz_words kernel;
    ``cpu``: its plain version).  Blocks up to MAX_FLAT run through the
    whole-block flat engine in FLAT_GROUP-sized dispatches of one bucket;
    larger blocks through the overlapped 256 KiB-row engine (in-row
    distances only).  Returns a list aligned with ``blocks`` (None = skip).
    ``extra`` (LZ vs LZX hash width in the reference) is accepted for
    interface parity; the content sort is exact, so there is no table."""
    dev = check_device(device)
    mm = min_match if min_match > 0 else 4
    blocks = [np.asarray(b, dtype=np.uint8) for b in blocks]
    out = [None] * len(blocks)

    def emit_one(i, p, l, d):
        out[i] = _emit_block(blocks[i], mm, p, l, d)

    flat_live = [i for i, b in enumerate(blocks)
                 if MIN_BLOCK_LENGTH <= b.size <= MAX_FLAT]
    # one group at a time on the device; each block's emission runs on a
    # host thread (the C++ emitter releases the GIL) beside the next group
    with cf.ThreadPoolExecutor(2) as pool:
        futs = []
        # group same-bucket blocks per dispatch; bound positions per
        # dispatch: MAX_DISPATCH => 8 blocks at 4 MiB
        by_bucket: dict[int, list[int]] = {}
        for i in flat_live:
            by_bucket.setdefault(_flat_bucket(blocks[i].size), []).append(i)
        for bucket in sorted(by_bucket):
            idxs = by_bucket[bucket]
            gmax = max(1, min(FLAT_GROUP, MAX_DISPATCH // bucket))
            for g0 in range(0, len(idxs), gmax):
                grp = idxs[g0:g0 + gmax]
                gp = 1 << max(len(grp) - 1, 0).bit_length()  # pad pow2
                bufs = np.zeros((gp, bucket), np.uint8)
                send = np.full(gp, -18, np.int64)   # pad rows: no tokens
                mdist = np.zeros(gp, np.int64)
                for j, i in enumerate(grp):
                    bufs[j, :blocks[i].size] = blocks[i]
                    send[j] = blocks[i].size - 18
                    mdist[j] = _block_max_dist(blocks[i].size)
                pk, dist, k = _parse_stage(*_match_flat(
                    torch.from_numpy(bufs).to(dev), torch.from_numpy(send).to(dev),
                    torch.from_numpy(mdist).to(dev), mm), mm)
                if k == 0:
                    continue
                p, l_, d = _fetch_tokens(pk, dist)
                for j, i in enumerate(grp):
                    lo, hi = np.searchsorted(p, [j * bucket, (j + 1) * bucket])
                    if hi > lo:
                        futs.append(pool.submit(emit_one, i, p[lo:hi] - j * bucket,
                                                l_[lo:hi].copy(), d[lo:hi]))
        for f in futs:
            f.result()

    parts = [(_block_rows(b) if b.size > MAX_FLAT else None) for b in blocks]
    live = [i for i, p in enumerate(parts) if p is not None]
    if not live:
        return out
    rows = np.concatenate([parts[i][0] for i in live])
    vend = np.concatenate([parts[i][1] for i in live])
    isfirst = np.concatenate([parts[i][2] for i in live])
    mdrow = np.concatenate([parts[i][3] for i in live])
    nb = rows.shape[0]

    ps, ls, ds = [], [], []
    for g0 in range(0, nb, GROUP_ROWS):
        g1 = min(g0 + GROUP_ROWS, nb)
        pad = _row_buckets(g1 - g0) - (g1 - g0)
        r = np.concatenate([rows[g0:g1], np.zeros((pad, ROW), np.uint8)])
        v = np.concatenate([vend[g0:g1], np.zeros(pad, np.int64)])
        f = np.concatenate([isfirst[g0:g1], np.ones(pad, bool)])
        m = np.concatenate([mdrow[g0:g1], np.zeros(pad, np.int64)])
        pk, dist, k = _parse_stage(*_match_stage(
            *(torch.from_numpy(a).to(dev) for a in (r, v, f, m)), mm), mm)
        if k == 0:
            continue
        p, l_, d = _fetch_tokens(pk, dist)
        ps.append(p + g0 * STRIDE)
        ls.append(l_)
        ds.append(d)
    if not ps:
        return out
    p = np.concatenate(ps)
    l = np.concatenate(ls)
    d = np.concatenate(ds)
    base = 0
    for i in live:
        span = parts[i][0].shape[0] * STRIDE
        lo, hi = np.searchsorted(p, [base, base + span])
        if hi > lo:
            out[i] = _emit_block(blocks[i], mm, p[lo:hi] - base, l[lo:hi].copy(),
                                 d[lo:hi])
        base += span
    return out


def _emit_native(src: np.ndarray, mm: int, p, l, d,
                 max_dist: int = MAX_DISTANCE1):
    """C++ fuse+extend+emit (native/lz.cpp kz_lzx_emit_tokens); returns
    False when the library is unavailable, None when the block gains
    nothing, else the stream bytes."""
    from ..utils.native import as_u8p, get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "kz_lzx_emit_tokens"):
        return False
    import ctypes as c
    if not getattr(lib, "_lz_emit_sig", False):
        i32p = c.POINTER(c.c_int32)
        u8p = c.POINTER(c.c_uint8)
        lib.kz_lzx_emit_tokens.restype = c.c_int64
        lib.kz_lzx_emit_tokens.argtypes = [u8p, c.c_int64, i32p, i32p, i32p,
                                           c.c_int64, c.c_int32, c.c_int32,
                                           u8p]
        lib._lz_emit_sig = True
    spad = np.zeros(src.size + 16, np.uint8)
    spad[:src.size] = src
    dst = np.zeros(src.size + 64, np.uint8)
    pi = np.ascontiguousarray(p, np.int32)
    li = np.ascontiguousarray(l, np.int32)
    di = np.ascontiguousarray(d, np.int32)
    # the C++ emitter trusts its tokens; a malformed device batch must fail
    # loudly here, not scribble over memory
    src_end = src.size - 18
    if pi.size and not (
            np.all(np.diff(pi) >= 4) and 0 <= pi[0]
            and pi[-1] < src_end and np.all(li >= mm)
            and np.all(pi + li <= src_end) and np.all(di > 0)
            and np.all(di <= np.minimum(pi, max_dist))):
        raise ValueError("lzx emit: malformed device token batch")

    def _i32p(a):
        return a.ctypes.data_as(c.POINTER(c.c_int32))

    n = lib.kz_lzx_emit_tokens(as_u8p(spad), src.size, _i32p(pi), _i32p(li),
                               _i32p(di), pi.size, mm, max_dist, as_u8p(dst))
    if n < 0:
        return None
    return dst[:n].copy()


def lzx_forward_device_v2(src: np.ndarray, extra: bool = False,
                          min_match: int = 4, *, device) -> np.ndarray | None:
    """LZX forward of one block with the sort engine on ``device``; None
    when the block should be skipped."""
    return lzx_forward_device_batch([src], extra, min_match, device=device)[0]
