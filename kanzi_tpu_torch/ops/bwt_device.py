"""Suffix array by prefix doubling over sorts, on a torch device.

Counterpart of kanzi_tpu/ops/bwt_tpu.py (the suffix array that level 5's BWT
takes under ``KANZI_TPU_DEVICE_BWT=1``), in PyTorch on an explicit device.
The reference has no Pallas kernel here: its rounds are XLA sorts inside a
``jax.lax.while_loop`` over a buffer padded to a shape bucket of up to
1.5 x the block.  The port keeps the contract (the unique SA, so the host's
BWT bit for bit) and sorts over the block's exact length:

  - a call up to ``SEED8_MAX`` positions, where the bytes are few, takes
    kanzi_tpu's rounds: a seed of each suffix's first eight bytes, then
    (rank, rank at i + k) pairs sorted by ``torch.sort``, whose int64
    index is the new SA (``_doubling_sorted``);
  - a larger call makes every key of a round unique, so that one sort of
    int64 keys with no index array is the whole round.  Its seed: key
    ``pack_key(w, low)`` of each position ``i``, where ``w`` holds the
    next four bytes (0 past the end) and ``low`` is ``i + 3``, or ``n - 1
    - i`` at the last three positions, whose suffixes are shorter than
    four bytes: they sort below every longer suffix that shares ``w`` (no
    pad positions are needed), and each gets a rank of its own;
  - its rounds, at k = 4, 8, 16, ...: key ``pack_key(rank[i], low)`` with
    ``low = k + isa[i + k]`` (``isa`` the previous round's inverse SA, so
    ``low`` orders like ``rank[i + k]`` and is unique) or ``i - (n - k)``
    past the end, below every real one;
  - the sort is ``torch.unique`` of the keys, which are distinct; from the
    sorted keys the new SA is decoded (``i = low + n - k`` or ``sa[low - k]
    - k``), the dense ranks are the cumsum of the (rank, rank at i + k)
    changes, sent back to their positions by a scatter; it stops when the
    ranks are all distinct (one ``.item()`` a round, a sync with the
    device's current stream).

Key order: ``pack_key`` is ``(hi - 2^31) << 32 | lo``, whose signed order
is the order of the pairs for every ``hi`` and ``lo`` in [0, 2^32).  The
BWT takes at most 2^30 bytes (transforms/bwt.py), so ranks are at most
2^30, ``low`` below ``n + k <= 2^31`` and the seed's ``w`` below 2^32:
every word stays in [0, 2^32).

Footprint: a round holds ``rank``, ``sa`` (int32) and the keys (int64),
and the sort adds its sorted copy and the radix sort's alternate buffer;
every other temporary is made in slices of ``SLICE`` positions.
``sa_bytes`` reckons the bytes a call takes from the card at its peak:
what the caching allocator reserves, which runs above what is allocated
because blocks of different sizes split each other's segments.
``suffix_array_device`` admits a call by those reckoned bytes against a
``ByteBudget`` (the card's, unless the caller names one): a call waits
until it fits beside the calls already admitted, within ``CARD_SHARE`` of
the card and within the memory the card has free at that moment (so the
stream's other buffers and other processes on the card count too), and a
call larger than the whole budget raises ``SuffixArrayTooLarge`` before
it allocates anything.  Nothing falls back to the host's SA-IS.  Every run
of ``prefix_doubling`` is counted in ``launch.launches["suffix_array"]``,
on either device (the SA has no kernel of its own).
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from ..utils.device import check_device
from . import launch

__all__ = ["suffix_array_device", "prefix_doubling", "check_suffix_array",
           "sa_bytes", "ByteBudget", "SuffixArrayTooLarge", "admitted"]

_BIAS = 1 << 31               # the high word's sign flip: unsigned order
_LOW = (1 << 32) - 1
SEED_BYTES = 4                # bytes of the seed's window, 8 bits each
SLICE = 1 << 25               # positions a slice of the temporaries
# calls up to this length seed with eight bytes and sort (rank, rank at
# i + k) pairs with torch.sort and its index (_doubling_sorted: a round
# fewer, fewer passes a round), at some 60 B a position allocated, within
# what sa_bytes reckons there (104 a position and 64 MiB)
SEED8_MAX = SLICE
# the bytes a call is reckoned to take from the card at its peak, the text
# and the returned SA included: BYTES_PER_POSITION a position and
# SLICE_BYTES a position of the first slice, plus FIXED_BYTES for the
# sort's own scratch.  Allocated at the peak: rank and sa (4 + 4), the keys
# (8), their sorted copy (8) and the radix sort's alternate buffer (8), 34
# B a position at 2^30; the allocator reserves some 30% more (blocks of
# different sizes split each other's segments), and the slice temporaries
# set the peak below ~2^27 positions.  Checked on the card by chip_smoke.py
# phase 16 part e: every call's reserved peak is at most sa_bytes(n)
BYTES_PER_POSITION = 44
SLICE_BYTES = 60
FIXED_BYTES = 64 << 20
# the share of the card that the reckoned calls may hold at once; the rest
# is left to the stream's other device buffers
CARD_SHARE = 0.875
POLL_S = 0.05                 # how often a waiting call reads the card's room
PATIENCE_S = 120.0            # how long a call alone waits for the card's room

launch.register(["suffix_array"])


def _bucket(n: int) -> int:
    """kanzi_tpu's shape bucket: a power of two or 1.5x a power of two
    (waste <= 25%).  The multi-GPU engine pads its rows to it, as
    kanzi_tpu's mesh does; one call sorts over its block's exact length."""
    p = 1 << max(n - 1, 1).bit_length()
    if n <= (p >> 2) * 3:
        return (p >> 2) * 3
    return p


def pack_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 whose signed order is the order of the pairs (hi, lo), for
    int64 ``hi`` and ``lo`` in [0, 2^32)."""
    return ((hi - _BIAS) << 32) | lo


def sa_bytes(n: int) -> int:
    """The bytes one call on ``n`` positions is reckoned to take from the
    card at its peak."""
    return BYTES_PER_POSITION * n + SLICE_BYTES * min(n, SLICE) + FIXED_BYTES


class SuffixArrayTooLarge(RuntimeError):
    """A suffix array whose reckoned bytes exceed its whole budget, or the
    room the card kept for it."""

    def __init__(self, n: int, reckoned: int, capacity: int,
                 where: str = "its budget") -> None:
        super().__init__(
            f"device suffix array of n = {n} (npad = {n}: the exact length) is "
            f"reckoned at {reckoned} B, over {where} of {capacity} B on the "
            f"device; use a smaller block or a host stream")
        self.n, self.reckoned, self.capacity = n, reckoned, capacity


class ByteBudget:
    """Bytes that admitted calls may hold at once.  ``admit(n)`` waits until
    ``sa_bytes(n)`` fits beside the calls already admitted, both within
    ``capacity`` and, where ``room`` is given (a function: the bytes the
    device can hand out now), within ``room()``.  A call that never fits
    ``capacity`` raises ``SuffixArrayTooLarge`` at once; one that waits
    alone (no admitted call to wait for) longer than ``patience`` seconds
    for ``room()`` raises it then."""

    def __init__(self, capacity: int, room=None, patience: float = PATIENCE_S) -> None:
        self.capacity = int(capacity)
        self.room = room
        self.patience = patience
        self.in_use = 0
        self.peak = 0           # the most bytes ever admitted at once
        self.waits = 0          # calls that had to wait
        self._cond = threading.Condition()

    def _fits(self, need: int) -> bool:
        # room() leaves out what the admitted calls already hold, and in_use
        # counts it again: an admission errs on the side of waiting
        if self.in_use + need > self.capacity:
            return False
        return self.room is None or self.in_use + need <= self.room()

    @contextlib.contextmanager
    def admit(self, n: int):
        need = sa_bytes(n)
        if need > self.capacity:
            raise SuffixArrayTooLarge(n, need, self.capacity)
        with self._cond:
            waited, alone = False, None
            while not self._fits(need):
                if not waited:
                    waited = True
                    self.waits += 1
                if self.in_use:
                    alone = None
                elif alone is None:
                    alone = time.monotonic()
                elif time.monotonic() - alone > self.patience:
                    raise SuffixArrayTooLarge(n, need, self.room(),
                                              "the room free on the device")
                self._cond.wait(POLL_S if self.room is not None else None)
            self.in_use += need
            self.peak = max(self.peak, self.in_use)
        try:
            yield
        finally:
            with self._cond:
                self.in_use -= need
                self._cond.notify_all()


_BUDGETS: dict[int, ByteBudget] = {}
_BUDGETS_LOCK = threading.Lock()


def _card_room(idx: int):
    """The bytes card ``idx`` can hand this process now: its free memory
    and what this process's caching allocator holds unallocated."""
    def room() -> int:
        free, _ = torch.cuda.mem_get_info(idx)
        return free + torch.cuda.memory_reserved(idx) - torch.cuda.memory_allocated(idx)
    return room


def device_budget(dev: torch.device) -> ByteBudget | None:
    """The card's budget (CARD_SHARE of its memory, and its room at each
    admission), one a card for the process; None on the CPU, where nothing
    is admitted."""
    if dev.type != "cuda":
        return None
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    with _BUDGETS_LOCK:
        if idx not in _BUDGETS:
            total = torch.cuda.get_device_properties(idx).total_memory
            _BUDGETS[idx] = ByteBudget(int(total * CARD_SHARE), _card_room(idx))
        return _BUDGETS[idx]


def admitted(dev: torch.device, n: int, budget: ByteBudget | None = None):
    """The context in which a call on ``n`` positions runs on ``dev``:
    admitted by ``budget`` (default: the card's; none on the CPU)."""
    if budget is None:
        budget = device_budget(dev)
    return budget.admit(n) if budget is not None else contextlib.nullcontext()


def _sort_keys(key: torch.Tensor) -> torch.Tensor:
    """``key`` (int64, all distinct) in ascending order.  ``torch.unique``
    sorts keys alone, where ``torch.sort`` would also build and permute an
    int64 index array; on distinct keys it drops nothing."""
    out = torch.unique(key, sorted=True)
    if out.numel() != key.numel():
        raise RuntimeError("prefix doubling: the sort keys are not distinct")
    return out


def _slices(n: int):
    for a in range(0, n, SLICE):
        yield a, min(a + SLICE, n)


def _seed_keys(text: torch.Tensor, n: int) -> torch.Tensor:
    """pack_key(w, low): ``w`` the four bytes at i, big-endian, 0 past the
    end; ``low`` i + 3, or n - 1 - i at the last three positions."""
    dev = text.device
    key = torch.empty(n, dtype=torch.int64, device=dev)
    for a, b in _slices(n):
        w = torch.zeros(b - a, dtype=torch.int64, device=dev)
        for c in range(SEED_BYTES):
            m = max(0, min(b + c, n) - (a + c))
            if m:
                w[:m] |= text[a + c:a + c + m].to(torch.int64) << (8 * (SEED_BYTES - 1 - c))
        i = torch.arange(a, b, device=dev)
        low = torch.where(i < n - 3, i + 3, n - 1 - i)
        key[a:b] = pack_key(w, low)
    return key


def _seed_sa(s: torch.Tensor, n: int) -> torch.Tensor:
    """The positions of the sorted seed keys ``s``."""
    sa = torch.empty(n, dtype=torch.int32, device=s.device)
    for a, b in _slices(n):
        low = s[a:b] & _LOW
        sa[a:b] = torch.where(low >= 3, low - 3, n - 1 - low).to(torch.int32)
    return sa


def _seed8(text: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The SA by each suffix's first eight bytes, and its dense ranks (n <=
    SEED8_MAX): int64 keys of the bytes at i..i+7 (0 past the end; the
    first byte's top bit flipped, so that the signed order is the bytes'),
    in reversed position order and stable-sorted with torch.sort, so that
    among equal keys the later positions come first: a suffix shorter
    than eight bytes sorts before every longer one that shares its window,
    and those of them in ascending length.  A new rank where the key
    changes, and at and after each of the last seven positions."""
    dev = text.device
    b = text[:n].to(torch.int64)
    key = (b ^ 0x80) << 56
    for c in range(1, min(8, n)):
        key[:n - c] |= b[c:] << (8 * (7 - c))
    del b
    skey, j = torch.sort(key.flip(0), stable=True)
    del key
    sa = (n - 1 - j).to(torch.int32)
    del j
    end = sa >= n - 7
    flag = torch.ones(n, dtype=torch.bool, device=dev)
    flag[1:] = (skey[1:] != skey[:-1]) | end[1:] | end[:-1]
    return sa, torch.cumsum(flag, 0, dtype=torch.int32)


def _doubling_sorted(text: torch.Tensor, n: int) -> tuple[torch.Tensor, int]:
    """prefix_doubling of a call up to SEED8_MAX positions: the eight-byte
    seed, then rounds that sort ``pack_key(rank[i], rank[i + k])`` (0 past
    the end, below every rank) with ``torch.sort``, whose index is the new
    SA: fewer passes a round than the distinct keys' rounds, and one sync.
    Keys tie only between suffixes whose first 2k bytes are equal, and at
    most one suffix of a rank reaches the end at i + k, so the pairs order
    the suffixes as their ranks do."""
    sa, newr = _seed8(text, n)
    rank = torch.empty(n, dtype=torch.int64, device=text.device)
    rank[sa.to(torch.int64)] = newr.to(torch.int64)
    groups = int(newr[-1])                # one sync a round
    del newr
    rounds, k = 0, 8
    while groups != n:
        if k >= n:
            raise RuntimeError(f"prefix doubling did not converge: {groups} of {n} ranks")
        nxt = torch.zeros_like(rank)
        nxt[:n - k] = rank[k:]
        key = pack_key(rank, nxt)
        del nxt
        sa = None                           # the last round's, no longer needed
        skey, sa = torch.sort(key)
        del key
        flag = torch.ones(n, dtype=torch.bool, device=text.device)
        flag[1:] = skey[1:] != skey[:-1]
        del skey
        newr = torch.cumsum(flag, 0)
        del flag
        rank[sa] = newr
        groups = int(newr[-1])
        del newr
        rounds += 1
        k *= 2
    return sa.to(torch.int32), rounds


def _round_keys(rank: torch.Tensor, sa: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """pack_key(rank[i], low(i)) of each position, low as the module says."""
    dev = rank.device
    isa = torch.empty(n, dtype=torch.int32, device=dev)
    for a, b in _slices(n):
        isa[sa[a:b].to(torch.int64)] = torch.arange(a, b, dtype=torch.int32, device=dev)
    key = torch.empty(n, dtype=torch.int64, device=dev)
    for a, b in _slices(n):
        low = torch.empty(b - a, dtype=torch.int64, device=dev)
        m = max(0, min(b, n - k) - a)          # positions with i + k < n
        if m:
            low[:m] = isa[a + k:a + k + m].to(torch.int64) + k
        if m < b - a:
            low[m:] = torch.arange(a + m, b, device=dev) - (n - k)
        key[a:b] = pack_key(rank[a:b].to(torch.int64), low)
    return key


def _ranks(s: torch.Tensor, sa: torch.Tensor, rank: torch.Tensor | None,
           n: int, k: int) -> torch.Tensor:
    """Dense ranks (1-based, int32) of the sorted keys ``s`` (positions
    ``sa``): a new rank where the key's high word changes and, for the
    seed (``rank`` None), at and after each of the last three positions
    (low below 3), else where rank[i + k] changes."""
    dev = s.device
    flag = torch.empty(n, dtype=torch.bool, device=dev)
    for a, b in _slices(n):
        a0 = max(a - 1, 0)
        hi = s[a0:b] >> 32
        ch = hi[1:] != hi[:-1]
        if rank is None:
            end = (s[a0:b] & _LOW) < 3
            ch |= end[1:] | end[:-1]
        else:
            nxt = sa[a0:b].to(torch.int64) + k
            r2 = torch.where(nxt < n, rank[nxt.clamp(max=n - 1)], 0)
            ch |= r2[1:] != r2[:-1]
        if a == 0:
            flag[0] = True
            flag[1:b] = ch
        else:
            flag[a:b] = ch
    return torch.cumsum(flag, 0, dtype=torch.int32)


def prefix_doubling(text: torch.Tensor, n: int) -> tuple[torch.Tensor, int]:
    """Suffix array (int32, ``n`` long) of the first ``n`` bytes of
    ``text`` (uint8, on its device; bytes past ``n`` are not read), and the
    rounds after the seed.  Counted as one ``suffix_array`` launch."""
    launch.count("suffix_array")
    if n <= SEED8_MAX:
        return _doubling_sorted(text, n)
    dev = text.device
    s = _sort_keys(_seed_keys(text, n))
    sa = _seed_sa(s, n)
    newr = _ranks(s, sa, None, n, 0)
    del s
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    rounds, k = 0, SEED_BYTES
    while True:
        for a, b in _slices(n):
            rank[sa[a:b].to(torch.int64)] = newr[a:b]
        groups = int(newr[-1])              # one sync a round
        del newr
        if groups == n:
            return sa, rounds
        if k >= n:
            raise RuntimeError(f"prefix doubling did not converge: {groups} of {n} ranks")
        s = _sort_keys(_round_keys(rank, sa, n, k))
        nsa = torch.empty(n, dtype=torch.int32, device=dev)
        for a, b in _slices(n):
            low = s[a:b] & _LOW
            past = low < k
            prev = sa[(low - k).clamp(min=0)].to(torch.int64) - k
            nsa[a:b] = torch.where(past, low + (n - k), prev).to(torch.int32)
        sa = nsa
        del nsa
        newr = _ranks(s, sa, rank, n, k)
        del s
        rounds += 1
        k *= 2


def check_suffix_array(text: torch.Tensor, sa: torch.Tensor) -> bool:
    """Whether ``sa`` is the suffix array of ``text`` (uint8), both on one
    device, by the linear check of Burkhardt and Kärkkäinen: ``sa`` is a
    permutation of [0, n), and with ``rank`` its inverse and ``rank[n] =
    -1`` every adjacent pair ``a = sa[t], b = sa[t + 1]`` has ``text[a] <
    text[b]``, or equal bytes and ``rank[a + 1] < rank[b + 1]``."""
    n = text.numel()
    if sa.numel() != n:
        return False
    if n == 0:
        return True
    dev = text.device
    if int(sa.min()) < 0 or int(sa.max()) >= n:
        return False
    rank = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    for a, b in _slices(n):
        rank[sa[a:b].to(torch.int64)] = torch.arange(a, b, dtype=torch.int32, device=dev)
    if int((rank[:n] < 0).sum()):
        return False                        # an index repeated, another missing
    for a, b in _slices(n - 1):
        x = sa[a:b].to(torch.int64)
        y = sa[a + 1:b + 1].to(torch.int64)
        cx, cy = text[x], text[y]
        ok = (cx < cy) | ((cx == cy) & (rank[x + 1] < rank[y + 1]))
        if not bool(ok.all()):
            return False
    return True


def suffix_array_device(src: np.ndarray, *, device, budget: ByteBudget | None = None
                        ) -> np.ndarray:
    """Suffix array of ``src`` (uint8) computed on ``device`` (``cuda``: the
    card, which must be there; ``cpu``: the same tensor code on the host),
    admitted by ``budget`` (default: the card's; none on the CPU)."""
    dev = check_device(device)
    src = np.array(src, dtype=np.uint8)     # a copy torch may write to
    n = src.size
    if n == 0:
        return np.zeros(0, np.int32)
    with admitted(dev, n, budget):
        sa, _ = prefix_doubling(torch.from_numpy(src).to(dev), n)
        return sa.cpu().numpy()
