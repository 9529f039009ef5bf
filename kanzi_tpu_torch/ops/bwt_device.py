"""Suffix array by prefix doubling over sorts, on a torch device.

Counterpart of kanzi_tpu/ops/bwt_tpu.py (the suffix array that level 5's BWT
takes under ``KANZI_TPU_DEVICE_BWT=1``), in PyTorch on an explicit device.
The reference has no Pallas kernel here: its rounds are XLA sorts inside a
``jax.lax.while_loop``.  The port keeps the contract and translates each
step into tensor code that runs alike on ``cpu`` and ``cuda`` tensors:

  - the padding: ``npad = _bucket(n + 1)`` positions, the pads behind the
    text, ranked below every real suffix and descending with position, so
    that the convergence check can fire; the pads sort first and are cut;
  - the seed: the reference's stable 2-key sort of the 8-byte windows
    ``(w0 ^ S, w1 ^ S, iota)`` is one stable ``torch.sort`` of the int64
    key ``(w0 - 2^31) << 32 | w1`` (the top word sign-flipped, so signed
    int64 order is the words' unsigned order); dense ranks are the cumsum
    of the key changes, sent back to their positions by a scatter
    (``rank[sa] = newr``: ``sa`` is a permutation, so no sort back);
  - each round at k = 8, 16, ...: the same on the key
    ``(rank - 2^31) << 32 | shifted`` with ``shifted = rank[i + k]``, or 0
    past ``npad``; it stops when the ranks are all distinct
    (``newr[-1] == npad - 1``) or k reaches ``npad``.

Ranks stay below ``2 * npad``; biasing the high word by 2^31 keeps the key's
order for any rank below 2^32, so no block the BWT takes (at most 1 GiB,
``npad`` at most 1.5 x 2^30) can overflow it.  The SA is unique, so its BWT
is the host's bit for bit.  Each round costs one ``.item()`` (the
convergence flag), a sync with the device's current stream.  Every run of
``prefix_doubling`` is counted in ``launch.launches["suffix_array"]``, on
either device (the SA has no kernel of its own).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import check_device
from . import launch

__all__ = ["suffix_array_device", "prefix_doubling"]

_BIAS = 1 << 31               # the high word's sign flip: unsigned order

launch.register(["suffix_array"])


def _bucket(n: int) -> int:
    """Pad to a power of two or 1.5x a power of two (waste <= 25%)."""
    p = 1 << max(n - 1, 1).bit_length()
    if n <= (p >> 2) * 3:
        return (p >> 2) * 3
    return p


def pack_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 whose signed order is the order of the pairs (hi, lo), for
    int64 ``hi`` and ``lo`` in [0, 2^32)."""
    return ((hi - _BIAS) << 32) | lo


def _dense_ranks(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of ``key``; returns (the permutation, the dense rank of
    each sorted entry: the count of key changes before it)."""
    skey, sa = torch.sort(key, stable=True)
    change = torch.zeros_like(skey, dtype=torch.bool)
    change[1:] = skey[1:] != skey[:-1]
    return sa, torch.cumsum(change, 0)


def prefix_doubling(glob: torch.Tensor, n: int) -> tuple[torch.Tensor, int]:
    """Suffix array of the padded buffer ``glob`` (uint8, ``npad`` long, its
    first ``n`` bytes real, the rest 0) over all ``npad`` positions, on
    ``glob``'s device; returns (the int64 SA, the rounds after the seed).
    Counted as one ``suffix_array`` launch."""
    launch.count("suffix_array")
    npad = glob.numel()
    dev = glob.device
    iota = torch.arange(npad, device=dev)

    def sh(x: torch.Tensor, k: int) -> torch.Tensor:
        return torch.cat([x[k:], x.new_zeros(k)])

    b = glob.to(torch.int64)
    w0 = (b << 24) | (sh(b, 1) << 16) | (sh(b, 2) << 8) | sh(b, 3)
    sa, newr = _dense_ranks(pack_key(w0, sh(w0, 4)))
    del b, w0
    rank = torch.empty_like(newr)
    rank[sa] = newr
    # reals above every pad; the pads distinct and descending with position:
    # a pad's rank read at i + k stands for "past the end", and a later
    # (shorter) suffix compares smaller
    rank = torch.where(iota < n, rank + npad, npad - iota)
    rounds = 0
    k = 8
    while True:
        shifted = torch.zeros_like(rank)
        if k < npad:
            shifted[:npad - k] = rank[k:]
        sa, newr = _dense_ranks(pack_key(rank, shifted))
        del shifted
        rank[sa] = newr
        rounds += 1
        k *= 2
        # one sync a round: the host reads the convergence flag
        if int(newr[-1]) == npad - 1 or k >= npad:
            return sa, rounds


def suffix_array_device(src: np.ndarray, *, device) -> np.ndarray:
    """Suffix array of ``src`` (uint8) computed on ``device`` (``cuda``: the
    card, which must be there; ``cpu``: the same tensor code on the host)."""
    dev = check_device(device)
    src = np.asarray(src, dtype=np.uint8)
    n = src.size
    if n <= 2:
        return np.argsort([src[i:].tobytes() for i in range(n)]).astype(
            np.int32) if n else np.zeros(0, np.int32)
    npad = _bucket(n + 1)
    glob = np.zeros(npad, np.uint8)
    glob[:n] = src
    sa, _ = prefix_doubling(torch.from_numpy(glob).to(dev), n)
    # the pads sort first (strictly smallest ranks)
    return sa[npad - n:].to(torch.int32).cpu().numpy()
