"""Shared entropy-coding helpers: alphabet wire coding, frequency
normalization, LSB-first varints.

Wire format re-derived from K/entropy/EntropyUtils.java:30-300.  The
normalization error-spreading procedure is replicated exactly because encoder
and decoder must derive identical frequency tables from the same histogram
(ANS/Range emit the normalized freqs; Huffman re-normalizes lengths).
"""

from __future__ import annotations

import numpy as np

from ..core.bits import BitReader, BitWriter

INCOMPRESSIBLE_THRESHOLD = 973  # 0.95 * 1024

_FULL_ALPHABET = 0
_PARTIAL_ALPHABET = 1
_ALPHABET_256 = 0
_ALPHABET_0 = 1


def encode_alphabet(bw: BitWriter, alphabet: np.ndarray) -> int:
    """Emit the symbol set: 2 bits for full/empty, else 5-bit last-mask index
    plus presence bitmap bytes (EntropyUtils.java:38-74)."""
    count = len(alphabet)
    if count > 256:
        return -1
    if count == 0:
        bw.write_bit(_FULL_ALPHABET)
        bw.write_bit(_ALPHABET_0)
    elif count == 256:
        bw.write_bit(_FULL_ALPHABET)
        bw.write_bit(_ALPHABET_256)
    else:
        bw.write_bit(_PARTIAL_ALPHABET)
        alphabet = np.asarray(alphabet, dtype=np.int64)
        masks = np.zeros(32, dtype=np.uint8)
        np.bitwise_or.at(masks, alphabet >> 3, (1 << (alphabet & 7)).astype(np.uint8))
        last_mask = int(alphabet[-1]) >> 3
        bw.write_bits(last_mask, 5)
        bw.write_bits_vec(masks[:last_mask + 1].astype(np.uint64),
                          np.full(last_mask + 1, 8, dtype=np.int64))
    return count


def decode_alphabet(br: BitReader) -> np.ndarray:
    """Inverse of encode_alphabet; returns sorted symbol array."""
    if br.read_bit() == _FULL_ALPHABET:
        if br.read_bit() == _ALPHABET_0:
            return np.zeros(0, dtype=np.int32)
        return np.arange(256, dtype=np.int32)
    last_mask = br.read_bits(5)
    masks = br.read_bits_vec(np.full(last_mask + 1, 8, dtype=np.int64)).astype(np.uint8)
    bits = np.unpackbits(masks, bitorder="little")
    return np.nonzero(bits)[0].astype(np.int32)


def normalize_frequencies(freqs: np.ndarray, total_freq: int, scale: int) -> np.ndarray:
    """Scale ``freqs`` (len<=256, modified in place) so they sum to ``scale``.

    Returns the alphabet (symbols with non-zero original frequency).  The
    rounding + bounded error-spreading procedure matches
    EntropyUtils.java:141-250 exactly (wire-critical for ANS/Range).
    """
    if len(freqs) > 256:
        raise ValueError("alphabet too large")
    if not (1 << 8) <= scale <= (1 << 16):
        raise ValueError("scale must be in [256..65536]")
    if len(freqs) == 0 or total_freq == 0:
        return np.zeros(0, dtype=np.int32)

    if total_freq == scale:
        return np.nonzero(freqs[:256])[0].astype(np.int32)

    alphabet = []
    sum_scaled = 0
    sum_freq = 0
    idx_max = 0
    n = len(freqs)
    for i in range(n):
        f = int(freqs[i])
        if f == 0:
            continue
        sf = f * scale
        scaled = 1 if sf <= total_freq else (sf + (total_freq >> 1)) // total_freq
        alphabet.append(i)
        sum_scaled += scaled
        freqs[i] = scaled
        sum_freq += f
        if scaled > freqs[idx_max]:
            idx_max = i
        if sum_freq >= total_freq:
            break

    alphabet_size = len(alphabet)
    if alphabet_size == 0:
        return np.zeros(0, dtype=np.int32)
    if alphabet_size == 1:
        freqs[alphabet[0]] = scale
        return np.array(alphabet, dtype=np.int32)
    if sum_scaled == scale:
        return np.array(alphabet, dtype=np.int32)

    delta = sum_scaled - scale
    err_thr = int(freqs[idx_max]) >> 4
    if abs(delta) <= err_thr:
        freqs[idx_max] -= delta
        return np.array(alphabet, dtype=np.int32)

    if delta < 0:
        delta += err_thr
        freqs[idx_max] += err_thr
    else:
        delta -= err_thr
        freqs[idx_max] -= err_thr

    inc = -1 if delta > 0 else 1
    delta = abs(delta)
    round_ = 0
    while True:
        round_ += 1
        if round_ >= 6 or delta <= 0:
            break
        adjustments = 0
        for idx in alphabet:
            if freqs[idx] <= 2:
                continue
            freqs[idx] += inc
            adjustments += 1
            delta -= 1
            if delta == 0:
                break
        if adjustments == 0:
            break

    freqs[idx_max] = max(int(freqs[idx_max]) - delta, 1)
    return np.array(alphabet, dtype=np.int32)


def normalize_frequencies_batch(hist: np.ndarray, total_freq,
                                scale: int) -> np.ndarray:
    """Vectorized ``normalize_frequencies`` over a batch of histograms.

    ``hist`` is (n, 256); ``total_freq`` is a scalar (full chunks) or an
    (n,) per-row total vector (order-1 context tables).  Rows whose sum
    disagrees with their total are normalized with the scalar routine.
    Returns the normalized (n, 256) int64 frequency matrix; alphabets are
    recovered by the caller as ``np.nonzero(hist[i])``.  Bit-exact with the
    scalar path (EntropyUtils.java:141-250): same half-up scaling, same
    running first-argmax, same bounded 5-round error spreading in symbol
    order with the ``freq > 2`` eligibility re-evaluated per round (the
    scalar path's ``sum_freq >= total_freq`` early break is a no-op when
    the row sums to its total, which holds for every row handled here).
    """
    hist = np.asarray(hist, dtype=np.int64)
    n = hist.shape[0]
    freq = hist.copy()
    if n == 0:
        return freq
    row_tot = hist.sum(axis=1)
    totals = np.broadcast_to(np.asarray(total_freq, dtype=np.int64), (n,))
    irregular = np.flatnonzero((row_tot != totals) & (row_tot != 0))
    for i in irregular:  # rare: delegate to the exact scalar routine
        f = hist[i].copy()
        normalize_frequencies(f, int(row_tot[i]), scale)
        freq[i] = f
    rows = np.flatnonzero((row_tot == totals) & (row_tot != 0)
                          & (row_tot != scale))
    if rows.size == 0:
        return freq
    h = hist[rows]
    t = totals[rows][:, None]
    nz = h > 0
    asize = nz.sum(axis=1)
    # scaling pass (the scalar early-break is a no-op when the row sums to
    # total_freq exactly, which holds for every row handled here)
    sf = h * scale
    scaled = np.where(sf <= t, 1, (sf + (t >> 1)) // t)
    scaled = np.where(nz, scaled, 0)
    f = scaled.copy()
    idx_max = np.argmax(scaled, axis=1)  # first max, zeros never win vs >=1
    sum_scaled = scaled.sum(axis=1)
    ar = np.arange(len(rows))
    # single-symbol rows: that symbol gets the whole scale
    single = asize == 1
    if single.any():
        f[single] = 0
        f[np.flatnonzero(single), idx_max[single]] = scale
    active = (~single) & (sum_scaled != scale)
    delta = sum_scaled - scale
    err_thr = scaled[ar, idx_max] >> 4
    small = active & (np.abs(delta) <= err_thr)
    if small.any():
        f[np.flatnonzero(small), idx_max[small]] -= delta[small]
    big = active & ~small
    if big.any():
        neg = big & (delta < 0)
        pos = big & (delta > 0)
        f[np.flatnonzero(neg), idx_max[neg]] += err_thr[neg]
        f[np.flatnonzero(pos), idx_max[pos]] -= err_thr[pos]
        d = np.where(neg, delta + err_thr, np.where(pos, delta - err_thr, 0))
        inc = np.where(d > 0, -1, 1).astype(np.int64)
        d = np.abs(d)
        live = big.copy()
        for _ in range(5):  # rounds 1..5 (round_ >= 6 stops)
            if not live.any():
                break
            elig = nz & (f > 2) & live[:, None]
            cnt = np.cumsum(elig, axis=1)
            adj = elig & (cnt <= d[:, None])
            nadj = adj.sum(axis=1)
            f += adj * inc[:, None]
            d = d - np.minimum(nadj, d)
            live = live & (d > 0) & (nadj > 0)
        tgt = np.flatnonzero(big)
        f[tgt, idx_max[big]] = np.maximum(f[tgt, idx_max[big]] - d[big], 1)
    # rows with sum_scaled == scale keep their scaled values as-is
    freq[rows] = f
    return freq


def write_varint(bw: BitWriter, value: int) -> int:
    """LSB-first 7-bit varint, unsigned 32-bit (EntropyUtils.java:259-277)."""
    value &= 0xFFFFFFFF
    res = 0
    while value >= 128:
        bw.write_bits(0x80 | (value & 0x7F), 8)
        value >>= 7
        res += 1
    bw.write_bits(value, 8)
    return res


def read_varint(br: BitReader) -> int:
    value = br.read_bits(8)
    res = value & 0x7F
    shift = 7
    while value >= 128:
        value = br.read_bits(8)
        res |= (value & 0x7F) << shift
        if shift == 28:
            break
        shift += 7
    return res
