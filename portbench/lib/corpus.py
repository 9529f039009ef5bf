"""Frozen copy of the port's seeded silesia-like corpus generator
(kanzi_tpu_torch/utils/corpus.py ``mixed_corpus`` and its generators, as
of this benchmark's first version), so that the yardstick does not move
when the program's copy does.

Text-like, XML-like, executable-like, DNA-like, numeric and random data
in fixed shares, each part made from the seed, interleaved in 1 MiB
extents.  The same seed gives the same bytes on any machine."""

from __future__ import annotations

import numpy as np

_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)


def _zipf_probs(n: int, s: float = 1.07) -> np.ndarray:
    p = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), s)
    return p / p.sum()


def _ragged_gather(flat: np.ndarray, starts: np.ndarray,
                   lens: np.ndarray) -> np.ndarray:
    """Concatenate flat[starts[i]:starts[i]+lens[i]] for all i, vectorized.
    int32 + minimal temporaries: this host's numpy is allocation-bound."""
    starts = starts.astype(np.int32, copy=False)
    lens = lens.astype(np.int32, copy=False)
    cum = np.cumsum(lens, dtype=np.int32)
    total = int(cum[-1])
    # pos[j] = starts[i] + (j - out_start[i])  for j inside word i
    pos = np.repeat(starts - (cum - lens), lens)
    pos += np.arange(total, dtype=np.int32)
    return flat[pos]


def _make_vocab(rng: np.random.Generator, nwords: int = 8192):
    """Random 'words' (2..11 letters + trailing space) in a flat byte pool."""
    lens = rng.integers(3, 12, nwords)          # includes the trailing space
    flat = np.empty(int(lens.sum()), dtype=np.uint8)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    body = _LETTERS[rng.integers(0, 26, int(lens.sum()))]
    flat[:] = body
    flat[starts + lens - 1] = ord(" ")
    return flat, starts.astype(np.int64), lens.astype(np.int64)


def text_like(size: int, seed: int = 1) -> np.ndarray:
    """English-like filler: Zipf-ranked word stream with sentence structure.
    Compresses at roughly real-text ratios (l1 ~0.45, l5 ~0.33)."""
    rng = np.random.default_rng(seed)
    flat, starts, lens = _make_vocab(rng)
    navg = max(size // int(lens.mean()), 16)
    ids = rng.choice(len(starts), size=navg, p=_zipf_probs(len(starts)))
    out = _ragged_gather(flat, starts[ids], lens[ids])
    # sentence structure: every ~12th word ends with ". ", every ~70th "\n"
    word_ends = np.cumsum(lens[ids]) - 1
    dots = word_ends[11::12]
    out[dots[dots < out.size]] = ord(".")
    nl = word_ends[69::70]
    out[nl[nl < out.size]] = ord("\n")
    return out[:size]


def xml_like(size: int, seed: int = 2) -> np.ndarray:
    """Markup: nested tags wrapping short zipf text runs."""
    rng = np.random.default_rng(seed)
    tags = [b"<item>", b"</item>", b"<name>", b"</name>", b"<value>",
            b"</value>", b'<row id="', b'">', b"<doc>", b"</doc>\n"]
    text = text_like(size, seed + 100)
    pieces, pos, tpos = [], 0, 0
    # structural skeleton is built in ~1k-element python chunks, payload is
    # vectorized text; the loop is O(size/64), negligible
    order = rng.integers(0, len(tags), size // 32 + 16)
    for t in order:
        pieces.append(tags[t])
        run = 16 + int(rng.integers(0, 48))
        pieces.append(text[pos:pos + run].tobytes())
        pos += run
        tpos += len(tags[t]) + run
        if tpos >= size:
            break
    return np.frombuffer(b"".join(pieces)[:size], dtype=np.uint8)


def exe_like(size: int, seed: int = 3) -> np.ndarray:
    """x86-flavored machine code: a pool of 'function bodies' (skewed opcode
    bytes) tiled zipf-fashion — real binaries repeat instruction sequences,
    which is what LZ/EXECodec actually see — with E8 rel32 call sites whose
    displacements cluster, and 0x00 padding runs."""
    rng = np.random.default_rng(seed)
    # skewed opcode distribution: a few very common bytes (push/mov/rex)
    common = np.frombuffer(bytes([0x48, 0x89, 0x8B, 0x55, 0x53, 0xC3, 0x0F,
                                  0x83, 0x45, 0x31, 0xFF, 0x41, 0x00]),
                           dtype=np.uint8)
    pool_sz = 1 << 18
    pool = common[rng.choice(len(common), pool_sz,
                             p=_zipf_probs(len(common), 0.9))]
    noise = rng.integers(0, 256, pool_sz)
    pool = np.where(rng.random(pool_sz) < 0.30, noise, pool).astype(np.uint8)
    # function bodies of 32..480 bytes sampled zipf (hot functions repeat)
    nb = 2048
    blens = rng.integers(32, 480, nb).astype(np.int32)
    bstarts = rng.integers(0, pool_sz - 512, nb).astype(np.int32)
    ids = rng.choice(nb, size=size // 128 + 16, p=_zipf_probs(nb, 0.8))
    cum = np.cumsum(blens[ids])
    if cum[-1] < size:  # short-body-heavy draw: top up deterministically
        ids = np.tile(ids, int(np.ceil(size / cum[-1])) + 1)
        cum = np.cumsum(blens[ids])
    ids = ids[:int(np.searchsorted(cum, size)) + 1]
    out = _ragged_gather(pool, bstarts[ids], blens[ids])[:size].copy()
    # call sites every ~48 bytes with small clustered displacements
    sites = np.arange(0, size - 8, 48)
    out[sites] = 0xE8
    disp = (rng.normal(0, 1 << 12, sites.size)).astype(np.int32)
    le = disp.view(np.uint8).reshape(-1, 4)
    for j in range(4):
        out[sites + 1 + j] = le[:, j]
    # 0x00 padding runs
    for s in rng.integers(0, max(size - 256, 1), size // 8192 + 1):
        out[s:s + int(rng.integers(16, 200))] = 0
    return out


def dna_like(size: int, seed: int = 4) -> np.ndarray:
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = acgt[rng.choice(4, size, p=[0.30, 0.20, 0.20, 0.30])]
    out[79::80] = ord("\n")  # FASTA-ish line breaks
    return out


def numeric_like(size: int, seed: int = 5) -> np.ndarray:
    """CSV-ish numeric table bytes: digits with comma/newline structure."""
    rng = np.random.default_rng(seed)
    # skewed digit distribution (Benford-flavored leading digits)
    digits = np.frombuffer(b"0123456789", dtype=np.uint8)
    out = digits[rng.choice(10, size, p=_zipf_probs(10, 0.6))]
    out[6::7] = ord(",")
    out[69::70] = ord("\n")
    return out


_DEFAULT_MIX = (("text", 0.34), ("xml", 0.15), ("exe", 0.16),
                ("dna", 0.10), ("numeric", 0.10), ("random", 0.15))


def mixed_corpus(size: int, seed: int = 42,
                 mix=_DEFAULT_MIX) -> np.ndarray:
    """Silesia-like mixed corpus of exactly ``size`` bytes, interleaved in
    1 MiB extents so every 4+ MiB block sees several data types (like a tar
    of heterogeneous files crossing block boundaries)."""
    gens = {"text": text_like, "xml": xml_like, "exe": exe_like,
            "dna": dna_like, "numeric": numeric_like,
            "random": lambda n, s: np.random.default_rng(s).integers(
                0, 256, n).astype(np.uint8)}
    parts = []
    for i, (name, frac) in enumerate(mix):
        n = int(size * frac)
        parts.append(gens[name](n, seed + i))
    rest = size - sum(p.size for p in parts)
    if rest > 0:
        parts.append(gens["text"](rest, seed + 99))
    # interleave in 1 MiB extents (deterministic round-robin)
    ext = 1 << 20
    queues = [[p[i:i + ext] for i in range(0, p.size, ext)] for p in parts]
    out = []
    while queues:
        for q in queues:
            out.append(q.pop(0))
        queues = [q for q in queues if q]
    return np.concatenate(out)[:size]
