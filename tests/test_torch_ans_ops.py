"""The port's plain ANS0 kernels (kanzi_tpu_torch/ops/ans_cuda.py) against
kanzi_tpu's JAX functions, on the same numpy inputs, at zero tolerance:
these are integer codecs and bit-exactness is the contract.  Pallas kernels
run in interpret mode, as tests/test_pallas_interpret.py runs them."""

from __future__ import annotations

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanzi_tpu.entropy.utils import normalize_frequencies_batch
from kanzi_tpu.ops import ans as jans
from kanzi_tpu.ops import ans_pallas as P
from kanzi_tpu.ops.ans_block import _chunk_stats
from kanzi_tpu.utils.corpus import mixed_corpus
from kanzi_tpu_torch.ops import ans1_cuda as A1
from kanzi_tpu_torch.ops import ans_cuda as A

CHUNK = 16384
SCALE = 4096


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("KANZI_TPU_PALLAS_INTERPRET", "1")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _chunk_from_hist(h, rng):
    return rng.permutation(np.repeat(np.arange(256, dtype=np.uint8), h))


def _hist_rows():
    """29 pareto-skewed rows (as test_pallas_interpret) + single-symbol,
    256-symbol and one-dominant-symbol (freq 4095) rows, 32 in all."""
    rng = np.random.default_rng(1)
    hists = []
    for _ in range(29):
        k = int(rng.integers(1, 257))
        syms = rng.choice(256, k, replace=False)
        w = rng.pareto(rng.uniform(0.2, 3.0), k) + 1e-9
        h = np.zeros(256, np.int64)
        h[syms] = 1 + rng.multinomial(CHUNK - k, w / w.sum())
        hists.append(h)
    single = np.zeros(256, np.int64)
    single[77] = CHUNK
    flat = np.full(256, CHUNK // 256, np.int64)
    dominant = np.zeros(256, np.int64)
    dominant[[3, 200]] = [CHUNK - 1, 1]
    hists = np.array(hists + [single, flat, dominant])
    chunks = np.stack([_chunk_from_hist(h, rng) for h in hists])
    return hists, chunks


def _edge_chunks():
    """16 KiB chunks for the full encode: corpus text, skewed, uniform
    random, all one byte (freq 4096, capped to 4095) and one dominant byte
    (freq 4095 beside a freq-1 byte)."""
    rng = np.random.default_rng(5)
    corpus = mixed_corpus(2 * CHUNK, seed=7).reshape(2, CHUNK)
    dominant = np.full(CHUNK, 9, np.uint8)
    dominant[1234] = 10
    return np.concatenate([corpus, np.stack([
        (rng.zipf(1.4, CHUNK) % 230).astype(np.uint8),
        rng.integers(0, 256, CHUNK).astype(np.uint8),
        np.zeros(CHUNK, np.uint8),
        dominant,
    ])])


@pytest.mark.parametrize("reference", ["pallas", "xla", "numpy"])
def test_hist_norm_ref_matches_jax(reference):
    hists, chunks = _hist_rows()
    got = A.hist_norm_ref(_t(chunks)).numpy()
    assert got.dtype == np.int32
    if reference == "pallas":
        want = P._normalize_freqs_pallas(P._hist16(jnp.asarray(chunks)), 14,
                                         SCALE, rows_per_cell=32)
    elif reference == "xla":
        want = P._normalize_freqs_jax(P._hist16(jnp.asarray(chunks)), 14, SCALE)
    else:
        want = normalize_frequencies_batch(hists, CHUNK, SCALE)
    assert np.array_equal(got, np.asarray(want))
    assert np.all(got.sum(axis=1) == SCALE)


def _norm_edge_rows():
    """Histograms (each summing to 2^14) at the normalisation's edges: a max
    tied at bins 17, 40, 200 and 201 (the lowest takes the correction);
    a delta past err_thr of each sign (+125 against 77, whose five rounds
    move only three symbols a round and leave d = 33; -32 against 4, beside
    a max tied at six bins); exactly two symbols, rounded up together to a
    sum of 4,097."""
    tie = np.zeros(256, np.int64)
    tie[[5, 17, 40, 200, 201]] = [1, 4095, 4096, 4096, 4096]
    pos = np.zeros(256, np.int64)
    pos[:250] = 6
    pos[250:253] = [4961, 4961, 4962]
    neg = np.zeros(256, np.int64)
    neg[:200] = 5
    neg[200:] = (CHUNK - 1000) // 56
    neg[200:200 + (CHUNK - 1000) % 56] += 1
    two = np.zeros(256, np.int64)
    two[[3, 250]] = [5002, 11382]
    hists = np.stack([tie, pos, neg, two])
    rng = np.random.default_rng(4)
    return hists, np.stack([_chunk_from_hist(h, rng) for h in hists])


def _norm_warp(hists):
    """hist_norm_kernel's normalisation (csrc/ans0.cu norm_warp) modelled in
    numpy: lane l holds bins [8 l, 8 l + 8) of a row; the symbol count, the
    scaled sum and the max are sums and maxima of the lanes' own; the first
    index of the max the least of the lanes' first indices; each of the five
    rounds ranks a lane's eligible symbols by an exclusive scan of the
    lanes' counts plus the rank inside the lane, and the rounds stop once a
    round leaves nothing to move.  Returns (freq (N, 256), the first index
    of the max, the delta, err_thr, and d after the rounds, per row)."""
    out, info = [], []
    for h in hists:
        h = np.asarray(h, np.int64).reshape(32, 8)         # lane, register
        nz = h > 0
        sf = h * SCALE
        f = np.where(nz, np.where(sf <= CHUNK, 1, (sf + CHUNK // 2) >> 14), 0)
        asize = int(nz.sum(axis=1).sum())
        sum_scaled = int(f.sum(axis=1).sum())
        mval = int(f.max(axis=1).max())
        first = [8 * lane + int(np.argmax(f[lane] == mval)) if (f[lane] == mval).any()
                 else 256 for lane in range(32)]
        imax = min(first)
        at_max = np.arange(256).reshape(32, 8) == imax
        single = asize == 1
        if single:
            f = np.where(nz, SCALE, 0)
        active = not single and sum_scaled != SCALE
        delta = sum_scaled - SCALE
        err_thr = mval >> 4
        small = active and abs(delta) <= err_thr
        big = active and not small
        f = f + at_max * (-delta if small else (err_thr if delta < 0 else -err_thr) if big
                          else 0)
        d = (delta + err_thr if delta < 0 else delta - err_thr) if big else 0
        inc = -1 if d > 0 else 1
        d = abs(d)
        live = big
        for _ in range(5):
            if not live:
                break
            el = nz & (f > 2)
            cnt = el.sum(axis=1)
            incl = np.cumsum(cnt)
            rank = (incl - cnt)[:, None] + np.cumsum(el, axis=1)
            f = f + np.where(el & (rank <= d), inc, 0)
            nadj = min(int(incl[31]), d)
            d -= nadj
            live = d > 0 and nadj > 0
        if big:
            f = np.where(at_max, np.maximum(f - d, 1), f)
        out.append(f.reshape(256))
        info.append((imax, delta, err_thr, d))
    return np.stack(out).astype(np.int32), info


@pytest.mark.parametrize("rows", ["hist_rows", "edge_rows"])
@pytest.mark.parametrize("reference", ["port", "xla", "numpy"])
def test_norm_warp_matches_ref(rows, reference):
    """The one-warp normalisation equals hist_norm_ref, kanzi_tpu's
    _normalize_freqs_jax and the host's normalize_frequencies_batch bit for
    bit, on the 32 rows of _hist_rows and on the edge rows."""
    hists, chunks = _hist_rows() if rows == "hist_rows" else _norm_edge_rows()
    got, _ = _norm_warp(hists)
    if reference == "port":
        want = A.hist_norm_ref(_t(chunks)).numpy()
    elif reference == "xla":
        want = np.asarray(P._normalize_freqs_jax(P._hist16(jnp.asarray(chunks)), 14, SCALE))
    else:
        want = normalize_frequencies_batch(hists, CHUNK, SCALE)
    assert np.array_equal(got, want)
    assert np.all(got.sum(axis=1) == SCALE)


def test_norm_edge_rows_reach_their_edges():
    """Each edge row reaches the edge it is named for, in the model and in
    the reference's outputs."""
    hists, _ = _norm_edge_rows()
    got, info = _norm_warp(hists)
    (imax0, delta0, thr0, _), (_, delta1, thr1, d1), (imax2, delta2, thr2, _), _ = info
    assert imax0 == 17 and 0 < delta0 <= thr0 and got[0, 17] == 1023
    assert got[0, 40] == got[0, 200] == got[0, 201] == 1024
    assert delta1 > thr1 and d1 == 33
    assert delta2 < -thr2 and imax2 == 200
    assert np.count_nonzero(hists[3]) == 2 and got[3, 250] == 2845
    want = normalize_frequencies_batch(hists, CHUNK, SCALE)
    assert np.array_equal(got, want)


def test_encode_scan_ref_matches_pallas():
    rng = np.random.default_rng(2)
    n, c = 128, 512
    f = rng.integers(1, 4096, (n, 256)).astype(np.int64)
    cum = np.minimum(np.cumsum(f, axis=1) - f, 4096 - f)
    chunks = rng.integers(0, 256, (n, c), dtype=np.uint8)
    tables = (np.minimum(f, 4095) | (cum << 12)).astype(np.int32)
    wv, wf, st = P._scan_sub_fused(jnp.asarray(chunks), jnp.asarray(tables), rb=1)
    words, flags, states = A.encode_scan_ref(_t(chunks), _t(tables))
    assert np.array_equal(words.numpy().view(np.uint16), np.asarray(wv))
    assert np.array_equal(flags.numpy(), np.asarray(wf))
    assert np.array_equal(states.numpy(), np.asarray(st).reshape(4, n).T)


def test_compact_ref_matches_pallas():
    rng = np.random.default_rng(0)
    n, nb = 8, 4
    flag = (rng.random((n, nb * 128)) < 0.4).astype(np.uint8)
    val = rng.integers(0, 65536, (n, nb * 128)).astype(np.uint16)
    pay, cnt = P._compact2(jnp.asarray(val.reshape(n, nb, 128)),
                           jnp.asarray(flag.reshape(n, nb, 128)))
    payload, n_emit = A.compact_ref(_t(val.view(np.int16)), _t(flag))
    assert np.array_equal(payload.numpy().view(np.uint16),
                          np.asarray(pay).reshape(n, nb * 128))
    assert np.array_equal(n_emit.numpy(), np.asarray(cnt).sum(axis=1))


_NT, _PER = 512, 32          # compact_kernel's threads and positions a thread a tile
_TILE = _NT * _PER


def _run_masks(fl):
    """The loader's flags (N, 32) u8 -> (N, 32) bool, by its arithmetic: four
    flag bytes a 32-bit word x, __vcmpne4(x, 0) (0xFF for each nonzero
    byte), masked by 0x08040201 and multiplied by 0x01010101, whose top
    byte then holds the four bits."""
    x = np.ascontiguousarray(fl).view("<u4").astype(np.uint64)
    ne = np.zeros_like(x)
    for b in range(4):
        ne |= np.where((x >> np.uint64(8 * b)) & np.uint64(255), np.uint64(255 << (8 * b)), 0)
    nib = (((ne & np.uint64(0x08040201)) * np.uint64(0x01010101)) & np.uint64(0xFFFFFFFF)) >> 24
    mask = (nib << (np.arange(nib.shape[1], dtype=np.uint64) * np.uint64(4))).sum(axis=1)
    return (mask[:, None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1) != 0


def _compact_tiled(val, flag):
    """compact_kernel (csrc/ans0.cu) modelled in numpy on words ``val`` (N, C)
    u16 and ``flag`` (N, C) u8.  A width that is a multiple of 16 runs the
    tiled path: tiles of 16,384 positions, 32 consecutive ones a thread,
    their flags a bit mask (_run_masks), each thread's flagged words
    staged at its exclusive offset after the
    words carried from the tile before, the tile storing whole groups of 8
    words and carrying the rest (fewer than 8) to the next, the last tile
    storing the rest and zeros to the row's end.  Any other width runs
    compact.cuh's compact_tile: runs of ceil(C / 512) positions a thread, the
    same offsets, the tail zeroed.  Asserts that every output word is
    written once.  Returns (payload u16, n_emit)."""
    n, c = val.shape
    out = np.zeros((n, c), np.uint16)
    n_emit = np.zeros(n, np.int64)
    for r in range(n):
        written = np.zeros(c, np.int64)
        if c % 16 or c == 0:
            per = -(-c // _NT)
            lo = np.minimum(np.arange(_NT) * per, c)
            hi = np.minimum(lo + per, c)
            cnt = np.array([np.count_nonzero(flag[r, a:b]) for a, b in zip(lo, hi)])
            off = np.cumsum(cnt) - cnt
            for t in range(_NT):
                kept = val[r, lo[t]:hi[t]][flag[r, lo[t]:hi[t]] != 0]
                out[r, off[t]:off[t] + len(kept)] = kept
                written[off[t]:off[t] + len(kept)] += 1
            total = int(cnt.sum())
            out[r, total:] = 0
            written[total:] += 1
            n_emit[r] = total
        else:
            stage = np.zeros(_TILE + 16, np.uint16)
            head = done = 0
            for s in range(0, c, _TILE):
                fl = np.zeros(_TILE, np.uint8)
                wd = np.zeros(_TILE, np.uint16)
                m = min(_TILE, c - s)
                fl[:m], wd[:m] = flag[r, s:s + m], val[r, s:s + m]
                runs = _run_masks(fl.reshape(_NT, _PER))
                cnt = runs.sum(axis=1)
                off = head + np.cumsum(cnt) - cnt
                for t in np.flatnonzero(cnt):
                    stage[off[t]:off[t] + cnt[t]] = wd.reshape(_NT, _PER)[t][runs[t]]
                avail = head + int(cnt.sum())
                assert avail + 8 <= len(stage)
                if s + _TILE >= c:
                    stage[avail:avail + 8] = 0
                    for q in range((c - done) // 8):
                        out[r, done + 8 * q:done + 8 * q + 8] = (
                            stage[8 * q:8 * q + 8] if 8 * q < avail else 0)
                        written[done + 8 * q:done + 8 * q + 8] += 1
                    n_emit[r] = done + avail
                    break
                full = avail & ~7
                out[r, done:done + full] = stage[:full]
                written[done:done + full] += 1
                stage[:avail - full] = stage[full:avail].copy()
                head, done = avail - full, done + full
                assert done % 8 == 0 and head < 8
        assert (written == 1).all()
    return out, n_emit


@pytest.mark.parametrize("c", [16384, 40000, 4076, 1])
@pytest.mark.parametrize("flags", ["all", "none", "random"])
def test_compact_tiled_matches_ref(c, flags):
    """The compaction kernel's tiles, per-thread runs, carried count and
    staged stores equal compact_ref bit for bit: at the main path's 16,384
    (one tile), at 40,000 (three tiles, the count carried twice), and at
    4,076 and 1 (the scalar path), with every flag set, none set, and random
    flags of any nonzero value."""
    rng = np.random.default_rng(c)
    n = 3
    val = rng.integers(0, 65536, (n, c)).astype(np.uint16)
    if flags == "all":
        flag = np.ones((n, c), np.uint8)
    elif flags == "none":
        flag = np.zeros((n, c), np.uint8)
    else:
        flag = np.where(rng.random((n, c)) < 0.4,
                        rng.choice([1, 7, 128, 255], (n, c)), 0).astype(np.uint8)
    got = _compact_tiled(val, flag)
    payload, n_emit = A.compact_ref(_t(val.view(np.int16)), _t(flag))
    assert np.array_equal(got[0], payload.numpy().view(np.uint16))
    assert np.array_equal(got[1], n_emit.numpy())


@pytest.fixture(scope="module")
def decode_case():
    """The four chunks of test_decode_inverts_encode_interpret, encoded by
    the XLA reference: (chunks, payload bytes, n_emit, states, freq, cum)."""
    rng = np.random.default_rng(5)
    chunks = np.stack([
        (rng.zipf(1.4, CHUNK) % 230).astype(np.uint8),
        np.clip(rng.normal(100, 2, CHUNK), 0, 255).astype(np.uint8),
        rng.integers(0, 256, CHUNK).astype(np.uint8),
        np.zeros(CHUNK, np.uint8),
    ])
    freq, cum, _, _ = _chunk_stats(chunks)
    p, ne, st = jans.ans0_encode_chunks(jnp.asarray(chunks),
                                        jnp.asarray(freq, jnp.int32),
                                        jnp.asarray(cum, jnp.int32))
    p, ne, st = np.asarray(p), np.asarray(ne), np.asarray(st)
    maxb = ((int(ne.max()) * 2 + 130) // 128 + 2) * 128
    pay = np.zeros((4, maxb), np.uint8)
    for i in range(4):
        pay[i, :ne[i] * 2] = p[i, :ne[i]].astype(">u2").view(np.uint8)
    return chunks, pay, ne, st, freq, cum


@pytest.mark.parametrize("reference", ["pallas", "xla"])
def test_decode_ref_matches_jax(decode_case, reference):
    chunks, pay, ne, st, freq, cum = decode_case
    dec = P.ans0_decode_chunks_pallas if reference == "pallas" else jans.ans0_decode_chunks
    want_out, want_used = dec(jnp.asarray(pay), jnp.asarray(st, jnp.int32),
                              jnp.asarray(freq, jnp.int32), jnp.asarray(cum, jnp.int32))
    out, used = A.decode_ref(_t(pay), _t(np.full(4, pay.shape[1], np.int32)),
                             _t(st.astype(np.int64)), _t(freq), _t(cum))
    assert np.array_equal(out.numpy(), np.asarray(want_out))
    assert np.array_equal(used.numpy(), np.asarray(want_used))
    assert np.array_equal(out.numpy(), chunks)
    assert np.array_equal(used.numpy(), ne * 2)


def test_full_encode_matches_xla():
    """hist_norm_ref -> tables -> encode_scan_ref -> compact_ref against
    ops/ans.ans0_encode_chunks with XLA-normalised tables."""
    chunks = _edge_chunks()
    freq_x = np.asarray(P._normalize_freqs_jax(P._hist16(jnp.asarray(chunks)),
                                               14, SCALE))
    cum_x = np.cumsum(freq_x, axis=1) - freq_x
    pay_x, ne_x, st_x = (np.asarray(a) for a in jans.ans0_encode_chunks(
        jnp.asarray(chunks), jnp.asarray(freq_x, jnp.int32),
        jnp.asarray(cum_x, jnp.int32)))

    freq = A.hist_norm_ref(_t(chunks))
    _, tables = A.make_tables(freq)
    words, flags, states = A.encode_scan_ref(_t(chunks), tables)
    payload, n_emit = A.compact_ref(words, flags)
    assert np.array_equal(freq.numpy(), freq_x)
    assert np.array_equal(n_emit.numpy(), ne_x)
    assert np.array_equal(states.numpy(), st_x)
    payload = payload.numpy().view(np.uint16)
    for i in range(len(chunks)):
        assert np.array_equal(payload[i, :ne_x[i]], pay_x[i, :ne_x[i]])
        assert not payload[i, ne_x[i]:].any()

    # the numpy-contract entry points give the same arrays
    f2, p2, n2, s2 = A.ans0_encode_device(chunks, "cpu")
    assert np.array_equal(f2, freq_x) and np.array_equal(n2, ne_x)
    assert np.array_equal(s2, st_x) and np.array_equal(p2, payload)
    p3, n3, s3 = A.ans0_encode_chunks(chunks, freq_x, cum_x, "cpu")
    assert np.array_equal(p3, payload) and np.array_equal(n3, ne_x)
    assert np.array_equal(s3, st_x)


def _division_edge_case():
    """(freq, cum, chunks): 30 rows of 4,096 bytes of five symbols, f = 4095
    beside f = 1, 3, 37 and 700 (and f = 0 for the absent ones), cum 1 under
    the 4095, so that states just under 2^31 are divided by 4095."""
    n, c = 30, 4096
    freq = np.zeros((n, 256), np.int64)
    cum = np.zeros((n, 256), np.int64)
    freq[:, :5] = [4095, 1, 3, 37, 700]
    cum[:, 0] = 1
    chunks = np.stack([np.random.default_rng(s).choice(
        5, c, p=[0.5, 0.1, 0.1, 0.15, 0.15]).astype(np.uint8) for s in range(n)])
    return freq, cum, chunks


def test_encode_scan_ref_division_edge():
    """f = 4095 dividing states just under 2^31 (quotients near 2^19), where
    the TPU's f32 quotient needs its correction: encode_scan_ref against
    ops/ans.ans0_encode_chunks on tables that drive the states there."""
    freq, cum, chunks = _division_edge_case()
    n, c = chunks.shape
    pay_x, ne_x, st_x = (np.asarray(a) for a in jans.ans0_encode_chunks(
        jnp.asarray(chunks), jnp.asarray(freq, jnp.int32),
        jnp.asarray(cum, jnp.int32)))
    tables = _t((np.minimum(freq, 4095) | (cum << 12)).astype(np.int32))
    words, flags, states = A.encode_scan_ref(_t(chunks), tables)
    payload, n_emit = A.compact_ref(words, flags)
    assert np.array_equal(states.numpy(), st_x)
    assert np.array_equal(n_emit.numpy(), ne_x)
    payload = payload.numpy().view(np.uint16)
    for i in range(n):
        assert np.array_equal(payload[i, :ne_x[i]], pay_x[i, :ne_x[i]])
    # the edge was reached: a state within 2^21 of 2^31 divided by 4095
    best = 0
    for row in chunks:
        st = [1 << 15] * 4
        for t in range(c):
            s = int(row[c - 1 - t])
            f, x = min(int(freq[0, s]), 4095), st[t & 3]
            if (x >> 19) >= f:
                x >>= 16
            if f == 4095:
                best = max(best, x)
            st[t & 3] = ((x // f) << 12) + x % f + int(cum[0, s])
    assert best > (1 << 31) - (1 << 21)


def _encode_scan_recip(chunks, tables):
    """ANS0's encode scan as the kernel computes it: the doubled state
    st2 = 2 st stepped by ans1_cuda.ans_step_recip_ref at logRange 12 (the
    reciprocal of recip_table(12) in place of the divide), the emitted
    flag << 16 | val split into the word and the flag at the byte's own
    position, and the state written back as st2 >> 1."""
    rcp, shift = A1.recip_table(A.LOG_RANGE)
    n, c = chunks.shape
    lk = tables.long().gather(1, chunks.long())
    st2 = torch.full((n, 4), 2 * A.ANS_TOP, dtype=torch.int64)
    emit = torch.empty((n, c), dtype=torch.int64)
    for t in range(c // 4):
        cols = c - 1 - 4 * t - torch.arange(4)      # lane u codes byte c - 1 - 4t - u
        emit[:, cols], st2 = A1.ans_step_recip_ref(st2, lk[:, cols], A.LOG_RANGE, rcp, shift)
    words = torch.where(emit >> 16 != 0, emit & 0xFFFF, 0)
    return A._i16(words), (emit >> 16).to(torch.uint8), (st2 >> 1).to(torch.int32)


@pytest.mark.parametrize("case", ["edge_rows", "division_edge"])
def test_encode_scan_recip_matches_ref(case):
    """The kernel's arithmetic on doubled states with a reciprocal equals
    encode_scan_ref bit for bit: on the edge rows (one byte, capped to
    4095; one dominant byte; uniform; skewed; corpus text) with their
    normalised tables, and on the division-edge tables."""
    if case == "edge_rows":
        chunks = _t(_edge_chunks())
        _, tables = A.make_tables(A.hist_norm_ref(chunks))
    else:
        freq, cum, ch = _division_edge_case()
        chunks = _t(ch)
        tables = _t((np.minimum(freq, 4095) | (cum << 12)).astype(np.int32))
    got = _encode_scan_recip(chunks, tables)
    want = A.encode_scan_ref(chunks, tables)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _decode_scalar(pay, length, states, freq):
    """Python-int oracle of one chunk's decode (no fixed width)."""
    cum = np.cumsum(freq) - freq
    lut = np.repeat(np.arange(256), freq)
    st = [int(s) for s in states]
    out = np.empty(CHUNK, np.uint8)
    ptr = 0
    for t in range(CHUNK // 4):
        for j in range(4):
            sym = int(lut[st[j] & 4095])
            out[4 * t + 3 - j] = sym
            st[j] = min(int(freq[sym]), 4095) * (st[j] >> 12) + (st[j] & 4095) - int(cum[sym])
        for j in (3, 2, 1, 0):
            if st[j] < (1 << 15):
                b0 = int(pay[ptr]) if ptr < length else 0
                b1 = int(pay[ptr + 1]) if ptr + 1 < length else 0
                st[j] = (st[j] << 16) | (b0 << 8) | b1
                ptr += 2
    return out, ptr


def test_decode_ref_unsigned_states_and_bounded_reads(decode_case):
    """Stream states are 32-bit unsigned: values >= 2^31 must neither wrap
    nor sign-extend, and reads stop at the row's real length."""
    _, pay, ne, st, freq, cum = decode_case
    states = st[:1].astype(np.int64)
    states[0, [0, 2]] = [0xFFFFFFFF, (1 << 31) + 12345]
    length = int(ne[0]) * 2 - 6
    out, used = A.decode_ref(_t(pay[:1]), _t(np.array([length], np.int32)),
                             _t(states), _t(freq[:1]), _t(cum[:1]))
    want_out, want_used = _decode_scalar(pay[0], length, states[0], freq[0])
    assert np.array_equal(out.numpy()[0], want_out)
    assert int(used[0]) == want_used
    assert want_used != length        # the host glue rejects this chunk


def test_launch_counter_is_thread_safe():
    """The stream's thread pool launches kernels from several threads at
    once; no count may be lost."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        A.reset_launches()
        threads = [threading.Thread(target=lambda: [A._count("ans0_decode")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert A.launches["ans0_decode"] == 16 * 2000
    finally:
        sys.setswitchinterval(old)
        A.reset_launches()


def _decode_via_tables(pay, length, states, freq, cum):
    """One chunk decoded through decode_tables_ref's slot-indexed arrays, step
    by step as the kernel runs it: st' = f (st >> 12) + d mod 2^32, then the
    refills, lane 3 first, a byte at or past ``length`` reading as 0."""
    sym, f, d = (t[0].numpy() for t in A.decode_tables_ref(_t(freq[None]), _t(cum[None])))
    st = [int(s) & 0xFFFFFFFF for s in states]
    out = np.empty(CHUNK, np.uint8)
    ptr = 0
    for t in range(CHUNK // 4):
        for j in range(4):
            slot = st[j] & 4095
            out[4 * t + 3 - j] = sym[slot]
            st[j] = (int(f[slot]) * (st[j] >> 12) + int(d[slot])) & 0xFFFFFFFF
        for j in (3, 2, 1, 0):
            if st[j] < (1 << 15):
                b0 = int(pay[ptr]) if ptr < min(length, len(pay)) else 0
                b1 = int(pay[ptr + 1]) if ptr + 1 < min(length, len(pay)) else 0
                st[j] = ((st[j] << 16) | (b0 << 8) | b1) & 0xFFFFFFFF
                ptr += 2
    return out, ptr


def test_decode_tables_ref_decodes_like_jax(decode_case):
    """The kernel's slot-indexed tables decode the four chunks as decode_ref
    and kanzi_tpu's XLA decoder do."""
    chunks, pay, ne, st, freq, cum = decode_case
    sym, f, d = A.decode_tables_ref(_t(freq), _t(cum))
    assert sym.dtype == torch.uint8 and sym.shape == f.shape == d.shape == (4, SCALE)
    want_out, want_used = jans.ans0_decode_chunks(
        jnp.asarray(pay), jnp.asarray(st, jnp.int32), jnp.asarray(freq, jnp.int32),
        jnp.asarray(cum, jnp.int32))
    ref_out, ref_used = A.decode_ref(_t(pay), _t(np.full(4, pay.shape[1], np.int32)),
                                     _t(st.astype(np.int64)), _t(freq), _t(cum))
    for i in range(4):
        out, used = _decode_via_tables(pay[i], pay.shape[1], st[i], freq[i], cum[i])
        assert np.array_equal(out, chunks[i]) and used == ne[i] * 2
        assert np.array_equal(out, ref_out.numpy()[i]) and used == int(ref_used[i])
        assert np.array_equal(out, np.asarray(want_out)[i])
        assert used == int(np.asarray(want_used)[i])


def _corrupt_table(kind, freq, cum):
    f, c = freq.astype(np.int64), cum.astype(np.int64)
    if kind == "non_monotone":
        c = c[::-1].copy()                       # bounds fall, then rise again
    elif kind == "sum_over_4096":
        f = f * 2
        c = np.cumsum(f) - f
    elif kind == "f_zero":
        k = int(np.flatnonzero(f)[len(np.flatnonzero(f)) // 2])
        f[k], c[k] = 0, 5000                     # a zero-frequency symbol holds slots
    else:                                        # f_4096: one symbol, capped to 4095
        f, c = np.zeros(256, np.int64), np.zeros(256, np.int64)
        f[9] = 4096
    return f, c


@pytest.mark.parametrize("kind", ["non_monotone", "sum_over_4096", "f_zero", "f_4096"])
def test_decode_tables_ref_on_corrupt_tables(decode_case, kind):
    """Tables no valid stream holds decode through the slot-indexed arrays
    exactly as decode_ref decodes them, consumed count included."""
    _, pay, ne, st, freq, cum = decode_case
    f, c = _corrupt_table(kind, freq[0], cum[0])
    length = int(ne[0]) * 2
    out, used = A.decode_ref(_t(pay[:1]), _t(np.array([length], np.int32)),
                             _t(st[:1].astype(np.int64)), _t(f[None]), _t(c[None]))
    got_out, got_used = _decode_via_tables(pay[0], length, st[0], f, c)
    assert np.array_equal(got_out, out.numpy()[0])
    assert got_used == int(used[0])
    if kind == "f_4096":
        sym, fs, _ = A.decode_tables_ref(_t(f[None]), _t(c[None]))
        assert bool((sym == 9).all()) and int(fs.max()) == 4095
