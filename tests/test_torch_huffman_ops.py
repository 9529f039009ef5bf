"""The port's plain Huffman kernels (kanzi_tpu_torch/ops/huffman_cuda.py) and
its decode tables (ops/huffman_block.py) against kanzi_tpu's JAX functions,
on the same numpy inputs, at zero tolerance: the wire format leaves none.
Pallas kernels run in interpret mode, as tests/test_pallas_interpret.py runs
them; each runs once, in a module-scoped fixture."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanzi_tpu.entropy.huffman import build_tables_batch
from kanzi_tpu.ops import huffman_decode_pallas as HD
from kanzi_tpu.ops import huffman_pallas as HE
from kanzi_tpu_torch.ops import huffman_block as B
from kanzi_tpu_torch.ops import huffman_cuda as H

CHUNK = 16384
STREAM = CHUNK // 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fib_chunk(rng):
    """Fibonacci-distributed frequencies: an unlimited code would be 19
    bits deep, so the lengths hit the 12-bit limit."""
    f = [1, 1]
    while len(f) < 19:
        f.append(f[-1] + f[-2])
    f.append(CHUNK - sum(f))
    return rng.permutation(np.repeat(np.arange(40, 60, dtype=np.uint8), f))


def _chunks():
    """zipf, one symbol, all 256 symbols, length-limited."""
    rng = np.random.default_rng(11)
    return np.stack([
        (rng.zipf(1.3, CHUNK) % 256).astype(np.uint8),
        np.full(CHUNK, 77, np.uint8),
        rng.permutation(np.repeat(np.arange(256, dtype=np.uint8), CHUNK // 256)),
        _fib_chunk(rng),
    ])


def _tables(chunks):
    hists = np.stack([np.bincount(c, minlength=256) for c in chunks]).astype(np.int64)
    sizes, codes, nsym = build_tables_batch(hists)
    tbl = ((sizes << 12) | codes).astype(np.uint16).view(np.int32)
    return hists, sizes, codes, nsym, tbl


def _payload(words, n_words, acc, nbits):
    """Each chunk's four streams, byte-aligned, at 6,656-byte strides."""
    n = len(n_words) // 4
    pay = np.zeros((n, H.PAY_WIDTH), np.uint8)
    for r in range(4 * n):
        w, p = int(n_words[r]), int(nbits[r])
        data = words[r, :w].astype(">u2").tobytes()
        if p:
            nby = (p + 7) // 8
            data += ((int(acc[r]) & ((1 << p) - 1)) << (8 * nby - p)).to_bytes(nby, "big")
        i, j = divmod(r, 4)
        pay[i, j * H.PAY_STRIDE:j * H.PAY_STRIDE + len(data)] = np.frombuffer(data, np.uint8)
    return pay


@pytest.fixture(scope="module")
def case():
    """The Pallas encode of the four chunks and the Pallas decode of its
    wire, each run once (interpret mode)."""
    chunks = _chunks()
    hists, sizes, _, nsym, tbl = _tables(chunks)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KANZI_TPU_PALLAS_INTERPRET", "1")
        enc = tuple(np.asarray(a) for a in HE.huffman_encode_streams(
            jnp.asarray(chunks), jnp.asarray(tbl)))
        pay = _payload(*enc)
        alphabets = [np.flatnonzero(h) for h in hists]
        bnd, adj, perm = HD.build_decode_tables(list(sizes), alphabets)
        dec = tuple(np.asarray(a) for a in HD.huffman_decode_chunks_pallas(
            jnp.asarray(pay), jnp.asarray(bnd), jnp.asarray(adj), jnp.asarray(perm)))
    return {"chunks": chunks, "sizes": sizes, "nsym": nsym, "tbl": tbl,
            "alphabets": alphabets, "enc": enc, "pay": pay,
            "tables": (bnd, adj, perm), "dec": dec}


def test_case_covers_the_edges(case):
    assert list(case["nsym"]) == [case["nsym"][0], 1, 256, 20]
    assert case["sizes"][3].max() == 12          # the limit is reached
    assert case["sizes"][0].max() > 8


def test_encode_streams_ref_matches_pallas(case):
    words, n_words, acc, nbits = H.encode_streams_ref(_t(case["chunks"]), _t(case["tbl"]))
    w_p, nw_p, acc_p, nb_p = case["enc"]
    assert np.array_equal(words.numpy().view(np.uint16), w_p)
    assert np.array_equal(n_words.numpy(), nw_p)
    assert np.array_equal(acc.numpy(), acc_p)
    assert np.array_equal(nbits.numpy(), nb_p)
    # the numpy-contract entry point gives the same arrays
    for got, want in zip(H.huffman_encode_streams(case["chunks"], case["tbl"], "cpu"),
                         case["enc"]):
        assert np.array_equal(got, want)


def test_decode_chunks_ref_matches_pallas(case):
    bnd, adj, perm = case["tables"]
    syms, used = H.decode_chunks_ref(_t(case["pay"]), _t(bnd), _t(adj), _t(perm))
    syms_p, used_p = case["dec"]
    assert np.array_equal(syms.numpy(), syms_p)
    assert np.array_equal(used.numpy(), used_p)
    _, n_words, _, nbits = case["enc"]
    assert np.array_equal(syms.numpy(), case["chunks"])
    assert np.array_equal(used.numpy().reshape(-1), 16 * n_words + nbits)
    got = H.huffman_decode_chunks(case["pay"], bnd, adj, perm, "cpu")
    assert np.array_equal(got[0], syms_p) and np.array_equal(got[1], used_p)


def test_build_decode_tables_matches_reference(case):
    got = B.build_decode_tables(list(case["sizes"]), case["alphabets"])
    for a, b in zip(got, case["tables"]):
        assert a.dtype == np.int32 and np.array_equal(a, b)
    # random valid alphabets and lengths, lengths of absent symbols arbitrary
    rng = np.random.default_rng(3)
    hists = np.where(rng.random((24, 256)) < rng.random((24, 1)),
                     rng.zipf(1.5, (24, 256)), 0).astype(np.int64)
    hists[:, 0] += 1
    sizes, _, _ = build_tables_batch(hists)
    sizes = np.where(hists > 0, sizes, rng.integers(0, 13, sizes.shape))
    alphabets = [np.flatnonzero(h) for h in hists]
    for a, b in zip(B.build_decode_tables(list(sizes), alphabets),
                    HD.build_decode_tables(list(sizes), alphabets)):
        assert np.array_equal(a, b)


def test_hist_ref_matches_bincount():
    rng = np.random.default_rng(4)
    chunks = np.concatenate([_chunks(), rng.integers(0, 256, (3, CHUNK), dtype=np.uint8)])
    got = H.hist_ref(_t(chunks)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, np.stack([np.bincount(c, minlength=256) for c in chunks]))
    assert np.array_equal(H.hist(_t(chunks)).numpy(), got)


def _encode_scalar(stream, tbl16):
    """Python-int oracle of one stream's packing (codes masked to length)."""
    acc = nb = 0
    words = []
    for b in stream:
        e = int(tbl16[b])
        ln = e >> 12
        acc = (acc << ln) | (e & 0xFFF & ((1 << ln) - 1))
        nb += ln
        if nb >= 16:
            nb -= 16
            words.append((acc >> nb) & 0xFFFF)
            acc &= (1 << nb) - 1
    return words, acc, nb


def test_encode_streams_ref_any_table():
    """Tables build_tables_batch never makes (lengths up to 15, codes wider
    than their length): the plain version, which the kernel must equal on
    every row, packs what the scalar definition packs."""
    rng = np.random.default_rng(6)
    chunks = rng.integers(0, 256, (2, CHUNK), dtype=np.uint8)
    tbl16 = rng.integers(0, 1 << 16, (2, 256)).astype(np.uint16)
    words, n_words, acc, nbits = H.encode_streams_ref(_t(chunks), _t(tbl16.view(np.int32)))
    words = words.numpy().view(np.uint16)
    for r in range(8):
        i, j = divmod(r, 4)
        w, a, nb = _encode_scalar(chunks[i, j * STREAM:(j + 1) * STREAM], tbl16[i])
        assert int(n_words[r]) == len(w) and int(acc[r]) == a and int(nbits[r]) == nb
        assert np.array_equal(words[r, :len(w)], w)
        assert not words[r, len(w):].any()


def _encode_split_runs(chunks, tbl16, lanes):
    """huffman_encode_kernel's packing (csrc/huffman.cu), modelled in numpy:
    each stream cut into ``lanes`` runs, each run's lengths summed, an
    exclusive scan giving each run's bit offset o, then every run packed in
    lock-step into 32-bit pairs (bits 32p .. 32p + 31, MSB-first, swapped
    halfwise so that word 2p is the low half) from a 64-bit buffer that
    starts with o & 31 zero bits: a pair whose bits are all the run's own is
    stored, the run's first pair (when o & 31 != 0) and its last, partial
    one are ORed in.  Asserts that no stored pair is written twice or ORed,
    which is what lets the kernel store it without an atomic.  Returns the
    wrapper's four outputs as numpy arrays."""
    n = chunks.shape[0]
    e = tbl16.astype(np.uint64)
    ln = e >> 12
    code = e & 0xFFF & ((np.uint64(1) << ln) - 1)
    sym = chunks.reshape(4 * n, STREAM).astype(np.int64)
    src = np.repeat(np.arange(n), 4)[:, None]
    lens = ln[src, sym].reshape(4 * n, lanes, -1)
    codes = code[src, sym].reshape(4 * n, lanes, -1)
    bits = lens.sum(axis=2)
    total = bits.sum(axis=1).astype(np.int64)
    o = np.cumsum(bits, axis=1) - bits
    pairs = np.zeros((4 * n, STREAM // 2), np.uint64)
    stored = np.zeros(pairs.shape, np.int64)
    ored = np.zeros(pairs.shape, np.int64)
    p0 = o >> 5
    lead = (o & 31) != 0
    p, nb = p0.copy(), o & 31
    acc = np.zeros(o.shape, np.uint64)
    s_idx = np.broadcast_to(np.arange(4 * n)[:, None], o.shape)

    def put(mask, v, atomic):
        si, pi, vi = s_idx[mask], p[mask], v[mask]
        if atomic:
            np.bitwise_or.at(pairs, (si, pi), vi)
            np.add.at(ored, (si, pi), 1)
        else:
            pairs[si, pi] = vi
            np.add.at(stored, (si, pi), 1)

    def as_pair(v):
        v &= np.uint64(0xFFFFFFFF)
        return ((v & np.uint64(0xFFFF)) << np.uint64(16)) | (v >> np.uint64(16))

    for t in range(lens.shape[2]):
        acc = (acc << lens[:, :, t]) | codes[:, :, t]
        nb = nb + lens[:, :, t]
        em = nb >= 32
        nb = np.where(em, nb - 32, nb)
        v = as_pair(acc >> nb)
        atom = em & lead & (p == p0)
        put(atom, v, True)
        put(em & ~atom, v, False)
        p = p + em
    put(nb > 0, as_pair(acc << (np.uint64(32) - nb)), True)
    assert stored.max() <= 1 and not (ored[stored > 0]).any()
    w = np.empty((4 * n, STREAM), np.uint64)
    w[:, 0::2] = pairs & np.uint64(0xFFFF)
    w[:, 1::2] = pairs >> np.uint64(16)
    n_words, nbits = total >> 4, total & 15
    last = w[np.arange(4 * n), n_words].astype(np.int64)
    acc_out = np.where(nbits > 0, last >> (16 - nbits), 0)
    w[np.arange(STREAM)[None, :] >= n_words[:, None]] = 0
    return w.astype(np.uint16), n_words, acc_out, nbits


def _split_runs_case(kind):
    rng = np.random.default_rng(12)
    if kind == "edge_rows":
        chunks = _chunks()
        return chunks, _tables(chunks)[4].view(np.uint16)
    chunks = rng.integers(0, 256, (2, CHUNK), dtype=np.uint8)
    if kind == "any_table":
        return chunks, rng.integers(0, 1 << 16, (2, 256)).astype(np.uint16)
    return chunks, ((15 << 12) | rng.integers(0, 1 << 16, (2, 256)) & 0xFFF).astype(np.uint16)


@pytest.mark.parametrize("kind,lanes", [("edge_rows", 128), ("any_table", 128),
                                        ("all_15_bit", 128), ("any_table", 32)])
def test_encode_split_runs_matches_ref(kind, lanes):
    """The kernel's packing by runs at bit offsets from a prefix sum equals
    encode_streams_ref bit for bit: on the edge rows (zipf, one symbol, all
    256, Fibonacci lengths at the 12-bit limit) with their tables, on random
    16-bit entries (lengths up to 15 and 0, codes wider than their length),
    on an all-15-bit table (3,840 words a stream, the most a row holds),
    at the kernel's 128 runs a stream and at 32."""
    chunks, tbl16 = _split_runs_case(kind)
    got = _encode_split_runs(chunks, tbl16, lanes)
    want = H.encode_streams_ref(_t(chunks), _t(tbl16.view(np.int32)))
    assert np.array_equal(got[0], want[0].numpy().view(np.uint16))
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g, w.numpy())
    if kind == "all_15_bit":
        assert (want[1].numpy() == 3840).all()
    if kind == "edge_rows":
        assert got[3].any() and (got[3] == 0).any()     # partial and whole last words


def _decode_scalar(seg, lens, syms):
    bits = np.unpackbits(np.concatenate([seg, np.zeros(4, np.uint8)]))
    pos = 0
    out = []
    for _ in range(STREAM):
        v = int("".join(map(str, bits[pos:pos + 12])).ljust(12, "0"), 2)
        out.append(syms[v])
        pos += lens[v]
    return out, pos


def test_decode_chunks_ref_corrupt_stream(case):
    """An incomplete code (one symbol of length 12): windows past the last
    code decode to symbol 0 and advance 13 bits, and bits past the segment
    read as 0, as in the scalar definition."""
    sizes = np.full(256, 8, np.int64)
    sizes[200] = 12
    bnd, adj, perm = B.build_decode_tables([sizes], [np.array([200])])
    rng = np.random.default_rng(8)
    pay = rng.integers(0, 256, (1, H.PAY_WIDTH), dtype=np.uint8)
    syms, used = H.decode_chunks_ref(_t(pay), _t(bnd), _t(adj), _t(perm))
    lens, symt = (a.numpy()[0] for a in H._window_tables(_t(bnd), _t(adj), _t(perm)))
    assert set(np.unique(symt)) == {0, 200} and lens.max() == 13
    for j in range(4):
        seg = pay[0, j * H.PAY_STRIDE:(j + 1) * H.PAY_STRIDE]
        want, pos = _decode_scalar(seg, lens, symt)
        assert np.array_equal(syms.numpy()[0, j * STREAM:(j + 1) * STREAM], want)
        assert int(used[0, j]) == pos
        assert pos + 12 > 8 * H.PAY_STRIDE      # the last windows ran past the segment


def test_decode_chunks_ref_all_ones_ends_at_segment_end():
    """The incomplete code on all-ones payload bytes: every window is past
    the last code, so every step advances 13 bits and each stream ends
    exactly at its segment's end, bit 53,248 = 8 x 6,656, having read no
    bit past it (the decode kernel's refill reads ahead of that position,
    into zero fill)."""
    sizes = np.full(256, 8, np.int64)
    sizes[200] = 12
    bnd, adj, perm = B.build_decode_tables([sizes], [np.array([200])])
    pay = np.full((1, H.PAY_WIDTH), 255, np.uint8)
    syms, used = H.decode_chunks_ref(_t(pay), _t(bnd), _t(adj), _t(perm))
    lens, symt = (a.numpy()[0] for a in H._window_tables(_t(bnd), _t(adj), _t(perm)))
    assert lens[4095] == 13 and symt[4095] == 0
    assert np.array_equal(used.numpy(), np.full((1, 4), 13 * STREAM))
    assert 13 * STREAM == 8 * H.PAY_STRIDE
    assert not syms.numpy().any()
    want, pos = _decode_scalar(pay[0, :H.PAY_STRIDE], lens, symt)
    assert pos == 13 * STREAM and not any(want)


def test_wrappers_refuse_other_devices():
    meta = torch.empty((2, CHUNK), dtype=torch.uint8, device="meta")
    for call in (lambda: H.hist(meta),
                 lambda: H.encode_streams(meta, torch.empty((2, 128), dtype=torch.int32,
                                                            device="meta"))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    with pytest.raises(ValueError, match="unsupported device"):
        H.huffman_encode_streams(np.zeros((1, CHUNK), np.uint8),
                                 np.zeros((1, 128), np.int32), "meta")
