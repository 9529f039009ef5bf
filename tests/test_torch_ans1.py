"""The port's order-1 ANS encode (kanzi_tpu_torch/ops/ans1_cuda.py, the
ops/ans_block.py glue and the entropy/ans.py gate) against kanzi_tpu's JAX
functions and host coders, on the same numpy inputs, at zero tolerance:
bit-exactness is the contract.  Pallas kernels run in interpret mode, as
tests/test_pallas_interpret.py runs them."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanzi_tpu.core.bits import BitWriter as JBitWriter
from kanzi_tpu.entropy import ans as jhans
from kanzi_tpu.entropy.utils import normalize_frequencies_batch
from kanzi_tpu.ops import ans as jans
from kanzi_tpu.ops import ans_pallas as P
from kanzi_tpu.utils.corpus import mixed_corpus
from kanzi_tpu_torch.core.bits import BitReader, BitWriter
from kanzi_tpu_torch.entropy.ans import ANSRangeDecoder, ANSRangeEncoder
from kanzi_tpu_torch.ops import ans1_cuda as A
from kanzi_tpu_torch.ops import ans_block
from kanzi_tpu_torch.utils.native_coders import ans_encode_native

C = 16384          # narrow chunks: the plain scan takes ~40 s for 4 MiB here
CHUNK1 = 4 << 20


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("KANZI_TPU_PALLAS_INTERPRET", "1")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tables(chunks):
    """kanzi_tpu's order-1 statistics (ops/ans_block.py ans1_encode):
    freq, cum (N, 256, 256) int64."""
    freq = np.zeros((len(chunks), 256, 256), np.int64)
    for i, ch in enumerate(chunks):
        h2 = jhans._order1_histogram(ch.astype(np.int64))
        freq[i] = normalize_frequencies_batch(h2, h2.sum(axis=1), 2048)
    return freq, np.cumsum(freq, axis=2) - freq


def _chunks(kind):
    rng = np.random.default_rng(3)
    if kind == "corpus":
        return mixed_corpus(2 * C, seed=7).reshape(2, C)
    # one repeated byte (every context single-symbol: freq 2048, capped to
    # 2047) and uniform random bytes
    return np.stack([np.full(C, 200, np.uint8), rng.integers(0, 256, C).astype(np.uint8)])


@pytest.mark.parametrize("kind", ["corpus", "edges"])
def test_lookup1_ref_matches_pallas(kind):
    chunks = _chunks(kind)
    freq, cum = _tables(chunks)
    n, c = chunks.shape
    # the f32 table and the context of ans_pallas.py:945-951
    packed = np.minimum(freq, 2047) | (cum << 11)
    tbl = jnp.asarray(packed.astype(np.float32).reshape(n, 512, 128))
    pos = np.arange(c)
    ctx = np.where(pos % (c // 4) == 0, 0, np.roll(chunks, 1, axis=1)).astype(np.uint8)
    want = np.asarray(P._lookup1(jnp.asarray(ctx), jnp.asarray(chunks), tbl))
    got = A.lookup1_ref(_t(chunks), A.pack_tables(_t(freq), _t(cum))).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    if kind == "edges":
        assert (got[0] & 2047 == 2047).all()          # the cap of freq 2048


def _scan_case(lr, s):
    """(S, 1, 128) packed lanes: 100 live lanes mixing freq 2^lr - 1, freq 1
    and random (f, cum) pairs of valid tables, then 28 inert (1, 0) lanes,
    as ans1_encode_chunks_pallas pads them."""
    rng = np.random.default_rng(lr * 1000 + s)
    scale = 1 << lr
    f = rng.integers(1, scale, (s, 128))
    kind = rng.integers(0, 4, (s, 128))
    f = np.where(kind == 0, scale - 1, np.where(kind == 1, 1, f))
    cum = rng.integers(0, scale - f + 1)
    f[:, 100:], cum[:, 100:] = 1, 0
    return (f | (cum << lr)).astype(np.int32).reshape(s, 1, 128)


def _max_state(lk, lr):
    """Largest state the lanes reach (a numpy walk of the same scan)."""
    x = lk.reshape(lk.shape[0], -1).astype(np.int64)
    st = np.full(x.shape[1], 1 << 15, np.int64)
    best = 0
    for row in x:
        f, cm = row & ((1 << lr) - 1), row >> lr
        st = np.where((st >> (31 - lr)) >= f, st >> 16, st)
        st = (st // f << lr) + st % f + cm
        best = max(best, int(st.max()))
    return best


@pytest.mark.parametrize("lr", [11, 12])
@pytest.mark.parametrize("steps", [256, 4096])
def test_scan_ref_matches_pallas(lr, steps):
    lk = _scan_case(lr, steps)
    emit, st = P._scan(jnp.asarray(lk), lr=lr)
    got_emit, got_st = A.scan_ref(_t(lk), lr)
    assert got_emit.dtype == torch.int32 and got_emit.shape == (steps, 1, 128)
    assert np.array_equal(got_emit.numpy(), np.asarray(emit))
    assert np.array_equal(got_st.numpy(), np.asarray(st))
    if steps == 4096:                                  # the int32 edge was reached
        assert _max_state(lk, lr) > (1 << 31) - (1 << 22)


@pytest.mark.parametrize("lr", [11, 12])
def test_recip_table_matches_floor_division(lr):
    """The kernel's reciprocal against //, for every f in [1, 2^lr - 1]: x at
    0, 1, f - 1, f, f + 1, the edge of renormalisation (f << (31 - lr)) and
    the multiples of f next to the top of the domain (every state below
    2^31), and 2,000 random x a frequency; the shift by 16 more, which
    divides the renormalised state x >> 16 of an emitting step."""
    rcp, shift = A.recip_table(lr)
    f = np.arange(1, 1 << lr, dtype=np.int64)[:, None]
    top, edge = 1 << 31, f << (31 - lr)
    near = top // f * f
    x = np.concatenate([np.zeros_like(f), np.ones_like(f), f - 1, f, f + 1, edge - 1, edge,
                        near - f - 1, near - f, near - 1, np.full_like(f, top - 1),
                        np.random.default_rng(lr).integers(0, top, (f.size, 2000))], axis=1)
    x, ft = torch.from_numpy(np.clip(x, 0, top - 1)), torch.from_numpy(f)
    h = A.umulhi_ref(2 * x, rcp[ft])
    assert torch.equal(h >> shift[ft], x // ft)
    assert torch.equal(h >> (shift[ft] + 16), (x >> 16) // ft)
    assert int(rcp[1]) == 1 << 31 and int(shift[1]) == 0      # f = 1: q = x exactly


@pytest.mark.parametrize("lr", [11, 12])
def test_recip_step_matches_pallas_scan(lr):
    """The kernel's step, reciprocal and doubled state and all, over
    _scan_case's 4,096 steps (freq 1, freq 2^lr - 1, states at the int32
    edge) equals kanzi_tpu's _scan bit for bit."""
    lk = _scan_case(lr, 4096)
    emit, st = P._scan(jnp.asarray(lk), lr=lr)
    rcp, shift = A.recip_table(lr)
    x = torch.from_numpy(lk.reshape(4096, 128).astype(np.int64))
    st2 = torch.full((128,), 2 << 15, dtype=torch.int64)
    words = torch.empty_like(x)
    for t in range(4096):
        words[t], st2 = A.ans_step_recip_ref(st2, x[t], lr, rcp, shift)
    assert np.array_equal(words.numpy().reshape(lk.shape), np.asarray(emit))
    assert np.array_equal((st2 >> 1).numpy(), np.asarray(st).reshape(128))


@pytest.mark.parametrize("rate", [0.0, 0.25, 0.75, 1.0])
def test_compact_ref_matches_pallas(rate):
    rng = np.random.default_rng(int(rate * 100))
    m, nb = 4, 128
    flag = rng.random((m, nb, 128)) < rate
    val = rng.integers(0, 65536, (m, nb, 128))
    e = np.where(flag, (1 << 16) | val, 0).astype(np.int32)
    pay, cnt = P._compact(jnp.asarray(e))
    got_pay, got_cnt = A.compact_ref(_t(e))
    assert got_pay.dtype == torch.int16
    assert np.array_equal(got_pay.numpy().view(np.uint16), np.asarray(pay))
    assert np.array_equal(got_cnt.numpy(), np.asarray(cnt))
    assert np.array_equal(got_cnt.numpy(), flag.sum(axis=2))


def _compact1_tiled(e):
    """compact1_kernel (csrc/ans1.cu) modelled in numpy on e (M, nb, 128)
    int32: a CTA of NT = max(c / 32, 32) threads a tile of c = nb * 128
    words, thread t on the run [32 t, 32 t + 32) (empty past c), its flags
    w >> 16 != 0; its offset an exclusive scan of the runs' counts; its
    kept words staged at that offset, 8 zeros after the tile's count; the
    tile stored in groups of 8, staged words where 8 q < count, else
    zeros; block b's count the runs' counts summed by two xor-shuffles
    (offsets 1 and 2) and stored by lane 4 b.  Asserts that every output
    word and every count is written once.  Returns (payload u16 (M, nb,
    128), counts (M, nb))."""
    m, nb, _ = e.shape
    c = nb * 128
    nt = max(c // 32, 32)
    out = np.zeros((m, c), np.uint16)
    counts = np.zeros((m, nb), np.int64)
    for r in range(m):
        runs = np.zeros(nt * 32, np.uint32)
        runs[:c] = e[r].reshape(c).view(np.uint32)
        runs = runs.reshape(nt, 32)
        fl = (runs >> 16) != 0
        cnt = fl.sum(axis=1)
        off = np.cumsum(cnt) - cnt
        total = int(cnt.sum())
        stage = np.zeros(nt * 32 + 16, np.uint16)
        for t in np.flatnonzero(cnt):
            stage[off[t]:off[t] + cnt[t]] = runs[t][fl[t]] & 0xFFFF
        stage[total:total + 8] = 0
        written = np.zeros(c, np.int64)
        for q in range(c // 8):
            out[r, 8 * q:8 * q + 8] = stage[8 * q:8 * q + 8] if 8 * q < total else 0
            written[8 * q:8 * q + 8] += 1
        lanes = np.arange(nt)
        s1 = cnt + cnt[lanes ^ 1]
        s2 = s1 + s1[lanes ^ 2]
        stored = np.zeros(nb, np.int64)
        for t in lanes[(lanes % 4 == 0) & (lanes * 32 < c)]:
            counts[r, t // 4] = s2[t]
            stored[t // 4] += 1
        assert (written == 1).all() and (stored == 1).all()
    return out.reshape(m, nb, 128), counts


@pytest.mark.parametrize("nb", [1, 2, 64, 128])
@pytest.mark.parametrize("rate", [0.0, 0.25, 1.0])
def test_compact1_tiled_matches_ref(nb, rate):
    """The order-1 compaction kernel's runs, lane-group block counts, staged
    tile and zero fill equal compact_ref and kanzi_tpu's _compact bit for
    bit: at the main path's nb = 128 (a CTA of 512 threads), at 64 (256),
    and at 2 and 1 (a warp, of which 8 and 4 lanes hold words), with no
    word flagged, a quarter, and every one."""
    rng = np.random.default_rng(nb + int(rate * 100))
    m = 3
    flag = rng.random((m, nb, 128)) < rate
    val = rng.integers(0, 65536, (m, nb, 128))
    e = np.where(flag, (1 << 16) | val, val & rng.integers(0, 2, (m, nb, 128))).astype(np.int32)
    got_pay, got_cnt = _compact1_tiled(e)
    pay_r, cnt_r = A.compact_ref(_t(e))
    assert np.array_equal(got_pay, pay_r.numpy().view(np.uint16))
    assert np.array_equal(got_cnt, cnt_r.numpy())
    pay_p, cnt_p = P._compact(jnp.asarray(e))
    assert np.array_equal(got_pay, np.asarray(pay_p))
    assert np.array_equal(got_cnt, np.asarray(cnt_p))
    assert np.array_equal(got_cnt, flag.sum(axis=2))


@pytest.mark.parametrize("kind", ["corpus", "edges"])
def test_entry_points_match_reference(kind):
    chunks = _chunks(kind)
    freq, cum = _tables(chunks)
    f2, c2 = ans_block.order1_tables(chunks)
    assert np.array_equal(f2, freq) and np.array_equal(c2, cum)
    args = (jnp.asarray(chunks), jnp.asarray(freq, jnp.int32), jnp.asarray(cum, jnp.int32))

    pay_p, cnt_p, st_p = (np.asarray(a) for a in P.ans1_encode_chunks_pallas(*args))
    pay, cnt, st = A.ans1_encode_chunks_pallas(chunks, freq, cum, "cpu")
    assert pay.dtype == np.uint16 and cnt.shape == (2, 1, 128)
    assert np.array_equal(pay, pay_p)
    assert np.array_equal(cnt, cnt_p)
    assert np.array_equal(st, st_p)

    pay_x, ne_x, st_x = (np.asarray(a) for a in jans.ans1_encode_chunks(*args))
    pay, ne, st = A.ans1_encode_chunks(chunks, freq, cum, "cpu")
    assert np.array_equal(ne, ne_x) and np.array_equal(st, st_x)
    for i in range(2):
        assert np.array_equal(pay[i, :ne[i]], pay_x[i, :ne[i]])
        assert not pay[i, ne[i]:].any()


def test_gate_and_wire(monkeypatch):
    """4 MiB + 70,000 B of context-heavy data (tests/test_ans_pallas.py's
    ANS1 case) through the gate on the CPU: the port's stream equals its host
    coders' and kanzi_tpu's, the glue ran, a block of 4 MiB - 1 does not take
    it nor do non-default chunk sizes or log ranges, and the host decoder
    reads the stream back."""
    rng = np.random.default_rng(11)
    base = (rng.zipf(1.4, CHUNK1 + 70000) % 53).astype(np.uint8)
    data = np.convolve(base, np.ones(2), "same").astype(np.uint8) % 59

    calls = []
    real = ans_block.ans1_encode
    monkeypatch.setattr(ans_block, "ans1_encode",
                        lambda *a: calls.append(a[0].size) or real(*a))

    def encode(block, device, **kw):
        bw = BitWriter()
        assert ANSRangeEncoder(bw, 1, device=device, **kw).encode(block) == block.size
        return bw.getvalue()

    dev_bytes = encode(data, "cpu")
    assert calls == [data.size]
    assert dev_bytes == encode(data, None)
    jbw = JBitWriter()
    jhans.ANSRangeEncoder(jbw, 1).encode(data)
    assert dev_bytes == jbw.getvalue()
    out = ANSRangeDecoder(BitReader(dev_bytes), 1, device="cpu").decode(data.size)
    assert np.array_equal(np.asarray(out, np.uint8), data)

    short = data[:CHUNK1 - 1]
    assert encode(short, "cpu") == encode(short, None)
    for kw in ({"chunk_size": 8192}, {"log_range": 13}):  # non-default settings
        assert encode(data, "cpu", **kw) == encode(data, None, **kw)
    assert calls == [data.size]                        # only the first block took the glue


@pytest.mark.parametrize("size", [33, 70000, CHUNK1 - 1])
def test_tail_native_matches_numpy(size):
    """The order-1 tail: the native coder writes the bytes of the
    reference's numpy loop, from an unaligned bit position too."""
    rng = np.random.default_rng(size)
    seg = ((rng.zipf(1.3, size) + np.arange(size) // 997) % 61).astype(np.uint8)
    want, got, glue = BitWriter(), BitWriter(), BitWriter()
    for bw in (want, got, glue):
        bw.write_bits(5, 3)
    ANSRangeEncoder(want, 1)._encode_chunk(seg, want)
    assert ans_encode_native(seg, got, 1, 16384, 12)
    ans_block.encode_tail(seg, glue, 1)
    assert got.getvalue() == want.getvalue()
    assert glue.getvalue() == want.getvalue()


def test_ans1_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for CPU tensors."""
    meta = torch.empty((1, C), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        A.scan_chunks(meta, torch.empty((1, 65536), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        A.compact(torch.empty((1, 128, 128), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        A.ans1_encode_chunks(np.zeros((1, C), np.uint8), np.zeros((1, 256, 256)),
                             np.zeros((1, 256, 256)), "meta")
