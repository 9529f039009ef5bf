"""The port's LZX sort engine (level 1) on device=cpu against kanzi_tpu's.

The content-word kernel's plain version against kanzi_tpu's Pallas
``_words_kernel`` in interpret mode, bit for bit, tail included; the probe,
merge and parse stages against kanzi_tpu's; and whole LZX section streams
of ``lzx_forward_device_batch`` (flat engine) and of the windowed row
engine against kanzi_tpu's, run with KANZI_TPU_PALLAS_INTERPRET=1 so its
words come from the Pallas kernel.  Zero tolerance: every comparison is
exact.  Then levels 1, 2 and 3 as streams under KANZI_TPU_DEVICE_LZ=1
against kanzi_tpu's under the same variable, and the windowed engine's
group loop across two blocks.  kanzi_tpu compiles once per shape (~15-40 s
here), so the cases share four shapes, and its engine results are
computed once per module.
"""

from __future__ import annotations

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanzi_tpu.app.block_compressor import LEVELS
from kanzi_tpu.io import stream as host
from kanzi_tpu.ops import lz_sort as J
from kanzi_tpu_torch.io import stream as port
from kanzi_tpu_torch.ops import lz_sort as T
from kanzi_tpu_torch.ops import lz_words_cuda as W
from kanzi_tpu_torch.utils import native_transforms as nt
from kanzi_tpu_torch.utils.corpus import dna_like, mixed_corpus, text_like

N = 1 << 18


def _blocks():
    """name -> (blocks, min_match).  Single blocks share the (1, 256 KiB)
    bucket; the batch pads three blocks to (4, 256 KiB)."""
    rng = np.random.default_rng(17)
    zero_prefix = np.concatenate([np.zeros(60_000, np.uint8),
                                  mixed_corpus(140_000, seed=19)])
    return {
        "text": ([text_like(200_000, seed=11)], 4),
        "zeros": ([np.zeros(100_000, np.uint8)], 4),
        "period7": ([np.tile(np.arange(7, dtype=np.uint8), 20_000)], 4),
        "mixed": ([mixed_corpus(200_000, seed=5)], 4),
        "zero_prefix": ([zero_prefix], 4),
        "full_bucket": ([mixed_corpus(N, seed=8)], 4),
        "min_match6": ([dna_like(150_000, seed=13)], 6),
        "incompressible": ([rng.integers(0, 256, 100_000).astype(np.uint8)], 4),
        "batch3": ([mixed_corpus(150_000, seed=9), text_like(60_000, seed=10),
                    mixed_corpus(N - 100, seed=12)], 4),
    }


def _rows_block():
    """A block of four 256 KiB rows in the windowed engine's layout."""
    return mixed_corpus(3 * T.STRIDE + 5_000, seed=23)


@pytest.fixture(scope="module")
def ref():
    """kanzi_tpu's results, computed once, with its Pallas word kernel in
    interpret mode."""
    mp = pytest.MonkeyPatch()
    mp.setenv("KANZI_TPU_PALLAS_INTERPRET", "1")
    try:
        out = {name: J.lzx_forward_device_batch(blocks, True, mm)
               for name, (blocks, mm) in _blocks().items()}
        rows, vend, isfirst, mdrow = J._block_rows(_rows_block())
        pk, dist, n_tok = J._parse_stage(*J._match_stage(
            jnp.asarray(np.ascontiguousarray(rows)), jnp.asarray(vend),
            jnp.asarray(isfirst), jnp.asarray(mdrow), 4), 4)
        k = int(n_tok)
        out["rows"] = (np.asarray(pk)[:k], np.asarray(dist)[:k])
    finally:
        mp.undo()
    return out


def _word_rows():
    """Two 256 KiB rows; the second row's last 1 KiB repeats the KiB before
    it, so its tail words (which read 1,024 bytes back) repeat too."""
    b = mixed_corpus(2 * N, seed=3).reshape(2, N).copy()
    b[1, N - 1024:] = b[1, N - 2048:N - 1024]
    return b


def test_words_plain_matches_pallas():
    b = _word_rows()
    want = [np.asarray(w) for w in J._words_call(2, N, True)(jnp.asarray(b))]
    got = [w.numpy() for w in W.lz_words(torch.from_numpy(b))]
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, w)
    # the tail rule itself: w0 at n-2 reads bytes n-2, n-1, n-1024, n-1023
    row = b[0].astype(np.int64)
    be = (row[N - 2] << 24) | (row[N - 1] << 16) | (row[N - 1024] << 8) | row[N - 1023]
    assert got[0][0, N - 2] == np.int64(be).astype(np.uint32).view(np.int32)
    # and its effect: the repeated KiB makes the tail words equal the words
    # 1,024 positions earlier
    for g in got:
        assert np.array_equal(g[1, N - 15:], g[1, N - 1024 - 15:N - 1024])


def test_words_refuse_bad_rows():
    with pytest.raises(ValueError, match="multiple of 65536"):
        W.lz_words(torch.zeros((1, 3 * 4096), dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        W.lz_words(torch.empty((1, N), dtype=torch.uint8, device="meta"))


def _flat_inputs():
    """Two rows of 512 KiB (two tier-B segments each), one full, one short."""
    n = 2 * N
    b = mixed_corpus(2 * n, seed=29).reshape(2, n)
    src_end = np.array([n - 18, 300_000], np.int64)
    max_dist = np.array([(1 << 24) - 2, J.MAX_DISTANCE1], np.int64)
    return b, src_end, max_dist


def _jax_tiers(b, src_end, max_dist):
    nb, n = b.shape
    ws = [jnp.asarray(w.numpy()) for w in W.lz_words(torch.from_numpy(b))]
    idx = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), (nb, n))
    se_, md_ = jnp.asarray(src_end, jnp.int32), jnp.asarray(max_dist, jnp.int32)

    def mask_fn(sidx, c):
        rep = sidx.shape[0] // nb
        se = jnp.repeat(se_, rep)[:, None]
        md = jnp.repeat(md_, rep)[:, None]
        return (sidx < se) & (sidx - c > 0) & (sidx - c <= md)

    return J._probe_tiers(ws, idx, mask_fn, (nb, n))


def _torch_tiers(b, src_end, max_dist):
    nb, n = b.shape
    ws = W.lz_words(torch.from_numpy(b))
    se, md = torch.from_numpy(src_end), torch.from_numpy(max_dist)

    def mask_fn(sidx, c):
        d = sidx - c
        return ((sidx < T._per_row(se, nb, sidx)) & (d > 0)
                & (d <= T._per_row(md, nb, sidx)))

    return T._probe_tiers(ws, mask_fn, (nb, n))


@pytest.fixture(scope="module")
def tiers():
    inp = _flat_inputs()
    return _jax_tiers(*inp), _torch_tiers(*inp)


def test_probe_tiers_matches(tiers):
    want, got = tiers
    for (wd, wm), (gd, gm) in zip(want, got):
        assert np.array_equal(np.asarray(wd), gd.numpy())
        assert np.array_equal(np.asarray(wm), gm.numpy())
        assert (gm.numpy() > 0).sum() > 10_000


def test_merge_tiers_matches(tiers):
    want, got = tiers
    wd, wm = J._merge_tiers(*want)
    gd, gm = T._merge_tiers(*got)
    assert np.array_equal(np.asarray(wd), gd.numpy())
    assert np.array_equal(np.asarray(wm), gm.numpy())


def test_parse_stage_matches(tiers):
    want, _ = tiers
    dist, mlen = J._merge_tiers(*want)
    # the first 64 Ki positions: 1,024 parse windows
    mlen = jnp.where(mlen >= 4, mlen, 0)[0, :1 << 16]
    dist = dist[0, :1 << 16]
    wpk, wdist, wn = J._parse_stage(mlen, dist, 4)
    gpk, gdist, gn = T._parse_stage(torch.tensor(np.asarray(mlen)).long(),
                                    torch.tensor(np.asarray(dist)).long(), 4)
    k = int(wn)
    assert gn == k > 1000
    assert np.array_equal(gpk.numpy(), np.asarray(wpk)[:k])
    assert np.array_equal(gdist.numpy(), np.asarray(wdist)[:k])


@pytest.mark.parametrize("name", list(_blocks()))
def test_lzx_batch_matches(ref, name):
    blocks, mm = _blocks()[name]
    got = T.lzx_forward_device_batch(blocks, True, mm, device="cpu")
    want = ref[name]
    assert len(got) == len(want) == len(blocks)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g is not None and np.array_equal(g, w)
    if name == "incompressible":
        assert got == [None]
    else:
        assert all(g is not None for g in got)


def test_row_engine_matches(ref):
    """Four rows through _match_stage + _parse_stage (the engine of blocks
    over 16 MiB), in the layout of _block_rows."""
    src = _rows_block()
    rows, vend, isfirst, mdrow = T._block_rows(src)
    assert rows.shape == (4, T.ROW)
    pk, dist, k = T._parse_stage(*T._match_stage(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (rows, vend, isfirst, mdrow)),
        4), 4)
    wpk, wdist = ref["rows"]
    assert k == wpk.size > 1000
    assert np.array_equal(pk.numpy(), wpk) and np.array_equal(dist.numpy(), wdist)


def test_device_lz_round_trips():
    """The engine's sections decode with the host inverse."""
    blocks = [mixed_corpus(200_000, seed=5), np.zeros(100_000, np.uint8)]
    for src, enc in zip(blocks, T.lzx_forward_device_batch(blocks, True, 4, device="cpu")):
        assert np.array_equal(nt.lzx_inverse_native(enc, src.size), src)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        T.lzx_forward_device_batch([np.zeros(5000, np.uint8)], device="cuda")


def _stream(mod, data: bytes, ctx: dict, **kw) -> bytes:
    out = io.BytesIO()
    with mod.CompressedOutputStream(out, ctx, **kw) as cos:
        cos.write(data)
    return out.getvalue()


def _stream_data(level: int) -> bytes:
    """300,077 bytes of the mixed corpus; for level 2 (DNA+LZ) its second
    128 KiB block is dna_like, which the DNA stage packs and LZ then parses
    at min_match 6."""
    data = mixed_corpus(300_077, seed=41)
    if level == 2:
        data[128 << 10:256 << 10] = dna_like(128 << 10, seed=43)
    return data.tobytes()


@pytest.mark.parametrize("level", [1, 2, 3])
def test_device_lz_stream_matches(level, ref, monkeypatch):
    """Level 1 (LZX alone: the writer's batched dispatch), level 2 (LZ after
    DNA) and level 3 (LZX after four transforms), the last two through the
    codec's own dispatch, one block a call, with the gate on equal
    kanzi_tpu's device-LZ streams, decode on the port both ways, and differ
    from the host parse's streams."""
    data = _stream_data(level)
    t, e, _ = LEVELS[level]
    ctx = {"transform": t, "entropy": e, "blockSize": 128 << 10, "jobs": 1}
    monkeypatch.setenv("KANZI_TPU_DEVICE_LZ", "1")
    monkeypatch.setenv("KANZI_TPU_PALLAS_INTERPRET", "1")
    want = _stream(host, data, ctx)
    got = _stream(port, data, ctx, device="cpu")
    assert got == want
    for dev in (None, "cpu"):
        with port.CompressedInputStream(io.BytesIO(got), {}, device=dev) as cis:
            assert cis.read(-1) == data
    # device=None ignores the gate: the host parse, as with the gate off
    parse = _stream(port, data, ctx, device=None)
    assert parse != got
    monkeypatch.delenv("KANZI_TPU_DEVICE_LZ")
    assert _stream(port, data, ctx, device="cpu") == parse


def test_row_engine_groups_match(monkeypatch):
    """The windowed row engine's group loop, as blocks over 16 MiB take it:
    with MAX_FLAT at 1 MiB and GROUP_ROWS at 4 in both packages (both read
    them at call time), two blocks of 1.5 MiB + 5,000 B make 2 x 9 rows in
    five dispatches of four, one of them straddling the two blocks and the
    last padded from two.  Their sections equal kanzi_tpu's and decode."""
    blocks = [mixed_corpus((3 << 19) + 5_000, seed=43),
              text_like((3 << 19) + 5_000, seed=44)]
    for mod in (J, T):
        monkeypatch.setattr(mod, "MAX_FLAT", 1 << 20)
        monkeypatch.setattr(mod, "GROUP_ROWS", 4)
    monkeypatch.setenv("KANZI_TPU_PALLAS_INTERPRET", "1")
    groups = []
    stage = T._match_stage

    def counted(rows, vend, isfirst, mdrow, mm):
        groups.append((rows.shape[0], int(isfirst.sum())))
        return stage(rows, vend, isfirst, mdrow, mm)

    monkeypatch.setattr(T, "_match_stage", counted)
    got = T.lzx_forward_device_batch(blocks, True, 4, device="cpu")
    assert [-(-b.size // T.STRIDE) for b in blocks] == [9, 9]
    # (rows, first rows + pad rows): block 1 starts in group 2, pads end group 4
    assert groups == [(4, 1), (4, 0), (4, 1), (4, 0), (4, 2)]
    want = J.lzx_forward_device_batch(blocks, True, 4)
    for src, g, w in zip(blocks, got, want):
        assert g is not None and w is not None and np.array_equal(g, w)
        assert np.array_equal(nt.lzx_inverse_native(g, src.size), src)


@pytest.mark.parametrize("anchor", ["0", "2"])
def test_anchor_variable_ignored(anchor, monkeypatch):
    """kanzi_tpu's KANZI_TPU_LZ_ANCHOR (anchor-sampled tier A, a measured
    rejection kept off by default in kanzi_tpu) is not ported: under any
    value the port's level-1 device stream is its stream without it."""
    data = _stream_data(1)
    t, e, _ = LEVELS[1]
    ctx = {"transform": t, "entropy": e, "blockSize": 128 << 10, "jobs": 1}
    monkeypatch.setenv("KANZI_TPU_DEVICE_LZ", "1")
    want = _stream(port, data, ctx, device="cpu")
    monkeypatch.setenv("KANZI_TPU_LZ_ANCHOR", anchor)
    got = _stream(port, data, ctx, device="cpu")
    assert got == want
    with port.CompressedInputStream(io.BytesIO(got), {}, device=None) as cis:
        assert cis.read(-1) == data
