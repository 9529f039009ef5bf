"""The device LZX parse's spans (core/events.py ``span``) and counters
(ops/launch.py ``launches``) on device=cpu, through the engine's plain
version, under KANZI_TPU_DEVICE_LZ=1: the writer's batch at level 1 is one
LZ_BATCH span of its bytes, reported as its first block's, with LZ_CARD,
LZ_FETCH and LZ_EMIT inside it (the windowed engine's too); the codec's
per-block dispatch at level 3 reports the same inner spans inside the
block's transform span; untraced, no Event is built; a listener changes no
byte; lz_dispatch and lz_emit_native count the groups and the blocks
emitted; the C++ emitter writes what kanzi_tpu's numpy extension and
emission (kanzi_tpu/ops/lz_sort.py _extend_tokens_host, ops/lz_tpu.py
_emit) write from the same tokens."""

from __future__ import annotations

import io
import threading

import numpy as np
import pytest

from kanzi_tpu.ops import lz_sort as J
from kanzi_tpu.ops import lz_tpu as JT
from kanzi_tpu_torch.core import events
from kanzi_tpu_torch.io import stream as kstream
from kanzi_tpu_torch.io.stream import CompressedInputStream, CompressedOutputStream
from kanzi_tpu_torch.ops import launch
from kanzi_tpu_torch.ops import lz_sort as T
from kanzi_tpu_torch.utils.corpus import mixed_corpus

BLOCK = 1 << 16
# three corpus blocks, a random block the LZX stage gains nothing on, and a
# tail under MIN_BLOCK_LENGTH that never reaches the engine
CORPUS = mixed_corpus(4 * BLOCK, seed=2**31 + 23)[:3 * BLOCK]
NOISE = np.random.default_rng(23).integers(0, 256, BLOCK, dtype=np.uint8)
TAIL = CORPUS[:T.MIN_BLOCK_LENGTH - 4]
BLOCKS = [CORPUS[i * BLOCK:(i + 1) * BLOCK] for i in range(3)] + [NOISE, TAIL]
DATA = b"".join(b.tobytes() for b in BLOCKS)
L1 = ("LZX", "NONE")
L3 = ("TEXT+UTF+PACK+MM+LZX", "HUFFMAN")
INNER = ("LZ_CARD", "LZ_FETCH", "LZ_EMIT")


class Recorder:
    def __init__(self) -> None:
        self.events = []
        self._lock = threading.Lock()

    def process_event(self, evt) -> None:
        with self._lock:
            self.events.append((evt.type.name, evt.block_id, evt.size, evt.time_ns))


@pytest.fixture(autouse=True)
def device_lz(monkeypatch):
    monkeypatch.setenv("KANZI_TPU_DEVICE_LZ", "1")


def compress(chain, jobs: int, listener=None, block: int = BLOCK) -> bytes:
    out = io.BytesIO()
    ctx = {"transform": chain[0], "entropy": chain[1], "blockSize": block, "jobs": jobs}
    with CompressedOutputStream(out, ctx, device="cpu") as cos:
        if listener is not None:
            cos.add_listener(listener)
        cos.write(DATA)
    return out.getvalue()


def decompress(blob: bytes) -> bytes:
    with CompressedInputStream(io.BytesIO(blob), {"jobs": 4}, device=None) as cis:
        return cis.read(-1)


def pair(evts) -> dict:
    """{kind: [(block, t0, t1, size before, size after)]} of every span;
    raises on an unpaired event."""
    open_, out = {}, {}
    for name, block, size, t in evts:
        when, _, kind = name.partition("_")
        if when not in ("BEFORE", "AFTER"):
            continue
        key = (block, kind)
        if when == "BEFORE":
            assert key not in open_, f"{kind} of block {block} opened twice"
            open_[key] = (t, size)
        else:
            t0, s0 = open_.pop(key)
            assert t0 <= t
            out.setdefault(kind, []).append((block, t0, t, s0, size))
    assert not open_, f"unclosed spans {sorted(open_)}"
    return out


def batches(jobs: int) -> list[list[int]]:
    """The writer's batches: indices of BLOCKS, ``jobs`` a batch."""
    return [list(range(i, min(i + jobs, len(BLOCKS)))) for i in range(0, len(BLOCKS), jobs)]


def emitted(idx: list[int]) -> dict:
    """{index: LZX output bytes (0: no gain)} of the blocks of one batch
    that reach the emitter, from an untraced run of the engine."""
    where = {id(BLOCKS[i]): i for i in idx}
    out = {}
    real = T._emit_block

    def spy(src, *a):
        res = real(src, *a)
        out[where[id(src)]] = 0 if res is None else res.size
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "_emit_block", spy)
        T.lzx_forward_device_batch([BLOCKS[i] for i in idx], True, 4, device="cpu")
    return out


@pytest.fixture(scope="module", params=[2, 8], ids=["jobs2", "jobs8"])
def level1(request):
    jobs = request.param
    rec = Recorder()
    fetched = []
    real = T._fetch_tokens

    def spy(pk, dist):
        fetched.append(pk.numel() * pk.element_size() + dist.numel() * dist.element_size())
        return real(pk, dist)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KANZI_TPU_DEVICE_LZ", "1")
        mp.setattr(T, "_fetch_tokens", spy)
        launch.reset_launches()
        blob = compress(L1, jobs, rec)
        counts = {k: launch.launches[k] for k in ("lz_dispatch", "lz_emit_native")}
    want = {i: n for idx in batches(jobs) for i, n in emitted(idx).items()}
    return {"jobs": jobs, "blob": blob, "spans": pair(rec.events), "counts": counts,
            "fetched": fetched, "emitted": want}


def test_one_batch_span_a_process_sized_its_bytes(level1):
    got = sorted((b, s0, s1) for b, _, _, s0, s1 in level1["spans"]["LZ_BATCH"])
    want = [(idx[0] + 1, sum(BLOCKS[i].size for i in idx), sum(BLOCKS[i].size for i in idx))
            for idx in batches(level1["jobs"])]
    assert got == want


def test_inner_spans_lie_in_their_batch_with_their_sizes(level1):
    spans = level1["spans"]
    assert set(INNER) <= set(spans)
    bounds = {b: (t0, t1) for b, t0, t1, _, _ in spans["LZ_BATCH"]}
    first = {i: idx[0] + 1 for idx in batches(level1["jobs"]) for i in idx}
    for kind in INNER:
        for b, t0, t1, _, _ in spans[kind]:
            lo, hi = bounds[first[b - 1]]
            assert lo <= t0 <= t1 <= hi, (kind, b)
    # one dispatch a batch that has a block the engine takes: its live bytes
    card = sorted((b, s0) for b, _, _, s0, _ in spans["LZ_CARD"])
    assert card == [(idx[0] + 1, sum(BLOCKS[i].size for i in idx
                                     if BLOCKS[i].size >= T.MIN_BLOCK_LENGTH))
                    for idx in batches(level1["jobs"])
                    if any(BLOCKS[i].size >= T.MIN_BLOCK_LENGTH for i in idx)]
    assert sorted(s0 for *_, s0, _ in spans["LZ_FETCH"]) == sorted(level1["fetched"])
    # each emission under its own block's id: its bytes in, its output out
    want = {i + 1: (BLOCKS[i].size, n) for i, n in level1["emitted"].items()}
    assert {b: (s0, s1) for b, _, _, s0, s1 in spans["LZ_EMIT"]} == want
    assert {1, 2, 3} <= set(want) and 5 not in want
    assert want.get(4, (BLOCK, 0))[1] == 0          # the random block gains nothing


def test_counters_follow_the_grouping_and_the_emitter(level1):
    c = level1["counts"]
    # jobs 2: the batches [0, 1], [2, 3] and the tail alone, which none takes
    assert c["lz_dispatch"] == len(level1["spans"]["LZ_CARD"]) == (2 if level1["jobs"] == 2 else 1)
    assert c["lz_emit_native"] == len(level1["spans"]["LZ_EMIT"]) == len(level1["emitted"])


def test_listeners_change_no_byte(level1):
    assert compress(L1, level1["jobs"]) == level1["blob"]
    assert decompress(level1["blob"]) == DATA


def test_numpy_emitter_is_counted_and_writes_the_same_bytes(level1, monkeypatch):
    """Each block the batch hands to the C++ emitter: its bytes equal what
    kanzi_tpu's numpy extension (_extend_tokens_host) and emission
    (lz_tpu._emit) write from the same tokens; one count a block."""
    got = []
    real = T._emit_native

    def spy(src, mm, p, l, d, max_dist):
        toks = (p.copy(), l.copy(), d.copy())
        res = real(src, mm, p, l, d, max_dist)
        got.append((src, mm, max_dist, toks, res))
        return res

    monkeypatch.setattr(T, "_emit_native", spy)
    launch.reset_launches()
    assert compress(L1, level1["jobs"]) == level1["blob"]
    assert launch.launches["lz_emit_native"] == len(level1["emitted"]) == len(got)
    assert any(res is not None for *_, res in got)
    for src, mm, max_dist, (p, l, d), res in got:
        p, l, d = (np.asarray(a, np.int64) for a in (p, l, d))
        l = J._extend_tokens_host(src, p, l, d, src.size - 18)
        ref = JT._emit(src, src.size, mm, max_dist, p, l, d)
        assert (res is None) == (ref is None)
        if res is not None:
            assert np.array_equal(res, ref)


def test_windowed_rows_are_one_card_span_of_their_rows(monkeypatch):
    monkeypatch.setattr(T, "MAX_FLAT", BLOCK - 1)     # every block through the rows
    rec = Recorder()
    launch.reset_launches()
    blob = compress(L1, 8, rec)
    spans = pair(rec.events)
    assert launch.launches["lz_dispatch"] == 1
    assert [(b, s0) for b, _, _, s0, _ in spans["LZ_CARD"]] == [(1, 4 * T.ROW)]
    (_, lo, hi, _, _), = spans["LZ_BATCH"]
    for kind in INNER:
        assert all(lo <= t0 <= t1 <= hi for _, t0, t1, _, _ in spans[kind]), kind
    assert {b for b, *_ in spans["LZ_EMIT"]} <= {1, 2, 3, 4}
    assert launch.launches["lz_emit_native"] == len(spans["LZ_EMIT"]) > 0
    assert decompress(blob) == DATA


def test_codec_dispatch_reports_inside_the_transform_span():
    rec = Recorder()
    blob = compress(L3, 8, rec)
    spans = pair(rec.events)
    assert "LZ_BATCH" not in spans                  # level 3's chain starts with TEXT
    transform = {b: (t0, t1) for b, t0, t1, _, _ in spans["TRANSFORM"]}
    for kind in INNER:
        assert spans.get(kind), kind
        for b, t0, t1, _, _ in spans[kind]:
            assert transform[b][0] <= t0 <= t1 <= transform[b][1], (kind, b)
    assert decompress(blob) == DATA


@pytest.mark.parametrize("chain", [L1, L3], ids=["level1", "level3"])
def test_untraced_builds_no_event(monkeypatch, chain):
    built = []
    real = events.Event

    def counting(*a, **k):
        built.append(a[0])
        return real(*a, **k)

    monkeypatch.setattr(events, "Event", counting)   # span's events
    monkeypatch.setattr(kstream, "Event", counting)  # the blocks' and the header's
    assert decompress(compress(chain, 8)) == DATA
    assert built == []


def test_current_block_hands_the_context_to_another_thread():
    rec = Recorder()
    assert events.current_block() is None
    with events.block_context([rec], 5):
        ctx = events.current_block()
        assert ctx == ([rec], 5)

        def work():
            assert events.current_block() is None
            with events.block_context(ctx[0], ctx[1] + 2):
                with events.span("LZ_EMIT", 9) as sp:
                    sp.size = 4

        t = threading.Thread(target=work)
        t.start()
        t.join()
    with events.span("LZ_EMIT", 1) as sp:
        assert sp is None
    assert [(n, b, s) for n, b, s, _ in rec.events] == [
        ("BEFORE_LZ_EMIT", 7, 9), ("AFTER_LZ_EMIT", 7, 4)]
