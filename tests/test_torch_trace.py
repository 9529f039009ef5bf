"""The device glue's spans (core/events.py ``span``) on device=cpu, through
the kernels' plain versions: at jobs 8, with the chains of levels 5 and 3,
every span is paired and carries its block's id, waits and holds of
GLUE_LOCK lie inside their block's entropy span, copies and card waits
inside a hold, no two holds overlap, copies carry their arrays' bytes;
untraced, no Event is built; a listener changes no byte and one that
raises breaks nothing."""

from __future__ import annotations

import io
import threading
from collections import Counter

import pytest

from kanzi_tpu_torch.core import events
from kanzi_tpu_torch.io import stream as kstream
from kanzi_tpu_torch.io.stream import CompressedInputStream, CompressedOutputStream
from kanzi_tpu_torch.ops import ans1_cuda, ans_block, ans_cuda, glue, huffman_block, huffman_cuda
from kanzi_tpu_torch.utils.corpus import mixed_corpus

CHAINS = {"kanzi_l5": ("TEXT+UTF+BWT+RANK+ZRLT", "ANS0"),
          "kanzi_l3": ("TEXT+UTF+PACK+MM+LZX", "HUFFMAN")}
KINDS = ("GLUE_WAIT", "GLUE_HOLD", "COPY_IN", "CARD_WAIT", "COPY_OUT")
GLUE_MODULES = (ans_block, huffman_block, ans_cuda, ans1_cuda, huffman_cuda)
DATA = mixed_corpus(1 << 20, seed=5).tobytes()     # eight blocks of 128 KiB


class Recorder:
    def __init__(self) -> None:
        self.events = []
        self._lock = threading.Lock()

    def process_event(self, evt) -> None:
        with self._lock:
            self.events.append((evt.type.name, evt.block_id, evt.size, evt.time_ns))


class Raising:
    def process_event(self, evt) -> None:
        raise RuntimeError("a listener that fails")


def compress(chain: str, listener=None) -> bytes:
    transform, entropy = CHAINS[chain]
    out = io.BytesIO()
    ctx = {"transform": transform, "entropy": entropy, "blockSize": 1 << 17, "jobs": 8}
    with CompressedOutputStream(out, ctx, device="cpu") as cos:
        if listener is not None:
            cos.add_listener(listener)
        cos.write(DATA)
    return out.getvalue()


def decompress(blob: bytes, listener=None) -> bytes:
    with CompressedInputStream(io.BytesIO(blob), {"jobs": 8}, device="cpu") as cis:
        if listener is not None:
            cis.add_listener(listener)
        return cis.read(-1)


def pair(evts) -> dict:
    """{kind: [(block, t0, t1, size)]} of every BEFORE/AFTER pair, in each
    block's order (size: the BEFORE event's); raises on an unpaired event,
    or a glue span whose two events differ in size."""
    open_, out = {}, {}
    for name, block, size, t in evts:
        when, _, kind = name.partition("_")
        key = (block, kind)
        if when == "BEFORE":
            assert key not in open_, f"{kind} of block {block} opened twice"
            open_[key] = (t, size)
        else:
            t0, s0 = open_.pop(key)
            assert t0 <= t and (s0 == size or kind not in KINDS)
            out.setdefault(kind, []).append((block, t0, t, size))
    assert not open_, f"unclosed spans {sorted(open_)}"
    return out


@pytest.fixture(scope="module", params=sorted(CHAINS))
def round_trip(request):
    """One traced round trip of a chain: its events each way, the bytes of
    every array copied (to_device's input, to_host's output), the stream."""
    copied = {"COPY_IN": Counter(), "COPY_OUT": Counter()}

    def spy(kind, fn, nbytes):
        def wrapped(*a, **k):
            r = fn(*a, **k)
            copied[kind][nbytes(r)] += 1
            return r
        return wrapped

    rec_c, rec_d = Recorder(), Recorder()
    with pytest.MonkeyPatch.context() as mp:
        for mod in GLUE_MODULES:
            mp.setattr(mod, "to_device", spy("COPY_IN", mod.to_device,
                                             lambda t: t.numel() * t.element_size()))
            mp.setattr(mod, "to_host", spy("COPY_OUT", mod.to_host, lambda a: a.nbytes))
        blob = compress(request.param, rec_c)
        back = decompress(blob, rec_d)
    assert back == DATA
    return {"chain": request.param, "blob": blob, "copied": copied,
            "compress": rec_c.events, "decompress": rec_d.events}


@pytest.mark.parametrize("direction", ["compress", "decompress"])
def test_spans_are_paired_with_their_block_ids(round_trip, direction):
    evts = round_trip[direction]
    spans = pair(e for e in evts if e[0].partition("_")[2] in KINDS)
    assert set(spans) == set(KINDS)                 # the device glue ran
    entropy = {b for b, *_ in pair(e for e in evts if e[0].endswith("_ENTROPY"))["ENTROPY"]}
    assert len(entropy) == 8
    for kind in KINDS:
        assert {b for b, *_ in spans[kind]} <= entropy, kind
    assert Counter(b for b, *_ in spans["GLUE_WAIT"]) == Counter(b for b, *_ in spans["GLUE_HOLD"])
    assert all(n == 1 for n in Counter(b for b, *_ in spans["GLUE_HOLD"]).values())


@pytest.mark.parametrize("direction", ["compress", "decompress"])
def test_spans_nest(round_trip, direction):
    spans = pair(round_trip[direction])
    entropy = {b: (t0, t1) for b, t0, t1, _ in spans["ENTROPY"]}
    holds = {b: (t0, t1) for b, t0, t1, _ in spans["GLUE_HOLD"]}
    for kind in ("GLUE_WAIT", "GLUE_HOLD"):
        for b, t0, t1, _ in spans[kind]:
            assert entropy[b][0] <= t0 <= t1 <= entropy[b][1], (kind, b)
    for kind in ("COPY_IN", "CARD_WAIT", "COPY_OUT"):
        for b, t0, t1, _ in spans[kind]:
            assert holds[b][0] <= t0 <= t1 <= holds[b][1], (kind, b)
    for b, t0, _, _ in spans["GLUE_WAIT"]:
        assert t0 <= holds[b][0]
    ordered = sorted(holds.values())
    assert all(a[1] <= b[0] for a, b in zip(ordered, ordered[1:]))      # one holder


def test_copy_sizes_are_the_arrays_bytes(round_trip):
    for kind in ("COPY_IN", "COPY_OUT"):
        sizes = Counter(size for d in ("compress", "decompress")
                        for _, _, _, size in pair(round_trip[d])[kind])
        assert sizes == round_trip["copied"][kind], kind
        assert sum(sizes.values()) > 0
    for d in ("compress", "decompress"):
        assert all(size == 0 for _, _, _, size in pair(round_trip[d])["CARD_WAIT"])


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_untraced_builds_no_event(monkeypatch, chain):
    built = []
    real = events.Event

    def counting(*a, **k):
        built.append(a[0])
        return real(*a, **k)

    monkeypatch.setattr(events, "Event", counting)   # span's events
    monkeypatch.setattr(kstream, "Event", counting)  # the blocks' and the header's
    assert decompress(compress(chain)) == DATA
    assert built == []


def test_listeners_change_no_byte(round_trip):
    assert compress(round_trip["chain"]) == round_trip["blob"]
    assert decompress(round_trip["blob"]) == DATA


def test_a_raising_listener_breaks_nothing(round_trip):
    blob = compress(round_trip["chain"], Raising())
    assert blob == round_trip["blob"]
    assert decompress(blob, Raising()) == DATA
    assert not glue.GLUE_LOCK.locked()


def test_span_without_a_block_is_free():
    assert not events.traced()
    assert events.span("COPY_IN", 5) is events.span("GLUE_HOLD")
    rec = Recorder()
    with events.block_context([rec], 7):
        assert events.traced()
        with events.block_context((), 8):            # a block without listeners
            assert not events.traced()
            with events.span("COPY_OUT", 3):
                pass
        with events.span("COPY_OUT", 3):
            pass
    assert not events.traced()
    assert [(n, b, s) for n, b, s, _ in rec.events] == [
        ("BEFORE_COPY_OUT", 7, 3), ("AFTER_COPY_OUT", 7, 3)]
