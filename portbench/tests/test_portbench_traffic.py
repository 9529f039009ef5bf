"""The traffic generator: seeded, and of the stated sizes."""

import json
import os

import numpy as np

from portbench.lib.corpus import mixed_corpus
from portbench.lib.traffic import Traffic

MIXES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "traffic")


def mix(name, **over):
    with open(os.path.join(MIXES, name + ".json")) as f:
        m = json.load(f)
    m.update(over)
    return m


def first(t, k):
    g = t.requests()
    return [next(g) for _ in range(k)]


def test_archive_is_one_silesia_sized_file():
    t = Traffic(mix("archive"), 2**31 + 5)
    assert t.sizes() == [211_957_760]
    assert t._corpus is None               # sized without making it


def test_chunk_sizes_follow_restic_bounds():
    sizes = Traffic(mix("chunks"), 1).sizes()
    assert len(sizes) == 64
    assert min(sizes) >= 512 * 1024 and max(sizes) <= 8 * 1024 * 1024
    assert abs(np.mean(sizes) / (1024 * 1024) - 1.0) < 0.05


SMALL = {"corpus": {"kind": "mixed", "bytes": 3 << 20, "base_seed": 12, "extent": 1 << 18}}


def test_same_seed_same_requests_other_seed_others():
    small = SMALL
    a = first(Traffic(mix("chunks", **small), 7), 10)
    b = first(Traffic(mix("chunks", **small), 7), 10)
    c = first(Traffic(mix("chunks", **small), 8), 10)
    assert a == b
    assert [x[1] for x in a] != [x[1] for x in c]


def test_every_seed_sends_the_same_sizes_in_another_order():
    small = SMALL
    a = first(Traffic(mix("chunks", **small), 7), 64)
    c = first(Traffic(mix("chunks", **small), 8), 64)
    assert sorted(len(x[1]) for x in a) == sorted(len(x[1]) for x in c)
    assert [len(x[1]) for x in a] != [len(x[1]) for x in c]


def test_chunks_are_consecutive_and_wrap():
    t = Traffic(mix("chunks", **SMALL), 3)
    reqs = first(t, 12)
    off = 0
    for o, data in reqs:
        assert o == off
        want = np.concatenate([t.corpus, t.corpus])[o:o + len(data)]
        assert data == want.tobytes()
        off = (off + len(data)) % t.corpus.size


def test_warmup_blocks_cover_full_blocks_and_the_tail():
    t = Traffic(mix("archive", corpus={"kind": "mixed", "bytes": 9 * 1024 + 100,
                                       "base_seed": 12, "extent": 1024}), 4)
    (w,) = t.warmup({"block_size": 1024})
    assert len(w) == 8 * 1024 + (9 * 1024 + 100) % 1024


def test_corpus_is_seeded_and_exact():
    a = mixed_corpus(5_000_001, 2**31 + 9)
    assert a.size == 5_000_001
    assert np.array_equal(a, mixed_corpus(5_000_001, 2**31 + 9))
    assert not np.array_equal(a, mixed_corpus(5_000_001, 2**31 + 10))


def test_every_seed_sends_the_same_extents_in_another_order():
    e = 1 << 18
    a = Traffic(mix("chunks", **SMALL), 2**31 + 1).corpus
    b = Traffic(mix("chunks", **SMALL), 2**31 + 2).corpus
    assert a.size == b.size == 3 << 20
    assert not np.array_equal(a, b)
    ext = sorted(a[i:i + e].tobytes() for i in range(0, a.size, e))
    assert ext == sorted(b[i:i + e].tobytes() for i in range(0, b.size, e))
    base = mixed_corpus(3 << 20, 12)
    assert ext == sorted(base[i:i + e].tobytes() for i in range(0, base.size, e))


def test_archive_blocks_are_the_same_set_for_every_seed():
    m = mix("archive")
    assert m["corpus"]["extent"] == 4 * 1024 * 1024      # whole blocks of kanzi_l5
