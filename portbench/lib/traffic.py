"""The one traffic generator.  A mix is a data file,
``portbench/traffic/<mix>.json``, that this module reads:

``corpus``
    ``{"kind": "mixed", "bytes": n, "base_seed": b, "extent": e}``: the
    frozen silesia-like corpus (``lib/corpus.py``) of n bytes made from
    seed b, its whole extents of e bytes then put in an order drawn from
    the run's seed (a partial last extent stays last).  Every seed sends
    the same data in another order: the seed changes the inputs, not
    the work.
``requests``
    ``{"kind": "whole"}``: every request is the whole corpus, as one file.
    ``{"kind": "chunks", "min": a, "mean_extra": m, "max": b, "set": k}``:
    consecutive pieces of the corpus, wrapping round at its end.  Their
    sizes are a fixed set of k, the quantiles (i + 0.5) / k of a + an
    exponential of mean m, capped at b; each pass through the set takes
    them in an order drawn from the seed.  So every seed sends the same
    sizes, in another order, over other bytes.
``warmup``
    ``{"kind": "blocks", "full": f, "tail": true}``: one stream of f whole
    blocks of the configuration, then, if the requests' size leaves one,
    a block of the size of their last, from the corpus' start and end.
    ``{"kind": "requests", "count": c}``: the first c requests of a
    sequence drawn apart from the window's.
``check``
    ``{"ref_blocks": k}``: blocks the reference decodes after the window,
    the first of the longest request among them, then one at each slot
    of the blocks in flight (``lib/check.py``).

Requests run in a closed loop, one caller: a request is compressed, then
its stream decompressed, then the next one starts.
"""

from __future__ import annotations

import math

import numpy as np

from .corpus import mixed_corpus

SEED_MASK = (1 << 62) - 1


class Traffic:
    def __init__(self, mix: dict, seed: int) -> None:
        self.mix = mix
        self.seed = int(seed) & SEED_MASK
        c = mix["corpus"]
        if c["kind"] != "mixed":
            raise ValueError(f"unknown corpus kind {c['kind']!r}")
        self.corpus_bytes = int(c["bytes"])
        self._corpus = None

    @property
    def corpus(self) -> np.ndarray:
        if self._corpus is None:
            c = self.mix["corpus"]
            base = mixed_corpus(self.corpus_bytes, int(c["base_seed"]))
            e = int(c["extent"])
            whole = self.corpus_bytes // e
            order = np.random.default_rng([self.seed, 3]).permutation(whole)
            self._corpus = np.concatenate(
                [base[i * e:(i + 1) * e] for i in order] + [base[whole * e:]])
            self._view = memoryview(self._corpus)
        return self._corpus

    def sizes(self) -> list[int]:
        r = self.mix["requests"]
        if r["kind"] == "whole":
            return [self.corpus_bytes]
        if r["kind"] == "chunks":
            k = int(r["set"])
            out = []
            for i in range(k):
                x = -math.log(1.0 - (i + 0.5) / k) * r["mean_extra"]
                out.append(min(int(r["min"] + x), int(r["max"])))
            return out
        raise ValueError(f"unknown request kind {r['kind']!r}")

    def requests(self, stream: int = 0):
        """Endless (offset, bytes) requests; ``stream`` 0 is the window's."""
        sizes = self.sizes()
        rng = np.random.default_rng([self.seed, 7, stream])
        n = self.corpus.size
        off = 0 if stream == 0 else int(rng.integers(0, n))
        while True:
            for i in rng.permutation(len(sizes)):
                size = sizes[i]
                yield off, self._take(off, size)
                off = (off + size) % n

    def _take(self, off: int, size: int) -> bytes:
        n = self.corpus.size
        if off + size <= n:
            return bytes(self._view[off:off + size])
        return bytes(self._view[off:]) + self._take(0, size - (n - off))

    def warmup(self, config: dict) -> list[bytes]:
        w = self.mix["warmup"]
        if w["kind"] == "blocks":
            bs = int(config["block_size"])
            corpus = self.corpus
            data = corpus[:int(w["full"]) * bs].tobytes()
            tail = self.sizes()[-1] % bs
            if w.get("tail") and tail:
                data += corpus[corpus.size - tail:].tobytes()
            return [data]
        if w["kind"] == "requests":
            gen = self.requests(stream=1)
            return [next(gen)[1] for _ in range(int(w["count"]))]
        raise ValueError(f"unknown warmup kind {w['kind']!r}")
