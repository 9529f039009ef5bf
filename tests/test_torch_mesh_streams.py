"""The port's mesh streams (kanzi_tpu_torch/parallel/engine.py: level 5 and
level 1 with their stages sharded over two ranks) against kanzi_tpu's mesh
streams, byte for byte.

The port's two ranks are spawned gloo processes on the CPU; kanzi_tpu's
side runs on ``make_mesh(2)`` of the virtual 8-device CPU mesh.  A mesh
stream is not the host writer's stream (each block's ANS0 wire is appended
byte-aligned, tests/test_mesh_pipeline.py), so the comparison is with
kanzi_tpu's mesh streams.  kanzi_tpu's level 1 runs with
KANZI_TPU_PALLAS_INTERPRET=1, so that its content words come from its Pallas
kernel and its tail rule, which the port follows.  Zero tolerance.
"""

from __future__ import annotations

import io
import os

import numpy as np
import pytest

from kanzi_tpu_torch.io.stream import CompressedInputStream
from kanzi_tpu_torch.parallel import dryrun
from kanzi_tpu_torch.utils.corpus import mixed_corpus

TESTS = os.path.dirname(os.path.abspath(__file__))
SIZE = 1 << 20
BLOCK = 256 << 10


def _random_bytes() -> np.ndarray:
    return np.random.default_rng(0).integers(0, 256, 2 * BLOCK, dtype=np.uint8)


def _rank_l5(mesh) -> dict:
    """Every rank: level 5 at jobs 2, its mesh decode, a corrupt copy's mesh
    decode, then level 5 twice at jobs 4 (blocks race for the dispatch
    lock).  Rank 0 reports everything, the others what the corrupt stream
    raised there."""
    from kanzi_tpu_torch.parallel import engine as E

    data = mixed_corpus(SIZE, seed=6) if mesh.rank == 0 else None
    out: dict = {"wire": E.mesh_l5_compress(mesh, data, block_size=BLOCK, jobs=2)}
    out["decoded"] = E.mesh_decompress(mesh, out["wire"], jobs=2)
    bad = None
    if mesh.rank == 0:
        bad = bytearray(out["wire"])
        bad[(len(bad) * 3) // 4] ^= 0xFF
        bad = bytes(bad)
    try:
        E.mesh_decompress(mesh, bad, jobs=2)
        out["corrupt"] = None
    except Exception as e:
        out["corrupt"] = type(e).__name__
    out["jobs4"] = [E.mesh_l5_compress(mesh, data, block_size=BLOCK, jobs=4)
                    for _ in range(2)]
    return out if mesh.rank == 0 else {"corrupt": out["corrupt"]}


def _rank_l1(mesh) -> dict:
    """Every rank: level 1 of the mixed corpus, then of random bytes."""
    from kanzi_tpu_torch.parallel import engine as E

    return {"wire": E.mesh_l1_compress(mesh, mixed_corpus(SIZE, seed=3), block_size=BLOCK),
            "random": E.mesh_l1_compress(mesh, _random_bytes(), block_size=BLOCK)}


@pytest.fixture(scope="module", autouse=True)
def _native_ready():
    """Load kanzi_tpu's native library before its writer's pool threads
    do: its one-time set-up is not guarded against two threads."""
    from kanzi_tpu.utils import native_transforms as ref_nt
    ref_nt._lib()


@pytest.fixture(scope="module")
def ref_mesh():
    from kanzi_tpu.parallel.engine import make_mesh
    return make_mesh(2)


@pytest.fixture(scope="module")
def l5():
    return dryrun.spawn("test_torch_mesh_streams:_rank_l5", 2, "cpu", timeout=300,
                        pythonpath=(TESTS,))


@pytest.fixture(scope="module")
def l1():
    return dryrun.spawn("test_torch_mesh_streams:_rank_l1", 2, "cpu", timeout=300,
                        pythonpath=(TESTS,))[0]


def _port_read(blob: bytes) -> bytes:
    with CompressedInputStream(io.BytesIO(blob), {"jobs": 2}, device=None) as cis:
        return cis.read(-1)


def _ref_read(blob: bytes) -> bytes:
    from kanzi_tpu.io.stream import CompressedInputStream as RefInput
    return RefInput(io.BytesIO(blob), {"jobs": 2}).read(-1)


def test_mesh_l5_matches_kanzi_tpu(l5, ref_mesh):
    from kanzi_tpu.parallel.engine import mesh_l5_compress
    ref = mesh_l5_compress(ref_mesh, mixed_corpus(SIZE, seed=6), block_size=BLOCK, jobs=2)
    assert l5[0]["wire"] == ref


def test_mesh_l5_decodes_through_both_readers_and_the_mesh(l5):
    data = mixed_corpus(SIZE, seed=6).tobytes()
    wire = l5[0]["wire"]
    assert _port_read(wire) == data
    assert _ref_read(wire) == data
    assert l5[0]["decoded"] == data


def test_mesh_l5_corrupt_stream_raises_on_every_rank(l5):
    """A flipped byte at 3/4 of the stream raises on rank 0 (the reader's
    own error), and rank 1 leaves its serve loop with a MeshError."""
    assert l5[0]["corrupt"] in ("BitStreamError", "IOError_", "ValueError", "EOFError")
    assert l5[1]["corrupt"] == "MeshError"


def test_mesh_l5_dispatch_order_gives_the_same_bytes(l5):
    """At jobs 4 all four blocks race for the dispatch lock: two runs write
    the same bytes, those of jobs 2."""
    a, b = l5[0]["jobs4"]
    assert a == b == l5[0]["wire"]


def test_mesh_l1_matches_kanzi_tpu(l1, ref_mesh, monkeypatch):
    from kanzi_tpu.parallel.engine import mesh_l1_compress
    monkeypatch.setenv("KANZI_TPU_PALLAS_INTERPRET", "1")
    ref = mesh_l1_compress(ref_mesh, mixed_corpus(SIZE, seed=3), block_size=BLOCK)
    assert l1["wire"] == ref


def test_mesh_l1_decodes_through_both_readers(l1):
    data = mixed_corpus(SIZE, seed=3).tobytes()
    assert len(l1["wire"]) < len(data)
    assert _port_read(l1["wire"]) == data
    assert _ref_read(l1["wire"]) == data


def test_mesh_l1_incompressible_copy_fallback(l1):
    """Random bytes gain nothing: the blocks take the copy fallback, and the
    stream round-trips through both readers."""
    data = _random_bytes().tobytes()
    assert len(l1["random"]) >= len(data)
    assert _port_read(l1["random"]) == data
    assert _ref_read(l1["random"]) == data
