"""The launcher and the multi-process dry run of the port's multi-GPU engine
(kanzi_tpu_torch/parallel/dryrun.py, multihost.py), and how the mesh fails:
a world shorter than asked, a rank whose step raises, a rank that hangs, a
card that is not there.  Every rank is a spawned gloo process on the CPU.
"""

from __future__ import annotations

import os
import re
import time

import numpy as np
import pytest
import torch

from kanzi_tpu_torch.parallel import dryrun, engine, multihost

TESTS = os.path.dirname(os.path.abspath(__file__))


def test_dryrun_multihost_two_ranks():
    """Both processes feed only their rows; rank 0's ANS0 wire equals the
    host encoder's and decodes, and the level-1 stage round-trips."""
    lines = dryrun.dryrun_multihost(2, "cpu", timeout=300)
    assert [line.split(":")[0] for line in lines] == ["OK p0", "OK p1"]
    assert "equal to the host encoder's" in lines[0] and "round-trip ok" in lines[0]


def test_dryrun_multichip_small(capsys):
    """Level 1, the ANS0 stage and level 5 over two ranks, each round-tripped
    by rank 0 (at a small size: the plain versions run on the CPU), then the
    scaling line of the sharded LZX stage at 1 and 2 ranks."""
    rep = dryrun.dryrun_multichip(2, "cpu", size=512 << 10, block=256 << 10, timeout=300)
    assert rep["ranks"] == 2 and rep["backend"] == "gloo"
    assert rep["l1"]["bytes_out"] < rep["l1"]["bytes_in"]
    assert rep["l5"]["bytes_out"] < rep["l5"]["bytes_in"]
    assert rep["stats"]["sa lengths"][1] > 0 and rep["stats"]["encode payloads"][1] > 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("scaling [")]
    assert len(line) == 1, line
    m = re.match(r"scaling \[2 MiB sharded LZX stage, 8 blocks, cpu\]: t1=([0-9.]+)s "
                 r"tN=([0-9.]+)s \| scaling efficiency=([0-9.]+) \(raw ([0-9.]+) vs ceiling "
                 r"([0-9.]+): .*rank 0 cpu-s a run 1: [0-9.]+, 2: [0-9.]+", line[0])
    assert m, line[0]
    t1, tn, eff, raw, ceiling = map(float, m.groups())
    sc = rep["scaling"]
    assert t1 > 0 and tn > 0 and 0 < eff <= 1.0 and ceiling == min(os.cpu_count(), 2) / 2
    assert sc["blocks"] == 8 and sorted(sc["worlds"]) == [1, 2]
    assert abs(sc["t1"] - t1) < 1e-3 and abs(sc["tN"] - tn) < 1e-3
    assert all(len(w["runs"]) == 3 and w["t"] == min(w["runs"]) for w in sc["worlds"].values())


def _rank_make_mesh(mesh, n):
    try:
        engine.make_mesh(n, device="cpu")
    except ValueError as e:
        return str(e)
    return None


def test_make_mesh_wider_than_the_world_raises():
    got = dryrun.spawn("test_torch_multihost:_rank_make_mesh", 2, "cpu", (4,),
                       timeout=120, pythonpath=(TESTS,))
    assert all(g is not None and "has 2 ranks" in g for g in got)


def _rank_fault(mesh, bad_rank):
    """``bad_rank``'s ANS0 step raises; every rank reports what it raised."""
    from kanzi_tpu_torch.ops import ans_cuda

    if mesh.rank == bad_rank:
        def broken(x):
            raise ArithmeticError("injected fault")
        ans_cuda.encode_chunks_tensors = broken
    block = np.random.default_rng(2).integers(0, 9, 8 * 16384).astype(np.uint8)
    try:
        engine.mesh_ans0_compress(mesh, block)
    except Exception as e:
        return type(e).__name__, str(e), type(e.__cause__).__name__
    return None


@pytest.mark.parametrize("bad_rank", [0, 1])
def test_a_failing_step_raises_on_every_rank(bad_rank):
    """A rank whose local step raises tells every rank through the first
    gather: rank 0 raises MeshError naming it, and the serving rank leaves
    its loop with a MeshError; the faulty rank's error is the cause there."""
    t = time.monotonic()
    got = dryrun.spawn("test_torch_multihost:_rank_fault", 2, "cpu", (bad_rank,),
                       timeout=120, pythonpath=(TESTS,))
    assert time.monotonic() - t < 120
    for rank, (name, msg, cause) in enumerate(got):
        assert name == "MeshError"
        assert cause == ("ArithmeticError" if rank == bad_rank else "NoneType")
    assert f"rank(s) [{bad_rank}]" in got[0][1]


FAULT_OPS = ("encode", "decode", "sa", "l1")


def _rank_input_fault(mesh):
    """Rank 1's move of its rows to its device raises in every step; rank 0
    drives each dispatched op once, and every rank reports what it raised."""
    from kanzi_tpu_torch.core.bits import BitWriter
    from kanzi_tpu_torch.entropy import ans as hans
    from kanzi_tpu_torch.utils.corpus import mixed_corpus

    if mesh.rank == 1:
        def broken(*args):
            raise ArithmeticError("injected fault in the input's move")
        engine._to = broken
    block = np.random.default_rng(2).integers(0, 9, 4 * 4096).astype(np.uint8)
    bw = BitWriter()
    hans.ANSRangeEncoder(bw, 0, chunk_size=4096).encode(block)
    data = mixed_corpus(64 << 10, seed=5)
    calls = {"encode": lambda: engine.mesh_ans0_compress(mesh, block, chunk=4096),
             "decode": lambda: engine.mesh_ans0_decompress(mesh, bw.getvalue(),
                                                           block.size, chunk=4096),
             "sa": lambda: engine.mesh_l5_compress(mesh, data, block_size=32 << 10),
             "l1": lambda: engine.mesh_l1_compress(mesh, data, block_size=32 << 10)}
    got = {}
    for op in FAULT_OPS:
        try:
            calls[op]()
            got[op] = None
        except Exception as e:
            got[op] = (type(e).__name__, str(e), type(e.__cause__).__name__)
    return got


@pytest.fixture(scope="module")
def input_fault():
    t = time.monotonic()
    got = dryrun.spawn("test_torch_multihost:_rank_input_fault", 2, "cpu",
                       timeout=120, pythonpath=(TESTS,))
    assert time.monotonic() - t < 120
    return got


@pytest.mark.parametrize("op", FAULT_OPS)
def test_a_failing_input_move_raises_on_every_rank(input_fault, op):
    """A serving rank whose rows fail to reach its device (the conversion
    ahead of each step's kernels) still joins the first gather with its
    status word: both ranks raise MeshError, the injected error the cause on
    rank 1, and the mesh goes on to serve the next op."""
    for rank, res in enumerate(input_fault):
        name, msg, cause = res[op]
        assert name == "MeshError"
        assert cause == ("ArithmeticError" if rank == 1 else "NoneType")
    assert "rank(s) [1]" in input_fault[0][op][1]


def _rank_hang(mesh, pid_dir):
    """Rank 1 never joins the step's gather."""
    with open(os.path.join(pid_dir, f"{mesh.rank}.pid"), "w") as f:
        f.write(str(os.getpid()))
    if mesh.rank == 1:
        time.sleep(600)
    engine.make_pipeline_step(mesh, 4096)(np.zeros((1, 4096), np.uint8))


def test_a_hung_rank_ends_at_the_timeout(tmp_path):
    """No process outlives the launcher's timeout: the run raises, and both
    ranks are gone."""
    t = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        dryrun.spawn("test_torch_multihost:_rank_hang", 2, "cpu", (str(tmp_path),),
                     timeout=30, pythonpath=(TESTS,))
    assert time.monotonic() - t < 60
    pids = [int((tmp_path / f"{r}.pid").read_text()) for r in range(2)]
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_cuda_without_a_card_raises():
    """Every entry point that takes a device refuses ``cuda`` without a
    card, before it starts a process; none carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    calls = [lambda: engine.make_mesh(device="cuda"),
             lambda: dryrun.spawn("x:y", 1, "cuda"),
             lambda: dryrun.dryrun_multichip(1, "cuda"),
             lambda: dryrun.dryrun_multihost(2, "cuda"),
             lambda: dryrun.entry("cuda"),
             lambda: multihost.worker_main(0, 1, "127.0.0.1:1", None, "cuda")]
    for call in calls:
        with pytest.raises(RuntimeError, match="is_available"):
            call()


def test_entry_matches_kanzi_tpu_entry():
    """entry's step on the CPU (8 chunks of 4 KiB, the plain versions)
    equals kanzi_tpu's entry step there (ops/ans.py ans0_encode_chunks) on
    the same inputs."""
    import jax.numpy as jnp

    from kanzi_tpu.ops.ans import ans0_encode_chunks
    fn, args = dryrun.entry("cpu")
    payload, n_emit, states = fn(*args)
    want = [np.asarray(a) for a in ans0_encode_chunks(*(jnp.asarray(a.numpy()) for a in args))]
    np.testing.assert_array_equal(n_emit.numpy(), want[1])
    np.testing.assert_array_equal(states.numpy(), want[2])
    got = payload.numpy().view(np.uint16)
    for k, n in enumerate(want[1]):
        np.testing.assert_array_equal(got[k, :n], want[0][k, :n])
