"""The port's multi-GPU engine (kanzi_tpu_torch/parallel/engine.py), its
ANS0 stage, against kanzi_tpu's mesh (kanzi_tpu/parallel/engine.py) on the
same inputs.

The port's ranks are spawned gloo processes on the CPU (their kernels'
plain versions); kanzi_tpu's side runs on ``make_mesh(W)`` of the virtual
8-device CPU mesh (tests/conftest.py), with the same W.  Every comparison is
exact (tolerance 0): the step's arrays, the wire bytes, the decoded bytes.
Each world's ranks run once per module (``_rank_ans0``, executed in the
children) and the tests read their results.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from kanzi_tpu_torch.core.bits import BitWriter
from kanzi_tpu_torch.entropy.ans import ANSRangeEncoder
from kanzi_tpu_torch.parallel import dryrun

TESTS = os.path.dirname(os.path.abspath(__file__))
WIDTHS = (16384, 4096)


def _blob(world: int, chunk: int) -> np.ndarray:
    """2W+1 full chunks (the batch pads) and a tail, from numpy seed 1."""
    rng = np.random.default_rng(1)
    n = 2 * world + 1
    return rng.normal(48, 14, n * chunk + 257).clip(0, 255).astype(np.uint8)


def _step_rows(world: int) -> np.ndarray:
    """The 16 KiB chunks of _blob, padded to a multiple of W by repeating
    the last, as mesh_ans0_compress pads them."""
    nfull = 2 * world + 1
    chunks = _blob(world, 16384)[:nfull * 16384].reshape(nfull, 16384)
    return np.concatenate([chunks, np.repeat(chunks[-1:], (-nfull) % world, axis=0)])


def _rank_ans0(mesh) -> dict:
    """Every rank (in a spawned process): the SPMD steps on its rows, then
    the driven ANS0 paths; rank 0 reports everything, the other ranks the
    exception a corrupt wire raised there."""
    from kanzi_tpu_torch.parallel import engine as E

    w, r = mesh.size, mesh.rank
    rows = _step_rows(w)
    per = rows.shape[0] // w
    own = rows[r * per:(r + 1) * per]
    out: dict = {"step": E.make_pipeline_step(mesh, 16384)(own)}
    freq = out["step"][0][r * per:(r + 1) * per]
    cum = np.cumsum(freq, axis=1) - freq
    out["compress_step"] = E.compress_step(mesh, own, freq, cum)
    out["train_total"] = E.train_step(mesh, own, freq, cum)[3]
    for chunk in WIDTHS:
        blob = _blob(w, chunk)
        wire = E.mesh_ans0_compress(mesh, blob, chunk=chunk)
        out[("wire", chunk)] = wire
        out[("decoded", chunk)] = E.mesh_ans0_decompress(mesh, wire, blob.size, chunk=chunk)
        if wire is not None:
            bad = bytearray(wire)
            bad[len(bad) // 2] ^= 0xFF          # flip payload bits mid-stream
            wire = bytes(bad)
        try:
            E.mesh_ans0_decompress(mesh, wire, blob.size, chunk=chunk)
            out[("corrupt", chunk)] = None
        except Exception as e:
            out[("corrupt", chunk)] = type(e).__name__
    return out if r == 0 else {k: v for k, v in out.items() if k[0] == "corrupt"}


@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def world(request):
    """(W, each rank's results, kanzi_tpu's mesh of W devices)."""
    import jax

    from kanzi_tpu.parallel.engine import make_mesh
    w = request.param
    assert len(jax.devices()) >= w
    res = dryrun.spawn("test_torch_mesh_ans0:_rank_ans0", w, "cpu", timeout=300,
                       pythonpath=(TESTS,))
    return w, res, make_mesh(w)


def _assert_payload(got: np.ndarray, want: np.ndarray, lengths: np.ndarray) -> None:
    """Each row's emitted words equal kanzi_tpu's; the port gathers a
    power-of-two prefix at or above every length, and its words past a
    row's length are 0 (kanzi_tpu's XLA path leaves other words there)."""
    width = got.shape[1]
    assert width >= lengths.max() and width & (width - 1) == 0
    for k, n in enumerate(lengths):
        np.testing.assert_array_equal(got[k, :n], want[k, :n])
        assert not got[k, n:].any()


def test_pipeline_step_matches_kanzi_tpu(world):
    """freq, payload, lengths and states of make_pipeline_step on 2W+1
    chunks padded to the world equal kanzi_tpu's."""
    from kanzi_tpu.parallel.engine import make_pipeline_step as ref_step
    w, res, mesh = world
    rows = _step_rows(w)
    freq, pay, lengths, states = (np.asarray(a) for a in ref_step(mesh, 16384)(rows))
    got = res[0]["step"]
    np.testing.assert_array_equal(got[0], freq)
    np.testing.assert_array_equal(got[2], lengths)
    np.testing.assert_array_equal(got[3], states)
    _assert_payload(got[1], pay, lengths)


def test_compress_and_train_steps_match_kanzi_tpu(world):
    """compress_step with the step's tables and train_step's all_reduced
    total equal kanzi_tpu's (its psum)."""
    from kanzi_tpu.parallel.engine import compress_step, train_step
    w, res, mesh = world
    rows = _step_rows(w)
    freq = res[0]["step"][0]
    cum = np.cumsum(freq, axis=1) - freq
    pay, lengths, states = (np.asarray(a) for a in compress_step(mesh, rows, freq, cum))
    got = res[0]["compress_step"]
    np.testing.assert_array_equal(got[1], lengths)
    np.testing.assert_array_equal(got[2], states)
    _assert_payload(got[0], pay, lengths)
    assert res[0]["train_total"] == int(train_step(mesh, rows, freq, cum)[3])
    assert res[0]["train_total"] == 2 * int(lengths.sum())


@pytest.mark.parametrize("chunk", WIDTHS)
def test_mesh_ans0_compress_matches_kanzi_tpu_and_host(world, chunk):
    """The wire equals kanzi_tpu's mesh wire and the host encoder's in a
    fresh writer (kanzi_tpu's multihost.py asserts the same)."""
    from kanzi_tpu.parallel.engine import mesh_ans0_compress
    w, res, mesh = world
    blob = _blob(w, chunk)
    wire = res[0][("wire", chunk)]
    assert wire == mesh_ans0_compress(mesh, blob, chunk=chunk)
    bw = BitWriter()
    ANSRangeEncoder(bw, 0, chunk_size=chunk).encode(blob)
    assert wire == bw.getvalue()


@pytest.mark.parametrize("chunk", WIDTHS)
def test_mesh_ans0_decompress_round_trip(world, chunk):
    """The port's sharded decode gives the block back, and so does
    kanzi_tpu's sharded decode of the same wire."""
    from kanzi_tpu.parallel.engine import mesh_ans0_decompress
    w, res, mesh = world
    blob = _blob(w, chunk)
    np.testing.assert_array_equal(res[0][("decoded", chunk)], blob)
    ref = mesh_ans0_decompress(mesh, res[0][("wire", chunk)], blob.size, chunk=chunk)
    np.testing.assert_array_equal(np.asarray(ref), blob)


@pytest.mark.parametrize("chunk", WIDTHS)
def test_mesh_ans0_corrupt_payload_raises_on_every_rank(world, chunk):
    """A flipped payload byte raises BitStreamError on rank 0, and every
    other rank leaves its serve loop with a MeshError: none hangs."""
    w, res, _ = world
    assert res[0][("corrupt", chunk)] == "BitStreamError"
    assert [r[("corrupt", chunk)] for r in res[1:]] == ["MeshError"] * (w - 1)


def test_cuda_mesh_takes_16_kib_chunks_only():
    """On a CUDA rank the mesh's ANS0 functions refuse any chunk width but
    the kernels' 16 KiB, naming it, before any collective; so does the
    decode kernel's wrapper.  (The mesh object is built by hand: no card is
    needed to reach the checks.)"""
    import torch

    from kanzi_tpu_torch.ops import ans_cuda
    from kanzi_tpu_torch.parallel import engine as E

    mesh = E.Mesh(None, 0, 1, torch.device("cuda"), "nccl")
    for make in (lambda: E.make_pipeline_step(mesh, 4096),
                 lambda: E.make_decode_step(mesh, 256, 4096),
                 lambda: E.ans0_wire(mesh, np.zeros(8192, np.uint8), 4096)):
        with pytest.raises(ValueError, match="chunk 4096"):
            make()
    E.make_pipeline_step(mesh, 16384)        # the kernels' width passes
    meta = [torch.empty(s, dtype=d, device="meta") for s, d in (
        ((1, 256), torch.uint8), ((1,), torch.int32), ((1, 4), torch.int64),
        ((1, 256), torch.int32), ((1, 256), torch.int32))]
    with pytest.raises(ValueError, match="chunk width 4096"):
        ans_cuda.decode(*meta, width=4096)
