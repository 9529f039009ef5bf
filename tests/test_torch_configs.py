"""The configuration space on the CPU: the port's sweep harness reports a
failing configuration as a failure, never as a skip (app/benchmark.py; its
exit code is not 0), and the entropy stages at the device gates' block-size
and data edges (ANS0 and Huffman, transform NONE, device="cpu": the kernels'
plain versions) write kanzi_tpu's host streams byte for byte, decode in
both packages, and take the device where the gates say so.  chip_smoke.py
phase 15 runs the same edges on the card at full size."""

from __future__ import annotations

import hashlib
import io

import numpy as np
import pytest

from kanzi_tpu.app.block_compressor import BlockCompressor as HostCompressor
from kanzi_tpu.io import stream as host
from kanzi_tpu_torch.app import benchmark as bench
from kanzi_tpu_torch.io.stream import CompressedInputStream, CompressedOutputStream
from kanzi_tpu_torch.ops import ans_cuda, huffman_cuda
from kanzi_tpu_torch.utils.corpus import mixed_corpus

CHUNK = 16384


def _fake_config(fail: str):
    """A run_config that returns at once, and raises for ``fail``."""
    def run_config(data, t, e, block_size, jobs=4, *, device, checksum=0):
        if f"{t}+{e}" == fail:
            raise RuntimeError(f"round-trip failed for {t}+{e}")
        return bench.Result(f"{t}+{e} b=4M", len(data), len(data) // 2, 1.0, 1.0)
    return run_config


def test_sweep_failure_is_not_a_skip(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(bench, "run_config", _fake_config("BWT+ANS0"))
    with pytest.raises(bench.SweepFailed) as info:
        bench.run_sweep(b"x" * 1000, 1, device=None)
    names = [c for c, _ in info.value.failures]
    assert names == ["BWT+ANS0"]
    assert isinstance(info.value.failures[0][1], RuntimeError)
    # every other configuration still ran
    n = len(bench.SWEEP_TRANSFORMS) * len(bench.SWEEP_ENTROPIES)
    assert len(info.value.results) == n - 1
    out = capsys.readouterr().out
    assert "BWT+ANS0 [failed: RuntimeError: round-trip failed" in out
    assert "skipped" not in out
    src = tmp_path / "in.bin"
    src.write_bytes(b"y" * 1000)
    assert bench.main([str(src), "--sweep", "--device", "none"]) == 1
    assert "BWT+ANS0" in capsys.readouterr().err
    monkeypatch.setattr(bench, "run_config", _fake_config(""))
    assert bench.main([str(src), "--sweep", "--device", "none"]) == 0


class _Corrupting(bench.BlockDecompressor):
    def decompress_bytes(self, blob: bytes) -> bytes:
        out = super().decompress_bytes(blob)
        return out[:-1] + bytes([out[-1] ^ 1])


def _wrapper_refuses(chunks):
    raise ValueError("expected a CUDA tensor")


@pytest.mark.parametrize("fault", ["round trip", "kernel wrapper"])
def test_sweep_raises_on_real_failures(fault, monkeypatch, capsys):
    """A round trip that differs, and a kernel wrapper that raises (as one
    does on a tensor it does not take), fail the sweep's configurations."""
    data = mixed_corpus(100_000, seed=3).tobytes()
    if fault == "round trip":
        monkeypatch.setattr(bench, "BlockDecompressor", _Corrupting)
        entropy, kind = "NONE", RuntimeError
    else:
        monkeypatch.setattr(ans_cuda, "encode_chunks_tensors", _wrapper_refuses)
        entropy, kind = "ANS0", ValueError
    with pytest.raises(bench.SweepFailed) as info:
        bench.run_sweep(data, 1, entropies=[entropy], workers=2, quiet=True, device="cpu")
    failed = dict(info.value.failures)
    assert f"NONE+{entropy}" in failed
    assert all(isinstance(ex, kind) for ex in failed.values())
    assert len(failed) + len(info.value.results) == len(bench.SWEEP_TRANSFORMS)
    if fault == "round trip":
        assert len(failed) == len(bench.SWEEP_TRANSFORMS)
    assert "skipped" not in capsys.readouterr().out


def test_run_config_checksum_matches_reference():
    """run_config's checksum and its stream's digest: the port's stream at
    -x 64 equals kanzi_tpu's."""
    data = mixed_corpus(150_000, seed=4).tobytes()
    r = bench.run_config(data, "BWT+RANK+ZRLT", "ANS0", 1 << 16, 2, device=None, checksum=64)
    ref = HostCompressor(transform="BWT+RANK+ZRLT", entropy="ANS0", block_size=1 << 16,
                         jobs=2, checksum=64).compress_bytes(data)
    assert r.digest == hashlib.sha256(ref).hexdigest() and r.out_size == len(ref)
    plain = bench.run_config(data, "BWT+RANK+ZRLT", "ANS0", 1 << 16, 2, device=None)
    assert plain.out_size < r.out_size


def _edge_input(kind: str, n: int = 200_000) -> bytes:
    rng = np.random.default_rng(16)
    if kind == "one byte":
        return bytes([0x41]) * n
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    return np.where(rng.random(n) < 0.001, 0x42, 0x41).astype(np.uint8).tobytes()


@pytest.fixture
def device_calls(monkeypatch):
    """The blocks whose full chunks went to the device stage, each way."""
    calls = {"encode": 0, "decode": 0}

    def counting(mod, name, way):
        fn = getattr(mod, name)

        def run(*a, **kw):
            calls[way] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, run)

    counting(ans_cuda, "encode_chunks_tensors", "encode")
    counting(ans_cuda, "ans0_decode_chunks", "decode")
    counting(huffman_cuda, "encode_streams", "encode")
    counting(huffman_cuda, "decode_chunks", "decode")
    return calls


@pytest.mark.parametrize("kind", ["one byte", "random", "two symbols 999:1"])
@pytest.mark.parametrize("block", [64 * 1024 - 16, 64 * 1024, 80 * 1024])
@pytest.mark.parametrize("entropy", ["ANS0", "HUFFMAN"])
def test_entropy_block_edges(entropy, block, kind, device_calls):
    """Blocks of one chunk short of the encode gate's four (Huffman: host
    encode, device decode), exactly four chunks, and five; 200,000 B, so the
    last block is short.  A block's full chunks take the device on encode
    from four of them, on decode (ANS0: four; Huffman: one) when the block is
    entropy-coded and holds a chunk of two symbols: random blocks are stored
    as copies, one-byte chunks are a header only."""
    data = _edge_input(kind)
    ctx = {"transform": "NONE", "entropy": entropy, "blockSize": block, "jobs": 2}
    out = io.BytesIO()
    with CompressedOutputStream(out, ctx, device="cpu") as cos:
        cos.write(data)
    blob = out.getvalue()
    ref = io.BytesIO()
    with host.CompressedOutputStream(ref, ctx) as cos:
        cos.write(data)
    assert blob == ref.getvalue()
    with CompressedInputStream(io.BytesIO(blob), {"jobs": 2}, device="cpu") as cis:
        assert cis.read(-1) == data
    with host.CompressedInputStream(io.BytesIO(blob), {"jobs": 2}) as cis:
        assert cis.read(-1) == data
    nfull = [min(block, len(data) - s) // CHUNK for s in range(0, len(data), block)]
    enc = sum(n >= 4 for n in nfull)
    dec = sum(n >= (4 if entropy == "ANS0" else 1) for n in nfull)
    assert device_calls == {"encode": enc, "decode": dec if kind.startswith("two") else 0}
