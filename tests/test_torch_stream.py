"""The port's whole slice on device=cpu (the kernels' plain versions): its
streams against kanzi_tpu's host streams and frozen golden bytes, byte for
byte, and its decoder against corrupt streams (reject or decode exactly)."""

from __future__ import annotations

import io
import os

import numpy as np
import pytest

from kanzi_tpu.app.block_compressor import LEVELS, BlockCompressor
from kanzi_tpu_torch.core.bits import BitReader, BitWriter
from kanzi_tpu_torch.core.errors import BitStreamError
from kanzi_tpu_torch.entropy.ans import ANSRangeDecoder, ANSRangeEncoder
from kanzi_tpu.io import stream as host
from kanzi_tpu.ops import ans_block as jblock
from kanzi_tpu.utils.corpus import mixed_corpus
from kanzi_tpu_torch.io.stream import CompressedInputStream, CompressedOutputStream
from kanzi_tpu_torch.ops import ans_block, ans_cuda

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CHUNK = 16384


def _compress(data: bytes, ctx: dict) -> bytes:
    out = io.BytesIO()
    with CompressedOutputStream(out, ctx, device="cpu") as cos:
        cos.write(data)
    return out.getvalue()


def _decompress(blob: bytes, jobs: int) -> bytes:
    with CompressedInputStream(io.BytesIO(blob), {"jobs": jobs}, device="cpu") as cis:
        return cis.read(-1)


def test_level5_golden_bytes():
    data = mixed_corpus(256 * 1024, seed=1234).tobytes()
    t, e, b = LEVELS[5]
    ctx = BlockCompressor(transform=t, entropy=e, block_size=b, jobs=1)._ctx(len(data))
    blob = _compress(data, ctx)
    with open(os.path.join(GOLDEN, "l5.knz"), "rb") as f:
        assert blob == f.read()
    assert _decompress(blob, 1) == data


@pytest.mark.parametrize("size", [3 * (512 << 10) + 24, 3 * (512 << 10) - 5000],
                         ids=["final_block_24B", "tail_chunk"])
def test_ans0_stream_matches_host(size):
    data = mixed_corpus(size, seed=21).tobytes()
    ctx = {"transform": "NONE", "entropy": "ANS0", "blockSize": 512 << 10,
           "jobs": 2}
    blob = _compress(data, ctx)
    ref = io.BytesIO()
    with host.CompressedOutputStream(ref, ctx) as cos:
        cos.write(data)
    assert blob == ref.getvalue()
    assert _decompress(blob, 2) == data
    with host.CompressedInputStream(io.BytesIO(blob), {"jobs": 2}) as cis:
        assert cis.read(-1) == data


@pytest.mark.parametrize("size", [24, 40 * 1024 - 3], ids=["raw", "chunks_and_tail"])
def test_ans0_wire_matches_reference_glue(size):
    """The port's block glue against kanzi_tpu.ops.ans_block.ans0_encode (its
    XLA path here), and its decode back."""
    block = mixed_corpus(size, seed=5)
    bw, ref = BitWriter(), BitWriter()
    ans_block.ans0_encode(block, bw, "cpu")
    jblock.ans0_encode(block, ref)
    wire = bw.getvalue()
    assert wire == ref.getvalue()
    got = ans_block.ans0_decode(size, BitReader(np.frombuffer(wire, np.uint8)), "cpu")
    assert np.array_equal(got, block)


@pytest.mark.parametrize("transform", ["NONE", LEVELS[5][0]])
def test_corrupt_stream_reject_or_exact(transform):
    """Byte flips, bit flips and truncations anywhere must raise or decode
    to the exact input, never to wrong data (tests/test_stream.py's sweep)."""
    data = mixed_corpus(80 << 10, seed=105).tobytes()
    ctx = {"transform": transform, "entropy": "ANS0", "blockSize": 64 << 10,
           "jobs": 2, "checksum": 32}
    blob = _compress(data, ctx)
    rng = np.random.default_rng(len(transform))
    for trial in range(9):
        ba = bytearray(blob)
        kind = trial % 3
        if kind == 0:
            ba[int(rng.integers(0, len(ba)))] ^= int(rng.integers(1, 256))
        elif kind == 1:
            del ba[int(rng.integers(1, len(ba))):]
        else:
            ba[int(rng.integers(0, len(ba)))] ^= 1 << int(rng.integers(0, 8))
        try:
            out = _decompress(bytes(ba), 2)
        except Exception:
            continue
        assert out == data, f"trial {trial}: corrupt stream decoded to wrong data"


def test_short_chunk_payload_rejected():
    """A chunk whose payload lacks its last word gives a consumed-count
    mismatch on decode, not wrong bytes."""
    chunks = mixed_corpus(2 * CHUNK, seed=9).reshape(2, CHUNK)
    freq, payload, n_emit, states = ans_cuda.ans0_encode_device(chunks, "cpu")
    nz = freq > 0
    alphabets = [np.flatnonzero(r).astype(np.int32) for r in nz]
    bw = BitWriter()
    ans_block.assemble_ans0_wire(bw, freq, nz.sum(1), alphabets, n_emit - [1, 0],
                                 states, payload, np.arange(2))
    br = BitReader(np.frombuffer(bw.getvalue(), np.uint8))
    with pytest.raises(BitStreamError, match="size mismatch"):
        ans_block.ans0_decode(2 * CHUNK, br, "cpu")


@pytest.mark.parametrize("size,glue", [(4 * CHUNK - 1, False), (4 * CHUNK, True)],
                         ids=["under_four_chunks", "four_chunks"])
def test_ans0_gate_minimum(monkeypatch, size, glue):
    """The order-0 gate takes the device glue only for blocks of at least
    four full 16 KiB chunks, on encode and on decode, as kanzi_tpu's
    (kanzi_tpu/entropy/ans.py); either side of that size the stream equals
    the host coders' and decodes back."""
    calls = []
    for name in ("ans0_encode", "ans0_decode"):
        real = getattr(ans_block, name)
        monkeypatch.setattr(ans_block, name,
                            lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    block = mixed_corpus(size, seed=17)

    def encode(device):
        bw = BitWriter()
        assert ANSRangeEncoder(bw, 0, device=device).encode(block) == size
        return bw.getvalue()

    wire = encode("cpu")
    assert calls == (["ans0_encode"] if glue else [])
    assert wire == encode(None)
    for device in ("cpu", None):
        out = ANSRangeDecoder(BitReader(np.frombuffer(wire, np.uint8)), 0,
                              device=device).decode(size)
        assert np.array_equal(np.asarray(out, np.uint8), block)
    assert calls == (["ans0_encode", "ans0_decode"] if glue else [])
