"""The port's Huffman stage on device=cpu (the kernels' plain versions): its
streams at levels 2 and 3 and Huffman alone against kanzi_tpu's host streams
and frozen golden bytes, byte for byte, each side decoding the other's; its
decoder against corrupt streams (reject or decode exactly); and its streams
under KANZI_TPU_DEVICE_LZ=1, which run the port's own device LZ engine,
without jax or kanzi_tpu, and equal kanzi_tpu's device-LZ streams."""

from __future__ import annotations

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from kanzi_tpu.app.block_compressor import LEVELS, BlockCompressor
from kanzi_tpu_torch.core.bits import BitReader, BitWriter
from kanzi_tpu_torch.core.errors import BitStreamError
from kanzi_tpu_torch.entropy import utils as eu
from kanzi_tpu_torch.entropy.expgolomb import ExpGolombEncoder
from kanzi_tpu.io import stream as host
from kanzi_tpu.utils.corpus import mixed_corpus
from kanzi_tpu_torch.io.stream import CompressedInputStream, CompressedOutputStream
from kanzi_tpu_torch.ops import huffman_block, huffman_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
CHUNK = 16384


def _compress(data: bytes, ctx: dict) -> bytes:
    out = io.BytesIO()
    with CompressedOutputStream(out, ctx, device="cpu") as cos:
        cos.write(data)
    return out.getvalue()


def _decompress(blob: bytes, jobs: int) -> bytes:
    with CompressedInputStream(io.BytesIO(blob), {"jobs": jobs}, device="cpu") as cis:
        return cis.read(-1)


def _host_compress(data: bytes, ctx: dict) -> bytes:
    out = io.BytesIO()
    with host.CompressedOutputStream(out, ctx) as cos:
        cos.write(data)
    return out.getvalue()


@pytest.fixture
def device_calls(monkeypatch):
    """Counts the chunks that went through the device encode and decode."""
    calls = {"encode": 0, "decode": 0}
    enc, dec = huffman_cuda.encode_streams, huffman_cuda.decode_chunks

    def encode_streams(chunks, tbl):
        calls["encode"] += chunks.shape[0]
        return enc(chunks, tbl)

    def decode_chunks(pay, bnd, adj, perm):
        calls["decode"] += pay.shape[0]
        return dec(pay, bnd, adj, perm)

    monkeypatch.setattr(huffman_cuda, "encode_streams", encode_streams)
    monkeypatch.setattr(huffman_cuda, "decode_chunks", decode_chunks)
    return calls


@pytest.mark.parametrize("level", [2, 3])
def test_golden_bytes(level, device_calls):
    data = mixed_corpus(256 * 1024, seed=1234).tobytes()
    t, e, b = LEVELS[level]
    ctx = BlockCompressor(transform=t, entropy=e, block_size=b, jobs=1)._ctx(len(data))
    blob = _compress(data, ctx)
    with open(os.path.join(GOLDEN, f"l{level}.knz"), "rb") as f:
        assert blob == f.read()
    assert _decompress(blob, 1) == data
    assert device_calls["encode"] >= 4 and device_calls["decode"] >= 4


@pytest.mark.parametrize("transform,block", [("NONE", (64 << 10) + 4096),
                                             (LEVELS[2][0], 64 << 10),
                                             (LEVELS[3][0], 64 << 10)],
                         ids=["huffman_alone", "level2", "level3"])
def test_huffman_stream_matches_host(transform, block, device_calls):
    """~200 KiB; Huffman alone has a tail chunk in every device block."""
    data = mixed_corpus(200 * 1024 + 77, seed=31).tobytes()
    ctx = {"transform": transform, "entropy": "HUFFMAN", "blockSize": block, "jobs": 2}
    blob = _compress(data, ctx)
    assert blob == _host_compress(data, ctx)
    assert _decompress(blob, 2) == data
    with host.CompressedInputStream(io.BytesIO(blob), {"jobs": 2}) as cis:
        assert cis.read(-1) == data
    assert device_calls["decode"] > 0
    if transform == "NONE":
        assert device_calls["encode"] > 0


@pytest.mark.parametrize("transform", ["NONE", LEVELS[3][0]])
def test_corrupt_stream_reject_or_exact(transform):
    """Byte flips, bit flips and truncations anywhere must raise or decode
    to the exact input, never to wrong data (tests/test_stream.py's sweep)."""
    data = mixed_corpus(96 << 10, seed=106).tobytes()
    ctx = {"transform": transform, "entropy": "HUFFMAN", "blockSize": 64 << 10,
           "jobs": 2, "checksum": 32}
    blob = _compress(data, ctx)
    rng = np.random.default_rng(len(transform) + 1)
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


def test_short_stream_rejected(monkeypatch):
    """A stream whose wire lacks its last full word gives a bit count
    mismatch on decode, not wrong bytes."""
    real = huffman_cuda.encode_streams

    def short(chunks, tbl):
        words, n_words, acc, nbits = real(chunks, tbl)
        n_words = n_words.clone()
        n_words[-1] -= 1           # the last stream of the last chunk
        return words, n_words, acc, nbits

    block = mixed_corpus(4 * CHUNK, seed=9)
    bw = BitWriter()
    with monkeypatch.context() as mp:
        mp.setattr(huffman_cuda, "encode_streams", short)
        assert huffman_block.huffman_encode_full(block, bw, "cpu") == 4 * CHUNK
    br = BitReader(np.frombuffer(bw.getvalue(), np.uint8))
    with pytest.raises(BitStreamError, match="length mismatch"):
        huffman_block.huffman_decode(4 * CHUNK, br, "cpu")
    good = BitWriter()
    huffman_block.huffman_encode_full(block, good, "cpu")
    br = BitReader(np.frombuffer(good.getvalue(), np.uint8))
    assert np.array_equal(huffman_block.huffman_decode(4 * CHUNK, br, "cpu"), block)


@pytest.mark.parametrize("lengths,match", [((), "empty Huffman alphabet"),
                                           ((1, 1, 1), "oversubscribed")])
def test_bad_header_rejected(lengths, match):
    """A chunk header with an empty alphabet, or with code lengths that do
    not fit the 12-bit code space."""
    bw = BitWriter()
    eu.encode_alphabet(bw, np.arange(10, 10 + len(lengths)))
    if lengths:
        deltas = np.diff(np.concatenate([[2], lengths]))
        ExpGolombEncoder(bw, True).encode(deltas.astype(np.uint8))
        for _ in range(4):
            eu.write_varint(bw, 0)
    bw.write_bytes(bytes(64))
    br = BitReader(np.frombuffer(bw.getvalue(), np.uint8))
    with pytest.raises(BitStreamError, match=match):
        huffman_block.huffman_decode(CHUNK, br, "cpu")


def test_read_bits_vec_on_a_large_reader():
    """BitReader.read_bits_vec, which the Huffman glue's header reads now
    run on the block's own reader, copies only the bytes its call reads: on
    a 1 MiB + 5 B reader it equals per-item read_bits at the start, in the
    middle and over the last bits, and a read past the end raises
    EOFError."""
    rng = np.random.default_rng(31)
    data = rng.integers(0, 256, (1 << 20) + 5, dtype=np.uint8)
    nbits = data.size * 8 - 3
    counts = rng.integers(0, 57, 40)
    counts[0] = 56             # unaligned, its first bits in the window's first byte
    total = int(counts.sum())
    for pos in (0, 5, nbits // 2 + 3, nbits - total):
        vec = BitReader(data, nbits=nbits, bitpos=pos)
        one = BitReader(data, nbits=nbits, bitpos=pos)
        got = vec.read_bits_vec(counts)
        assert got.tolist() == [one.read_bits(int(c)) for c in counts], pos
        assert vec.read_count == one.read_count == pos + total
    with pytest.raises(EOFError):
        BitReader(data, nbits=nbits, bitpos=nbits - total + 1).read_bits_vec(counts)


_LZX_STREAM = """
import io, sys
from kanzi_tpu_torch.utils.corpus import mixed_corpus
from kanzi_tpu_torch.io.stream import CompressedOutputStream
data = mixed_corpus(120000, seed=4).tobytes()
buf = io.BytesIO()
ctx = {"transform": "LZX", "entropy": "HUFFMAN", "blockSize": 1 << 16}
with CompressedOutputStream(buf, ctx, device="cpu") as cos:
    cos.write(data)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "kanzi_tpu"))
assert not loaded, loaded
sys.stdout.write(buf.getvalue().hex())
"""


def test_device_lz_variable_does_not_reach_jax(monkeypatch):
    """Under KANZI_TPU_DEVICE_LZ=1 the port's writer runs its own device LZ
    engine (ops/lz_sort.py, on the plain versions for device=cpu), in a
    fresh process that loads neither jax nor kanzi_tpu (tests/conftest.py
    imports jax into this one).  Its stream equals kanzi_tpu's under the
    same variable, with the Pallas word kernel in interpret mode, and
    differs from the host parse's."""
    env = dict(os.environ, KANZI_TPU_DEVICE_LZ="1")
    env.pop("KANZI_TPU_PALLAS_INTERPRET", None)
    res = subprocess.run([sys.executable, "-c", _LZX_STREAM], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    data = mixed_corpus(120000, seed=4).tobytes()
    ctx = {"transform": "LZX", "entropy": "HUFFMAN", "blockSize": 1 << 16}
    monkeypatch.setenv("KANZI_TPU_DEVICE_LZ", "1")
    monkeypatch.setenv("KANZI_TPU_PALLAS_INTERPRET", "1")
    ref = _host_compress(data, ctx)
    assert bytes.fromhex(res.stdout) == ref
    monkeypatch.delenv("KANZI_TPU_DEVICE_LZ")
    assert _host_compress(data, ctx) != ref
