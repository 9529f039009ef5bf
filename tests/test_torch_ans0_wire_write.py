"""The ANS0 encode's native record writer (kanzi_tpu_torch/hostsrc/ans0_wire.cpp
kz_ans0_wire_write, through ops/ans_block.py encode_ans0_wire) against
kanzi_tpu's device glue writer (kanzi_tpu/ops/ans_block.py
assemble_ans0_wire, with kanzi_tpu's host encoder for the tail): the same
bytes and bit count from the same device rows, the host encoder's bytes, a
wire that the host decoder and decode_ans0_wire read back, the tail through
the native coder above 32 bytes only, one counter a block, GLUE_LOCK held
around the device rows alone, and RuntimeError, with nothing written, where
the native library is withheld."""

from __future__ import annotations

import io

import numpy as np
import pytest

from kanzi_tpu.core.bits import BitWriter as JBitWriter
from kanzi_tpu.entropy import ans as jhans
from kanzi_tpu.io.stream import CompressedOutputStream as JCompressedOutputStream
from kanzi_tpu.ops import ans_block as jans_block
from kanzi_tpu_torch.app.block_compressor import LEVELS
from kanzi_tpu_torch.core.bits import BitReader, BitWriter
from kanzi_tpu_torch.entropy import ans as hans
from kanzi_tpu_torch.io.stream import CompressedInputStream, CompressedOutputStream
from kanzi_tpu_torch.ops import ans_block, ans_cuda, glue, launch
from kanzi_tpu_torch.utils import native_coders
from kanzi_tpu_torch.utils.corpus import mixed_corpus

CHUNK = 16384


@pytest.fixture
def no_native(monkeypatch):
    """Withhold the native library from the host coders and the writer."""
    def withhold():
        monkeypatch.setattr(native_coders, "_lib", lambda: None)
    return withhold


def _chunk(nsym: int, rng, size: int = CHUNK, ones: int = 0) -> np.ndarray:
    """``size`` bytes over ``nsym`` distinct symbols (skewed counts), the
    last ``ones`` of them seen once each (a frequency of 1 after
    normalisation, so groups of them have logMax 0)."""
    syms = rng.permutation(256)[:nsym].astype(np.uint8)
    body = syms[:nsym - ones]
    p = rng.pareto(1.2, body.size) + 1
    out = rng.choice(body, size - ones, p=p / p.sum())
    out[:body.size] = body[:size - ones]              # each symbol at least once
    out = np.concatenate([out, syms[nsym - ones:]])
    return rng.permutation(out).astype(np.uint8)


def _cpu_rows(chunks: np.ndarray):
    """The device rows from the kernels' plain PyTorch versions on cpu."""
    return ans_cuda.ans0_encode_device(chunks, "cpu")


def _cases():
    """(id, chunk segments, payload layout): ``pow2`` the power-of-two width
    the device path fetches, ``full`` a width equal to the longest payload,
    ``junk`` random words past every payload's end."""
    rng = np.random.default_rng(2025)
    c = []
    for nsym in (1, 2, 6, 7, 63, 64, 65, 256):
        c.append((f"alphabet_{nsym}", [_chunk(nsym, rng) for _ in range(4)], "pow2"))
    c.append(("logmax_0_groups", [_chunk(200, rng, ones=190), _chunk(70, rng, ones=64),
                                  _chunk(9, rng, ones=8), _chunk(256, rng)], "pow2"))
    c.append(("mixed_singles", [_chunk(1, rng), _chunk(40, rng), _chunk(1, rng),
                                _chunk(256, rng)], "pow2"))
    c.append(("payload_fills_width", [_chunk(n, rng) for n in (3, 256, 40, 128)], "full"))
    c.append(("junk_past_payload", [_chunk(n, rng) for n in (5, 90, 256, 17)], "junk"))
    for tail in (0, 1, 32, 33, 16383):
        segs = [_chunk(50, rng) for _ in range(4)]
        if tail:
            segs.append(_chunk(min(tail, 20), rng, size=tail))
        c.append((f"tail_{tail}", segs, "pow2"))
    return c


CASES = _cases()


def _layout(rows, layout: str, rng):
    freq, payload, n_emit, states = rows
    top = int(n_emit.max(initial=0))
    if layout == "full":
        return freq, np.ascontiguousarray(payload[:, :top]), n_emit, states
    w = min(1 << max(top - 1, 1).bit_length(), payload.shape[1])
    payload = payload[:, :w].copy()
    if layout == "junk":
        past = np.arange(w)[None, :] >= n_emit[:, None]
        payload[past] = rng.integers(1, 1 << 16, int(past.sum()), dtype=np.uint16)
    return freq, payload, n_emit, states


def _encode(block: np.ndarray, rows) -> tuple[bytes, int, int]:
    """encode_ans0_wire of ``block`` with ``rows``: (wire bytes, bits, the
    writer counter's increment)."""
    before = launch.launches["ans0_wire_write_native"]
    bw = BitWriter()
    assert ans_block.encode_ans0_wire(block, bw, rows) == block.size
    arr, nbits = bw.getvalue_packed()
    return arr.tobytes(), nbits, launch.launches["ans0_wire_write_native"] - before


def _reference(block: np.ndarray, rows) -> tuple[bytes, int]:
    """kanzi_tpu's wire of ``block`` from the same rows: its
    assemble_ans0_wire for the full chunks, its host encoder for the tail."""
    freq, payload, n_emit, states = rows
    nfull = len(n_emit)
    freq = np.asarray(freq, dtype=np.int64)
    nz = freq > 0
    bw = JBitWriter()
    jans_block.assemble_ans0_wire(bw, freq, nz.sum(axis=1),
                                  [np.flatnonzero(r).astype(np.int32) for r in nz],
                                  n_emit, states, payload, np.arange(nfull))
    if block.size > nfull * CHUNK:
        jhans.ANSRangeEncoder(bw, 0)._encode_chunk(block[nfull * CHUNK:], bw)
    arr, nbits = bw.getvalue_packed()
    return arr.tobytes(), nbits


def _decode_rows(pay, lens, states, freq, cum):
    return ans_cuda.ans0_decode_chunks(pay, states, freq, cum, "cpu", lengths=lens)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_native_write_matches_python(case, no_native, monkeypatch):
    """The native writer's wire equals kanzi_tpu's from the same rows, byte
    for byte and bit count for bit count, and the host encoder's; it reads
    back through the host decoder and through decode_ans0_wire; a tail of
    more than 32 bytes, and only such a tail, goes through the native
    coder; without the native library the encode raises and writes
    nothing."""
    _, segs, layout = case
    block = np.concatenate(segs)
    nfull = block.size // CHUNK
    tail = block.size - nfull * CHUNK
    rows = _layout(_cpu_rows(block[:nfull * CHUNK].reshape(nfull, CHUNK)), layout,
                   np.random.default_rng(1))

    tails = []
    real = ans_block.ans_encode_native
    monkeypatch.setattr(ans_block, "ans_encode_native",
                        lambda seg, *a: tails.append(seg.size) or real(seg, *a))
    native = _encode(block, lambda chunks: rows)
    assert native[2] == 1
    assert tails == ([tail] if tail > 32 else [])

    ref = _reference(block, rows)
    assert native[1] == ref[1]
    assert native[0] == ref[0]
    hw = BitWriter()
    hans.ANSRangeEncoder(hw, 0).encode(block)
    assert native[0] == hw.getvalue()

    wire = np.frombuffer(native[0], np.uint8)
    assert np.array_equal(hans.ANSRangeDecoder(BitReader(wire), 0).decode(block.size), block)
    assert np.array_equal(ans_block.decode_ans0_wire(block.size, BitReader(wire), _decode_rows),
                          block)
    no_native()
    bw = BitWriter()
    with pytest.raises(RuntimeError, match="native library"):
        ans_block.encode_ans0_wire(block, bw, lambda chunks: rows)
    assert bw.getvalue() == b""


def test_rows_outside_their_width_raise():
    """A payload length past the row's width, or below 0, is refused before
    the native call."""
    rng = np.random.default_rng(4)
    chunks = np.stack([_chunk(30, rng) for _ in range(2)])
    freq, payload, n_emit, states = _cpu_rows(chunks)
    top = int(n_emit.max())
    for ne in (n_emit + (n_emit == top), n_emit - 2 * (n_emit == top) * top):
        with pytest.raises(ValueError, match="payload lengths"):
            native_coders.ans0_wire_write_native(freq, ne, states, payload[:, :top], 12)


def _level5(nblocks: int, device) -> bytes:
    t, e, _ = LEVELS[5]
    data = mixed_corpus(nblocks * (1 << 20), seed=12).tobytes()
    ctx = {"transform": t, "entropy": e, "blockSize": 1 << 20, "jobs": 1}
    out = io.BytesIO()
    with CompressedOutputStream(out, ctx, device=device) as cos:
        cos.write(data)
    return out.getvalue()


def test_level5_blocks_on_cpu(no_native, monkeypatch):
    """Two level-5 blocks of mixed_corpus through ans0_encode(..., "cpu")
    (the kernels' plain versions): the stream equals the host coders' and
    kanzi_tpu's host stream, and reads back; one count a block on the
    native writer; without the library the encode raises RuntimeError."""
    data = mixed_corpus(2 * (1 << 20), seed=12).tobytes()
    host = _level5(2, None)
    t, e, _ = LEVELS[5]
    ref = io.BytesIO()
    with JCompressedOutputStream(ref, {"transform": t, "entropy": e, "blockSize": 1 << 20,
                                       "jobs": 1}) as cos:
        cos.write(data)
    assert ref.getvalue() == host
    sizes = []
    real = ans_block.encode_ans0_wire
    monkeypatch.setattr(ans_block, "encode_ans0_wire",
                        lambda block, *a: sizes.append(block.size) or real(block, *a))

    def encode():
        launch.reset_launches()
        blob = _level5(2, "cpu")
        return blob, launch.launches["ans0_wire_write_native"]

    assert encode() == (host, 2)
    assert len(sizes) == 2 and min(sizes) >= 4 * CHUNK and all(s % CHUNK for s in sizes)
    with CompressedInputStream(io.BytesIO(host), {"jobs": 1}, device=None) as cis:
        assert cis.read(-1) == data
    no_native()
    with pytest.raises(RuntimeError, match="native library"):
        encode()
    assert launch.launches["ans0_wire_write_native"] == 0


def test_counter_and_lock_a_block(no_native, monkeypatch):
    """A block through ans0_encode adds one to ans0_wire_write_native;
    withheld, the library's absence raises, writes nothing and counts
    nothing; a block of 32 bytes or less writes no record and counts
    nothing, with or without the library.  GLUE_LOCK is held while the
    device rows run and released before the records are written."""
    rng = np.random.default_rng(5)
    block = np.concatenate([_chunk(n, rng) for n in (1, 7, 1, 200)]
                           + [_chunk(3, rng, size=100)])
    held = []
    rows, write = ans_block._device_rows, ans_block.ans0_wire_write_native
    monkeypatch.setattr(ans_block, "_device_rows",
                        lambda *a: held.append(("rows", glue.GLUE_LOCK.locked())) or rows(*a))
    monkeypatch.setattr(ans_block, "ans0_wire_write_native",
                        lambda *a: held.append(("write", glue.GLUE_LOCK.locked())) or write(*a))
    hw = JBitWriter()
    jhans.ANSRangeEncoder(hw, 0).encode(block)
    for native in (True, False):
        if not native:
            no_native()
        before = dict(launch.launches)
        bw = BitWriter()
        if native:
            assert ans_block.ans0_encode(block, bw, "cpu") == block.size
            assert bw.getvalue() == hw.getvalue()
        else:
            with pytest.raises(RuntimeError, match="native library"):
                ans_block.ans0_encode(block, bw, "cpu")
            assert bw.getvalue() == b""
        small = BitWriter()
        assert ans_block.ans0_encode(block[:20], small, "cpu") == 20
        assert small.getvalue() == block[:20].tobytes()
        diff = {k: launch.launches[k] - before.get(k, 0) for k in launch.launches}
        assert {k: v for k, v in diff.items() if v} == (
            {"ans0_wire_write_native": 1} if native else {})
    assert held == [("rows", True), ("write", False)] * 2
    assert not glue.GLUE_LOCK.locked()
