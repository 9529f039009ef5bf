"""The ANS0 decode's native wire parse (kanzi_tpu_torch/hostsrc/ans0_wire.cpp
through ops/ans_block.py parse_ans0_wire) against the Python parse it
replaces, which runs where the native library is withheld (the
native_coders ``_lib()``-is-None path): the same rows, tables, states,
payloads, single-symbol chunks, resume point and reader position on valid
blocks; the same exception class and message, at the same point, on
corrupt and truncated ones; and the same decoded bytes, the host's tail
through the native coder included."""

from __future__ import annotations

import io

import numpy as np
import pytest

from kanzi_tpu_torch.app.block_compressor import LEVELS
from kanzi_tpu_torch.core.bits import BitReader, BitWriter
from kanzi_tpu_torch.core.errors import BitStreamError
from kanzi_tpu_torch.entropy import ans as hans
from kanzi_tpu_torch.entropy import utils as eu
from kanzi_tpu_torch.io.stream import CompressedInputStream, CompressedOutputStream
from kanzi_tpu_torch.ops import ans_block, launch
from kanzi_tpu_torch.utils import native_coders
from kanzi_tpu_torch.utils.corpus import mixed_corpus

CHUNK = 16384


@pytest.fixture
def no_native(monkeypatch):
    """Withhold the native library from the host coders and the parse."""
    def withhold():
        monkeypatch.setattr(native_coders, "_lib", lambda: None)
    return withhold


def _chunk(nsym: int, rng, size: int = CHUNK, ones: int = 0) -> np.ndarray:
    """``size`` bytes over ``nsym`` distinct symbols (skewed counts), the
    last ``ones`` of them seen once each (a frequency of 1 after
    normalisation, so groups of them have logMax 0)."""
    if nsym == 0:
        return np.zeros(0, np.uint8)
    syms = rng.permutation(256)[:nsym].astype(np.uint8)
    body = syms[:nsym - ones]
    p = rng.pareto(1.2, body.size) + 1
    out = rng.choice(body, size - ones, p=p / p.sum())
    out[:body.size] = body[:size - ones]              # each symbol at least once
    out = np.concatenate([out, syms[nsym - ones:]])
    return rng.permutation(out).astype(np.uint8)


def _record(bw: BitWriter, seg: np.ndarray, lr: int = 12) -> None:
    """One chunk record of the order-0 wire, at log range ``lr``."""
    hans.ANSRangeEncoder(bw, 0, log_range=lr)._encode_chunk(seg, bw)


def _wire(segs, lrs=None, lead: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(block, wire bytes) of consecutive chunk records, after ``lead``
    bits of another stage."""
    bw = BitWriter()
    if lead:
        bw.write_bits(0x5A5A, lead)
    for k, seg in enumerate(segs):
        _record(bw, seg, 12 if lrs is None else lrs[k])
    return np.concatenate(segs), np.frombuffer(bw.getvalue(), np.uint8)


def _rows_host(native: bool = True):
    """A ``rows`` that decodes on the host: each row's record rebuilt (log
    range, header from its table, varint, states, payload) and read back by
    the native coder or, with ``native`` false, the numpy chunk decoder."""
    def rows(pay, lens, states, freq, cum):
        out = np.empty((len(lens), CHUNK), np.uint8)
        for k in range(len(lens)):
            bw = BitWriter()
            bw.write_bits(12 - 8, 3)
            alpha = np.flatnonzero(freq[k]).astype(np.int32)
            hans._write_freqs_header(bw, alpha, freq[k].astype(np.int64), 12)
            eu.write_varint(bw, int(lens[k]))
            for j in range(4):
                bw.write_bits(int(states[k, j]), 32)
            bw.write_bytes(pay[k, :lens[k]])
            br = BitReader(np.frombuffer(bw.getvalue(), np.uint8))
            if native:
                out[k] = native_coders.ans_decode_native(CHUNK, br, 0, CHUNK)
            else:
                hans.ANSRangeDecoder(br, 0)._decode_chunk(out[k], 0, CHUNK, br)
        return out, np.asarray(lens, np.int32)
    return rows


def _parse(wire: np.ndarray, nfull: int, *, native: bool, bitpos: int = 0,
           host_log_ranges: bool = True):
    br = BitReader(wire, bitpos=bitpos)
    if native:
        got = ans_block.parse_ans0_wire(br, nfull, host_log_ranges)
    else:
        got = ans_block._parse_py(br, nfull, host_log_ranges)
    return got, br.read_count


def _outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except (BitStreamError, EOFError, IndexError) as e:
        return "raise", (type(e), str(e))


def _same_parse(a, b) -> None:
    (wa, pa), (wb, pb) = a, b
    assert pa == pb
    assert wa.resume == wb.resume
    for name in ("rows", "freq", "cum", "states", "lens", "payload", "single"):
        x, y = getattr(wa, name), getattr(wb, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert np.array_equal(x, y), name


def _cases():
    """(id, chunk segments, their log ranges or None for 12 each)."""
    rng = np.random.default_rng(2024)
    c = []
    for nsym in (1, 2, 5, 63, 64, 200, 256):
        c.append((f"alphabet_{nsym}", [_chunk(nsym, rng) for _ in range(4)], None))
    c.append(("logmax_0_groups", [_chunk(200, rng, ones=190), _chunk(70, rng, ones=64),
                                  _chunk(9, rng, ones=8), _chunk(256, rng)], None))
    c.append(("mixed_singles", [_chunk(1, rng), _chunk(40, rng), _chunk(1, rng),
                                _chunk(256, rng)], None))
    c.append(("lr_at_chunk_0", [_chunk(30, rng) for _ in range(4)], [9, 12, 12, 12]))
    c.append(("lr_mid_block", [_chunk(30, rng) for _ in range(5)], [12, 12, 15, 12, 8]))
    for tail in (0, 1, 32, 33, 16383):
        segs = [_chunk(50, rng) for _ in range(4)]
        if tail:
            segs.append(_chunk(min(tail, 20), rng, size=tail))
        c.append((f"tail_{tail}", segs, None))
    return c


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_native_parse_matches_python(case, no_native, monkeypatch):
    """Parse and decode of valid blocks: the native parse's arrays, resume
    point and reader position equal the Python parse's; both decodes return
    the block; the host's chunks of more than 32 bytes go through the
    native coder, and only those."""
    _, segs, lrs = case
    block, wire = _wire(segs, lrs)
    nfull = block.size // CHUNK
    for lead in (5, 0):                       # not byte-aligned, then aligned
        w = _wire(segs, lrs, lead)[1]
        native = _parse(w, nfull, native=True, bitpos=lead)
        _same_parse(native, _parse(w, nfull, native=False, bitpos=lead))
        assert native[0].payload.shape[1] % 16 == 0

    host_calls = []
    real = ans_block.ans_decode_native
    monkeypatch.setattr(ans_block, "ans_decode_native",
                        lambda n, *a: host_calls.append(n) or real(n, *a))
    got = ans_block.decode_ans0_wire(block.size, BitReader(wire), _rows_host())
    assert np.array_equal(got, block)
    resume = native[0].resume
    rest = block.size - (nfull * CHUNK if resume is None else resume * CHUNK)
    assert host_calls == ([rest] if rest > 32 else [])
    no_native()
    got_py = ans_block.decode_ans0_wire(block.size, BitReader(wire), _rows_host(False))
    assert np.array_equal(got_py, block)


def test_host_log_ranges_false_raises():
    """kanzi_tpu's mesh rule: a non-default log range raises, on both paths."""
    rng = np.random.default_rng(3)
    block, wire = _wire([_chunk(30, rng) for _ in range(3)], [12, 10, 12])
    for native in (True, False):
        with pytest.raises(BitStreamError, match="mesh decode: non-default log range"):
            _parse(wire, 3, native=native, host_log_ranges=False)


def _crafted(kind: str) -> tuple[np.ndarray, int]:
    """A valid first chunk, then a second chunk whose header is corrupt in
    the way ``kind`` names; (wire, nfull)."""
    rng = np.random.default_rng(11)
    bw = BitWriter()
    _record(bw, _chunk(20, rng))
    bw.write_bits(12 - 8, 3)
    if kind == "empty_alphabet":
        bw.write_bits(0b01, 2)                        # full flag, then ALPHABET_0
    elif kind in ("freq_size", "freq", "freqs"):
        bw.write_bits(1, 1)                           # partial alphabet: symbols 0-2
        bw.write_bits(0, 5)
        bw.write_bits(0b00000111, 8)
        if kind == "freq_size":
            bw.write_bits(13, 4)                      # logMax 13 > lr 12
        elif kind == "freq":
            bw.write_bits(12, 4)
            bw.write_bits(4095, 12)                   # 1 + 4095 = the scale
            bw.write_bits(0, 12)
        else:
            bw.write_bits(11, 4)
            bw.write_bits(2047, 11)                   # 2048 + 2048 = the scale
            bw.write_bits(2047, 11)
    elif kind == "chunk_size":
        _write_header_only(bw, rng)
        eu.write_varint(bw, hans.MAX_CHUNK_SIZE)
    elif kind == "chunk_size_35_bits":
        _write_header_only(bw, rng)
        bw.write_bits(0xFF, 8)
        for _ in range(3):
            bw.write_bits(0x80, 8)
        bw.write_bits(0x7F, 8)                        # 127 << 28: over 32 bits
    elif kind == "cut_in_states":
        _write_header_only(bw, rng)
        eu.write_varint(bw, 0)                        # an empty payload after them
        bw.write_bits(0x12345678, 32)
        bw.write_bits(0x9ABCDEF0, 32)                 # two states of four, then the end
        return np.frombuffer(bw.getvalue(), np.uint8), 2
    bw.write_bytes(bytes(64))
    return np.frombuffer(bw.getvalue(), np.uint8), 2


def _write_header_only(bw: BitWriter, rng) -> None:
    seg = _chunk(12, rng)
    hist = np.bincount(seg, minlength=256).astype(np.int64)
    alpha = eu.normalize_frequencies(hist, seg.size, 4096)
    hans._write_freqs_header(bw, alpha, hist, 12)


REJECTS = [("empty_alphabet", BitStreamError, "empty ANS alphabet"),
           ("freq_size", BitStreamError, "invalid ANS frequency size"),
           ("freq", BitStreamError, "invalid ANS frequency"),
           ("freqs", BitStreamError, "invalid ANS frequencies"),
           ("chunk_size", BitStreamError, "invalid ANS chunk size"),
           ("chunk_size_35_bits", BitStreamError, "invalid ANS chunk size"),
           ("cut_in_states", EOFError, "bitstream exhausted")]


@pytest.mark.parametrize("kind,cls,msg", REJECTS, ids=[r[0] for r in REJECTS])
def test_rejection_matches_python(kind, cls, msg):
    """Each header rejection raises the same class and message on both
    paths, at the chunk that carries it.  (The log range outside [8, 15]
    cannot be written: three bits over 8 are always inside it.)"""
    wire, nfull = _crafted(kind)
    for native in (True, False):
        with pytest.raises(cls) as e:
            _parse(wire, nfull, native=native)
        assert str(e.value) == msg


def _truncation_points(wire_bits: int, rng) -> list[int]:
    return sorted(set(rng.integers(1, wire_bits, 60).tolist()) | {1, 3, 10, 200})


@pytest.mark.parametrize("nsym", [5, 64, 256])
def test_truncated_stream_matches_python(nsym):
    """A stream cut anywhere (header, varint, states, payload, the next
    chunk): both parses raise EOFError, or both parse the same."""
    rng = np.random.default_rng(nsym)
    block, wire = _wire([_chunk(nsym, rng) for _ in range(3)])
    bits = wire.size * 8
    for cut in _truncation_points(bits, rng):
        nat = _outcome(_parse_cut, wire, cut, True)
        py = _outcome(_parse_cut, wire, cut, False)
        assert nat[0] == py[0], cut
        if nat[0] == "raise":
            assert nat[1] == py[1], cut
        else:
            _same_parse(nat[1], py[1])


def _parse_cut(wire, nbits, native):
    br = BitReader(wire, nbits=nbits)
    got = (ans_block.parse_ans0_wire(br, 3) if native
           else ans_block._parse_py(br, 3, True))
    return got, br.read_count


def test_bit_flips_match_python():
    """Single bit flips through the first headers: the same exception, or
    the same parse, on both paths."""
    rng = np.random.default_rng(7)
    block, wire = _wire([_chunk(n, rng) for n in (3, 64, 255, 2)])
    for bit in rng.integers(0, min(wire.size * 8, 9000), 150):
        w = wire.copy()
        w[bit >> 3] ^= 0x80 >> (bit & 7)
        nat = _outcome(_parse, w, 4, native=True)
        py = _outcome(_parse, w, 4, native=False)
        assert nat[0] == py[0], bit
        if nat[0] == "raise":
            assert nat[1] == py[1], bit
        else:
            _same_parse(nat[1], py[1])


@pytest.mark.parametrize("cut", [8, 300, 3000], ids=["lr", "header", "payload"])
def test_truncated_tail_raises_as_numpy(cut, no_native):
    """A tail the native coder refuses is decoded again by numpy, which
    raises what it raises without the library."""
    rng = np.random.default_rng(cut)
    segs = [_chunk(40, rng) for _ in range(4)] + [_chunk(40, rng, size=9000)]
    block, wire = _wire(segs)
    head = _wire(segs[:4])[1].size * 8 - 8       # the tail starts in this byte
    nbits = head + cut

    nat = _outcome(ans_block.decode_ans0_wire, block.size, BitReader(wire, nbits=nbits),
                   _rows_host())
    no_native()
    assert nat[0] == "raise"
    assert _outcome(ans_block.decode_ans0_wire, block.size, BitReader(wire, nbits=nbits),
                    _rows_host(False)) == nat


def _level5_stream(nblocks: int) -> tuple[bytes, bytes]:
    t, e, _ = LEVELS[5]
    data = mixed_corpus(nblocks * (1 << 20), seed=12).tobytes()
    ctx = {"transform": t, "entropy": e, "blockSize": 1 << 20, "jobs": 1}
    out = io.BytesIO()
    with CompressedOutputStream(out, ctx, device=None) as cos:
        cos.write(data)
    return data, out.getvalue()


def test_level5_blocks_decode_on_cpu(no_native, monkeypatch):
    """Three level-5 blocks of mixed_corpus through ans0_decode(..., "cpu")
    (the kernels' plain versions): the same bytes with the native parse and
    without the library, and one count a block on the parse that ran."""
    data, blob = _level5_stream(3)
    sizes = []
    real = ans_block.ans0_decode
    monkeypatch.setattr(ans_block, "ans0_decode",
                        lambda n, *a: sizes.append(n) or real(n, *a))

    def decode():
        launch.reset_launches()
        with CompressedInputStream(io.BytesIO(blob), {"jobs": 1}, device="cpu") as cis:
            got = cis.read(-1)
        return got, launch.launches["ans0_wire_native"], launch.launches["ans0_wire_py"]

    assert decode() == (data, 3, 0)
    assert len(sizes) == 3 and min(sizes) >= 4 * CHUNK
    no_native()
    assert decode() == (data, 0, 3)


def test_counter_one_a_block(no_native):
    """A block decoded through ans0_decode adds one to ans0_wire_native, or
    one to ans0_wire_py when the library is withheld; a block of 32 bytes
    or less parses nothing and counts nothing."""
    rng = np.random.default_rng(5)
    block, wire = _wire([_chunk(1, rng) for _ in range(4)] + [_chunk(3, rng, size=100)])
    for native, key in ((True, "ans0_wire_native"), (False, "ans0_wire_py")):
        if not native:
            no_native()
        before = dict(launch.launches)
        got = ans_block.ans0_decode(block.size, BitReader(wire), "cpu")
        assert np.array_equal(got, block)
        assert ans_block.ans0_decode(20, BitReader(wire), "cpu").size == 20
        diff = {k: launch.launches[k] - before.get(k, 0) for k in launch.launches}
        assert {k: v for k, v in diff.items() if v} == {key: 1}
