"""The ANS0 decode's native wire parse (kanzi_tpu_torch/hostsrc/ans0_wire.cpp
through ops/ans_block.py parse_ans0_wire) against a parse written over
kanzi_tpu's host decoder (entropy/ans.py _read_freqs_header,
entropy/utils.py read_varint, core/bits.py BitReader) with kanzi_tpu's mesh
decode's rule for the log range: the same rows, tables, states, payloads,
single-symbol chunks, resume point and reader position on valid blocks; the
same exception class and message, at the same point, on corrupt and
truncated ones; the decoded bytes, the host's tail through the native coder
included, against kanzi_tpu's host ANSRangeDecoder.  Without the native
library the device glue (the ANS0 parse and writer, the LZX emitter)
raises RuntimeError and writes nothing."""

from __future__ import annotations

import io

import numpy as np
import pytest

from kanzi_tpu.core.bits import BitReader as JBitReader
from kanzi_tpu.core.bits import BitWriter as JBitWriter
from kanzi_tpu.core.errors import BitStreamError as JBitStreamError
from kanzi_tpu.entropy import ans as jhans
from kanzi_tpu.entropy import utils as jeu
from kanzi_tpu.io.stream import CompressedInputStream as JCompressedInputStream
from kanzi_tpu_torch.app.block_compressor import LEVELS
from kanzi_tpu_torch.core.bits import BitReader, BitWriter
from kanzi_tpu_torch.core.errors import BitStreamError
from kanzi_tpu_torch.io.stream import CompressedInputStream, CompressedOutputStream
from kanzi_tpu_torch.ops import ans_block, launch
from kanzi_tpu_torch.ops import lz_sort
from kanzi_tpu_torch.utils import native, native_coders
from kanzi_tpu_torch.utils.corpus import mixed_corpus

CHUNK = 16384


@pytest.fixture
def no_native(monkeypatch):
    """Withhold the native library from the host coders, the ANS0 glue and
    the LZX emitter."""
    def withhold():
        monkeypatch.setattr(native_coders, "_lib", lambda: None)
        monkeypatch.setattr(native, "get_lib", lambda: None)
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


def _record(bw: JBitWriter, seg: np.ndarray, lr: int = 12) -> None:
    """One chunk record of the order-0 wire, at log range ``lr``, written by
    kanzi_tpu's host encoder."""
    jhans.ANSRangeEncoder(bw, 0, log_range=lr)._encode_chunk(seg, bw)


def _wire(segs, lrs=None, lead: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(block, wire bytes) of consecutive chunk records, after ``lead``
    bits of another stage."""
    bw = JBitWriter()
    if lead:
        bw.write_bits(0x5A5A, lead)
    for k, seg in enumerate(segs):
        _record(bw, seg, 12 if lrs is None else lrs[k])
    return np.concatenate(segs), np.frombuffer(bw.getvalue(), np.uint8)


def _rows_host():
    """A ``rows`` that decodes on the host: each row's record rebuilt (log
    range, header from its table, varint, states, payload) as kanzi_tpu
    writes it and read back by kanzi_tpu's host decoder."""
    def rows(pay, lens, states, freq, cum):
        out = np.empty((len(lens), CHUNK), np.uint8)
        for k in range(len(lens)):
            bw = JBitWriter()
            bw.write_bits(12 - 8, 3)
            alpha = np.flatnonzero(freq[k]).astype(np.int32)
            jhans._write_freqs_header(bw, alpha, freq[k].astype(np.int64), 12)
            jeu.write_varint(bw, int(lens[k]))
            for j in range(4):
                bw.write_bits(int(states[k, j]), 32)
            bw.write_bytes(pay[k, :lens[k]].tobytes())
            br = JBitReader(np.frombuffer(bw.getvalue(), np.uint8))
            out[k] = jhans.ANSRangeDecoder(br, 0).decode(CHUNK)
        return out, np.asarray(lens, np.int32)
    return rows


def _reference_parse(br, nfull: int, host_log_ranges: bool) -> ans_block.Ans0Wire:
    """parse_ans0_wire over kanzi_tpu: each chunk's log range, then
    kanzi_tpu's _read_freqs_header, read_varint and BitReader, raising as
    its host decoder raises; a chunk with another log range than 12 stops
    the parse there, or raises as kanzi_tpu's mesh decode does."""
    full = []     # (chunk index, freqs, states, payload bytes)
    single = []   # (chunk index, symbol)
    resume = None
    for i in range(nfull):
        lr = 8 + br.read_bits(3)
        if lr != 12:
            if not host_log_ranges:
                raise JBitStreamError("mesh decode: non-default log range",
                                      JBitStreamError.INVALID_STREAM)
            br.seek(br.read_count - 3)
            resume = i
            break
        alpha, freqs = jhans._read_freqs_header(br, lr)
        if len(alpha) == 0:
            raise JBitStreamError("empty ANS alphabet", JBitStreamError.INVALID_STREAM)
        if len(alpha) == 1:
            single.append((i, int(alpha[0])))
            continue
        sz = jeu.read_varint(br)
        if sz >= jhans.MAX_CHUNK_SIZE:
            raise JBitStreamError("invalid ANS chunk size", JBitStreamError.INVALID_STREAM)
        states = [br.read_bits(32) for _ in range(4)]
        full.append((i, freqs, states, br.read_bytes(sz)))
    n = len(full)
    lens = np.array([len(m[3]) for m in full], dtype=np.int32)
    pay = np.zeros((n, max(16, (int(lens.max(initial=0)) + 15) & ~15)), dtype=np.uint8)
    freq = np.zeros((n, 256), dtype=np.int32)
    states = np.zeros((n, 4), dtype=np.int64)
    for k, m in enumerate(full):
        pay[k, :lens[k]] = m[3]
        freq[k] = m[1]
        states[k] = m[2]
    return ans_block.Ans0Wire(np.array([m[0] for m in full], dtype=np.int32), freq,
                              np.cumsum(freq, axis=1, dtype=np.int32) - freq, states, lens,
                              pay, np.array(single, dtype=np.int32).reshape(-1, 2), resume)


def _parse(wire: np.ndarray, nfull: int, *, native: bool, bitpos: int = 0,
           host_log_ranges: bool = True, nbits: int | None = None):
    """(parse, reader position after it): the port's native parse, or, with
    ``native`` false, the reference parse over kanzi_tpu's reader."""
    if native:
        br = BitReader(wire, nbits=nbits, bitpos=bitpos)
        got = ans_block.parse_ans0_wire(br, nfull, host_log_ranges)
    else:
        br = JBitReader(wire, nbits=nbits, bitpos=bitpos)
        got = _reference_parse(br, nfull, host_log_ranges)
    return got, br.read_count


def _host_decode(wire: np.ndarray, count: int, nbits: int | None = None) -> np.ndarray:
    """kanzi_tpu's host ANSRangeDecoder, chunk by chunk in numpy."""
    br = JBitReader(wire, nbits=nbits)
    dec = jhans.ANSRangeDecoder(br, 0)
    out = np.empty(count, np.uint8)
    for s in range(0, count, CHUNK):
        dec._decode_chunk(out, s, min(s + CHUNK, count), br)
    return out


def _outcome(fn, *args, **kw):
    """("ok", result) or ("raise", (class name, message)): the port's and
    kanzi_tpu's BitStreamError are classes of the same name."""
    try:
        return "ok", fn(*args, **kw)
    except (BitStreamError, JBitStreamError, EOFError, IndexError) as e:
        return "raise", (type(e).__name__, str(e))


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
    point and reader position equal the reference parse's over kanzi_tpu;
    the decode returns the block, as kanzi_tpu's host decoder does; the
    host's chunks of more than 32 bytes go through the native coder, and
    only those; without the native library the decode raises."""
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
    assert np.array_equal(jhans.ANSRangeDecoder(JBitReader(wire), 0).decode(block.size), block)
    no_native()
    with pytest.raises(RuntimeError, match="native library"):
        ans_block.decode_ans0_wire(block.size, BitReader(wire), _rows_host())


def test_host_log_ranges_false_raises():
    """kanzi_tpu's mesh rule: a non-default log range raises, in the native
    parse and in the reference parse."""
    rng = np.random.default_rng(3)
    block, wire = _wire([_chunk(30, rng) for _ in range(3)], [12, 10, 12])
    for native in (True, False):
        got = _outcome(_parse, wire, 3, native=native, host_log_ranges=False)
        assert got == ("raise", ("BitStreamError", "mesh decode: non-default log range"))


def _crafted(kind: str) -> tuple[np.ndarray, int]:
    """A valid first chunk, then a second chunk whose header is corrupt in
    the way ``kind`` names; (wire, nfull)."""
    rng = np.random.default_rng(11)
    bw = JBitWriter()
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
        jeu.write_varint(bw, jhans.MAX_CHUNK_SIZE)
    elif kind == "chunk_size_35_bits":
        _write_header_only(bw, rng)
        bw.write_bits(0xFF, 8)
        for _ in range(3):
            bw.write_bits(0x80, 8)
        bw.write_bits(0x7F, 8)                        # 127 << 28: over 32 bits
    elif kind == "cut_in_states":
        _write_header_only(bw, rng)
        jeu.write_varint(bw, 0)                       # an empty payload after them
        bw.write_bits(0x12345678, 32)
        bw.write_bits(0x9ABCDEF0, 32)                 # two states of four, then the end
        return np.frombuffer(bw.getvalue(), np.uint8), 2
    bw.write_bytes(bytes(64))
    return np.frombuffer(bw.getvalue(), np.uint8), 2


def _write_header_only(bw: JBitWriter, rng) -> None:
    seg = _chunk(12, rng)
    hist = np.bincount(seg, minlength=256).astype(np.int64)
    alpha = jeu.normalize_frequencies(hist, seg.size, 4096)
    jhans._write_freqs_header(bw, alpha, hist, 12)


REJECTS = [("empty_alphabet", BitStreamError, "empty ANS alphabet"),
           ("freq_size", BitStreamError, "invalid ANS frequency size"),
           ("freq", BitStreamError, "invalid ANS frequency"),
           ("freqs", BitStreamError, "invalid ANS frequencies"),
           ("chunk_size", BitStreamError, "invalid ANS chunk size"),
           ("chunk_size_35_bits", BitStreamError, "invalid ANS chunk size"),
           ("cut_in_states", EOFError, "bitstream exhausted")]


@pytest.mark.parametrize("kind,cls,msg", REJECTS, ids=[r[0] for r in REJECTS])
def test_rejection_matches_python(kind, cls, msg):
    """Each header rejection raises the same class and message in the
    native parse and in the reference parse, at the chunk that carries it.
    (The log range outside [8, 15] cannot be written: three bits over 8 are
    always inside it.)"""
    wire, nfull = _crafted(kind)
    for native in (True, False):
        got = _outcome(_parse, wire, nfull, native=native)
        assert got == ("raise", (cls.__name__, msg))


def _truncation_points(wire_bits: int, rng) -> list[int]:
    return sorted(set(rng.integers(1, wire_bits, 60).tolist()) | {1, 3, 10, 200})


@pytest.mark.parametrize("nsym", [5, 64, 256])
def test_truncated_stream_matches_python(nsym):
    """A stream cut anywhere (header, varint, states, payload, the next
    chunk): the native and the reference parse both raise EOFError, or
    both parse the same."""
    rng = np.random.default_rng(nsym)
    block, wire = _wire([_chunk(nsym, rng) for _ in range(3)])
    bits = wire.size * 8
    for cut in _truncation_points(bits, rng):
        nat = _outcome(_parse, wire, 3, native=True, nbits=cut)
        py = _outcome(_parse, wire, 3, native=False, nbits=cut)
        assert nat[0] == py[0], cut
        if nat[0] == "raise":
            assert nat[1] == py[1], cut
        else:
            _same_parse(nat[1], py[1])


def test_bit_flips_match_python():
    """Single bit flips through the first headers: the same exception, or
    the same parse, in the native and the reference parse."""
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
    raises what kanzi_tpu's numpy chunk decoder raises on the same wire;
    without the native library the decode raises RuntimeError."""
    rng = np.random.default_rng(cut)
    segs = [_chunk(40, rng) for _ in range(4)] + [_chunk(40, rng, size=9000)]
    block, wire = _wire(segs)
    head = _wire(segs[:4])[1].size * 8 - 8       # the tail starts in this byte
    nbits = head + cut

    nat = _outcome(ans_block.decode_ans0_wire, block.size, BitReader(wire, nbits=nbits),
                   _rows_host())
    assert nat[0] == "raise"
    assert _outcome(_host_decode, wire, block.size, nbits) == nat
    no_native()
    with pytest.raises(RuntimeError, match="native library"):
        ans_block.decode_ans0_wire(block.size, BitReader(wire, nbits=nbits), _rows_host())


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
    (the kernels' plain versions): the data back, as kanzi_tpu's reader
    gives it, one count a block on the native parse; without the library
    the decode raises RuntimeError."""
    data, blob = _level5_stream(3)
    sizes = []
    real = ans_block.ans0_decode
    monkeypatch.setattr(ans_block, "ans0_decode",
                        lambda n, *a: sizes.append(n) or real(n, *a))

    def decode():
        launch.reset_launches()
        with CompressedInputStream(io.BytesIO(blob), {"jobs": 1}, device="cpu") as cis:
            got = cis.read(-1)
        return got, launch.launches["ans0_wire_native"]

    assert decode() == (data, 3)
    assert len(sizes) == 3 and min(sizes) >= 4 * CHUNK
    with JCompressedInputStream(io.BytesIO(blob), {"jobs": 1}) as cis:
        assert cis.read(-1) == data
    no_native()
    with pytest.raises(RuntimeError, match="native library"):
        decode()
    assert launch.launches["ans0_wire_native"] == 0


def test_counter_one_a_block(no_native):
    """A block decoded through ans0_decode adds one to ans0_wire_native;
    withheld, the library's absence raises and counts nothing; a block of
    32 bytes or less parses nothing and counts nothing, with or without the
    library."""
    rng = np.random.default_rng(5)
    block, wire = _wire([_chunk(1, rng) for _ in range(4)] + [_chunk(3, rng, size=100)])
    for native in (True, False):
        if not native:
            no_native()
        before = dict(launch.launches)
        if native:
            got = ans_block.ans0_decode(block.size, BitReader(wire), "cpu")
            assert np.array_equal(got, block)
        else:
            with pytest.raises(RuntimeError, match="native library"):
                ans_block.ans0_decode(block.size, BitReader(wire), "cpu")
        assert ans_block.ans0_decode(20, BitReader(wire), "cpu").size == 20
        diff = {k: launch.launches[k] - before.get(k, 0) for k in launch.launches}
        assert {k: v for k, v in diff.items() if v} == ({"ans0_wire_native": 1} if native else {})


def _lz_block() -> np.ndarray:
    return mixed_corpus(1 << 16, seed=2**31 + 23)


def _glue_ans0_encode():
    bw = BitWriter()
    block = mixed_corpus(4 * CHUNK + 100, seed=3)
    with pytest.raises(RuntimeError, match="native library"):
        ans_block.ans0_encode(block, bw, "cpu")
    return bw.getvalue(), "ans0_wire_write_native"


def _glue_ans0_decode():
    block, wire = _wire([_chunk(40, np.random.default_rng(6)) for _ in range(4)])
    br = BitReader(wire, bitpos=0)
    with pytest.raises(RuntimeError, match="native library"):
        ans_block.ans0_decode(block.size, br, "cpu")
    return br.read_count, "ans0_wire_native"


def _glue_lz_emit():
    out = []
    with pytest.raises(RuntimeError, match="native library"):
        out = lz_sort.lzx_forward_device_batch([_lz_block()], True, 4, device="cpu")
    return out, "lz_emit_native"


GLUE = {"ans0_encode": (_glue_ans0_encode, b""), "ans0_decode": (_glue_ans0_decode, 0),
        "lz_emit": (_glue_lz_emit, [])}


@pytest.mark.parametrize("stage", list(GLUE))
def test_glue_without_native_library_raises(stage, no_native):
    """The device glue has one compiled path: with the native library
    withheld, the ANS0 encode, the ANS0 decode and the LZX emitter on
    device=cpu each raise RuntimeError naming the library, and write
    nothing: no byte to the writer, no bit read, no block emitted, no
    count."""
    run, nothing = GLUE[stage]
    no_native()
    launch.reset_launches()
    written, key = run()
    assert written == nothing
    assert launch.launches[key] == 0
