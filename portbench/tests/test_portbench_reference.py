"""The reference reader decodes what the program writes, refuses what it
should, and each of its shortcuts equals the plain rule."""

import io

import numpy as np
import pytest

from portbench.lib.corpus import mixed_corpus
from portbench.reference import stream as ref
from portbench.reference.bits import Bits
from portbench.reference.stages import RANK

L5 = ("TEXT+UTF+BWT+RANK+ZRLT", "ANS0")
L3 = ("TEXT+UTF+PACK+MM+LZX", "HUFFMAN")


def program_stream(data: bytes, chain, block_size, jobs=2) -> bytes:
    # the program writes, on the host coders (the same format as on the card)
    from kanzi_tpu_torch.app.block_compressor import BlockCompressor
    dst = io.BytesIO()
    BlockCompressor(chain[0], chain[1], block_size, jobs=jobs, device=None) \
        .compress_stream(io.BytesIO(data), dst, len(data))
    return dst.getvalue()


def decode_all(comp: bytes, chain, block_size, size) -> bytes:
    st = ref.parse(comp, {"transform": chain[0], "entropy": chain[1],
                          "block_size": block_size, "size": size})
    return b"".join(ref.decode_block(st, b).tobytes() for b in st.blocks)


def inputs():
    rng = np.random.default_rng(5)
    yield "corpus", mixed_corpus(1 << 20, 2**31 + 3).tobytes()
    yield "tiny", b"0123456789"                      # a copy block
    yield "short", bytes(rng.integers(97, 100, 200, dtype=np.uint8))   # one BWT index
    yield "random", bytes(rng.integers(0, 256, 100_003, dtype=np.uint8))
    yield "one_byte", b"a" * 300_000
    yield "text_odd", mixed_corpus(300_001, 4)[:300_001].tobytes()
    yield from mm_inputs()


def mm_inputs():
    """Data the level 3 chain sends through MM: 16-bit samples (XOR mode)
    and RGB ramps that wrap (delta mode, with escapes)."""
    rng = np.random.default_rng(5)
    t = np.arange(150_000)
    pcm = 8000 * np.sin(t / 40.0) + rng.normal(0, 30, t.size)
    yield "pcm", pcm.astype("<i2").tobytes()
    rgb = np.stack([(t * 3) % 256, (t // 7) % 256, 255 - t % 256], 1) \
        + rng.integers(0, 3, (t.size, 3))
    yield "rgb", (rgb % 256).astype(np.uint8).tobytes()


@pytest.mark.parametrize("chain", [L5, L3], ids=["l5", "l3"])
@pytest.mark.parametrize("name,data", list(inputs()), ids=[n for n, _ in inputs()])
def test_reference_reads_the_programs_streams(chain, name, data):
    bs = 262144
    comp = program_stream(data, chain, bs)
    assert decode_all(comp, chain, bs, len(data)) == data


@pytest.mark.parametrize("name,data,mode", [(n, d, m) for (n, d), m in zip(mm_inputs(), (1, 0))],
                         ids=["pcm", "rgb"])
def test_level_3_sends_these_through_mm(name, data, mode):
    from portbench.reference.stages import MM
    seen = []
    inverse = MM.inverse
    try:
        MM.inverse = lambda d, ctx: seen.append(int(d[0])) or inverse(d, ctx)
        assert decode_all(program_stream(data, L3, 262144), L3, 262144, len(data)) == data
    finally:
        MM.inverse = inverse
    assert seen and set(seen) == {mode}


def test_reference_refuses_a_flipped_payload_byte():
    data = mixed_corpus(300_000, 9).tobytes()
    comp = bytearray(program_stream(data, L5, 262144))
    comp[len(comp) // 2] ^= 0x10
    try:
        out = decode_all(bytes(comp), L5, 262144, len(data))
    except Exception:
        return
    assert out != data


def test_reference_refuses_another_configuration():
    data = mixed_corpus(100_000, 9).tobytes()
    comp = program_stream(data, L5, 262144)
    with pytest.raises(ref.StreamError):
        ref.parse(comp, {"transform": L3[0], "entropy": L3[1], "block_size": 262144,
                         "size": len(data)})
    with pytest.raises(ref.StreamError):
        ref.parse(comp, {"transform": L5[0], "entropy": L5[1], "block_size": 262144,
                         "size": len(data) + 1})
    bad = bytearray(comp)
    bad[7] ^= 1                                      # inside the stream header
    with pytest.raises(ref.StreamError):
        ref.parse(bytes(bad))


def rank_inverse_plain(data):
    """SBRT.java's loop, as written there."""
    last, prio, r2s = [0] * 256, [0] * 256, list(range(256))
    out = bytearray(len(data))
    for i, r in enumerate(data):
        c = r2s[r]
        out[i] = c
        q = (i + last[c]) >> 1
        last[c] = i
        prio[c] = q
        while r > 0 and prio[r2s[r - 1]] <= q:
            r2s[r] = r2s[r - 1]
            r -= 1
        r2s[r] = c
    return bytes(out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_binary_search_equals_the_loop(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, [3, 40, 256][seed], 20_000).astype(np.uint8)
    assert RANK.inverse(data, {}).tobytes() == rank_inverse_plain(data.tolist())


def test_bits_reads_across_bytes_and_realigns():
    b = Bits(bytes([0b10110011, 0b01010101, 0xFF]))
    assert b.read(3) == 0b101
    assert b.read_bytes(1).tolist() == [0b10011010]
    s = b.sub(7)
    assert s.data.tolist() == [0b10101110] and s.end == 7
    assert b.left() == 6
