"""The port's v1 device LZX engine (ops/lz_tpu.py) on device=cpu against
kanzi_tpu's (kanzi_tpu/ops/lz_tpu.py, plain XLA: no Pallas kernel), bit for
bit, no tolerance: the analysis's tokens, the section bytes, and streams
under KANZI_TPU_DEVICE_LZ=legacy at levels 1, 2 (DNA) and 3.  Then the
real-file corpus against kanzi_tpu's.  kanzi_tpu compiles its analysis once
per (bucket, min match, max distance), ~6 s here, so the cases share five
such shapes.
"""

from __future__ import annotations

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanzi_tpu.app.block_compressor import LEVELS
from kanzi_tpu.core.globals import DataType as JDataType
from kanzi_tpu.io import stream as host
from kanzi_tpu.ops import lz_tpu as J
from kanzi_tpu.transforms.lz import LZXCodec as JLZXCodec
from kanzi_tpu_torch.core.globals import DataType
from kanzi_tpu_torch.io import stream as port
from kanzi_tpu_torch.ops import launch
from kanzi_tpu_torch.ops import lz_tpu as T
from kanzi_tpu_torch.transforms.lz import LZXCodec, _lzx_inverse_py
from kanzi_tpu_torch.utils import corpus
from kanzi_tpu_torch.utils.corpus import dna_like, mixed_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _text(n: int) -> np.ndarray:
    with open(os.path.join(ROOT, "SURVEY.md"), "rb") as fh:
        base = fh.read()
    return np.frombuffer((base * (n // len(base) + 1))[:n], np.uint8)


def _cases() -> dict:
    """name -> (block, min match): tests/test_lz_tpu.py's text, zeros,
    period-7 and mixed; 64 KiB of text and of random bytes, whose count
    fills the bucket (the shifts wrap round into the block); 300,000 B
    (MAX_DISTANCE2) whose repeats lie 100,000 B back; min match 6."""
    rng = np.random.default_rng(7)
    return {
        "text": (_text(200_000), 4),
        "zeros": (np.zeros(77_777, np.uint8), 4),
        "period7": (np.tile(np.arange(7, dtype=np.uint8), 11_111), 4),
        "mixed": (np.concatenate([np.zeros(5000, np.uint8),
                                  rng.integers(0, 256, 5000).astype(np.uint8),
                                  _text(50_000)]), 4),
        "text_full_bucket": (_text(1 << 16), 4),
        "random_full_bucket": (np.random.default_rng(3).integers(0, 256, 1 << 16)
                               .astype(np.uint8), 4),
        "max_distance2": (np.tile(rng.integers(0, 256, 100_000).astype(np.uint8), 3), 4),
        "min_match6": (np.frombuffer(b"ACGTACGGTTACG" * 4000, np.uint8), 6),
    }


def _hlog(mm: int) -> int:
    """kanzi_tpu's analysis compiles for each hash log too: LZX's 19 where
    level 3 calls it (min match 4), LZ's 16 where level 2 does (DNA, 6)."""
    return 16 if mm == 6 else 19


def _args(src: np.ndarray):
    count = src.size
    src_end = count - 18
    max_dist = J.MAX_DISTANCE1 if src_end < 4 * J.MAX_DISTANCE1 else J.MAX_DISTANCE2
    pad = np.zeros(J._pad_bucket(count), np.uint8)
    pad[:count] = src
    return pad, src_end, max_dist


def test_constants_match():
    assert (T.MAX_DISTANCE1, T.MAX_DISTANCE2, T.MIN_BLOCK_LENGTH, T.EXT_ROUNDS, T._MIX) == \
        (J.MAX_DISTANCE1, J.MAX_DISTANCE2, J.MIN_BLOCK_LENGTH, J.EXT_ROUNDS, J._MIX)
    for n in (1, 24, 1000, 1025, 1 << 16, (1 << 16) + 1, 300_000):
        assert T._pad_bucket(n) == J._pad_bucket(n)


@pytest.mark.parametrize("name", list(_cases()))
def test_analyze_tokens_match(name):
    src, mm = _cases()[name]
    pad, src_end, max_dist = _args(src)
    want = J._analyze_jit(jnp.asarray(pad), jnp.int32(src_end), _hlog(mm), mm, max_dist)
    k = int(want[3])
    before = launch.launches["lz_v1"]
    *got, n_tok = T._analyze(torch.from_numpy(pad), src_end, mm, max_dist)
    assert launch.launches["lz_v1"] == before + 1
    assert n_tok == k >= 1
    for g, w in zip(got, want[:3]):
        assert np.array_equal(g[:k].numpy(), np.asarray(w)[:k])
    if name == "max_distance2":
        assert max_dist == T.MAX_DISTANCE2 and int(got[2][:k].max()) > T.MAX_DISTANCE1
    if name.endswith("full_bucket"):
        assert pad.size == src.size


@pytest.mark.parametrize("name", [*_cases(), "incompressible", "under_24_bytes"])
def test_forward_bytes_match(name):
    """lzx_forward_device's sections equal kanzi_tpu's, None where its are
    None, and decode on the port's inverses."""
    if name == "incompressible":
        src, mm = np.random.default_rng(1).integers(0, 256, 60_000).astype(np.uint8), 4
    elif name == "under_24_bytes":
        src, mm = np.zeros(10, np.uint8), 4
    else:
        src, mm = _cases()[name]
    extra = _hlog(mm) == 19
    want = J.lzx_forward_device(src, extra, min_match=mm)
    got = T.lzx_forward_device(src, extra, min_match=mm, device="cpu")
    if name in ("incompressible", "under_24_bytes", "random_full_bucket"):
        assert want is None and got is None
        return
    assert want is not None and got is not None and np.array_equal(got, want)
    assert np.array_equal(_lzx_inverse_py(got, src.size), src)
    assert np.array_equal(np.asarray(LZXCodec().inverse(got, src.size)), src)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        T.lzx_forward_device(np.zeros(5000, np.uint8), device="cuda")


def _stream(mod, data: bytes, ctx: dict, **kw) -> bytes:
    out = io.BytesIO()
    with mod.CompressedOutputStream(out, dict(ctx), **kw) as cos:
        cos.write(data)
    return out.getvalue()


def _stream_cases() -> dict:
    """name -> (level, data, block size, kanzi_tpu's interpret mode).
    Level 3's LZX follows four transforms: the codec's own dispatch, the v1
    engine.  Level 2's DNA blocks take min match 6, which the writer's batch
    hint (min match 4) does not cover: the v1 engine (a 32,000-byte segment
    repeated, so that LZ gains on what the DNA transform leaves).  Level 1
    starts with LZX: the writer's v3 batch, which kanzi_tpu runs on its
    device only, so in interpret mode here."""
    return {"level3": (3, mixed_corpus(300_000, seed=41).tobytes(), 100_000, "0"),
            "level2_dna": (2, np.tile(dna_like(32_000, seed=13), 8).tobytes(), 128_000, "0"),
            "level1": (1, mixed_corpus(200_000, seed=41).tobytes(), 100_000, "1")}


@pytest.mark.parametrize("name", list(_stream_cases()))
def test_legacy_stream_matches(name, monkeypatch):
    """The port's stream at device=cpu under KANZI_TPU_DEVICE_LZ=legacy equals
    kanzi_tpu's under the same variable, decodes on the port both ways, and
    differs from the host parse's; the v1 engine runs where it should."""
    level, data, block, interpret = _stream_cases()[name]
    t, e, _ = LEVELS[level]
    ctx = {"transform": t, "entropy": e, "blockSize": block, "jobs": 1}
    monkeypatch.setenv("KANZI_TPU_DEVICE_LZ", "legacy")
    monkeypatch.setenv("KANZI_TPU_PALLAS_INTERPRET", interpret)
    want = _stream(host, data, ctx)
    launch.reset_launches()
    got = _stream(port, data, ctx, device="cpu")
    v1_runs = launch.launches["lz_v1"]
    assert got == want
    assert (v1_runs == 0) if level == 1 else (v1_runs > 0)
    for dev in (None, "cpu"):
        with port.CompressedInputStream(io.BytesIO(got), {}, device=dev) as cis:
            assert cis.read(-1) == data
    assert _stream(port, data, ctx, device=None) != got


def test_dna_codec_matches(monkeypatch):
    """The codec with dataType DNA (min match 6) under legacy, on the v1
    engine, equals kanzi_tpu's codec."""
    monkeypatch.setenv("KANZI_TPU_DEVICE_LZ", "legacy")
    src = dna_like(60_000, seed=21)
    want = JLZXCodec(ctx={"dataType": JDataType.DNA}).forward(src)
    codec = LZXCodec(ctx={"dataType": DataType.DNA, "_device": "cpu"})
    got = codec.forward(src)
    assert np.array_equal(got, want)
    assert got[12] >> 1 == 4                 # the header's min match, 6 - 2
    assert np.array_equal(np.asarray(codec.inverse(got, src.size)), src)


def test_real_corpus_matches_kanzi_tpu():
    from kanzi_tpu.utils.corpus import real_corpus as ref_real_corpus
    data, sha, breakdown = corpus.real_corpus(8 << 20)
    want = ref_real_corpus(8 << 20)
    assert data.dtype == np.uint8 and data.size == 8 << 20
    assert sha == want[1] and breakdown == want[2]
    assert np.array_equal(data, want[0])
    assert corpus.real_corpus(8 << 20)[0] is data       # cached
