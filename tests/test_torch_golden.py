"""The port's streams against the frozen golden files of every level:
with ``device=None`` (the host coders) and ``device="cpu"`` (the device
stages on their plain versions) it writes tests/golden/l0..l9.knz byte for
byte and decodes them, with the ctx that kanzi_tpu's BlockCompressor builds
(KANZI_TPU_DEVICE_LZ unset, so LZ/LZX parse on the host)."""

from __future__ import annotations

import io
import os

import pytest

from kanzi_tpu.app.block_compressor import LEVELS, BlockCompressor
from kanzi_tpu_torch.io.stream import CompressedInputStream, CompressedOutputStream
from kanzi_tpu_torch.utils.corpus import mixed_corpus

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def data() -> bytes:
    return mixed_corpus(256 * 1024, seed=1234).tobytes()


@pytest.mark.parametrize("device", [None, "cpu"], ids=["host", "cpu"])
@pytest.mark.parametrize("level", range(10))
def test_golden_level(level, device, data, monkeypatch):
    monkeypatch.delenv("KANZI_TPU_DEVICE_LZ", raising=False)
    t, e, b = LEVELS[level]
    ctx = BlockCompressor(transform=t, entropy=e, block_size=b, jobs=1)._ctx(len(data))
    out = io.BytesIO()
    with CompressedOutputStream(out, ctx, device=device) as cos:
        cos.write(data)
    with open(os.path.join(GOLDEN, f"l{level}.knz"), "rb") as f:
        golden = f.read()
    assert out.getvalue() == golden
    with CompressedInputStream(io.BytesIO(golden), {"jobs": 1}, device=device) as cis:
        assert cis.read(-1) == data
