"""kanzi_tpu_torch stands on its own, without jax and without kanzi_tpu, and
never falls back to the CPU when asked for a card it does not have."""

from __future__ import annotations

import io
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "kanzi_tpu_torch")

_ROUND_TRIP = """
import io, sys
from kanzi_tpu_torch.utils.corpus import mixed_corpus
from kanzi_tpu_torch.io.stream import CompressedInputStream, CompressedOutputStream
transform, entropy, size, block = sys.argv[1:]
data = mixed_corpus(int(size), seed=3).tobytes()
ctx = {"transform": transform, "entropy": entropy, "blockSize": int(block)}
buf = io.BytesIO()
with CompressedOutputStream(buf, ctx, device="cpu") as cos:
    cos.write(data)
with CompressedInputStream(io.BytesIO(buf.getvalue()), {}, device="cpu") as cis:
    assert cis.read(-1) == data
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "kanzi_tpu"))
assert not loaded, loaded
print("ok")
"""


@pytest.mark.parametrize("transform,entropy,size,block,device_lz", [
    ("TEXT+UTF+BWT+RANK+ZRLT", "ANS0", 40000, 1 << 16, "0"),
    ("DNA+LZ", "HUFFMAN", 300000, 1 << 18, "0"),
    ("TEXT+UTF+PACK+MM+LZX", "HUFFMAN", 300000, 1 << 18, "0"),
    ("LZX", "NONE", 300000, 1 << 17, "1"),
], ids=["level5", "level2", "level3", "level1_device_lz"])
def test_level5_round_trip_without_jax(transform, entropy, size, block, device_lz):
    """A fresh process, which loads no jax and no kanzi_tpu module
    (tests/conftest.py imports jax into this one).  The Huffman levels'
    blocks hold enough full chunks for the device encode and decode paths,
    and level 1 runs the device LZ engine (their plain versions here)."""
    env = dict(os.environ, KANZI_TPU_DEVICE_LZ=device_lz)
    res = subprocess.run([sys.executable, "-c", _ROUND_TRIP, transform, entropy,
                          str(size), str(block)], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


_ORDER1_OPS = """
import sys
import numpy as np
import torch
from kanzi_tpu_torch.ops import ans1_cuda, ksort
rng = np.random.default_rng(1)
chunks = rng.integers(0, 7, (2, 16384)).astype(np.uint8)
freq = np.zeros((2, 256, 256), np.int64)
freq[:, :, :7] = [292, 292, 292, 293, 293, 293, 293]
pay, n_emit, st = ans1_cuda.ans1_encode_chunks(chunks, freq, np.cumsum(freq, 2) - freq, "cpu")
assert pay.shape == (2, 16384) and st.shape == (2, 4) and (n_emit > 0).all()
keys = [torch.from_numpy(rng.integers(-9, 9, (2, 1024)).astype(np.int32)),
        torch.arange(1024, dtype=torch.int32).expand(2, 1024)]
out = ksort.ksort_rows(keys, 2)
assert (out[0][:, 1:] >= out[0][:, :-1]).all()
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "kanzi_tpu"))
assert not loaded, loaded
print("ok")
"""


def test_order1_and_ksort_ops_without_jax():
    """A fresh process runs the CPU ops of ops/ans1_cuda.py and ops/ksort.py
    at a small shape and loads no jax and no kanzi_tpu module."""
    res = subprocess.run([sys.executable, "-c", _ORDER1_OPS], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_no_jax_import_in_package():
    pat = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")]
    assert len(files) >= 8
    for new in ("ans1_cuda.py", "ksort.py"):
        assert os.path.join(PKG, "ops", new) in files
    for path in files:
        with open(path) as fh:
            assert not pat.search(fh.read()), path


def test_no_kanzi_tpu_import():
    """No module of the port, and not chip_smoke.py, imports kanzi_tpu."""
    pat = re.compile(r"^\s*(import|from)\s+kanzi_tpu(\.|\s|$)", re.M)
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) >= 40
    for path in files:
        with open(path) as fh:
            text = fh.read()
        assert not pat.search(text), path
        assert "jax" not in re.findall(r"^\s*(?:import|from)\s+(\w+)", text, re.M), path


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from kanzi_tpu_torch.io.stream import CompressedInputStream, CompressedOutputStream
    ctx = {"transform": "NONE", "entropy": "ANS0"}
    with pytest.raises(RuntimeError, match="is_available"):
        CompressedOutputStream(io.BytesIO(), ctx, device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="is_available"):
        CompressedInputStream(io.BytesIO(b""), {}, device="cuda")
    with pytest.raises(TypeError):
        CompressedOutputStream(io.BytesIO(), ctx)      # device is required


def test_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for CPU tensors."""
    from kanzi_tpu_torch.ops import ans_cuda as A
    meta = torch.empty((2, A.CHUNK), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        A.hist_norm(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        A.ans0_encode_device(torch.zeros((1, A.CHUNK), dtype=torch.uint8).numpy(), "meta")
