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
    ("TEXT+UTF+PACK+MM+LZX", "HUFFMAN", 300000, 1 << 18, "legacy"),
], ids=["level5", "level2", "level3", "level1_device_lz", "level3_legacy_lz"])
def test_level5_round_trip_without_jax(transform, entropy, size, block, device_lz):
    """A fresh process, which loads no jax and no kanzi_tpu module
    (tests/conftest.py imports jax into this one).  The Huffman levels'
    blocks hold enough full chunks for the device encode and decode paths,
    level 1 runs the device LZ engine and level 3 under "legacy" the v1
    engine (their plain versions here)."""
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


_CLI = """
import runpy, sys
sys.argv = ["kanzi_tpu_torch"] + sys.argv[1:]
try:
    runpy.run_module("kanzi_tpu_torch.app", run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert not e.code, e.code
from kanzi_tpu_torch.ops import launch
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "kanzi_tpu"))
assert not loaded, loaded
print("ok", launch.launches.get("suffix_array", 0))
"""


def test_cli_level5_device_bwt_without_jax(tmp_path):
    """The CLI, as ``python -m kanzi_tpu_torch.app`` runs it, compresses at
    level 5 on device=cpu with the SA gate on and decompresses, in fresh
    processes that load no jax and no kanzi_tpu module."""
    from kanzi_tpu_torch.utils.corpus import mixed_corpus
    src = tmp_path / "in.bin"
    src.write_bytes(mixed_corpus(100_000, seed=4).tobytes())
    env = dict(os.environ, KANZI_TPU_DEVICE_BWT="1")
    runs = [(["-c", "-l", "5", "-i", str(src), "-o", str(tmp_path / "in.knz")], "ok 1"),
            (["-d", "-i", str(tmp_path / "in.knz"), "-o", str(tmp_path / "out")], "ok 0")]
    for flags, want in runs:
        res = subprocess.run([sys.executable, "-c", _CLI, *flags, "-j", "2", "-v", "0",
                              "--device", "cpu"], cwd=ROOT,
                             capture_output=True, text=True, timeout=300, env=env)
        assert res.returncode == 0, res.stderr
        assert res.stdout.strip() == want
    assert (tmp_path / "out").read_bytes() == src.read_bytes()


_MESH_L5 = """
import io, sys
import torch.distributed as dist
from kanzi_tpu_torch.io.stream import CompressedInputStream
from kanzi_tpu_torch.parallel import dryrun, engine
from kanzi_tpu_torch.utils.corpus import mixed_corpus
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{dryrun.free_port()}",
                        world_size=1, rank=0)
mesh = engine.make_mesh(1, device="cpu")
data = mixed_corpus(200000, seed=5)
wire = engine.mesh_l5_compress(mesh, data, block_size=1 << 17, jobs=2)
assert engine.mesh_decompress(mesh, wire, jobs=2) == data.tobytes()
with CompressedInputStream(io.BytesIO(wire), {}, device=None) as cis:
    assert cis.read(-1) == data.tobytes()
dist.destroy_process_group()
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "kanzi_tpu"))
assert not loaded, loaded
print("ok")
"""


def test_mesh_level5_without_jax():
    """A fresh process runs the multi-GPU engine's level 5 on a gloo world
    of one rank on the CPU, and its mesh decode, and loads no jax and no
    kanzi_tpu module."""
    res = subprocess.run([sys.executable, "-c", _MESH_L5], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_no_jax_import_in_package():
    pat = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")]
    assert len(files) >= 8
    for new in ("ops/ans1_cuda.py", "ops/ksort.py", "ops/bwt_device.py", "ops/lz_tpu.py",
                "app/__main__.py"):
        assert os.path.join(PKG, *new.split("/")) in files
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
