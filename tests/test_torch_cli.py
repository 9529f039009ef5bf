"""The port's command line (kanzi_tpu_torch.app) and benchmark harness: the
counterparts of tests/test_cli.py's cases with ``--device none``, the same
``.knz`` bytes as kanzi_tpu's CLI for the same flags, the same bytes with
``--device cpu`` (the device stages' plain versions, the SA gate among them),
and no output at all when the default device, the card, is missing."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kanzi_tpu.app.__main__ import main as ref_main
from kanzi_tpu.utils import native_transforms as ref_nt
from kanzi_tpu_torch.app.__main__ import main
from kanzi_tpu_torch.core.errors import Error
from kanzi_tpu_torch.ops import launch
from kanzi_tpu_torch.utils import native_transforms as nt
from kanzi_tpu_torch.utils.corpus import mixed_corpus

NONE = ["--device", "none"]


@pytest.fixture(scope="module", autouse=True)
def _native_ready():
    """Load both packages' native libraries before any pool thread does:
    kanzi_tpu's one-time set-up is not guarded against two threads, and the
    TEXT dictionary rebuilt under a running block changes its bytes."""
    ref_nt._lib()
    nt._lib()


@pytest.fixture
def tree(tmp_path):
    rng = np.random.default_rng(0)
    d = tmp_path / "src"
    (d / "sub").mkdir(parents=True)
    (d / "a.bin").write_bytes(bytes(rng.integers(65, 91, 50000, dtype=np.uint8)))
    (d / "sub" / "b.bin").write_bytes(b"hello world " * 4000)
    return d


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """One input of about 100 KB of the mixed corpus."""
    path = tmp_path_factory.mktemp("sample") / "in.bin"
    path.write_bytes(mixed_corpus(100_000, seed=17).tobytes())
    return path


def test_dir_output_must_exist(tree, tmp_path, capsys):
    rc = main(["-c", "-f", "-i", str(tree), "-o", str(tmp_path / "missing"),
               "-l", "1", "-v", "0", *NONE])
    assert rc == Error.ERR_CREATE_FILE
    assert "existing directory" in capsys.readouterr().err


def test_dir_round_trip_mirrors_subpaths(tree, tmp_path):
    out = tmp_path / "out"
    dec = tmp_path / "dec"
    out.mkdir()
    dec.mkdir()
    assert main(["-c", "-f", "-i", str(tree), "-o", str(out),
                 "-l", "1", "-v", "0", *NONE]) == 0
    assert (out / "a.bin.knz").is_file()
    assert (out / "sub" / "b.bin.knz").is_file()
    assert main(["-d", "-f", "-i", str(out), "-o", str(dec),
                 "-v", "0", *NONE]) == 0
    assert (dec / "a.bin").read_bytes() == (tree / "a.bin").read_bytes()
    assert (dec / "sub" / "b.bin").read_bytes() == \
        (tree / "sub" / "b.bin").read_bytes()


def test_dir_without_output_writes_beside_inputs(tree):
    assert main(["-c", "-f", "-i", str(tree), "-l", "1", "-v", "0", *NONE]) == 0
    assert (tree / "a.bin.knz").is_file()
    assert (tree / "sub" / "b.bin.knz").is_file()


def test_output_none_sink(tree):
    assert main(["-c", "-f", "-i", str(tree / "a.bin"), "-o", "NONE",
                 "-l", "1", "-v", "0", *NONE]) == 0


def test_overwrite_protection(tree, tmp_path):
    out = tmp_path / "x.knz"
    assert main(["-c", "-i", str(tree / "a.bin"), "-o", str(out),
                 "-l", "1", "-v", "0", *NONE]) == 0
    rc = main(["-c", "-i", str(tree / "a.bin"), "-o", str(out),
               "-l", "1", "-v", "0", *NONE])
    assert rc == Error.ERR_OVERWRITE_FILE
    assert main(["-c", "-f", "-i", str(tree / "a.bin"), "-o", str(out),
                 "-l", "1", "-v", "0", *NONE]) == 0


@pytest.mark.parametrize("chain,entropy", [
    ("BWT+MTFT+ZRLT", "RANGE"),
    ("BWTS+SRT", "FPAQ"),
    ("RLT+TEXT", "HUFFMAN"),
    ("LZP+ZRLT", "ANS1"),
    ("MM+PACK", "ANS0"),
    ("EXE+LZX", "CM"),
])
def test_custom_chain_cli_round_trip(tree, tmp_path, chain, entropy):
    """Non-preset -t/-e chains: kanzi_tpu's CLI's bytes, and they decode."""
    src = tree / "sub" / "b.bin"
    knz = tmp_path / "c.knz"
    ref = tmp_path / "ref.knz"
    out = tmp_path / "c.out"
    assert main(["-c", "-i", str(src), "-o", str(knz), "-t", chain,
                 "-e", entropy, "-f", "-v", "0", *NONE]) == 0
    assert ref_main(["-c", "-i", str(src), "-o", str(ref), "-t", chain,
                     "-e", entropy, "-f", "-v", "0"]) == 0
    assert knz.read_bytes() == ref.read_bytes()
    assert main(["-d", "-i", str(knz), "-o", str(out), "-f", "-v", "0", *NONE]) == 0
    assert out.read_bytes() == src.read_bytes()


@pytest.mark.parametrize("level", range(7))
def test_levels_match_kanzi_tpu_cli(sample, tmp_path, level):
    knz = tmp_path / "p.knz"
    ref = tmp_path / "r.knz"
    flags = ["-c", "-f", "-i", str(sample), "-l", str(level), "-j", "2", "-v", "0"]
    assert main([*flags, "-o", str(knz), *NONE]) == 0
    assert ref_main([*flags, "-o", str(ref)]) == 0
    assert knz.read_bytes() == ref.read_bytes()
    out = tmp_path / "p.out"
    assert main(["-d", "-f", "-i", str(knz), "-o", str(out), "-v", "0", *NONE]) == 0
    assert out.read_bytes() == sample.read_bytes()


@pytest.mark.parametrize("level,gate", [(2, "0"), (3, "0"), (5, "0"), (5, "1")],
                         ids=["l2", "l3", "l5", "l5_device_bwt"])
def test_device_cpu_matches_none(sample, tmp_path, monkeypatch, level, gate):
    """``--device cpu`` (the plain versions of the device stages) writes the
    host coders' bytes and decodes on both; at level 5 with the SA gate on,
    the BWT's suffix array comes from ops/bwt_device.py."""
    monkeypatch.setenv("KANZI_TPU_DEVICE_BWT", gate)
    flags = ["-c", "-f", "-i", str(sample), "-l", str(level), "-j", "2", "-v", "0"]
    if gate == "1":
        flags += ["-b", "256k"]
    host = tmp_path / "none.knz"
    dev = tmp_path / "cpu.knz"
    assert main([*flags, "-o", str(host), *NONE]) == 0
    launch.reset_launches()
    assert main([*flags, "-o", str(dev), "--device", "cpu"]) == 0
    assert launch.launches.get("suffix_array", 0) == (1 if gate == "1" else 0)
    assert dev.read_bytes() == host.read_bytes()
    for device in ("cpu", "none"):
        out = tmp_path / f"{device}.out"
        assert main(["-d", "-f", "-i", str(dev), "-o", str(out), "-v", "0",
                     "--device", device]) == 0
        assert out.read_bytes() == sample.read_bytes()


def test_default_device_without_card_fails_and_writes_nothing(sample, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    knz = tmp_path / "x.knz"
    rc = main(["-c", "-i", str(sample), "-o", str(knz), "-l", "5", "-v", "0"])
    assert rc != 0
    assert "is_available" in capsys.readouterr().err
    assert not knz.exists()
    assert main(["-c", "-i", str(sample), "-o", str(knz), "-l", "5", "-v", "0", *NONE]) == 0
    out = tmp_path / "x.out"
    assert main(["-d", "-i", str(knz), "-o", str(out), "-v", "0"]) != 0
    assert not out.exists()


def test_info_reads_the_header_on_the_host(sample, tmp_path, capsys):
    knz = tmp_path / "i.knz"
    assert main(["-c", "-i", str(sample), "-o", str(knz), "-l", "5", "-v", "0", *NONE]) == 0
    capsys.readouterr()
    assert main(["-y", "-i", str(knz), "--device", "cuda"]) == 0
    text = capsys.readouterr().out
    assert "Entropy codec: ANS0" in text
    assert "Transforms: TEXT+UTF+BWT+RANK+ZRLT" in text
    assert f"Original size: {sample.stat().st_size} bytes" in text


def test_benchmark_harness_smoke():
    """The sweep harness (app/benchmark.py) runs level and config benchmarks
    with verified round trips, on the host coders."""
    from kanzi_tpu_torch.app import benchmark as B
    data = (b"benchmark harness smoke payload 0123456789 " * 1500)
    res = B.run_levels(data, levels=[0, 1, 5], jobs=2, device=None)
    assert [r.in_size for r in res] == [len(data)] * 3
    assert res[1].ratio < 1.0
    r = B.run_config(data, "BWT+RANK+ZRLT", "ANS0", 1 << 20, jobs=1, device=None)
    assert r.out_size < len(data)


def test_benchmark_main_device(sample, capsys):
    from kanzi_tpu_torch.app import benchmark as B
    assert B.main([str(sample), "5", "--device", "none"]) == 0
    assert "-l 5 (TEXT+UTF+BWT+RANK+ZRLT+ANS0)" in capsys.readouterr().out
    assert B.main([str(sample), "0", "--device=cpu"]) == 0
    assert B.main([str(sample), "--device", "tpu"]) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            B.main([str(sample), "0"])
