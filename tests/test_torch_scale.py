"""The port at the sizes its users run, held on the CPU at a narrow size:
the device suffix array at kanzi_tpu's old shape-bucket edges against
kanzi_tpu's and SA-IS, its linear check, its admission by a byte budget,
``-b auto`` against kanzi_tpu's CLI, and a device failure in one pool job
reaching the caller."""

from __future__ import annotations

import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from kanzi_tpu.app.__main__ import _parse_block_size as ref_parse_block_size
from kanzi_tpu.app.__main__ import main as ref_main
from kanzi_tpu.ops.bwt_tpu import _bucket as ref_bucket
from kanzi_tpu.ops.bwt_tpu import suffix_array_device as ref_suffix_array_device
from kanzi_tpu.utils import native_transforms as ref_nt
from kanzi_tpu_torch.app.__main__ import _parse_block_size, main
from kanzi_tpu_torch.ops import bwt_device, launch
from kanzi_tpu_torch.ops.bwt_device import (ByteBudget, SuffixArrayTooLarge,
                                            check_suffix_array, sa_bytes,
                                            suffix_array_device)
from kanzi_tpu_torch.utils import native_transforms as nt
from kanzi_tpu_torch.utils.corpus import dna_like, mixed_corpus, text_like

# kanzi_tpu's shape-bucket edges (2^k and 1.5 x 2^k) and one byte each side
EDGE_LENGTHS = [e + d for e in (4096, 6144, 65536) for d in (-1, 0, 1)]
CLASSES = ["text", "zeros", "dna", "random", "periodic"]


@pytest.fixture(scope="module", autouse=True)
def _native_ready():
    """Load both packages' native libraries before any pool thread does."""
    ref_nt._lib()
    nt._lib()


def _case(name: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    return {
        "text": lambda: np.resize(text_like(n), n),
        "zeros": lambda: np.zeros(n, np.uint8),
        "dna": lambda: np.resize(dna_like(n), n),
        "random": lambda: rng.integers(0, 256, n).astype(np.uint8),
        "periodic": lambda: np.resize(np.frombuffer(b"abcab", np.uint8), n),
    }[name]()


@pytest.mark.parametrize("seed", [8, 4])
@pytest.mark.parametrize("n", EDGE_LENGTHS)
@pytest.mark.parametrize("case", CLASSES)
def test_sa_at_bucket_edges_matches_reference_and_sais(monkeypatch, case, n, seed):
    """The port sorts over the exact length, seeded with eight bytes (calls
    up to SEED8_MAX) or four; its SA is SA-IS's at every length, and
    kanzi_tpu's wherever kanzi_tpu pads by at least eight bytes (see
    test_reference_sa_with_short_padding for where it does not)."""
    if seed == 4:
        monkeypatch.setattr(bwt_device, "SEED8_MAX", 0)
    x = _case(case, n)
    want = nt.suffix_array_native(x)
    got = suffix_array_device(x, device="cpu")
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    if ref_bucket(n + 1) - n >= 8:
        assert np.array_equal(ref_suffix_array_device(x), want)


@pytest.mark.parametrize("seed", [8, 4])
@pytest.mark.parametrize("case", CLASSES)
def test_sa_of_short_texts(monkeypatch, case, seed):
    """Texts of 1 to 20 bytes, where every suffix or most of them are
    shorter than the seed's window: the SA is the sorted suffixes'."""
    if seed == 4:
        monkeypatch.setattr(bwt_device, "SEED8_MAX", 0)
    for n in range(1, 21):
        x = _case(case, n)
        want = sorted(range(n), key=lambda i: x[i:].tolist())
        assert suffix_array_device(x, device="cpu").tolist() == want


def test_reference_sa_with_short_padding():
    """kanzi_tpu's device SA reads the ranks at i + 8 as 0 past its padded
    buffer, so where it pads by fewer than eight bytes two suffixes at the
    end that differ only in trailing zeros stay tied and keep their text
    order: a wrong SA (and so a wrong BWT).  The port's is SA-IS's."""
    for n in (4095, 6143, 65535):
        x = np.zeros(n, np.uint8)
        assert ref_bucket(n + 1) - n < 8
        want = nt.suffix_array_native(x)
        assert not np.array_equal(ref_suffix_array_device(x), want)
        assert np.array_equal(suffix_array_device(x, device="cpu"), want)


# lengths over several slices of SLICE = 4096 positions: at, one each
# side of, and between the slice edges
SLICE_LENGTHS = [3 * 4096, 3 * 4096 + 1, 5 * 4096 - 1, 5 * 4096 + 1234]


@pytest.mark.parametrize("n", SLICE_LENGTHS)
@pytest.mark.parametrize("case", CLASSES)
def test_sa_across_slices_matches_sais(monkeypatch, case, n):
    """With the slice of the temporaries cut to 4096 positions (and the
    four-byte seed, which slices, taken at every length), the seed's
    bytes, the round keys' rank at i + k, the ranks' overlap of one entry
    and the linear check all cross slice edges; the SA is SA-IS's, and the
    check still rejects a pair swapped across an edge."""
    monkeypatch.setattr(bwt_device, "SLICE", 4096)
    monkeypatch.setattr(bwt_device, "SEED8_MAX", 0)
    x = _case(case, n)
    want = nt.suffix_array_native(x)
    got = suffix_array_device(x, device="cpu")
    assert np.array_equal(got, want)
    text, sa = torch.from_numpy(x.copy()), torch.from_numpy(got)
    assert check_suffix_array(text, sa)
    swapped = sa.clone()
    swapped[[4095, 4096]] = swapped[[4096, 4095]]
    assert not check_suffix_array(text, swapped)


def test_check_suffix_array_accepts_sais_rejects_faults():
    for x in (text_like(5000), np.zeros(777, np.uint8), dna_like(3000),
              np.frombuffer(b"banana", np.uint8)):
        text = torch.from_numpy(x.copy())
        sa = torch.from_numpy(nt.suffix_array_native(x))
        assert check_suffix_array(text, sa)
        swapped = sa.clone()
        swapped[[1, 2]] = swapped[[2, 1]]
        assert not check_suffix_array(text, swapped)
        repeated = sa.clone()
        repeated[3] = repeated[4]
        assert not check_suffix_array(text, repeated)
        assert not check_suffix_array(text, sa[:-1])
        outside = sa.clone()
        outside[0] = x.size
        assert not check_suffix_array(text, outside)


def test_admission_threads_wait_and_match_serial():
    """With room for one call, calls from threads wait while one is
    admitted, then run one at a time, and equal the serial results."""
    n = 50_000
    blocks = [mixed_corpus(n, seed=s) for s in range(3)]
    serial = [suffix_array_device(b, device="cpu") for b in blocks]
    budget = ByteBudget(int(sa_bytes(n) * 1.5))
    got = [None] * len(blocks)

    def run(i):
        got[i] = suffix_array_device(blocks[i], device="cpu", budget=budget)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(blocks))]
    with budget.admit(n):
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while budget.waits < len(blocks) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert budget.waits == len(blocks)
        assert all(g is None for g in got)
    for t in threads:
        t.join()
    assert budget.in_use == 0
    assert budget.peak <= budget.capacity
    assert all(np.array_equal(g, s) for g, s in zip(got, serial))


def test_over_budget_raises_before_allocating(monkeypatch):
    """A call larger than its whole budget raises the named error, with n,
    npad and the reckoned bytes, before any tensor or launch."""
    def refuse(*args, **kwargs):
        raise AssertionError("the call allocated")

    monkeypatch.setattr(bwt_device, "prefix_doubling", refuse)
    monkeypatch.setattr(bwt_device.torch, "from_numpy", refuse)
    n = 70_000
    launch.reset_launches()
    with pytest.raises(SuffixArrayTooLarge,
                       match=rf"n = {n} \(npad = {n}.*{sa_bytes(n)} B"):
        suffix_array_device(np.zeros(n, np.uint8), device="cpu",
                            budget=ByteBudget(sa_bytes(n) - 1))
    assert launch.launches["suffix_array"] == 0
    assert bwt_device.device_budget(torch.device("cpu")) is None


def test_admission_waits_for_the_card_room():
    """Where the device has less room free than a call needs (other buffers,
    another process), the call waits, and starts once the room is there;
    calls already admitted count against the room too.  A call that waits
    alone longer than the budget's patience raises the named error."""
    n = 50_000
    need = sa_bytes(n)
    room = [need - 1]
    budget = ByteBudget(10 * need, room=lambda: room[0], patience=60)
    started = threading.Event()

    def run():
        with budget.admit(n):
            started.set()

    t = threading.Thread(target=run)
    t.start()
    assert not started.wait(0.3)
    assert budget.in_use == 0
    room[0] = need
    assert started.wait(30)
    t.join()
    assert budget.waits == 1 and budget.in_use == 0

    room[0] = 2 * need - 1          # room for one call, not for a second
    with budget.admit(n):
        second = threading.Thread(target=run)
        started.clear()
        second.start()
        assert not started.wait(0.3)
    assert started.wait(30)
    second.join()
    assert budget.waits == 2 and budget.peak == need

    with pytest.raises(SuffixArrayTooLarge, match=r"room free on the device"):
        with ByteBudget(10 * need, room=lambda: 0, patience=0.2).admit(n):
            pass


def test_mesh_sa_rows_are_admitted(monkeypatch):
    """The multi-GPU engine's SA step runs each row inside the device's
    budget: a row over it fails the step (MeshError from the named error)
    before it allocates; within it, every row is admitted in turn."""
    from kanzi_tpu_torch.parallel import engine

    monkeypatch.setattr(engine, "_all_gather", lambda mesh, t, name: t.cpu().numpy())
    mesh = engine.Mesh(None, 0, 1, torch.device("cpu"), "gloo")
    rows = [mixed_corpus(5000, seed=1), mixed_corpus(3000, seed=2)]
    npad = bwt_device._bucket(5001)
    glob = np.zeros((2, npad), np.uint8)
    for k, r in enumerate(rows):
        glob[k, :r.size] = r
    ns = np.array([r.size for r in rows], np.int32)
    step = engine.make_sa_step(mesh, npad)

    budget = ByteBudget(sa_bytes(5000))
    monkeypatch.setattr(bwt_device, "device_budget", lambda dev: budget)
    sas = step(glob, ns)
    for k, r in enumerate(rows):
        assert np.array_equal(sas[k, :r.size], nt.suffix_array_native(r))
    assert budget.peak == sa_bytes(5000) and budget.in_use == 0

    budget = ByteBudget(sa_bytes(5000) - 1)
    launch.reset_launches()
    with pytest.raises(engine.MeshError) as e:
        step(glob, ns)
    assert isinstance(e.value.__cause__, SuffixArrayTooLarge)
    assert launch.launches["suffix_array"] == 0


@pytest.mark.parametrize("slice_", [7, 4096, 1 << 24])
def test_assemble_forward_in_slices_matches_reference(monkeypatch, slice_):
    """The BWT from an SA, built in slices (no int64 array of the block's
    length, which at 1 GiB held ~34 GB of host memory a job), equals
    kanzi_tpu's, primary indexes included, at slice edges too."""
    from kanzi_tpu.transforms.bwt import BWT as RefBWT
    from kanzi_tpu_torch.transforms import bwt as port_bwt

    monkeypatch.setattr(port_bwt, "ASSEMBLE_SLICE", slice_)
    base = mixed_corpus(300_001, seed=29)
    for n in (3, 255, 256, 4096, 4097, 70_000, 300_001):
        for x in (base[:n].copy(), np.zeros(n, np.uint8)):
            sa = nt.suffix_array_native(x)
            chunks = port_bwt.get_bwt_chunks(n)
            ours, ref = port_bwt.BWT(), RefBWT()
            got = ours._assemble_forward(x, sa, chunks)
            assert np.array_equal(got, ref._assemble_forward(x, sa.astype(np.int64), chunks))
            assert ours.primary_indexes == ref.primary_indexes


@pytest.mark.parametrize("size,jobs", [(211_957_760, 8), ((1 << 30) + 12_345, 2),
                                       (0, 4), (1, 4), (1000, 8), (65, 1),
                                       (4097 * 4, 4), (300_001, 4)])
def test_auto_block_size_is_the_reference(size, jobs):
    assert _parse_block_size("auto", size, jobs) == ref_parse_block_size("auto", size, jobs)
    assert _parse_block_size("auto", 211_957_760, 8) == 26_494_720


def test_auto_block_cli_matches_reference(tmp_path):
    """``-b auto -j 4`` on a small file writes the same stream through both
    packages' CLIs on the CPU, and the port's decodes."""
    src = tmp_path / "in.bin"
    src.write_bytes(mixed_corpus(300_001, seed=19).tobytes())
    ours, ref, back = tmp_path / "ours.knz", tmp_path / "ref.knz", tmp_path / "back.bin"
    flags = ["-c", "-f", "-i", str(src), "-l", "5", "-b", "auto", "-j", "4", "-v", "0"]
    assert main([*flags, "-o", str(ours), "--device", "none"]) == 0
    assert ref_main([*flags, "-o", str(ref)]) == 0
    assert ours.read_bytes() == ref.read_bytes()
    assert main(["-d", "-f", "-i", str(ours), "-o", str(back), "-v", "0",
                 "--device", "cpu"]) == 0
    assert back.read_bytes() == src.read_bytes()


# one pool job's device SA fails: the stream must raise and the CLI exit
# non-zero, leaving no output behind
_FAIL_ONE = """
import runpy, sys, threading
import torch
from kanzi_tpu_torch.ops import bwt_device
real, seen, lock = bwt_device.suffix_array_device, [], threading.Lock()
def flaky(src, **kw):
    with lock:
        seen.append(1)
        first = len(seen) == 1
    if first:
        raise torch.OutOfMemoryError("device SA: out of memory (a test's)")
    return real(src, **kw)
bwt_device.suffix_array_device = flaky
sys.argv = ["kanzi_tpu_torch.app"] + sys.argv[1:]
runpy.run_module("kanzi_tpu_torch.app", run_name="__main__", alter_sys=True)
"""


def test_device_sa_failure_in_a_pool_job_is_not_hidden(tmp_path, monkeypatch):
    data = mixed_corpus(300_000, seed=21).tobytes()
    ctx = {"transform": "TEXT+UTF+BWT+RANK+ZRLT", "entropy": "ANS0",
           "blockSize": 100_000, "jobs": 3}
    monkeypatch.setenv("KANZI_TPU_DEVICE_BWT", "1")
    real = bwt_device.suffix_array_device
    calls = []

    def flaky(src, **kw):
        calls.append(src.size)
        if len(calls) == 2:
            raise torch.OutOfMemoryError("device SA: out of memory (a test's)")
        return real(src, **kw)

    monkeypatch.setattr(bwt_device, "suffix_array_device", flaky)
    import io

    from kanzi_tpu_torch.io.stream import CompressedOutputStream
    with pytest.raises(torch.OutOfMemoryError):
        with CompressedOutputStream(io.BytesIO(), ctx, device="cpu") as cos:
            cos.write(data)
    assert len(calls) >= 2

    src, dst = tmp_path / "in.bin", tmp_path / "out.knz"
    src.write_bytes(data)
    res = subprocess.run([sys.executable, "-c", _FAIL_ONE, "-c", "-f", "-i", str(src),
                          "-o", str(dst), "-l", "5", "-b", "100k", "-j", "3",
                          "--device", "cpu"], capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "OutOfMemoryError" in res.stderr
    assert not dst.exists()


@pytest.mark.parametrize("lzp", [False, True], ids=["lzx", "lzp"])
def test_inverse_of_unknown_size_stays_native(monkeypatch, lzp):
    """A decode that does not know its output's size (the sequence's last
    stage, as the stream calls it) tries the native inverse up to the
    largest block, where kanzi_tpu stops below it and falls to its Python
    mirror: at 1 GiB blocks that decoded level 1 at ~6 MB/s.  Here the
    largest block is cut to 1 MiB, so that a 600 KB block's sections, over
    a quarter of it, show the same; the bytes are kanzi_tpu's.  LZP's input
    is half random, so that its sections stay that large."""
    from kanzi_tpu.transforms.lz import LZCodec as RefLZCodec
    from kanzi_tpu_torch.transforms import lz

    data = mixed_corpus(600_000, seed=23)
    if lzp:
        rng = np.random.default_rng(23)
        data = np.concatenate([rng.integers(0, 256, 300_000).astype(np.uint8),
                               np.resize(mixed_corpus(4096, seed=23), 300_000)])
    src = RefLZCodec(lzp=lzp).forward(data)
    assert src.size * 4 + 65536 > 1 << 20
    monkeypatch.setattr(lz, "MAX_OUTPUT", 1 << 20)

    def python_mirror(*args, **kwargs):
        raise AssertionError("the Python mirror ran")

    monkeypatch.setattr(lz, "_lzp_inverse_py" if lzp else "_lzx_inverse_py", python_mirror)
    got = lz.LZCodec(lzp=lzp).inverse(src)
    assert np.array_equal(got, data)
    assert np.array_equal(got, RefLZCodec(lzp=lzp).inverse(src))


@pytest.mark.parametrize("n", [98_303, 131_071])
def test_gated_bwt_at_short_padding_round_trips(monkeypatch, n):
    """Under KANZI_TPU_DEVICE_BWT=1, a BWT input whose length leaves
    kanzi_tpu's padding under eight bytes and that ends in two zero bytes:
    the SA that padding gave (test_reference_sa_with_short_padding) made a
    BWT that did not invert.  The port's equals the host's and inverts."""
    from kanzi_tpu_torch.transforms.bwt import BWT

    assert ref_bucket(n + 1) - n < 8
    rng = np.random.default_rng(n)
    x = np.r_[rng.integers(1, 256, n - 2), [0, 0]].astype(np.uint8)
    monkeypatch.setenv("KANZI_TPU_DEVICE_BWT", "1")
    launch.reset_launches()
    dev = BWT(ctx={"_device": "cpu"})
    got = dev.forward(x.copy())
    assert launch.launches["suffix_array"] == 1
    host = BWT()
    assert np.array_equal(got, host.forward(x.copy()))
    assert dev.primary_indexes == host.primary_indexes
    back = BWT()
    back.primary_indexes = list(dev.primary_indexes)
    assert np.array_equal(back.inverse(got), x)


@pytest.mark.parametrize("transform", ["BWT", "BWT+RANK"])
def test_largest_block_grown_by_its_transform_reads_back(monkeypatch, transform):
    """A block of the largest size whose transform adds a header (the BWT's
    primary indexes: 2^30 + 33 B at -b 1g) is written alike by both
    packages; kanzi_tpu's reader caps a block's transformed length at the
    largest block size and refuses it, the port's reads it back.  The
    largest size is cut to 1 MiB in both packages."""
    import io

    from kanzi_tpu.io import stream as ref_stream
    from kanzi_tpu_torch.io import stream as port_stream

    big = 1 << 20
    for mod in (ref_stream, port_stream):
        monkeypatch.setattr(mod, "MAX_BITSTREAM_BLOCK_SIZE", big)
    data = np.resize(mixed_corpus(300_000, seed=31), big + 12_345).tobytes()
    ctx = {"transform": transform, "entropy": "NONE", "blockSize": big, "jobs": 2}

    def write(mod, **kw):
        out = io.BytesIO()
        with mod.CompressedOutputStream(out, dict(ctx), **kw) as cos:
            cos.write(data)
        return out.getvalue()

    blob = write(port_stream, device=None)
    assert blob == write(ref_stream)
    with pytest.raises(Exception, match="invalid compressed block length"):
        with ref_stream.CompressedInputStream(io.BytesIO(blob), {"jobs": 2}) as cis:
            cis.read(-1)
    for device in (None, "cpu"):
        with port_stream.CompressedInputStream(io.BytesIO(blob), {"jobs": 2},
                                               device=device) as cis:
            assert cis.read(-1) == data
