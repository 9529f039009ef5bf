"""The port's device suffix array (ops/bwt_device.py) on device=cpu against
kanzi_tpu's (XLA on the CPU) and the native SA-IS, and its gate in the BWT
(KANZI_TPU_DEVICE_BWT): the same blocks, the same primary indexes and the
same level-5 streams as the host path."""

from __future__ import annotations

import io
import sys
import threading

import numpy as np
import pytest
import torch

from kanzi_tpu.ops.bwt_tpu import _bucket as ref_bucket
from kanzi_tpu.ops.bwt_tpu import suffix_array_device as ref_suffix_array_device
from kanzi_tpu_torch.io.stream import CompressedInputStream, CompressedOutputStream
from kanzi_tpu_torch.ops import bwt_device, launch
from kanzi_tpu_torch.ops.bwt_device import pack_key, suffix_array_device
from kanzi_tpu_torch.transforms.bwt import BWT
from kanzi_tpu_torch.utils import native_transforms as nt
from kanzi_tpu_torch.utils.corpus import dna_like, mixed_corpus, text_like


def _case(name: str) -> np.ndarray:
    """The six input classes of tests/test_bwt_tpu.py."""
    rng = np.random.default_rng(3)
    return {
        "text": lambda: text_like(80_000),
        "zeros": lambda: np.zeros(4096, np.uint8),
        "dna": lambda: dna_like(50_000),
        "random": lambda: rng.integers(0, 256, 65537).astype(np.uint8),
        "periodic": lambda: np.tile(np.frombuffer(b"abcab", np.uint8), 10_000),
        "tiny": lambda: np.frombuffer(b"banana", np.uint8),
    }[name]()


@pytest.mark.parametrize("case", ["text", "zeros", "dna", "random", "periodic", "tiny"])
def test_device_sa_matches_reference_and_native(case):
    x = _case(case)
    got = suffix_array_device(x, device="cpu")
    assert got.dtype == np.int32
    assert np.array_equal(got, ref_suffix_array_device(x))
    assert np.array_equal(got, nt.suffix_array_native(x))


@pytest.mark.parametrize("data", [b"", b"a", b"ba", b"aab"], ids=["n0", "n1", "n2", "n3"])
def test_device_sa_small_n(data):
    x = np.frombuffer(data, np.uint8)
    got = suffix_array_device(x, device="cpu")
    assert got.dtype == np.int32
    assert np.array_equal(got, ref_suffix_array_device(x))
    assert np.array_equal(got, nt.suffix_array_native(x))


def test_bucket_is_the_reference():
    for n in [2, 3, 4, 5, 7, 96, 97, 4097, 65537, 200_001, (4 << 20) + 1, (1 << 30) + 1]:
        assert bwt_device._bucket(n) == ref_bucket(n)
    assert bwt_device._bucket((4 << 20) + 1) == 6_291_456


def test_pack_key_orders_pairs_up_to_2_32():
    """The packed key's signed order is the pairs' order for every word
    below 2^32 (ranks of the largest block, the seed's unsigned words), with
    no sign extension from the low word."""
    hi = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**31, 2**32 - 1, 2**32 - 1, 0, 5, 5])
    lo = torch.tensor([0, 0, 2**32 - 1, 0, 2**31, 0, 2**32 - 1, 2**32 - 1, 2**31, 2**31 - 1])
    key = pack_key(hi, lo)
    want = sorted(range(hi.numel()), key=lambda i: (int(hi[i]), int(lo[i])))
    assert torch.argsort(key, stable=True).tolist() == want
    assert len(set(key.tolist())) == hi.numel()


def test_device_sa_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        suffix_array_device(np.zeros(100, np.uint8), device="cuda")


def test_device_bwt_gate_wire_exact(monkeypatch):
    """The port's form of tests/test_bwt_tpu.py::test_device_bwt_gate_wire_exact."""
    x = mixed_corpus(200_000)
    monkeypatch.setenv("KANZI_TPU_DEVICE_BWT", "1")
    launch.reset_launches()
    b1 = BWT(ctx={"_device": "cpu"})
    d1 = b1.forward(x.copy())
    assert launch.launches["suffix_array"] == 1
    monkeypatch.delenv("KANZI_TPU_DEVICE_BWT")
    b2 = BWT(ctx={"_device": "cpu"})
    d2 = b2.forward(x.copy())
    assert launch.launches["suffix_array"] == 1
    assert np.array_equal(d1, d2)
    assert b1.primary_indexes == b2.primary_indexes
    assert np.array_equal(b1.inverse(d1), x)


def _refuse(*args, **kwargs):
    raise AssertionError("the device suffix array was called")


@pytest.mark.parametrize("size,device", [(65535, "cpu"), (65536, None)],
                         ids=["under_64k", "no_device"])
def test_device_bwt_gate_untaken(monkeypatch, size, device):
    """A block under 65,536 bytes, or a stream with no device, keeps the
    host SA whatever the variable says."""
    monkeypatch.setenv("KANZI_TPU_DEVICE_BWT", "1")
    monkeypatch.setattr(bwt_device, "suffix_array_device", _refuse)
    x = mixed_corpus(size, seed=8)
    b1 = BWT(ctx={"_device": device})
    d1 = b1.forward(x.copy())
    b2 = BWT()
    assert np.array_equal(d1, b2.forward(x.copy()))
    assert b1.primary_indexes == b2.primary_indexes


def _stream(data: bytes, ctx: dict, device) -> bytes:
    out = io.BytesIO()
    with CompressedOutputStream(out, ctx, device=device) as cos:
        cos.write(data)
    return out.getvalue()


def test_level5_stream_gate_on_equals_host(monkeypatch):
    """Level 5 with the gate on at device=cpu writes the device=None bytes,
    with one device SA for each BWT input of at least 65,536 bytes, and
    decodes."""
    data = mixed_corpus(200_000, seed=9).tobytes()
    ctx = {"transform": "TEXT+UTF+BWT+RANK+ZRLT", "entropy": "ANS0",
           "blockSize": 100_000, "jobs": 2}
    ref = _stream(data, ctx, None)
    sizes = []
    forward = BWT.forward

    def spy(self, src):
        sizes.append(src.size)
        return forward(self, src)

    monkeypatch.setattr(BWT, "forward", spy)
    monkeypatch.setenv("KANZI_TPU_DEVICE_BWT", "1")
    launch.reset_launches()
    blob = _stream(data, ctx, "cpu")
    calls = launch.launches["suffix_array"]
    assert len(sizes) == 2 and calls == sum(n >= 65536 for n in sizes) >= 1
    assert blob == ref
    with CompressedInputStream(io.BytesIO(blob), {"jobs": 2}, device="cpu") as cis:
        assert cis.read(-1) == data


def test_native_init_runs_once_under_threads(monkeypatch):
    """The pool's first blocks reach the native library together; its one-time
    set-up (signatures, the TEXT dictionary) runs once, not once a thread."""
    lib = nt._lib()
    if lib is None or not hasattr(lib, "kz_text_set_dict"):
        pytest.skip("native library unavailable")
    real = lib.kz_text_set_dict
    count = []

    def counted(*args):
        count.append(1)
        return real(*args)

    monkeypatch.setattr(lib, "kz_text_set_dict", counted)
    monkeypatch.setattr(nt, "_SIGS_DONE", False)
    gate = threading.Barrier(8)

    def first_call():
        gate.wait(timeout=30)
        nt._lib()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_call) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(count) == 1
    assert nt._SIGS_DONE
