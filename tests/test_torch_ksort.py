"""The port's row sort (kanzi_tpu_torch/ops/ksort.py) against kanzi_tpu's
``ksort_rows`` in interpret mode, on the same numpy inputs, bit for bit."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kanzi_tpu.ops.ksort_pallas as K
from kanzi_tpu_torch.ops import ksort


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("KANZI_TPU_PALLAS_INTERPRET", "1")


def _operands(rng, b, n, nops, nk):
    """tests/test_pallas_interpret.py's operands: small random keys with many
    ties, made total by a position iota as the last key."""
    arrs = [rng.integers(-50, 50, (b, n)).astype(np.int32) for _ in range(nops - 1)]
    idx = np.broadcast_to(np.arange(n, dtype=np.int32), (b, n)).copy()
    return arrs[:nk - 1] + [idx] + arrs[nk - 1:]


@pytest.mark.parametrize("ls,b,n,nops,nk", [(10, 2, 1 << 9, 2, 1), (10, 1, 1 << 12, 4, 2),
                                            (11, 2, 1 << 13, 3, 2)])
def test_ksort_rows_matches_pallas(monkeypatch, ls, b, n, nops, nk):
    monkeypatch.setattr(K, "LS", ls)
    K._span_call.cache_clear()
    K._cross_call.cache_clear()
    try:
        arrs = _operands(np.random.default_rng(7), b, n, nops, nk)
        want = K.ksort_rows([jnp.asarray(a) for a in arrs], nk)
    finally:
        K._span_call.cache_clear()
        K._cross_call.cache_clear()
    got = ksort.ksort_rows([torch.from_numpy(a) for a in arrs], nk)
    assert len(got) == nops
    for g, w, a in zip(got, want, arrs):
        assert g.dtype == torch.int32 and g.shape == (b, n)
        assert np.array_equal(g.numpy(), np.asarray(w))
    for row in range(b):
        order = np.lexsort(tuple(a[row] for a in arrs[:nk][::-1]))
        assert np.array_equal(got[nk - 1][row].numpy(), order)


def test_ksort_rows_rejects_non_power_of_two():
    x = torch.zeros((2, 768), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        ksort.ksort_rows([x, x], 1)
    with pytest.raises(ValueError, match="num_keys"):
        ksort.ksort_rows([x[:, :512]], 2)


def test_ksort_wrapper_refuses_other_devices():
    meta = torch.empty((2, 1024), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ksort.ksort_rows([meta, meta], 1)


def _total_operands(rng, b, n, nops, nk):
    """nk - 1 keys with many ties, the position iota as key nk, payloads over
    the whole int32 range; one operand alone is a permutation per row."""
    if nops == 1:
        return [np.stack([rng.permutation(n) for _ in range(b)]).astype(np.int32)]
    keys = [rng.integers(-5, 5, (b, n)).astype(np.int32) for _ in range(nk - 1)]
    idx = np.broadcast_to(np.arange(n, dtype=np.int32), (b, n)).copy()
    pay = [rng.integers(-(1 << 31), (1 << 31) - 1, (b, n)).astype(np.int32)
           for _ in range(nops - nk)]
    return keys + [idx] + pay


@pytest.mark.parametrize("ls,ls2,m,b,n,nops,nk", [
    (3, 3, 1, 2, 1 << 7, 1, 1), (4, 3, 2, 2, 1 << 8, 2, 1), (5, 5, 3, 1, 1 << 10, 3, 2),
    (2, 1, 5, 2, 1 << 9, 2, 2), (6, 4, 3, 3, 1 << 9, 5, 2), (1, 1, 4, 2, 1 << 4, 4, 2),
    (7, 7, 6, 1, 1 << 8, 1, 1), (3, 2, 3, 2, 1 << 11, 8, 3)])
def test_ksort_network_ref_runs_the_schedule(monkeypatch, ls, ls2, m, b, n, nops, nk):
    """The schedule's passes, run stage by stage as the kernel groups them,
    sort like the stable sorts and like kanzi_tpu's network in interpret
    mode (at its own span), over small spans and cross-pass widths."""
    arrs = _total_operands(np.random.default_rng(ls * 100 + m), b, n, nops, nk)
    sched = ksort.ksort_schedule(n, nops, ls=ls, m=m, ls2=ls2)
    assert sum(r[0] == ksort.CROSS for r in sched) == sum(
        -(-(k - ls2) // m) for k in range(ls + 1, n.bit_length()))
    got = ksort.ksort_network_ref([torch.from_numpy(a) for a in arrs], nk, sched)
    want = ksort.ksort_rows_ref([torch.from_numpy(a) for a in arrs], nk)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    if n >= 1 << 9:
        monkeypatch.setattr(K, "LS", 8)
        K._span_call.cache_clear()
        K._cross_call.cache_clear()
        try:
            ref = K.ksort_rows([jnp.asarray(a) for a in arrs], nk)
        finally:
            K._span_call.cache_clear()
            K._cross_call.cache_clear()
        for g, r in zip(got, ref):
            assert np.array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("n,nops,nk,passes", [(1 << 22, 2, 2, (11, 9)), (1 << 16, 5, 5, (3, 4)),
                                             (1 << 16, 5, 2, (2, 3))])
def test_ksort_schedule_pass_counts(n, nops, nk, passes):
    """The two shapes the chip check times: (8, 2^22) x 2 operands runs 11
    cross and 9 span passes (20; one cross pass a stride made 45), and
    (512, 2^16) x 5 runs 3 and 4 (7; 10 before) with every operand in its
    spans, 2 and 3 (5) with its 2 keys and their positions, as ksort_rows
    runs it.  The first span fills the 200 KiB budget, the later ones half
    of it (two CTAs to an SM), and the cross passes cover the strides
    between, at most m a pass."""
    sched = ksort.ksort_schedule(n, nops, nk=nk)
    cross = [r for r in sched if r[0] == ksort.CROSS]
    span = [r for r in sched if r[0] == ksort.SPAN]
    assert (len(cross), len(span)) == passes
    planes = ksort.span_planes(nops, nk)
    assert planes == (3 if nops - nk >= 2 else nops)
    ls = ksort.span_log(n, planes)
    ls2 = ksort.span_log(n, planes, ksort.PAIRED_BUDGET)
    assert planes * 4 << ls <= ksort.SMEM_BUDGET < planes * 4 << (ls + 1)
    assert planes * 4 << ls2 <= ksort.PAIRED_BUDGET < planes * 4 << (ls2 + 1)
    assert (ls, ls2) == {2: (14, 13), 5: (13, 12), 3: (14, 13)}[planes]
    assert span[0] == (ksort.SPAN, ls, ls - 1, 0)
    assert all(r[1:] == (k, ls2 - 1, 0) for r, k in zip(span[1:], range(ls + 1, 99)))
    m = ksort.cross_strides(nops)
    assert m == (6 if nops == 2 else 4) and (1 << m) * nops <= 128 < (2 << m) * nops
    # every stride from ls2 up of every later level runs once, largest first
    for k in range(ls + 1, n.bit_length()):
        rows = [r for r in cross if r[1] == k]
        assert [j for r in rows for j in range(r[2], r[3] - 1, -1)] == list(range(k - 1, ls2 - 1, -1))
        assert all(r[2] - r[3] + 1 <= m for r in rows)


def test_ksort_schedule_rejects_what_the_kernel_cannot_run():
    with pytest.raises(ValueError, match="operands"):
        ksort.ksort_schedule(1 << 10, 9)
    with pytest.raises(ValueError, match="power of two"):
        ksort.ksort_schedule(768, 2)
    with pytest.raises(ValueError, match="out of range"):
        ksort.ksort_schedule(1 << 10, 5, m=5)
    with pytest.raises(ValueError, match="out of range"):
        ksort.ksort_schedule(1 << 10, 2, ls=5, ls2=6)
    with pytest.raises(ValueError, match="out of range"):
        ksort.ksort_schedule(1 << 10, 2, ls=11)
