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
