"""Multi-operand row sort (K12) on the H100, beside its plain PyTorch version.

Counterpart of kanzi_tpu/ops/ksort_pallas.py ``ksort_rows``: a bitonic
network of span passes (every stride below the span, in fast memory) and
cross passes (the larger strides).  ``ksort_schedule`` lists the passes;
one hand-written CUDA source, kanzi_tpu_torch/csrc/ksort.cu, holds both
kernels, and one call of its launcher runs the whole schedule and counts as
one launch of ``ksort``.

No production path calls it: kanzi_tpu's LZ engine keeps ``jax.lax.sort``
(the fused sort was measured and rejected on the TPU), and the port's
engine keeps ``torch.sort``.  ``ksort_rows`` is its own entry point.

The wrapper runs the plain version when the operands lie on the CPU, and
launches the kernel when they lie on a CUDA device, or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .launch import launch, register, require, stream

KERNELS = ("ksort",)
register(KERNELS)

SPAN, CROSS = 0, 1        # the kinds of a schedule row (csrc/ksort.cu)
SMEM_BUDGET = 200 * 1024  # the first span pass's shared memory, bytes
PAIRED_BUDGET = 100 * 1024  # a later span pass's: two CTAs to an SM
MAX_OPERANDS = 8          # the kernel's register-blocked passes take 1..8


def span_log(n: int, nops: int, budget: int = SMEM_BUDGET) -> int:
    """log2 of the largest span whose ``nops`` int32 planes fit ``budget``
    bytes of shared memory, at most log2 ``n``."""
    ln = n.bit_length() - 1
    ls = 0
    while ls < ln and nops * 4 << (ls + 1) <= budget:
        ls += 1
    return ls


def cross_strides(nops: int) -> int:
    """M, the most strides one cross pass runs in registers: 2^M nops <= 128,
    and at most 6."""
    return min(6, (128 // nops).bit_length() - 1)


def span_planes(nops: int, nk: int) -> int:
    """The planes a span pass holds in shared memory: every operand, or for
    two or more payload operands the nk keys and each element's position,
    by which the payload is permuted once at the pass's end."""
    return nk + 1 if nops - nk >= 2 else nops


def ksort_schedule(n: int, nops: int, ls: int | None = None, m: int | None = None,
                   ls2: int | None = None, nk: int | None = None):
    """The passes of the bitonic network over rows of ``n`` (a power of two)
    elements of ``nops`` operands: a list of rows (kind, k, j_hi, j_lo).

    A SPAN row runs in a span of 2^(j_hi+1) elements (j_lo is 0): merge
    levels 1..k when k <= j_hi + 1 (the first row, the full sort of each
    span), else level k's strides j_hi..0.  A CROSS row runs level k's
    strides j_hi..j_lo over the whole row.  The network is the reference's
    (kanzi_tpu/ops/ksort_pallas.py:220-267): the first span pass over spans
    of 2^ls, then for each level k above it its strides k-1..ls2 in cross
    passes of at most ``m`` strides each, largest first, and one span pass
    over spans of 2^ls2 for strides ls2-1..0.  ``ls`` defaults to the
    largest span in SMEM_BUDGET, ``ls2`` to the largest in PAIRED_BUDGET
    (two CTAs to an SM; at most ls), both of ``span_planes`` planes for
    ``nk`` keys (all ``nops`` by default), and ``m`` to ``cross_strides``:
    a cross pass moves every operand."""
    if not 1 <= nops <= MAX_OPERANDS:
        raise ValueError(f"ksort_schedule: 1..{MAX_OPERANDS} operands, not {nops}")
    ln = n.bit_length() - 1
    if n < 2 or 1 << ln != n:
        raise ValueError("ksort_schedule: n must be a power of two >= 2")
    planes = span_planes(nops, nops if nk is None else nk)
    ls = span_log(n, planes) if ls is None else ls
    ls2 = min(ls, span_log(n, planes, PAIRED_BUDGET)) if ls2 is None else ls2
    m = cross_strides(nops) if m is None else m
    if not (1 <= ls2 <= ls <= ln and 1 <= m <= cross_strides(nops)
            and planes * 4 << ls <= SMEM_BUDGET):
        raise ValueError(f"ksort_schedule: spans 2^{ls}, 2^{ls2} or strides {m} out of range")
    rows = [(SPAN, ls, ls - 1, 0)]
    for k in range(ls + 1, ln + 1):
        hi = k - 1
        while hi >= ls2:
            lo = max(hi - m + 1, ls2)
            rows.append((CROSS, k, hi, lo))
            hi = lo - 1
        rows.append((SPAN, k, ls2 - 1, 0))
    return rows


def _stage(ops, nk: int, j: int, k: int):
    """One compare-exchange stage of stride 2^j at merge level k on (B, N)
    operands: the pair (i, i + 2^j) swaps when the second is lexicographically
    smaller over the first nk operands, unless bit k of i is set (descending)."""
    b, n = ops[0].shape
    h = 1 << j
    lo = [a.view(b, n // (2 * h), 2, h)[:, :, 0] for a in ops]
    hi = [a.view(b, n // (2 * h), 2, h)[:, :, 1] for a in ops]
    less = torch.zeros_like(lo[0], dtype=torch.bool)
    eq = torch.ones_like(less)
    for x, y in zip(lo[:nk], hi[:nk]):
        less = less | (eq & (y < x))
        eq = eq & (y == x)
    idx = torch.arange(n, device=ops[0].device).view(n // (2 * h), 2, h)[:, 0]
    swap = less ^ (((idx >> k) & 1) == 1)
    return [torch.stack([torch.where(swap, y, x), torch.where(swap, x, y)], 2).view(b, n)
            for x, y in zip(lo, hi)]


def ksort_network_ref(arrays, num_keys: int, schedule):
    """The schedule's passes run stage by stage in PyTorch, each row as the
    kernel runs it (span rows by the k <= j_hi + 1 rule): a plain model of
    the network, for the tests."""
    ops = [a.to(torch.int32).contiguous() for a in arrays]
    for kind, k, hi, lo in schedule:
        if kind == SPAN:
            levels = range(1, k + 1) if k <= hi + 1 else (k,)
            stages = [(kk, j) for kk in levels for j in range(min(kk, hi + 1) - 1, -1, -1)]
        else:
            stages = [(k, j) for j in range(hi, lo - 1, -1)]
        for kk, j in stages:
            ops = _stage(ops, num_keys, j, kk)
    return tuple(ops)


def ksort_rows_ref(arrays, num_keys: int):
    """Stable sorts from the last key operand to the first, then a gather of
    every operand: for a total order, the unique sorted rows."""
    b, n = arrays[0].shape
    perm = torch.arange(n, device=arrays[0].device).expand(b, n)
    for key in reversed(arrays[:num_keys]):
        _, order = torch.sort(key.gather(1, perm), dim=1, stable=True)
        perm = perm.gather(1, order)
    return tuple(a.gather(1, perm) for a in arrays)


def ksort_rows(arrays, num_keys: int):
    """Sort each row of the (B, N) int32 ``arrays`` by the lexicographic
    ascending (signed) order of the first ``num_keys`` operands, on their
    device.  N must be a power of two; the order must be total (unique keys,
    e.g. a position iota as the last key), so the output is unique.  On a
    card, at most MAX_OPERANDS operands."""
    arrays = [a.to(torch.int32) for a in arrays]
    b, n = arrays[0].shape
    if n < 1 or n & (n - 1):
        raise ValueError("ksort_rows: N must be a power of two")
    if not 1 <= num_keys <= len(arrays):
        raise ValueError("ksort_rows: num_keys must lie in [1, number of operands]")
    if any(a.shape != (b, n) or a.device != arrays[0].device for a in arrays):
        raise ValueError("ksort_rows: the operands must share one shape and device")
    if arrays[0].device.type == "cpu":
        return ksort_rows_ref(arrays, num_keys)
    buf = torch.stack(arrays)          # sorted in place; the inputs stay as they are
    require(buf, torch.int32, (len(arrays), b, n))
    if b and n > 1:
        sched = np.ascontiguousarray(ksort_schedule(n, len(arrays), nk=num_keys),
                                     dtype=np.int32)
        with torch.cuda.device(buf.device):
            launch("ksort", buf.data_ptr(), len(arrays), num_keys, b, n,
                   sched.ctypes.data, len(sched), stream(buf))
    return tuple(buf.unbind(0))
