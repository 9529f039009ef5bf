"""Multi-operand row sort (K12) on the H100, beside its plain PyTorch version.

Counterpart of kanzi_tpu/ops/ksort_pallas.py ``ksort_rows``: a bitonic
network of span passes (every stride below the span, in fast memory) and
cross passes (the larger strides).  One hand-written CUDA source,
kanzi_tpu_torch/csrc/ksort.cu, holds both kernels; one call of its launcher
runs the whole network and counts as one launch of ``ksort``.

No production path calls it: kanzi_tpu's LZ engine keeps ``jax.lax.sort``
(the fused sort was measured and rejected on the TPU), and the port's
engine keeps ``torch.sort``.  ``ksort_rows`` is its own entry point.

The wrapper runs the plain version when the operands lie on the CPU, and
launches the kernel when they lie on a CUDA device, or raises.
"""

from __future__ import annotations

import torch

from .launch import launch, register, require, stream

KERNELS = ("ksort",)
register(KERNELS)


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
    e.g. a position iota as the last key), so the output is unique."""
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
        with torch.cuda.device(buf.device):
            launch("ksort", buf.data_ptr(), len(arrays), num_keys, b, n, stream(buf))
    return tuple(buf.unbind(0))
