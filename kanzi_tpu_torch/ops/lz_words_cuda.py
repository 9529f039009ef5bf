"""The LZX content-word kernel on the H100, beside its plain PyTorch version.

Counterpart of kanzi_tpu/ops/lz_sort.py ``_words_kernel`` (:107) with its
``_words_call`` (:135): one hand-written CUDA kernel,
kanzi_tpu_torch/csrc/lz_words.cu.  For rows of n bytes it returns four
(nb, n) int32 arrays, ``w_j[p]`` the big-endian word of bytes
``p+4j .. p+4j+3`` of the same row.  A byte past the row's end is the byte
1,024 before it, ``byte(q) = buf[q] if q < n else buf[q - 1024]``: the TPU
kernel clamps its halo to the row's last 1 KiB, and the sorts of
ops/lz_sort.py see those tail words, so the port computes what the kernel
computes (kanzi_tpu's XLA fallback ``_build_words`` reads zeros there and
orders the tail positions differently).

``lz_words`` runs the plain version when its tensor lies on the CPU and
launches the kernel when it lies on a CUDA device, or raises: there is no
fallback.  Each launch adds one to ``launches["lz_words"]``
(ops/launch.py).  Rows must hold a multiple of 65,536 bytes, as every flat
bucket and every 256 KiB row of the engine does.
"""

from __future__ import annotations

import torch

from .launch import launch, register, require, stream

ROW_ALIGN = 65536
TAIL_BACK = 1024    # byte(q >= n) = buf[q - TAIL_BACK]
NWORDS = 4

KERNELS = ("lz_words",)
register(KERNELS)


def _check(bufs: torch.Tensor) -> None:
    if bufs.dim() != 2 or bufs.shape[1] % ROW_ALIGN or bufs.shape[1] == 0:
        raise ValueError(f"lz_words takes (nb, n) rows with n a positive "
                         f"multiple of {ROW_ALIGN}, got {tuple(bufs.shape)}")


def _to_i32(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) to the int32 of the same bits."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def lz_words_ref(bufs: torch.Tensor) -> list[torch.Tensor]:
    """bufs (nb, n) uint8 -> [w0, w1, w2, w3], each (nb, n) int32."""
    _check(bufs)
    n = bufs.shape[1]
    # bytes n .. n+14, the last any word reaches, follow the tail rule
    ext = torch.cat([bufs, bufs[:, n - TAIL_BACK:n - TAIL_BACK + 15]],
                    dim=1).to(torch.int64)
    w0 = ((ext[:, 0:n + 12] << 24) | (ext[:, 1:n + 13] << 16)
          | (ext[:, 2:n + 14] << 8) | ext[:, 3:n + 15])
    return [_to_i32(w0[:, 4 * j:4 * j + n]) for j in range(NWORDS)]


def lz_words(bufs: torch.Tensor) -> list[torch.Tensor]:
    if bufs.device.type == "cpu":
        return lz_words_ref(bufs)
    _check(bufs)
    require(bufs, torch.uint8, (None, None))
    nb, n = bufs.shape
    ws = [torch.empty((nb, n), dtype=torch.int32, device=bufs.device)
          for _ in range(NWORDS)]
    if nb:
        with torch.cuda.device(bufs.device):
            launch("lz_words", bufs.data_ptr(), *(w.data_ptr() for w in ws),
                   nb, n, stream(bufs))
    return ws
