"""What every kernel wrapper of the port shares: one launch count per
kernel, the launch through the built library, the checks on what a
kernel takes, and the copies to and from the card (``to_device``,
``to_host``), each a span to the block's listeners (core/events.py).

``launches`` maps each kernel's name to the number of times its wrapper
launched it; a wrapper adds one where it launches and nowhere else, so a run
can show which kernels its path went through.  ``suffix_array`` counts the
calls of ops/bwt_device.py's suffix array, which has no kernel of its own.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..core.events import span, traced
from ..utils import cuda_build

launches: dict[str, int] = {}
_COUNT_LOCK = threading.Lock()   # the stream's thread pool launches at once


def register(names) -> None:
    """Give each kernel in ``names`` a launch count (at import of its module)."""
    with _COUNT_LOCK:
        for name in names:
            launches.setdefault(name, 0)


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in launches:
            launches[k] = 0


def count(name: str) -> None:
    with _COUNT_LOCK:
        launches[name] += 1


def launch(name: str, *args) -> None:
    """Call the library's ``kz_<name>`` and count it; raise on a refused
    launch (the C function returns cudaGetLastError())."""
    err = getattr(cuda_build.load(), "kz_" + name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")
    count(name)


def require(t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    """Raise on what a kernel does not take: another device, dtype, shape,
    a non-contiguous or a misaligned tensor."""
    if t.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d
                                    for s, d in zip(shape, t.shape)):
        raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError("expected a contiguous, 16-byte aligned tensor")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def i16(v: torch.Tensor) -> torch.Tensor:
    """Values in [0, 65536) as int16 bit patterns."""
    return torch.where(v >= 32768, v - 65536, v).to(torch.int16)


def to_device(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """``a`` on ``device``; the copy is a COPY_IN span of ``a``'s bytes."""
    a = np.ascontiguousarray(a, dtype=dtype)
    if not a.flags.writeable:
        a = a.copy()
    with span("COPY_IN", a.nbytes):
        return torch.from_numpy(a).to(device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t.cpu().numpy()``.  Traced (core/events.py), the host first waits
    for ``t``'s stream inside a CARD_WAIT span, so that the COPY_OUT span of
    the fetch's bytes holds the copy alone."""
    if traced():
        with span("CARD_WAIT"):
            if t.is_cuda:
                torch.cuda.current_stream(t.device).synchronize()
    with span("COPY_OUT", t.numel() * t.element_size()):
        return t.cpu().numpy()
