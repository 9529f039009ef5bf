"""The device LZX parse's share of the compress calls (level 1 under
KANZI_TPU_DEVICE_LZ=1, where the parse is all the card does there).

The parse's work is counted from what it is given and what it gives
back, whatever engine parses the blocks: it reads each request's bytes
and its output becomes the stream, so its bytes are the calls' request
bytes plus their stream bytes, each once."""

from __future__ import annotations

import dataclasses

from . import peaks, trace
from .layers import calls, device_in_calls, megabytes, union


def _card_ops(run):
    """``run`` with its device operations less the harness's own window mark
    (lib/trace.py MARK), which the profiler puts on the card's timeline as a
    user annotation over the whole window once the window runs PyTorch's own
    kernels, as the parse does; lib/trace.py names it a kernel."""
    if not run.device_ops:
        return run
    return dataclasses.replace(run, device_ops=[o for o in run.device_ops
                                                if o.name != trace.MARK])


def parse_bytes(run, direction: str) -> int:
    """Bytes the parse reads and writes, once each: every call's request
    bytes plus its stream's bytes."""
    return sum(c.size + c.stream for c in calls(run, direction))


def card_ms_per_MB(run, direction: str) -> float | None:
    """The union of the card's kernel, copy and set intervals inside the
    direction's calls, in ms per MB of the requests."""
    ops = device_in_calls(_card_ops(run), direction, ("kernel", "memcpy", "memset"))
    mb = megabytes(run, direction)
    if not ops or not mb:
        return None
    return sum(b - a for a, b in union(ops)) / 1e6 / mb


def kernels_roofline_percent(run, direction: str) -> float | None:
    """100 x the least time the card could move the parse's bytes (at the
    HBM peak, lib/peaks.py) over the summed kernel time inside the
    direction's calls; nothing when the trace shows no kernel."""
    kernel_ns = sum(b - a for a, b in device_in_calls(_card_ops(run), direction, ("kernel",)))
    if not kernel_ns:
        return None
    bound_ns = parse_bytes(run, direction) / peaks.HBM_BYTES_PER_S * 1e9
    return 100.0 * bound_ns / kernel_ns
