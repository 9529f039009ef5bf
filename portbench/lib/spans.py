"""Per-block spans from the program's listener events, and interval
arithmetic on the host's monotonic clock (nanoseconds).

The program's streams notify listeners (``BlockCompressor.listeners``,
``BlockDecompressor.listeners``; kanzi's Listener API) at
BEFORE/AFTER_TRANSFORM and BEFORE/AFTER_ENTROPY of every block, with the
block's id, a size and ``time.monotonic_ns``.  ``Recorder`` keeps them;
``spans`` pairs them."""

from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass
class Span:
    direction: str      # "compress" / "decompress"
    call: int           # index of the call in the window
    block: int          # the stream's block id (1-based)
    kind: str           # "transform" / "entropy"
    t0: int
    t1: int
    size_in: int        # bytes into the stage (its BEFORE event's size)
    size_out: int       # bytes out (its AFTER event's size)


class Recorder:
    """A listener: keeps (type name, block id, size, time) of every event."""

    def __init__(self) -> None:
        self.events: list[tuple[str, int, int, int]] = []
        self._lock = threading.Lock()

    def process_event(self, evt) -> None:
        with self._lock:
            self.events.append((evt.type.name, evt.block_id, evt.size, evt.time_ns))

    def take(self) -> list[tuple[str, int, int, int]]:
        with self._lock:
            ev, self.events = self.events, []
        return ev


def spans(direction: str, call: int, events) -> list[Span]:
    open_: dict[tuple[int, str], tuple[int, int]] = {}
    out = []
    for name, block, size, t in events:
        when, _, kind = name.partition("_")
        if kind not in ("TRANSFORM", "ENTROPY"):
            continue
        key = (block, kind.lower())
        if when == "BEFORE":
            open_[key] = (t, size)
        elif key in open_:
            t0, s0 = open_.pop(key)
            out.append(Span(direction, call, block, kind.lower(), t0, t, s0, size))
    return out


def union(intervals) -> list[tuple[int, int]]:
    """Merged, sorted, disjoint intervals."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals, lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` inside [lo, hi)."""
    return sum(max(0, min(b, hi) - max(a, lo)) for a, b in union(intervals))


def gaps(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The parts of [lo, hi) that ``intervals`` leave uncovered."""
    out, at = [], lo
    for a, b in union(intervals):
        if b <= lo or a >= hi:
            continue
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out
