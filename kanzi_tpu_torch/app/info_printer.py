"""Listener that renders per-block stage events (K/app/InfoPrinter.java:35-289).

At verbosity >= 4 prints per-stage timings/sizes; at >= 5 prints per-block
BLOCK_INFO JSON lines.  Type.INFO renders decoded stream header info
(the `-y` CLI mode)."""

from __future__ import annotations

import enum
import sys
import threading

from ..core.events import Event, EventType


class Type(enum.Enum):
    ENCODING = 0
    DECODING = 1
    INFO = 2


class InfoPrinter:
    def __init__(self, info_type: Type = Type.ENCODING, verbosity: int = 4,
                 out=None) -> None:
        self.type = info_type
        self.verbosity = verbosity
        self.out = out or sys.stdout
        self._lock = threading.Lock()
        self._stage_times: dict = {}
        if info_type == Type.DECODING:
            self.thresholds = (EventType.BEFORE_ENTROPY, EventType.AFTER_ENTROPY,
                               EventType.BEFORE_TRANSFORM, EventType.AFTER_TRANSFORM)
        else:
            self.thresholds = (EventType.BEFORE_TRANSFORM, EventType.AFTER_TRANSFORM,
                               EventType.BEFORE_ENTROPY, EventType.AFTER_ENTROPY)

    def process_event(self, evt: Event) -> None:
        with self._lock:
            if evt.type == EventType.AFTER_HEADER_DECODING and evt.header is not None:
                h = evt.header
                print(f"Bitstream version: {h.bs_version}", file=self.out)
                print(f"Block checksum: "
                      f"{'NONE' if h.checksum_size == 0 else f'{h.checksum_size} bits'}",
                      file=self.out)
                print(f"Block size: {h.block_size} bytes", file=self.out)
                print(f"Entropy codec: {h.entropy or 'NONE'}", file=self.out)
                print(f"Transforms: {h.transform or 'NONE'}", file=self.out)
                if h.original_size >= 0:
                    print(f"Original size: {h.original_size} bytes", file=self.out)
                return
            if evt.type == EventType.BLOCK_INFO and self.verbosity >= 5:
                print(str(evt), file=self.out)
                return
            if self.verbosity < 4:
                return
            key = (evt.block_id, evt.type)
            if evt.type in (self.thresholds[0], self.thresholds[2]):
                self._stage_times[key] = evt
            elif evt.type in (self.thresholds[1], self.thresholds[3]):
                before_type = self.thresholds[self.thresholds.index(evt.type) - 1]
                before = self._stage_times.pop((evt.block_id, before_type), None)
                if before is not None:
                    dt = (evt.time_ns - before.time_ns) / 1e6
                    stage = "transform" if "TRANSFORM" in evt.type.name else "entropy"
                    print(f"block {evt.block_id}: {stage} {before.size} -> "
                          f"{evt.size} bytes in {dt:.1f} ms", file=self.out)
