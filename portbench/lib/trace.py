"""The card's activity over the window, from ``torch.profiler`` (CUPTI
activity tracing: every kernel, copy and set on the card, whatever
launched it, the port's ctypes launches included).

Times come out on the host's monotonic clock, in nanoseconds: a mark
opened at the window's start ties the profiler's clock to it."""

from __future__ import annotations

import time
from dataclasses import dataclass

MARK = "portbench.window"


@dataclass
class DeviceOp:
    name: str
    kind: str           # "kernel", "memcpy" or "memset"
    t0: int
    t1: int


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


class Profiler:
    def __init__(self) -> None:
        self.prof = None
        self.mark = None
        self.t0 = self.t1 = 0

    def __enter__(self) -> "Profiler":
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.mark = record_function(MARK)
        self.mark.__enter__()
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.monotonic_ns()
        self.mark.__exit__(*exc)
        self.prof.__exit__(*exc)

    def ops(self) -> list[DeviceOp]:
        from torch.autograd import DeviceType
        events = self.prof.events()
        marks = [e for e in events if e.name == MARK]
        if not marks:
            return []
        offset = self.t0 - int(marks[0].time_range.start * 1000)
        out = []
        for e in events:
            if e.device_type != DeviceType.CUDA:
                continue
            out.append(DeviceOp(e.name, _kind(e.name),
                                int(e.time_range.start * 1000) + offset,
                                int(e.time_range.end * 1000) + offset))
        out.sort(key=lambda o: o.t0)
        return out
