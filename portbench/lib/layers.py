"""Arithmetic the metric readers share.  All times are host monotonic
nanoseconds; "per MB" is per 10^6 bytes of the requests' own
(uncompressed) data in the direction's calls, in both directions."""

from __future__ import annotations

from . import peaks
from .spans import covered, gaps, union


def calls(run, direction: str) -> list:
    return [c for c in run.calls if c.direction == direction]


def megabytes(run, direction: str) -> float:
    return sum(c.size for c in calls(run, direction)) / 1e6


def wall_ns(run, direction: str) -> int:
    return sum(c.t1 - c.t0 for c in calls(run, direction))


def rate_MBps(run, direction: str) -> float | None:
    ns = wall_ns(run, direction)
    return megabytes(run, direction) / (ns / 1e9) if ns else None


def layer_ms_per_MB(run, direction: str, kind: str) -> float | None:
    """Summed span time of one stage over every block, per MB."""
    mb = megabytes(run, direction)
    sp = [s for s in run.spans if s.direction == direction and s.kind == kind]
    if not mb or not sp:
        return None
    return sum(s.t1 - s.t0 for s in sp) / 1e6 / mb


def self_ms_per_MB(run, direction: str) -> float | None:
    """Wall time of the calls that no block's transform or entropy span
    covers (the stream layer's own time), per MB."""
    mb = megabytes(run, direction)
    if not mb or not run.spans:
        return None
    own = 0
    for c in calls(run, direction):
        sp = [(s.t0, s.t1) for s in run.spans
              if s.direction == direction and s.call == c.request]
        own += (c.t1 - c.t0) - covered(sp, c.t0, c.t1)
    return own / 1e6 / mb


def device_in_calls(run, direction: str, kinds: tuple) -> list[tuple[int, int]]:
    if not run.device_ops:
        return []
    cs = calls(run, direction)
    out = []
    for o in run.device_ops:
        if o.kind not in kinds:
            continue
        for c in cs:
            if o.t0 < c.t1 and o.t1 > c.t0:
                out.append((max(o.t0, c.t0), min(o.t1, c.t1)))
                break
    return out


def idle_percent(run, direction: str) -> float | None:
    """100 x (1 - the union of the card's kernels, copies and sets / wall)
    over the direction's calls."""
    ops = device_in_calls(run, direction, ("kernel", "memcpy", "memset"))
    wall = wall_ns(run, direction)
    if not ops or not wall:
        return None
    busy = sum(b - a for a, b in union(ops))
    return 100.0 * (1.0 - busy / wall)


def entropy_roofline_percent(run, direction: str) -> float | None:
    """100 x the least time the card could move the entropy stage's bytes
    (its input and output of every block, the listener's sizes, each once
    at the HBM peak) over the summed kernel time in the direction's calls."""
    ops = device_in_calls(run, direction, ("kernel",))
    kernel_ns = sum(b - a for a, b in ops)
    sp = [s for s in run.spans if s.direction == direction and s.kind == "entropy"]
    if not kernel_ns or not sp:
        return None
    nbytes = sum(s.size_in + s.size_out for s in sp)
    bound_ns = nbytes / peaks.HBM_BYTES_PER_S * 1e9
    return 100.0 * bound_ns / kernel_ns


def _host_state(run, t: int) -> str:
    for c in run.calls:
        if c.t0 <= t < c.t1:
            kinds = sorted({s.kind for s in run.spans
                            if s.direction == c.direction and s.call == c.request
                            and s.t0 <= t < s.t1})
            return f"{c.direction}:{'+'.join(kinds) if kinds else 'stream'}"
    return "between_calls"


def device_summary(run) -> tuple[float, float, dict]:
    """busy_s and window_s of the traced window, and the breakdown: the
    ten device operations with the most time, and the ten longest idle
    gaps, each named by what the host was doing at its middle."""
    lo, hi = run.window
    ops = [(max(o.t0, lo), min(o.t1, hi)) for o in run.device_ops if o.t1 > lo and o.t0 < hi]
    busy = sum(b - a for a, b in union(ops)) / 1e9
    by_name: dict[str, int] = {}
    for o in run.device_ops:
        by_name[o.name] = by_name.get(o.name, 0) + (o.t1 - o.t0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps(ops, lo, hi), key=lambda g: g[0] - g[1])[:10]
    return busy, (hi - lo) / 1e9, {
        "device_ops": [[n[:120], ns / 1e9] for n, ns in top],
        "idle_gaps": [[_host_state(run, (a + b) // 2), (b - a) / 1e9] for a, b in idle],
    }
