"""The entropy stage split from inside the program: the device glue's
listener spans (kanzi_tpu_torch ``core/events.py``), a block's

    GLUE_WAIT   asking for ops/glue.py's GLUE_LOCK, until it holds it
    GLUE_HOLD   holding it
    COPY_IN     one copy to the card (size: its bytes)
    CARD_WAIT   the host waiting on the card's stream before a fetch
    COPY_OUT    one fetch from the card (size: its bytes)

each a BEFORE_<KIND>/AFTER_<KIND> pair with the block's id and
``time.monotonic_ns``, the clock of the stage spans and of the device
trace.  ``spans.spans`` ignores them; ``glue_spans`` pairs them into
``spans.Span``s (kind in lower case, size_in = size_out = the size).

The readers take ``run`` and its glue spans, and return None where the
program reports none (a program without these events).  Per MB as in
``layers``: 10^6 bytes of the requests' own data."""

from __future__ import annotations

import bisect

from .layers import calls, device_in_calls, megabytes, wall_ns
from .spans import Span, covered, gaps, union

KINDS = ("GLUE_WAIT", "GLUE_HOLD", "COPY_IN", "CARD_WAIT", "COPY_OUT")
CARD = ("copy_in", "card_wait", "copy_out")
STATES = ("glue",) + CARD + ("none",)
DEVICE_KINDS = ("kernel", "memcpy", "memset")


def glue_spans(direction: str, call: int, events) -> list[Span]:
    """The glue spans among one call's listener events, (type name, block
    id, size, time) in the order the listener got them: a block's spans of
    one kind follow one another on its thread."""
    open_: dict[tuple[int, str], tuple[int, int]] = {}
    out = []
    for name, block, size, t in events:
        when, _, kind = name.partition("_")
        if kind not in KINDS:
            continue
        key = (block, kind.lower())
        if when == "BEFORE":
            open_[key] = (t, size)
        elif key in open_:
            t0, s0 = open_.pop(key)
            out.append(Span(direction, call, block, kind.lower(), t0, t, s0, size))
    return out


def split(run_calls, events) -> list[Span]:
    """The glue spans of every call, from a whole window's events: each
    event belongs to the call whose [t0, t1] holds its time (events outside
    every call, of a request that raised, are dropped)."""
    cs = sorted(run_calls, key=lambda c: c.t0)
    starts = [c.t0 for c in cs]
    per: dict[int, list] = {}
    for e in events:
        i = bisect.bisect_right(starts, e[3]) - 1
        if i >= 0 and e[3] <= cs[i].t1:
            per.setdefault(i, []).append(e)
    out = []
    for i, evs in sorted(per.items()):
        out += glue_spans(cs[i].direction, cs[i].request, evs)
    return out


def _of(glue, direction: str, kinds) -> list[Span]:
    return [s for s in glue if s.direction == direction and s.kind in kinds]


def _ms_per_MB(run, glue, direction: str, kinds) -> float | None:
    mb = megabytes(run, direction)
    sp = _of(glue, direction, kinds)
    if not mb or not sp:
        return None
    return sum(s.t1 - s.t0 for s in sp) / 1e6 / mb


def lock_wait_ms_per_MB(run, glue, direction: str) -> float | None:
    """Summed GLUE_WAIT spans, ms per MB."""
    return _ms_per_MB(run, glue, direction, ("glue_wait",))


def card_ms_per_MB(run, glue, direction: str) -> float | None:
    """Summed COPY_IN, CARD_WAIT and COPY_OUT spans, ms per MB."""
    return _ms_per_MB(run, glue, direction, CARD)


def host_glue_ms_per_MB(run, glue, direction: str) -> float | None:
    """The entropy spans' self time: each block's entropy span less the
    part its GLUE_WAIT and card spans cover, ms per MB.  With those two,
    it adds up to ``layers.layer_ms_per_MB(run, direction, "entropy")``."""
    mb = megabytes(run, direction)
    children: dict[tuple[int, int], list] = {}
    for s in _of(glue, direction, ("glue_wait",) + CARD):
        children.setdefault((s.call, s.block), []).append((s.t0, s.t1))
    if not mb or not children:
        return None
    own = 0
    for s in run.spans:
        if s.direction == direction and s.kind == "entropy":
            own += (s.t1 - s.t0) - covered(children.get((s.call, s.block), []), s.t0, s.t1)
    return own / 1e6 / mb


def copy_bytes_per_byte(run, glue, direction: str) -> float | None:
    """Bytes of the COPY_IN and COPY_OUT spans / the requests' bytes."""
    total = sum(c.size for c in calls(run, direction))
    sp = _of(glue, direction, ("copy_in", "copy_out"))
    if not total or not sp:
        return None
    return sum(s.size_in for s in sp) / total


def hold_over_wall(run, glue, direction: str) -> float | None:
    """Summed GLUE_HOLD time / the calls' wall time: one holder at a time,
    so at most 1."""
    sp = _of(glue, direction, ("glue_hold",))
    wall = wall_ns(run, direction)
    if not sp or not wall:
        return None
    return sum(s.t1 - s.t0 for s in sp) / wall


def idle_by_glue_state(run, glue) -> dict | None:
    """The card's idle seconds inside the calls, keyed
    ``<direction>:<state>``: what GLUE_LOCK's holder was in (``copy_in``,
    ``card_wait``, ``copy_out``, else ``glue``), or ``none`` where no
    thread held it."""
    if not run.device_ops or not glue:
        return None
    out = {}
    for direction in ("compress", "decompress"):
        busy = union(device_in_calls(run, direction, DEVICE_KINDS))
        ns = dict.fromkeys(STATES, 0)
        for c in calls(run, direction):
            mine = [s for s in glue if s.direction == direction and s.call == c.request]
            holds = [(s.t0, s.t1) for s in mine if s.kind == "glue_hold"]
            parts = {k: [(s.t0, s.t1) for s in mine if s.kind == k] for k in CARD}
            for a, b in gaps(busy, c.t0, c.t1):
                held = covered(holds, a, b)
                inside = {k: covered(iv, a, b) for k, iv in parts.items()}
                for k, v in inside.items():
                    ns[k] += v
                ns["glue"] += held - sum(inside.values())
                ns["none"] += (b - a) - held
        out.update({f"{direction}:{k}": v / 1e9 for k, v in ns.items()})
    return out


def nesting_faults(run, glue) -> list[str]:
    """Each GLUE_WAIT and GLUE_HOLD inside its block's entropy span, each
    copy and CARD_WAIT inside its block's GLUE_HOLD, no two holds
    overlapping: what breaks that, one line a fault."""
    entropy = {(s.direction, s.call, s.block): (s.t0, s.t1)
               for s in run.spans if s.kind == "entropy"}
    holds: dict[tuple, list] = {}
    for s in glue:
        if s.kind == "glue_hold":
            holds.setdefault((s.direction, s.call, s.block), []).append((s.t0, s.t1))
    out = []
    for s in glue:
        key = (s.direction, s.call, s.block)
        if s.kind.startswith("glue"):
            where, outer = "entropy span", [entropy[key]] if key in entropy else []
        else:
            where, outer = "hold", holds.get(key, [])
        if not any(a <= s.t0 <= s.t1 <= b for a, b in outer):
            out.append(f"{s.kind} of {s.direction} call {s.call} block {s.block} "
                       f"at [{s.t0}, {s.t1}] outside its {where}")
    every = sorted(iv for ivs in holds.values() for iv in ivs)
    out += [f"holds overlap: {a} and {b}" for a, b in zip(every, every[1:]) if b[0] < a[1]]
    return out


def busy_in_holds(run, glue, widen_ns: int = 200_000) -> float | None:
    """The share of the card's busy time inside the calls that lies inside
    some GLUE_HOLD widened by ``widen_ns`` at each end: near 1 where every
    launch is made under the lock and both clocks agree."""
    busy = union(device_in_calls(run, "compress", DEVICE_KINDS)
                 + device_in_calls(run, "decompress", DEVICE_KINDS))
    holds = union((s.t0 - widen_ns, s.t1 + widen_ns) for s in glue if s.kind == "glue_hold")
    total = sum(b - a for a, b in busy)
    if not total or not holds:
        return None
    inside, j = 0, 0
    for a, b in busy:
        while j < len(holds) and holds[j][1] <= a:
            j += 1
        k = j
        while k < len(holds) and holds[k][0] < b:
            inside += min(b, holds[k][1]) - max(a, holds[k][0])
            k += 1
    return inside / total


def outside_holds(run, glue, widen_ns: int = 200_000, top: int = 10) -> list:
    """The device operations inside the calls that stick out of every
    GLUE_HOLD widened by ``widen_ns``, the longest ``top``: [name, start
    (s from the window's start), ns outside, ns to the nearest hold (0
    where it overlaps one), that hold's direction and block]."""
    holds = sorted((s.t0, s.t1, s.direction, s.block) for s in glue if s.kind == "glue_hold")
    if not run.device_ops or not holds:
        return []
    starts = [h[0] for h in holds]
    wide = union((a - widen_ns, b + widen_ns) for a, b, _, _ in holds)
    in_calls = {(a, b) for d in ("compress", "decompress")
                for a, b in device_in_calls(run, d, DEVICE_KINDS)}
    out = []
    for o in run.device_ops:
        if (o.t0, o.t1) not in in_calls:
            continue
        stick = (o.t1 - o.t0) - covered(wide, o.t0, o.t1)
        if stick <= 0:
            continue
        i = bisect.bisect_right(starts, o.t0)
        near = min(holds[max(i - 1, 0):i + 1],
                   key=lambda h: max(0, h[0] - o.t1, o.t0 - h[1]))
        out.append([o.name[:60], (o.t0 - run.window[0]) / 1e9, stick,
                    max(0, near[0] - o.t1, o.t0 - near[1]), near[2], near[3]])
    return sorted(out, key=lambda r: -r[2])[:top]


def copy_skew(run, glue, slice_s: float = 5.0) -> list:
    """The device trace's copies against the spans that made them: each
    HtoD copy inside the calls against the nearest COPY_IN span, each DtoH
    against the nearest COPY_OUT, read as ns before the span's start
    (negative), after its end (positive) or 0 inside.  One row a slice of
    ``slice_s`` seconds of the window: [slice start (s), copies, least,
    most].  All zero where both clocks agree to the copy."""
    lo = run.window[0]
    rows: dict[int, list] = {}
    for kind, span_kind in (("htod", "copy_in"), ("dtoh", "copy_out")):
        sp = sorted((s.t0, s.t1) for s in glue if s.kind == span_kind)
        if not sp:
            continue
        starts = [a for a, _ in sp]
        for o in run.device_ops or ():
            if o.kind != "memcpy" or kind not in o.name.lower().replace("_", ""):
                continue
            i = bisect.bisect_right(starts, o.t0)
            a, b = min(sp[max(i - 1, 0):i + 1],
                       key=lambda s: max(0, s[0] - o.t1, o.t0 - s[1]))
            off = o.t0 - a if o.t0 < a else max(0, o.t1 - b)
            r = rows.setdefault(int((o.t0 - lo) / 1e9 // slice_s), [0, off, off])
            r[0] += 1
            r[1], r[2] = min(r[1], off), max(r[2], off)
    return [[k * slice_s] + v for k, v in sorted(rows.items())]
