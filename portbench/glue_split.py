"""Runs a cell as ``run.py`` does and splits its entropy stage by the
device glue's spans (``lib/glue.py``); several seeds and trace settings
in one process, one JSON line a run.  Not part of a benchmark run.

    python3 portbench/glue_split.py --workload l5_archive --seconds 51 \\
        --seeds 11,12 --trace 1,0

The harness keeps only the stage spans it pairs from the listener's
events; this keeps every event of the window as well (a Recorder whose
``take`` remembers what it hands out) and the run that the readers read,
then pairs the glue spans of each call.  Each line has the run's result
metrics, both rates and the p95 (host clock, traced or not), and, where
the program reports glue spans and the run is traced, the split: lock
wait, card and host glue ms per MB, copied bytes a byte, the card's idle
seconds by what the lock's holder was in, the holds' share of the wall,
the nesting faults, the share of the card's busy time inside a hold, the
operations outside every hold and how far the trace's copies sit from
their spans."""

from __future__ import annotations

import argparse
import json
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.lib import glue, harness, layers, spans  # noqa: E402


def run_with_events(workload: str, seed: int, seconds: float, trace: bool, **kw):
    """harness.run_cell, returning (result line, the run, its glue spans)."""
    runs, kept = [], []

    class Keeping(spans.Recorder):
        def take(self):
            ev = super().take()
            kept.extend(ev)
            return ev

    class Kept(harness.Run):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    saved = harness.Run, spans.Recorder
    harness.Run, spans.Recorder = Kept, Keeping
    try:
        result, _ = harness.run_cell(workload, seed, seconds, trace, **kw)
    finally:
        harness.Run, spans.Recorder = saved
    run = runs[-1]
    return result, run, glue.split(run.calls, kept)


def split_line(run, gl) -> dict:
    """The split of a traced run, as one JSON-able dict."""
    out = {}
    for name, fn in (("entropy_lock_wait_ms_per_MB", glue.lock_wait_ms_per_MB),
                     ("entropy_card_ms_per_MB", glue.card_ms_per_MB),
                     ("entropy_host_glue_ms_per_MB", glue.host_glue_ms_per_MB),
                     ("card_copy_bytes_per_byte", glue.copy_bytes_per_byte),
                     ("glue_hold_over_wall", glue.hold_over_wall)):
        for d in ("compress", "decompress"):
            out[f"{name}.{d}"] = fn(run, gl, d)
    faults = glue.nesting_faults(run, gl)
    out.update({"idle_by_glue_state": glue.idle_by_glue_state(run, gl),
                "busy_in_holds": glue.busy_in_holds(run, gl),
                "outside_holds": glue.outside_holds(run, gl),
                "copy_skew": glue.copy_skew(run, gl),
                "glue_spans": len(gl), "nesting_faults": len(faults),
                "nesting_fault_lines": faults[:5]})
    return out


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--trace", default="1", help="comma-separated 0/1, run in that order")
    a = p.parse_args(argv)
    for seed in [int(s) for s in a.seeds.split(",")]:
        for trace in [bool(int(t)) for t in a.trace.split(",")]:
            result, run, gl = run_with_events(a.workload, seed, a.seconds, trace)
            line = {"workload": a.workload, "seed": seed, "trace": int(trace),
                    "correct": result["correct"], "attempted": result["attempted"],
                    "compress_MBps": layers.rate_MBps(run, "compress"),
                    "decompress_MBps": layers.rate_MBps(run, "decompress"),
                    "compress_p95_ms": harness.load_reader("compress_p95_ms")(run),
                    "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                    "device": result["device"], "breakdown": result.get("breakdown")}
            if trace:
                line.update(split_line(run, gl))
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
