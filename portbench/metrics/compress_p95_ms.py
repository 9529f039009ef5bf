"""95th percentile of the compress_stream latency of every request of the
window, in ms (host clock; statistics.quantiles, inclusive).  Prints the
median and the count to standard error beside it."""

import statistics
import sys

from portbench.lib.layers import calls


def read(run):
    ms = [(c.t1 - c.t0) / 1e6 for c in calls(run, "compress")]
    if len(ms) < 2:
        return None
    p95 = statistics.quantiles(ms, n=100, method="inclusive")[94]
    print(f"compress latency: median {statistics.median(ms)} ms, p95 {p95} ms, "
          f"{len(ms)} requests", file=sys.stderr)
    return p95
