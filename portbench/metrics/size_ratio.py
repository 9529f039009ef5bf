"""Compressed bytes / request bytes, summed over every request of the
window."""

from portbench.lib.layers import calls


def read(run):
    cs = calls(run, "compress")
    total = sum(c.size for c in cs)
    return sum(c.stream for c in cs) / total if total else None
