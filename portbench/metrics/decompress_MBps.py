"""Bytes given back by every decompress_stream call of the window (each
request's own size) / the summed wall time of those calls, in 10^6
bytes a second (host clock)."""

from portbench.lib.layers import rate_MBps


def read(run):
    return rate_MBps(run, "decompress")
