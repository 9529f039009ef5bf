"""Bytes of every request compressed in the window / the summed wall time
of those compress_stream calls, in 10^6 bytes a second (host clock)."""

from portbench.lib.layers import rate_MBps


def read(run):
    return rate_MBps(run, "compress")
