"""The stream layer's own time in the decompress calls (framing, the pool,
the ordered commit, the caller's copies): the calls' wall time that no
block's transform or entropy span covers, in ms per 10^6 bytes of the
requests' data.  Spans: the program's listener events."""

from portbench.lib.layers import self_ms_per_MB


def read(run):
    return self_ms_per_MB(run, "decompress")
