"""The host transforms' time in the decompress calls: the sum over blocks of
AFTER_TRANSFORM - BEFORE_TRANSFORM (the program's listener events), in ms
per 10^6 bytes of the requests' data."""

from portbench.lib.layers import layer_ms_per_MB


def read(run):
    return layer_ms_per_MB(run, "decompress", "transform")
