"""The entropy stage's time in the compress calls (the host glue, lock
waits, copies and kernel waits included): the sum over blocks of
AFTER_ENTROPY - BEFORE_ENTROPY (the program's listener events), in ms per
10^6 bytes of the requests' data."""

from portbench.lib.layers import layer_ms_per_MB


def read(run):
    return layer_ms_per_MB(run, "compress", "entropy")
