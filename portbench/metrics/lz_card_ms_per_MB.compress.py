"""The card's time in the compress calls, in ms per 10^6 bytes of the
requests: the union of its kernel, copy and set intervals (torch.profiler;
the harness's window mark left out, lib/lz.py) inside the calls.  At
level 1 under KANZI_TPU_DEVICE_LZ=1 the LZX parse is all the card does
there, so the compress wall per MB less this is the parse's host side.
Nothing when the trace shows no device time."""

from portbench.lib.lz import card_ms_per_MB


def read(run):
    return card_ms_per_MB(run, "compress")
