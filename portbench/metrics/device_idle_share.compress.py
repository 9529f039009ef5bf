"""The card's idle share of the compress calls, in %: 100 x (1 - the union
of its kernel, copy and set intervals (torch.profiler) inside the calls /
the calls' wall time).  Nothing when the trace shows no device time."""

from portbench.lib.layers import idle_percent


def read(run):
    return idle_percent(run, "compress")
