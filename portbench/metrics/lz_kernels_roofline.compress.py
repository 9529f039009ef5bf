"""The device LZX parse's kernels against the card's bandwidth in the
compress calls, in %: the parse's input and output bytes (each call's
request bytes plus its stream bytes, lib/lz.py) once at the HBM peak
(lib/peaks.py), over the summed time of the CUDA kernels (torch.profiler;
copies, sets and the harness's window mark left out) inside the calls.
Nothing when the trace shows no kernel."""

from portbench.lib.lz import kernels_roofline_percent


def read(run):
    return kernels_roofline_percent(run, "compress")
