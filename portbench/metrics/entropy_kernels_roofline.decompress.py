"""The entropy stage's kernels against the card's bandwidth in the decompress
calls, in %: the stage's input and output bytes of every block (listener
event sizes) once at the HBM peak (lib/peaks.py), over the summed time of
the CUDA kernels (torch.profiler; copies and sets left out) inside the
calls.  Nothing when the trace shows no kernel."""

from portbench.lib.layers import entropy_roofline_percent


def read(run):
    return entropy_roofline_percent(run, "decompress")
