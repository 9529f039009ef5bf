"""kanzi_tpu_torch: the kanzi_tpu block compressor with its device stages in
PyTorch and hand-written CUDA kernels for the NVIDIA H100.

A package of its own: it imports torch and numpy, builds the repository's
native C++ (``native/``) into its own ``_build/``, and keeps its own copy of
the host layers (core, entropy, models, transforms, io).  It imports nothing
of kanzi_tpu and never jax.  The stream classes are in
``kanzi_tpu_torch.io.stream`` and take an explicit ``device``: ``cuda`` (the
CUDA kernels), ``cpu`` (their plain PyTorch versions) or None (the host
coders, no device stage).
"""
