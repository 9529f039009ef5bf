"""kanzi_tpu_torch: the kanzi_tpu block compressor with its device stages in
PyTorch and hand-written CUDA kernels for the NVIDIA H100.

Imports torch, numpy and the host layers of kanzi_tpu (core, entropy wire
code, transforms, io framing, native C++); never jax.  The stream classes
are in ``kanzi_tpu_torch.io.stream`` and take an explicit ``device``.
"""
