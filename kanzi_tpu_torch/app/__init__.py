"""The port's command line (``python -m kanzi_tpu_torch.app``), its file
compressor and decompressor, and its benchmark harness
(``python -m kanzi_tpu_torch.app.benchmark``).

A copy of kanzi_tpu/app on the port's own streams, with one addition: the
device.  ``--device cuda`` (the default) runs the device stages on the card,
``cpu`` their plain PyTorch versions, ``none`` the host coders.
"""
