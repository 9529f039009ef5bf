"""The port's explicit device rule: the caller names the device, always."""

from __future__ import annotations

import torch


def check_device(device) -> torch.device:
    """Return ``device`` as a ``torch.device``; ``cuda`` without a usable
    card raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested, but "
                               "torch.cuda.is_available() is False")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
