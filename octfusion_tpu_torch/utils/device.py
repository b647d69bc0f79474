"""The device an entry point runs on: the card unless the caller asks for
the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """-> ``torch.device(device)``.  A CUDA device on a machine without a
    usable card raises: an entry point never carries on on the CPU
    unless the caller asked for it with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs an NVIDIA GPU and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
