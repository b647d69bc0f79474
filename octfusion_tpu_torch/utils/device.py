"""The device an entry point runs on (the card unless the caller asks for
the CPU) and the precision it computes in (fp32, as the reference)."""

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


def use_fp32_math() -> None:
    """Float32 matmuls and convolutions in full fp32 on the card, as the
    reference computes (``compute_dtype: float32``): PyTorch lets cuDNN
    run a float32 convolution in TF32 unless told otherwise."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
