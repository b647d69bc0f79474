"""Diagonal Gaussian posterior helpers
(port of ``octfusion_tpu/nn/distributions.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def split_params(params: torch.Tensor):
    """params [N, 2C] -> (mean, logvar) with logvar clamped to [-30, 20]."""
    mean, logvar = torch.chunk(params, 2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


def sample(mean: torch.Tensor, logvar: torch.Tensor,
           eps: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``mean + exp(logvar / 2) * eps``; ``eps`` is drawn from ``generator``
    unless given (a test injects the JAX package's draw)."""
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                          device=mean.device)
    return mean + torch.exp(0.5 * logvar) * eps.to(mean)


def kl(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Elementwise KL to N(0, I)."""
    return 0.5 * (mean**2 + torch.exp(logvar) - 1.0 - logvar)
