"""Exponential moving average of parameters
(port of ``octfusion_tpu/diffusion/ema.py``)."""

from __future__ import annotations

from typing import Dict

import torch


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor], beta: float = 0.999) -> None:
    """``e <- e * beta + (1 - beta) * p`` for every entry of ``ema_params``.
    Unlike the JAX function, which returns a new tree, this updates the
    EMA tensors in place, so a step allocates no second copy of them."""
    names = list(ema_params)
    ema = [ema_params[n] for n in names]
    torch._foreach_mul_(ema, beta)
    torch._foreach_add_(ema, [params[n].detach() for n in names],
                        alpha=1.0 - beta)
