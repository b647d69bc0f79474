"""Continuous-time samplers and the denoising loss
(port of ``sample_loop``, ``_sample_loop_dpmpp`` and ``diffusion_loss`` in
``octfusion_tpu/diffusion/sampler.py``).

Each JAX ``lax.scan`` becomes a Python loop over one denoise callable; the
per-step schedule scalars are computed in float32 on the host, as the
reference computes them in float32 on the device.  The lr stage snaps
outputs to {-1, +1} once t drops below the truncation time and stops
injecting noise past it.  ``solver="dpmpp"`` runs DPM-Solver++(2M) on the
same time grid: deterministic after its initial state, ~4x fewer denoiser
calls than the 200-step ancestral loop at 25 steps.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .schedule import log_snr_to_alpha_sigma, sampling_time_pairs


def sample_loop(
    denoise_fn: Callable,   # (x, log_snr[B], x_self_cond) -> output
    shape,
    batch_size: int,
    steps: int,
    log_snr_fn,
    df_type: str = "x0",
    truncated_index: float = 0.0,
    snap_sign: bool = False,
    noise_stream=None,
    eta: float = 1.0,
    solver: str = "ancestral",
    generator: Optional[torch.Generator] = None,
    *,
    device,
):
    """Returns the final state after ``steps`` updates, on ``device`` (the
    caller's; there is no default).

    ``noise_stream``: optional external noise replacing ``generator`` —
    entry 0 is the initial state, entries ``1..steps`` the per-step
    ancestral noise (the x0 path draws one per step; the eps and eta=0
    paths and ``solver="dpmpp"`` use entry 0 only)."""
    if solver == "dpmpp":
        return _sample_loop_dpmpp(
            denoise_fn, shape, batch_size, steps, log_snr_fn,
            df_type=df_type, truncated_index=truncated_index,
            snap_sign=snap_sign, noise_stream=noise_stream,
            generator=generator, device=device)
    if solver != "ancestral":
        raise ValueError(f"unknown solver {solver!r}")
    f32 = dict(dtype=torch.float32, device=device)
    t_arr, t_next_arr = sampling_time_pairs(steps)
    step_noise = None
    if noise_stream is not None:
        noise_stream = torch.as_tensor(noise_stream, **f32)
        x = noise_stream[0]
        if noise_stream.shape[0] >= steps + 1:
            step_noise = noise_stream[1:steps + 1]
        elif df_type == "x0" and eta != 0.0:
            raise ValueError(
                f"noise_stream has {noise_stream.shape[0]} entries but the "
                f"x0 ancestral path needs steps+1 = {steps + 1} (initial "
                "state + one per step)"
            )
    else:
        x = torch.randn(shape, generator=generator, **f32)
    x_start = torch.zeros(shape, **f32)

    for i in range(steps):
        t, t_next = t_arr[i], t_next_arr[i]
        snr = log_snr_fn(t)
        snr_next = log_snr_fn(t_next)
        alpha, sigma = log_snr_to_alpha_sigma(snr)
        alpha_next, sigma_next = log_snr_to_alpha_sigma(snr_next)
        tb = torch.full((batch_size,), snr.item(), **f32)
        out = denoise_fn(x, tb, x_start)
        if snap_sign and bool(t < truncated_index):
            out = torch.sign(out)
        if df_type == "x0":
            if eta == 0.0:
                # DDIM (eta=0): eps from the x0 prediction, re-noised
                eps = (x - alpha.item() * out) / max(sigma.item(), 1e-8)
                x = alpha_next.item() * out + sigma_next.item() * eps
            else:
                c = -torch.expm1(snr - snr_next)
                x = alpha_next.item() * (
                    x * (1 - c).item() / alpha.item() + c.item() * out)
                if bool(t_next > truncated_index):
                    std = torch.sqrt(torch.clamp(sigma_next**2 * c, min=0.0))
                    raw = (step_noise[i] if step_noise is not None else
                           torch.randn(shape, generator=generator, **f32))
                    x = x + std.item() * raw
            x_start = out
        elif df_type == "eps":
            x0 = (x - out * sigma.item()) / max(alpha.item(), 1e-8)
            x = x0 * alpha_next.item() + out * sigma_next.item()
            x_start = x0
        else:
            raise ValueError(df_type)
    return x


def _sample_loop_dpmpp(
    denoise_fn: Callable,
    shape,
    batch_size: int,
    steps: int,
    log_snr_fn,
    df_type: str = "x0",
    truncated_index: float = 0.0,
    snap_sign: bool = False,
    noise_stream=None,
    generator: Optional[torch.Generator] = None,
    *,
    device,
):
    """DPM-Solver++(2M), data-prediction form, on the time grid of
    ``sampling_time_pairs``.  With lambda = log_snr/2 and h = lambda_next -
    lambda, each step is

        x <- (sigma_next/sigma) x - alpha_next (e^{-h} - 1) D_hat
        D_hat = (1 + 1/(2r)) D_t - (1/(2r)) D_prev,  r = h_prev / h

    and the first step has no history (r = inf, so D_hat = D_t).  D_t is
    the model's x0 prediction (``df_type="x0"``) or (x - sigma eps)/alpha
    (``"eps"``), after the lr stage's sign snap below ``truncated_index``.
    The initial state is ``noise_stream[0]`` or the generator's first draw,
    as in the ancestral loop; nothing is drawn after it."""
    f32 = dict(dtype=torch.float32, device=device)
    if df_type not in ("x0", "eps"):
        raise ValueError(df_type)
    t_arr, t_next_arr = sampling_time_pairs(steps)
    if noise_stream is not None:
        x = torch.as_tensor(noise_stream[0], **f32)
    else:
        x = torch.randn(shape, generator=generator, **f32)
    d_prev = torch.zeros(shape, **f32)
    h_prev = None
    for i in range(steps):
        t, t_next = t_arr[i], t_next_arr[i]
        snr = log_snr_fn(t)
        snr_next = log_snr_fn(t_next)
        alpha, sigma = log_snr_to_alpha_sigma(snr)
        alpha_next, sigma_next = log_snr_to_alpha_sigma(snr_next)
        tb = torch.full((batch_size,), snr.item(), **f32)
        out = denoise_fn(x, tb, d_prev)
        if snap_sign and bool(t < truncated_index):
            out = torch.sign(out)
        if df_type == "x0":
            d = out
        else:
            d = (x - sigma.item() * out) / max(alpha.item(), 1e-8)
        h = (snr_next - snr) * 0.5
        r = h_prev / h if h_prev is not None else torch.tensor(math.inf)
        w = 1.0 / (2.0 * r)
        d_hat = (1.0 + w).item() * d - w.item() * d_prev
        x = ((sigma_next / torch.clamp(sigma, min=1e-20)).item() * x
             - (alpha_next * torch.expm1(-h)).item() * d_hat)
        d_prev, h_prev = d, h
    return x


def diffusion_loss(
    denoise_fn: Callable,   # (noised, log_snr[B]) -> output
    x0: torch.Tensor,
    batch_id: Optional[torch.Tensor],  # per-element sample index, or None
    batch_size: int,
    log_snr_fn,
    df_type: str = "x0",
    mask: Optional[torch.Tensor] = None,
    times: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    elem_weight=None,
) -> torch.Tensor:
    """Continuous-time denoising MSE.

    Dense states pass ``batch_id=None`` (the leading axis is the batch);
    graph states pass per-vertex batch ids and a validity mask, and the
    mean runs over the valid vertices.  ``times`` [B] and ``noise`` (x0's
    shape) are drawn from ``generator``, in that order, unless given (a
    test injects the JAX package's draws).  ``elem_weight`` (broadcastable
    to x0's shape) makes the loss sum(w * err) / sum(w), the lr stage's
    occupancy weighting; ``None`` keeps the plain mean."""
    f32 = dict(dtype=x0.dtype, device=x0.device)
    if times is None:
        times = torch.rand((batch_size,), generator=generator, **f32)
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, **f32)
    snr = log_snr_fn(times.to(**f32))
    alpha, sigma = log_snr_to_alpha_sigma(snr)
    if batch_id is None:
        bshape = (batch_size,) + (1,) * (x0.dim() - 1)
        a, s = alpha.reshape(bshape), sigma.reshape(bshape)
    else:
        bid = batch_id.clamp(0, batch_size - 1)
        a, s = alpha[bid][:, None], sigma[bid][:, None]
    noised = a * x0 + s * noise.to(**f32)
    if mask is not None:
        noised = torch.where(mask[:, None], noised, torch.zeros_like(noised))
    out = denoise_fn(noised, snr)
    target = x0 if df_type == "x0" else noise.to(**f32)
    err = (out - target) ** 2
    if elem_weight is not None:
        norm = torch.as_tensor(elem_weight, dtype=err.dtype,
                               device=err.device).expand_as(err)
        err = err * norm
    else:
        norm = torch.ones_like(err)
    if mask is not None:
        err = torch.where(mask[:, None], err, torch.zeros_like(err))
        norm = torch.where(mask[:, None], norm, torch.zeros_like(norm))
    return err.sum() / norm.sum().clamp(min=1e-8)
