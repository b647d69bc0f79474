"""Continuous-time log-SNR diffusion schedules
(port of ``octfusion_tpu/diffusion/schedule.py``).  The functions take
tensors (float32 keeps the reference's arithmetic)."""

from __future__ import annotations

import math

import torch


def beta_linear_log_snr(t):
    return -torch.log(torch.expm1(1e-4 + 10.0 * (t**2)))


def alpha_cosine_log_snr(t, s: float = 0.008):
    c = torch.cos((t + s) / (1 + s) * math.pi * 0.5)
    return -torch.log(torch.clamp(c**-2 - 1.0, min=1e-5))


def log_snr_to_alpha_sigma(log_snr):
    return (torch.sqrt(torch.sigmoid(log_snr)),
            torch.sqrt(torch.sigmoid(-log_snr)))


def get_log_snr(name: str):
    if name == "linear":
        return beta_linear_log_snr
    if name == "cosine":
        return alpha_cosine_log_snr
    raise ValueError(f"unknown noise schedule {name}")


def sampling_time_pairs(steps: int):
    """(t, t_next) as two [steps] float32 tensors, t from 1 -> 0."""
    times = torch.linspace(1.0, 0.0, steps + 1, dtype=torch.float32)
    return times[:-1], times[1:]
