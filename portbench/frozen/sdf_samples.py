"""A frozen copy of the program's SDF supervision of the seeded lumpy
spheres (``octfusion_tpu_torch/utils/shapes.py``: ``_field`` and
``lumpy_sphere_sdf_samples``), the SDF samples the VAE training cell
feeds: a later change to the program cannot change the benchmark's
inputs."""

from __future__ import annotations

import torch

from .shapes import _draw


def _field(p, radius, amp, freq, axis):
    """``F(p) = |p| - rho(p / |p|)`` and its exact gradient
    ``u - (I - u u^T) grad_u(rho) / |p|`` at points ``p`` [B, N, 3]."""
    r = p.norm(dim=-1, keepdim=True).clamp(min=1e-9)
    u = p / r
    t = (u * axis).sum(-1)
    rho = radius + amp * torch.sin(freq * t)
    grad_rho = (amp * freq * torch.cos(freq * t))[..., None] * axis
    tangential = grad_rho - (grad_rho * u).sum(-1, keepdim=True) * u
    return r[..., 0] - rho, u - tangential / r


def lumpy_sphere_sdf_samples(batch_size: int, n: int, seed: int = 0,
                             points_per_shape: int = 65536, device="cpu"):
    """SDF supervision of the shapes ``lumpy_spheres(batch_size,
    points_per_shape, seed)``: -> {"pos", "sdf", "grad"}, [B, n, 3], [B, n]
    and [B, n, 3] f32, the value and exact gradient of
    ``F(p) = |p| - rho(p / |p|)`` (negative inside) at ``n`` points per
    shape, the first ``n // 2`` uniform in [-1, 1]^3 and the rest near the
    surface (surface points moved by N(0, 0.02²) per axis).  Drawn on the
    CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    b = batch_size
    _, radius, amp, freq, axis = _draw(gen, b, points_per_shape)
    n_far = n // 2
    far = 2.0 * torch.rand(b, n_far, 3, generator=gen) - 1.0
    u = torch.randn(b, n - n_far, 3, generator=gen)
    u = u / u.norm(dim=-1, keepdim=True)
    rho = radius + amp * torch.sin(freq * (u * axis).sum(-1))
    near = rho[..., None] * u + 0.02 * torch.randn(u.shape, generator=gen)
    pos = torch.cat([far, near], dim=1)
    sdf, grad = _field(pos, radius, amp, freq, axis)
    return {"pos": pos.to(device), "sdf": sdf.to(device),
            "grad": grad.to(device)}
