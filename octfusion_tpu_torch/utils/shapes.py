"""Seeded analytic point clouds for driving the training path without a
dataset: lumpy spheres with exact normals."""

from __future__ import annotations

import torch


def lumpy_spheres(batch_size: int, n_points: int, seed: int = 0,
                  device="cpu"):
    """-> points, normals [B, N, 3] f32 on the surfaces
    ``p(u) = (R + a sin(k u.axis)) u`` over unit directions u, one seeded
    (R, a, k, axis) per sample (R in [0.3, 0.38], a in [0.02, 0.06]: the
    shapes stay inside [-0.44, 0.44]^3, as ShapeNet's scaled shapes stay
    inside [-0.5, 0.5]^3, and fit the default caps).
    The normals are the exact unit gradients of
    ``F(p) = |p| - rho(p / |p|)``.  Drawn on the CPU, so a seed gives the
    same cloud on every machine."""
    gen = torch.Generator().manual_seed(seed)
    b = batch_size
    u = torch.randn(b, n_points, 3, generator=gen)
    u = u / u.norm(dim=-1, keepdim=True)
    radius = 0.3 + 0.08 * torch.rand(b, 1, generator=gen)
    amp = 0.02 + 0.04 * torch.rand(b, 1, generator=gen)
    freq = 3.0 + 3.0 * torch.rand(b, 1, generator=gen)
    axis = torch.randn(b, 1, 3, generator=gen)
    axis = axis / axis.norm(dim=-1, keepdim=True)
    t = (u * axis).sum(-1)
    rho = radius + amp * torch.sin(freq * t)
    points = rho[..., None] * u
    # grad F = u - (I - u u^T) grad_u(rho) / rho
    grad_rho = (amp * freq * torch.cos(freq * t))[..., None] * axis
    tangential = grad_rho - (grad_rho * u).sum(-1, keepdim=True) * u
    normals = u - tangential / rho[..., None]
    normals = normals / normals.norm(dim=-1, keepdim=True)
    return points.to(device), normals.to(device)
