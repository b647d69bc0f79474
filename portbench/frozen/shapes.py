"""A frozen copy of the program's seeded lumpy spheres
(``octfusion_tpu_torch/utils/shapes.py``: ``_draw`` and ``lumpy_spheres``),
the point clouds the training cells feed: a later change to the program
cannot change the benchmark's inputs."""

from __future__ import annotations

import torch


def _draw(gen: torch.Generator, b: int, n_points: int):
    """Unit directions [B, N, 3] and each sample's (R, a, k, axis), in the
    order :func:`lumpy_spheres` draws them."""
    u = torch.randn(b, n_points, 3, generator=gen)
    u = u / u.norm(dim=-1, keepdim=True)
    radius = 0.3 + 0.08 * torch.rand(b, 1, generator=gen)
    amp = 0.02 + 0.04 * torch.rand(b, 1, generator=gen)
    freq = 3.0 + 3.0 * torch.rand(b, 1, generator=gen)
    axis = torch.randn(b, 1, 3, generator=gen)
    axis = axis / axis.norm(dim=-1, keepdim=True)
    return u, radius, amp, freq, axis


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
    u, radius, amp, freq, axis = _draw(gen, batch_size, n_points)
    t = (u * axis).sum(-1)
    rho = radius + amp * torch.sin(freq * t)
    points = rho[..., None] * u
    # grad F = u - (I - u u^T) grad_u(rho) / rho
    grad_rho = (amp * freq * torch.cos(freq * t))[..., None] * axis
    tangential = grad_rho - (grad_rho * u).sum(-1, keepdim=True) * u
    normals = u - tangential / rho[..., None]
    normals = normals / normals.norm(dim=-1, keepdim=True)
    return points.to(device), normals.to(device)
