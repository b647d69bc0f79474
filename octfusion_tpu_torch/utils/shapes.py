"""Seeded analytic shapes for driving the port without a dataset: lumpy
spheres as point clouds with exact normals (training) and as signed fields
on a grid (meshes for the evaluation path)."""

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


def lumpy_sphere_fields(batch_size: int, resolution: int, seed: int = 0,
                        device="cpu") -> torch.Tensor:
    """-> [B, R, R, R] f32 samples of ``F(p) = |p| - rho(p / |p|)`` on the
    grid ``linspace(-0.5, 0.5, R)^3`` (x-major), negative inside: the
    surfaces of :func:`lumpy_spheres`, with (R, a, k, axis) drawn from the
    same ranges, as fields whose zero level set a mesher extracts.  Drawn on
    the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    b = batch_size
    radius, amp, freq = (lo + span * torch.rand(b, 1, 1, 1, generator=gen)
                         for lo, span in ((0.3, 0.08), (0.02, 0.04),
                                          (3.0, 3.0)))
    axis = torch.randn(b, 3, generator=gen)
    axis = axis / axis.norm(dim=-1, keepdim=True)
    c = torch.linspace(-0.5, 0.5, resolution)
    p = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1)
    r = p.norm(dim=-1)
    t = torch.einsum("xyzk,bk->bxyz", p / r.clamp(min=1e-9)[..., None], axis)
    return (r - (radius + amp * torch.sin(freq * t))).to(device)
