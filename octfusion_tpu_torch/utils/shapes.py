"""Seeded analytic shapes for driving the port without a dataset: lumpy
spheres as point clouds with exact normals (training), as SDF samples with
exact gradients (VAE training) and as signed fields on a grid (meshes for
the evaluation path)."""

from __future__ import annotations

import os

import numpy as np
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


def position_colors(points: torch.Tensor) -> torch.Tensor:
    """Per-point RGB in [0, 1], a smooth function of position: the colour
    VAE's supervision for shapes that have none, which it can learn."""
    return 0.5 + 0.5 * torch.sin(4.0 * points)


def lumpy_sphere_batch(batch_size: int, n_points: int, n_sdf: int,
                       seed: int = 0, device="cpu", colors: bool = False):
    """A VAE training batch without a dataset: ``points`` / ``normals``
    of :func:`lumpy_spheres` and ``n_sdf`` SDF samples of the same shapes
    (:func:`lumpy_sphere_sdf_samples`); with ``colors``, the colour VAE's
    ``point_colors`` (:func:`position_colors`)."""
    pts, nrm = lumpy_spheres(batch_size, n_points, seed, device=device)
    out = {"points": pts, "normals": nrm, **lumpy_sphere_sdf_samples(
        batch_size, n_sdf, seed, points_per_shape=n_points, device=device)}
    if colors:
        out["point_colors"] = position_colors(pts)
    return out


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


def write_shapenet_set(root: str, n_shapes: int, n_points: int,
                       point_scale: float, seed: int = 0,
                       colors: bool = False):
    """``n_shapes`` seeded lumpy spheres in the reference's per-shape
    ShapeNet layout under ``root`` (``pointcloud.npz``: ``n_points``
    surface points scaled by ``point_scale`` as the files are, with exact
    normals; ``sdf.npz``: as many SDF samples with exact gradients, the
    value of the field in the loader's [-1, 1] frame; with ``colors``,
    ``color.npz``: each surface point's :func:`position_colors`) and a
    filelist -> (location, filelist), for ``data.location`` /
    ``data.filelist``."""
    pts, nrm = lumpy_spheres(n_shapes, n_points, seed)
    sdf = lumpy_sphere_sdf_samples(n_shapes, n_points, seed,
                                   points_per_shape=n_points)
    names = [f"02691156/lumpy_{i}" for i in range(n_shapes)]
    for i, name in enumerate(names):
        d = os.path.join(root, name)
        os.makedirs(d)
        np.savez(os.path.join(d, "pointcloud.npz"),
                 points=pts[i].numpy() * point_scale, normals=nrm[i].numpy())
        np.savez(os.path.join(d, "sdf.npz"),
                 points=sdf["pos"][i].numpy() * point_scale,
                 sdf=sdf["sdf"][i].numpy(), grad=sdf["grad"][i].numpy())
        if colors:
            np.savez(os.path.join(d, "color.npz"),
                     colors=position_colors(pts[i]).numpy())
    filelist = os.path.join(root, "filelist.txt")
    with open(filelist, "w") as fh:
        fh.write("".join(f"{name}\n" for name in names))
    return root, filelist
