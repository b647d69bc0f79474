"""Shading images for FID: the triangle rasteriser of the JAX package's
``metrics/render.py`` (``render_mesh_views_raster``) in torch float64 on
the device.

The reference renders 20 fixed views at 299² with pyrender/EGL
(unit-sphere normalisation, a perspective camera of yfov pi/3 at twice
each view's front vector, flat shading, lights at the camera).  This is
its software equivalent: flat Lambertian headlight shading of a
z-buffered triangle rasterisation, so holes and missing faces show in the
images.  Per view, every (triangle, pixel of its bounding box) pair is
tested at the pixel centre by barycentrics, its depth interpolated, and
each pixel keeps the nearest pair; at equal depth the lowest face index
wins, which is what the JAX code's per-chunk stable sort and strict merge
amount to.  Since that rule does not depend on how the faces are chunked,
the pairs are chunked by a budget (``PAIR_BUDGET``) as well as by
``face_chunk``, which keeps meshes with large triangles in memory.

The protocol's constants (the view directions, the camera frames, the
focal length) are numpy on the host, as in the JAX code; the per-vertex
and per-pair arithmetic is the same float64 operations in the same
order, so the images match the JAX renderer's wherever numpy's
matrix products round as the explicit sums here do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device

# The reference's 20 fixed view directions (icosahedral; camera = dir * 2,
# `utils/render/render.py:10-30`): defining constants of the protocol.
FRONT_VECTORS = np.array([
    [0.52573, 0.38197, 0.85065], [-0.20081, 0.61803, 0.85065],
    [-0.64984, 0.00000, 0.85065], [-0.20081, -0.61803, 0.85065],
    [0.52573, -0.38197, 0.85065], [0.85065, -0.61803, 0.20081],
    [1.0515, 0.00000, -0.20081], [0.85065, 0.61803, 0.20081],
    [0.32492, 1.00000, -0.20081], [-0.32492, 1.00000, 0.20081],
    [-0.85065, 0.61803, -0.20081], [-1.0515, 0.00000, 0.20081],
    [-0.85065, -0.61803, -0.20081], [-0.32492, -1.00000, 0.20081],
    [0.32492, -1.00000, -0.20081], [0.64984, 0.00000, -0.85065],
    [0.20081, 0.61803, -0.85065], [-0.52573, 0.38197, -0.85065],
    [-0.52573, -0.38197, -0.85065], [0.20081, -0.61803, -0.85065],
], np.float64)

# (triangle, pixel) pairs tested at once: ~40 float64 / int64 temporaries
# of this length, ~1.3 GB
PAIR_BUDGET = 1 << 22


def scale_to_unit_sphere(verts: np.ndarray) -> np.ndarray:
    """Reference normalisation (``utils/util.py`` scale_to_unit_sphere):
    centre on the bbox midpoint, scale the max radius to 1."""
    centre = (verts.min(0) + verts.max(0)) / 2
    v = verts - centre
    r = np.max(np.linalg.norm(v, axis=-1))
    return v / max(r, 1e-12)


def _look_at(eye: np.ndarray):
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(fwd, up)) > 0.98:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    up2 = np.cross(right, fwd)
    return np.stack([right, up2, -fwd])  # rows: camera axes


def _dot3(a: torch.Tensor, b) -> torch.Tensor:
    """``a @ b`` for a [..., 3] tensor and a 3-vector, as the sum
    ``(a0 b0 + a1 b1) + a2 b2``."""
    return a[..., 0] * b[0] + a[..., 1] * b[1] + a[..., 2] * b[2]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``np.cross`` of [..., 3] tensors, term for term."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_dot3(a, a.unbind(-1)))


def _chunks(counts: np.ndarray, face_chunk: int):
    """Consecutive face ranges of at most ``face_chunk`` faces and at most
    ``PAIR_BUDGET`` pairs (a single face may exceed the budget alone)."""
    ends = np.cumsum(counts)
    c0, n = 0, len(counts)
    while c0 < n:
        base = ends[c0 - 1] if c0 else 0
        c1 = int(np.searchsorted(ends, base + PAIR_BUDGET, side="right"))
        c1 = min(max(c1, c0 + 1), c0 + face_chunk, n)
        yield c0, c1
        c0 = c1


def _nearest_faces(sx, sy, z, f, size: int, face_chunk: int):
    """The z-buffer of one view: per pixel, the face whose depth at the
    pixel centre is the least (the lowest face index at a tie), or -1 ->
    [size * size] int64.  ``sx``, ``sy``, ``z`` are the vertices' screen
    coordinates and depths."""
    dev = z.device
    tx, ty, tz = sx[f], sy[f], z[f]                        # [T, 3]
    ok = (tz > 1e-4).all(dim=1)
    x0 = torch.clamp(torch.floor(tx.amin(1)), 0, size - 1).long()
    x1 = torch.clamp(torch.ceil(tx.amax(1)), 0, size - 1).long()
    y0 = torch.clamp(torch.floor(ty.amin(1)), 0, size - 1).long()
    y1 = torch.clamp(torch.ceil(ty.amax(1)), 0, size - 1).long()
    w = torch.where(ok, x1 - x0 + 1, 0)
    h = torch.where(ok, y1 - y0 + 1, 0)
    counts = w * h

    npix = size * size
    depth = torch.full((npix,), torch.inf, dtype=torch.float64, device=dev)
    face = torch.full((npix,), -1, dtype=torch.int64, device=dev)
    for c0, c1 in _chunks(counts.cpu().numpy(), face_chunk):
        cnt = counts[c0:c1]
        total = int(cnt.sum())
        if total == 0:
            continue
        tid = torch.repeat_interleave(
            torch.arange(c0, c1, device=dev), cnt, output_size=total)
        starts = torch.cumsum(cnt, 0) - cnt
        local = (torch.arange(total, device=dev)
                 - torch.repeat_interleave(starts, cnt, output_size=total))
        wt = torch.clamp(w[tid], min=1)
        px = x0[tid] + local % wt
        py = y0[tid] + local // wt
        # barycentric inside test at pixel centres
        ax, ay = tx[tid, 0], ty[tid, 0]
        bx, by = tx[tid, 1], ty[tid, 1]
        cx, cy = tx[tid, 2], ty[tid, 2]
        pxf = px + 0.5
        pyf = py + 0.5
        d00x, d00y = bx - ax, by - ay
        d01x, d01y = cx - ax, cy - ay
        den = d00x * d01y - d01x * d00y
        good = torch.abs(den) > 1e-12
        den = torch.where(good, den, 1.0)
        wpx, wpy = pxf - ax, pyf - ay
        u = (wpx * d01y - d01x * wpy) / den
        t = (d00x * wpy - wpx * d00y) / den
        inside = good & (u >= 0) & (t >= 0) & (u + t <= 1)
        zz = tz[tid, 0] * (1 - u - t) + tz[tid, 1] * u + tz[tid, 2] * t
        inside &= zz > 1e-4
        pix = (py * size + px)[inside]
        zz = zz[inside]
        tid = tid[inside]
        # the chunk's nearest pair per pixel, the lowest face at a tie ...
        cd = torch.full((npix,), torch.inf, dtype=torch.float64,
                        device=dev).scatter_reduce(0, pix, zz, "amin")
        tie = zz == cd[pix]
        cf = torch.full((npix,), -1, dtype=torch.int64, device=dev)
        cf = cf.scatter_reduce(0, pix[tie], tid[tie], "amin",
                               include_self=False)
        # ... merged strictly: an earlier chunk (lower faces) wins a tie
        closer = cd < depth
        depth = torch.where(closer, cd, depth)
        face = torch.where(closer, cf, face)
    return face


def _project(v, eye, rot, focal: float, half: float):
    """-> the vertices' screen x, y and depth in the camera at ``eye``
    with axes ``rot`` (rows)."""
    rel = v - torch.as_tensor(eye, device=v.device)
    cam = torch.stack([_dot3(rel, r) for r in rot.tolist()], -1)
    z = -cam[:, 2]
    zc = torch.clamp(z, min=1e-6)
    return cam[:, 0] / zc * focal + half, -cam[:, 1] / zc * focal + half, z


def render_mesh_views_raster(
    verts: np.ndarray,
    faces: np.ndarray,
    image_size: int = 299,
    n_views: int = 20,
    cam_dist: float = 2.0,
    yfov: float = np.pi / 3.0,
    face_chunk: int = 65536,
    device="cuda",
) -> np.ndarray:
    """-> [n_views, S, S] float32 images in [0, 1].

    Flat-shaded perspective triangle rasterisation with a per-pixel nearest
    (z-buffer) resolve and camera-headlight Lambertian shading, computed in
    float64 on ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    out = np.zeros((n_views, image_size, image_size), np.float32)
    if len(faces) == 0:
        return out
    v = torch.as_tensor(scale_to_unit_sphere(np.asarray(verts, np.float64)),
                        device=dev)
    f = torch.as_tensor(np.asarray(faces, np.int64), device=dev)
    tri_n = _cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    tri_n = tri_n / torch.clamp(_norm(tri_n), min=1e-12)[:, None]

    focal = (image_size / 2.0) / np.tan(yfov / 2.0)
    half = image_size / 2.0
    dirs = FRONT_VECTORS / np.linalg.norm(FRONT_VECTORS, axis=-1,
                                          keepdims=True)
    views = []
    for vi in range(min(n_views, len(dirs))):
        # the reference places cameras at the UNNORMALISED front * 2
        # (`utils/render/render.py:10-33`, |front| ~ 1.07 -> dist ~ 2.14);
        # only the Lambertian light direction uses the normalised vector
        eye = FRONT_VECTORS[vi] * cam_dist
        sx, sy, z = _project(v, eye, _look_at(eye), focal, half)
        face = _nearest_faces(sx, sy, z, f, image_size, face_chunk)
        lam = torch.abs(_dot3(tri_n, dirs[vi].tolist()))  # headlight
        views.append(torch.where(face >= 0, lam[face.clamp(min=0)], 0.0))
    img = torch.stack(views).to(torch.float32).cpu().numpy()
    out[:len(views)] = img.reshape(len(views), image_size, image_size)
    return out
