"""Dataset preparation: meshes -> reference-format training shards (port
of the JAX package's ``tools/prepare_dataset.py``, the counterpart of the
reference's ``tools/repair_mesh.py``).  For each input OBJ it writes the
per-shape layout that ``data/dataset.ShapeNetDataset`` reads
(``datasets/dualoctree_snet.py:110-168``):

    <out>/<shape>/pointcloud.npz   points, normals      (surface samples)
    <out>/<shape>/sdf.npz          points, sdf, grad    (SDF supervision)

The mesh is normalised and sampled on the host with numpy draws in the
JAX tool's order, so a mesh and seed give its surface samples, normals
and queries bit for bit.  The SDF's magnitude is the distance to the
nearest surface sample, found by brute force in float64 over direct
differences on the device (in place of scipy's ``cKDTree``).  Its sign
comes from the generalized winding number of the triangle mesh (van
Oosterom-Strackee solid angles in float32 on the device, as the JAX tool
computes them), which holds for the non-watertight meshes the reference
repairs; ``sign_method="normal"`` takes the nearest sample's normal
instead (exact only for clean watertight surfaces).

    python -m octfusion_tpu_torch.tools.prepare_dataset \\
        --meshes 'data/raw/*.obj' --out data/prepared \\
        --filelist data/prepared/filelist.txt [--device cpu]

Runs on the card unless ``--device cpu``.  Prints, per mesh, the seconds
of the nearest-sample search, of the winding numbers and in all, then
their means.
"""

from __future__ import annotations

import argparse
import glob
import math
import os
import time

import numpy as np
import torch

from ..utils import mesh as mesh_utils
from ..utils.device import resolve_device

# (query, surface sample) and (query, triangle) pairs computed at once: on
# the card, enough to hide the launches; on the CPU, what stays in cache
PAIR_BUDGET = {"cuda": 1 << 24, "cpu": 1 << 20}


def nearest_surface(queries: np.ndarray, surf: np.ndarray, device="cuda"):
    """-> (distance [Q] float64, index [Q] int64) of each query's nearest
    surface sample: the squared distances ``sum((q - s)^2)`` in float64
    (direct differences: the ``|q|^2 + |s|^2 - 2 q.s`` expansion cancels
    and loses the argmin at near-ties), the first index at a tie."""
    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(queries, np.float64), device=dev)
    s = torch.as_tensor(np.asarray(surf, np.float64), device=dev)
    dist = torch.empty(len(q), dtype=torch.float64, device=dev)
    idx = torch.empty(len(q), dtype=torch.int64, device=dev)
    step = max(1, PAIR_BUDGET[dev.type] // max(len(s), 1))
    for c0 in range(0, len(q), step):
        qc = q[c0:c0 + step]
        d2 = (qc[:, None, 0] - s[None, :, 0]) ** 2
        d2 += (qc[:, None, 1] - s[None, :, 1]) ** 2
        d2 += (qc[:, None, 2] - s[None, :, 2]) ** 2
        best, arg = torch.min(d2, dim=1)
        dist[c0:c0 + step] = torch.sqrt(best)
        idx[c0:c0 + step] = arg
    return dist.cpu().numpy(), idx.cpu().numpy()    # (waits for the card)


def winding_number(verts: np.ndarray, faces: np.ndarray,
                   queries: np.ndarray, device="cuda") -> np.ndarray:
    """Generalized winding number of the mesh at each query (Jacobson et
    al.): the sum of the triangles' solid angles over 4 pi, which degrades
    continuously on open or self-intersecting meshes instead of flipping.
    Solid angles by van Oosterom-Strackee in float32 on ``device``,
    chunked by ``PAIR_BUDGET`` (query, triangle) pairs -> [Q] float32."""
    dev = resolve_device(device)
    tri = torch.as_tensor(np.asarray(verts[faces], np.float32), device=dev)
    q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
    out = torch.empty(len(q), dtype=torch.float32, device=dev)
    step = max(1, PAIR_BUDGET[dev.type] // max(len(tri), 1))
    for c0 in range(0, len(q), step):
        qc = q[c0:c0 + step, None]                       # [C, 1, 3]
        a = tri[None, :, 0] - qc                         # [C, T, 3]
        b = tri[None, :, 1] - qc
        c = tri[None, :, 2] - qc
        la, lb, lc = (torch.linalg.vector_norm(x, dim=-1) for x in (a, b, c))
        num = (a * torch.linalg.cross(b, c)).sum(-1)
        den = (la * lb * lc + (a * b).sum(-1) * lc + (b * c).sum(-1) * la
               + (c * a).sum(-1) * lb)
        omega = 2.0 * torch.atan2(num, den)
        out[c0:c0 + step] = omega.sum(-1) / (4.0 * math.pi)
    return out.cpu().numpy()


def normalize_mesh(verts: np.ndarray, mesh_scale: float = 0.8,
                   point_scale: float = 0.5) -> np.ndarray:
    """Centre the bounding box and scale its largest half-extent to
    ``mesh_scale * point_scale``: the frame of the written shards."""
    centre = (verts.min(0) + verts.max(0)) / 2
    half = np.abs(verts - centre).max()
    return (verts - centre) / max(half, 1e-9) * mesh_scale * point_scale


def surface_and_queries(verts, faces, n_surface: int, n_sdf: int,
                        point_scale: float = 0.5, near_std: float = 0.02,
                        seed: int = 0):
    """The host's numpy draws, in the JAX tool's order -> (surface samples
    [n_surface, 3] float64, their normals, SDF queries [n_sdf, 3]
    float32): area-weighted samples (seed ``seed``), then from
    ``RandomState(seed + 1)`` 3/4 of the queries near the surface
    (Gaussian, ``near_std``; the reference samples around octree nodes at
    depths 4-6, ``repair_mesh.py:260-338``) and 1/4 uniform in the
    ``point_scale`` cube."""
    surf, nrm = mesh_utils.sample_surface(
        verts, faces, n_surface, seed=seed, return_normals=True)
    rng = np.random.RandomState(seed + 1)
    n_near = n_sdf * 3 // 4
    near = surf[rng.randint(0, n_surface, n_near)] + rng.normal(
        0, near_std, size=(n_near, 3))
    vol = rng.uniform(-point_scale, point_scale, size=(n_sdf - n_near, 3))
    return surf, nrm, np.concatenate([near, vol]).astype(np.float32)


def mesh_to_shards(
    mesh_path: str,
    out_dir: str,
    n_surface: int = 100_000,
    n_sdf: int = 100_000,
    mesh_scale: float = 0.8,
    point_scale: float = 0.5,
    near_std: float = 0.02,
    seed: int = 0,
    sign_method: str = "winding",
    device="cuda",
) -> dict:
    """Write ``out_dir/pointcloud.npz`` and ``out_dir/sdf.npz`` for one
    mesh -> the seconds of the nearest-sample search (``nearest_s``), of
    the winding numbers (``winding_s``, 0 with ``sign_method="normal"``)
    and of the whole mesh (``total_s``)."""
    if sign_method not in ("winding", "normal"):
        raise ValueError(f"sign_method {sign_method!r}: 'winding' or 'normal'")
    dev = resolve_device(device)
    t_start = time.perf_counter()
    verts, faces = mesh_utils.load_obj(mesh_path)
    if len(faces) == 0:
        raise ValueError(f"{mesh_path}: empty mesh")
    verts = normalize_mesh(verts, mesh_scale, point_scale)
    surf, nrm, queries = surface_and_queries(verts, faces, n_surface, n_sdf,
                                             point_scale, near_std, seed)

    t0 = time.perf_counter()
    dist, idx = nearest_surface(queries, surf, dev)
    t_nearest = time.perf_counter() - t0
    diff = queries - surf[idx]
    t_winding = 0.0
    if sign_method == "winding":
        t0 = time.perf_counter()
        w = winding_number(verts, faces, queries, dev)
        t_winding = time.perf_counter() - t0
        sign = np.where(w > 0.5, -1.0, 1.0)
    else:
        sign = np.sign(np.sum(diff * nrm[idx], axis=-1))
        sign[sign == 0] = 1.0
    sdf = (dist * sign).astype(np.float32)
    grad = diff / np.maximum(dist[:, None], 1e-9) * sign[:, None]

    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "pointcloud.npz"),
             points=surf.astype(np.float32), normals=nrm.astype(np.float32))
    np.savez(os.path.join(out_dir, "sdf.npz"),
             points=queries, sdf=sdf, grad=grad.astype(np.float32))
    return {"nearest_s": t_nearest, "winding_s": t_winding,
            "total_s": time.perf_counter() - t_start}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--meshes", required=True, help="glob of input OBJs")
    p.add_argument("--out", required=True)
    p.add_argument("--filelist", default=None)
    p.add_argument("--n_surface", type=int, default=100_000)
    p.add_argument("--n_sdf", type=int, default=100_000)
    p.add_argument("--point_scale", type=float, default=0.5)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    paths = sorted(glob.glob(args.meshes))
    names, times = [], []
    for i, mp in enumerate(paths):
        name = os.path.splitext(os.path.basename(mp))[0]
        t = mesh_to_shards(
            mp, os.path.join(args.out, name),
            n_surface=args.n_surface, n_sdf=args.n_sdf,
            point_scale=args.point_scale, seed=i, device=dev)
        names.append(name)
        times.append(t)
        print(f"[{i + 1}/{len(paths)}] {name} " + " ".join(
            f"{k}={v:.3f}" for k, v in t.items()), flush=True)
    if args.filelist:
        os.makedirs(os.path.dirname(args.filelist) or ".", exist_ok=True)
        with open(args.filelist, "w") as fh:
            fh.write("\n".join(names) + "\n")
    if times:
        print(f"[*] prepared {len(times)} meshes on {dev}: per mesh "
              + " ".join(f"{k}={np.mean([t[k] for t in times]):.3f}"
                         for k in times[0]), flush=True)
    return times


if __name__ == "__main__":
    main()
