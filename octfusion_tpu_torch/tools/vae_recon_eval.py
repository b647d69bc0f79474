"""Reconstruction Chamfer distance of a VAE checkpoint on held-out shapes
(port of the JAX package's ``tools/vae_recon_eval.py``).

The generation cascade can never score better than the VAE's own encode
-> decode -> mesh round trip.  This tool reconstructs the held-out
synthetic shapes [start, start + count) (the indices
``tools/make_reference_set`` marches analytically) from the latest
checkpoint of a VAE run, writes each mesh to ``--out`` (a rerun keeps
the meshes there and reconstructs the rest), and scores it
against the shape's own surface points: both normalised to the unit cube
(the evaluation's protocol), ``--points`` samples of the mesh against as
many of the shape's points, Chamfer distance = mean(dl) + mean(dr) of
``metrics.distances.chamfer`` (the kernel K4 on the card), for all shapes
in one batch.  Prints one JSON line (per-shape CD, their mean, the shapes
skipped for capacity or an empty mesh, the launches of K4).

    python -m octfusion_tpu_torch.tools.vae_recon_eval \\
        --config configs/synthetic_medium_v2.yaml --run logs/vae \\
        --start 10000 --count 128 --out logs/recon_vae

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..config import load_config
from ..data.dataset import SyntheticDataset, collate, fits_capacity
from ..metrics.distances import chamfer
from ..models.common import batch_to_device
from ..models.vae_solver import VAESolver
from ..ops import chamfer_cuda
from ..utils import ckpt as ckpt_lib
from ..utils import mesh as mesh_utils
from ..utils.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--run", required=True,
                    help="run dir holding ckpt/ (e.g. logs/vae)")
    ap.add_argument("--out", required=True, help="directory for recon .obj")
    ap.add_argument("--start", type=int, default=10_000,
                    help="first held-out index (must match the ref set)")
    ap.add_argument("--count", type=int, default=128)
    ap.add_argument("--resolution", type=int, default=None,
                    help="SDF grid size (default: config solver.resolution)")
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = load_config(args.config)
    solver = VAESolver(cfg, device=dev)
    path = ckpt_lib.latest_path(os.path.join(args.run, "ckpt"))
    if path is None:
        raise SystemExit(f"no checkpoint under {args.run}/ckpt")
    tree = ckpt_lib.restore(path)
    solver.vae.load_state_dict(tree["autoencoder"], strict=True)
    print(f"[ckpt] {path} (step {tree['train_state']['step']})")
    ds = SyntheticDataset()     # the shapes of tools/make_reference_set
    os.makedirs(args.out, exist_ok=True)

    t0 = time.perf_counter()
    recon, truth, kept, skipped = [], [], [], []
    for k in range(args.count):
        idx = args.start + k
        item = ds[idx]
        # an overflowing build drops nodes: its reconstruction is garbage
        if not fits_capacity(item["points"], solver.spec1,
                             solver.edge_factor):
            print(f"[!] shape {idx}: exceeds octree capacity, skipped")
            skipped.append(idx)
            continue
        dst = os.path.join(args.out, f"recon_{idx:06d}.obj")
        if not os.path.exists(dst):     # a rerun scores the meshes it has
            solver.reconstruct(batch_to_device(collate([item]), dev),
                               resolution=args.resolution, save_paths=[dst])
        if not os.path.exists(dst):     # an empty mesh writes no file
            print(f"[!] shape {idx}: empty reconstruction, skipped")
            skipped.append(idx)
            continue
        v, f = mesh_utils.load_obj(dst)
        recon.append(mesh_utils.sample_surface(
            mesh_utils.normalize_unit_cube(v), f, args.points, seed=idx))
        pts = mesh_utils.normalize_unit_cube(item["points"])
        truth.append(pts[np.random.RandomState(idx).choice(
            len(pts), args.points, replace=False)])
        kept.append(idx)
    cd = []
    if kept:
        a, b = (torch.as_tensor(np.stack(x), dtype=torch.float32, device=dev)
                for x in (recon, truth))
        dl, dr = chamfer(a, b)
        cd = (dl.mean(1) + dr.mean(1)).cpu().tolist()
    res = {"shapes": kept, "cd": cd,
           "cd_mean": float(np.mean(cd)) if cd else None,
           "skipped": skipped, "points": args.points, "device": str(dev),
           "chamfer_launches": chamfer_cuda.launches["chamfer"],
           "seconds": time.perf_counter() - t0}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
