"""Generation-quality evaluation from meshes (port of the JAX package's
``tools/evaluate.py``): each ``.obj`` is normalised to the unit cube and
sampled to a point cloud on the host (the reference's
``metrics/generate_pointclouds.py``), then the pairwise CD / EMD matrices
run on the device and give 1-NNA, COV and MMD (``metrics/1-NNA.py`` /
``cov_mmd.py``).

    python -m octfusion_tpu_torch.evaluate --samples 'out/*.obj' \\
        --reference 'ref/*.obj' [--points 2048] [--emd] [--emd_bf16] \\
        [--batch 8] [--device cuda] [--out result.json]

It runs on the card; ``--device cpu`` asks for the CPU.  Prints the result
as JSON, with the wall seconds of the surface sampling and of the pairwise
metrics.  Shading FID and the device-sharded tile loop are not ported.
"""

from __future__ import annotations

import argparse
import glob
import json
import time

import numpy as np

from .metrics import evaluation
from .utils import mesh as mesh_utils
from .utils.device import resolve_device


def meshes_to_pointclouds(paths, n_points: int, seed: int = 0):
    """-> ([K, n_points, 3] float32 clouds, the K paths kept); meshes
    without faces are skipped, mesh i is sampled with seed ``seed + i``."""
    clouds = []
    kept = []
    for i, p in enumerate(paths):
        v, f = mesh_utils.load_obj(p)
        if len(f) == 0:
            continue
        v = mesh_utils.normalize_unit_cube(v)
        pts = mesh_utils.sample_surface(v, f, n_points, seed=seed + i)
        clouds.append(pts.astype(np.float32))
        kept.append(p)
    return np.stack(clouds), kept


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--samples", required=True, help="glob of sample meshes")
    p.add_argument("--reference", required=True,
                   help="glob of reference meshes")
    p.add_argument("--points", type=int, default=2048)
    p.add_argument("--emd", action="store_true")
    p.add_argument("--emd_bf16", action="store_true",
                   help="store the EMD auction matrices in bfloat16")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    s_paths = sorted(glob.glob(args.samples))
    r_paths = sorted(glob.glob(args.reference))
    if not s_paths or not r_paths:
        raise SystemExit(f"no meshes match {args.samples!r} or "
                         f"{args.reference!r}")
    t0 = time.perf_counter()
    sp, _ = meshes_to_pointclouds(s_paths, args.points, seed=0)
    rp, _ = meshes_to_pointclouds(r_paths, args.points, seed=10_000)
    t_sample = time.perf_counter() - t0
    print(f"[*] {len(sp)} samples vs {len(rp)} references ({args.points} "
          f"pts each, surface sampling {t_sample:.3f}s, device {device})",
          flush=True)
    t1 = time.perf_counter()
    res = evaluation.evaluate_point_sets(
        sp, rp, batch=args.batch, emd=args.emd, emd_bf16=args.emd_bf16,
        device=device)
    res["wall_s_pointcloud_sampling"] = t_sample
    res["wall_s_pairwise_metrics"] = time.perf_counter() - t1
    print(json.dumps(res, indent=2), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=2)
    return res


if __name__ == "__main__":
    main()
