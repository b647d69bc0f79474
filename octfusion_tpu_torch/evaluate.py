"""Generation-quality evaluation from meshes (port of the JAX package's
``tools/evaluate.py``): each ``.obj`` is normalised to the unit cube and
sampled to a point cloud on the host (the reference's
``metrics/generate_pointclouds.py``), then the pairwise CD / EMD matrices
run on the device and give 1-NNA, COV and MMD (``metrics/1-NNA.py`` /
``cov_mmd.py``).  ``--fid_standin`` adds the per-view shading FID under
the fixed-seed random-conv stand-in features (``metrics/fid.py``; the
triangle rasteriser and the features on the device), reported as
``shading_fid_standin``: not comparable to Inception-FID numbers.

    python -m octfusion_tpu_torch.evaluate --samples 'out/*.obj' \\
        --reference 'ref/*.obj' [--points 2048] [--emd] [--emd_bf16] \\
        [--batch 8] [--shard] [--fid_standin [--fid_views 20]] \\
        [--skip_pairwise] [--device cuda] [--out result.json]

It runs on the card; ``--device cpu`` asks for the CPU.  Prints the result
as JSON, with the wall seconds of the surface sampling, of the pairwise
metrics and of the FID (``wall_s_fid``).  ``--shard`` splits the pair
tiles' rows over every visible card (no collectives; the same matrices).
``--skip_pairwise`` leaves out CD / EMD (an FID-only pass).  Each set's
per-mesh FID features are cached in a ``.fid_cache`` directory beside its
first mesh (keyed by file name, mtime, size, image size, views and
extractor), so a fixed reference set renders once.  Inception FID
(``--fid`` of the JAX tool) waits for a local InceptionV3 state dict in
the repository and is not offered.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np

from .metrics import evaluation
from .metrics import fid as fid_lib
from .utils import mesh as mesh_utils
from .utils.device import resolve_device, use_fp32_math


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
    p.add_argument("--shard", action="store_true",
                   help="split the pairwise tile grid's rows over every "
                        "visible card (no collectives)")
    p.add_argument("--fid_standin", action="store_true",
                   help="per-view shading Frechet distance under the "
                        "fixed-seed random-conv STAND-IN features (no "
                        "pretrained weights; reported as "
                        "shading_fid_standin, NOT comparable to "
                        "Inception-FID numbers; Inception --fid waits for "
                        "local weights and is not offered)")
    p.add_argument("--fid_views", type=int, default=20,
                   help="fixed views rendered per mesh (the protocol's 20)")
    p.add_argument("--skip_pairwise", action="store_true",
                   help="skip the pairwise CD / EMD metrics (FID-only pass)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    use_fp32_math()
    s_paths = sorted(glob.glob(args.samples))
    r_paths = sorted(glob.glob(args.reference))
    if not s_paths or not r_paths:
        raise SystemExit(f"no meshes match {args.samples!r} or "
                         f"{args.reference!r}")
    res = {}
    if not args.skip_pairwise:
        t0 = time.perf_counter()
        sp, _ = meshes_to_pointclouds(s_paths, args.points, seed=0)
        rp, _ = meshes_to_pointclouds(r_paths, args.points, seed=10_000)
        t_sample = time.perf_counter() - t0
        print(f"[*] {len(sp)} samples vs {len(rp)} references "
              f"({args.points} pts each, surface sampling {t_sample:.3f}s, "
              f"device {device})", flush=True)
        t1 = time.perf_counter()
        res = evaluation.evaluate_point_sets(
            sp, rp, batch=args.batch, emd=args.emd, emd_bf16=args.emd_bf16,
            device=device, shard_devices="auto" if args.shard else None)
        res["wall_s_pointcloud_sampling"] = t_sample
        res["wall_s_pairwise_metrics"] = time.perf_counter() - t1
    if args.fid_standin:
        t1 = time.perf_counter()
        print(f"[*] rendering {len(s_paths)}+{len(r_paths)} meshes x "
              f"{args.fid_views} views for stand-in shading FID on {device}",
              flush=True)
        # per-set feature caches beside the meshes: a fixed reference set
        # renders once across evaluations of different sample sets
        res["shading_fid_standin"] = fid_lib.shading_fid(
            s_paths, r_paths, n_views=args.fid_views,
            feature_fn=fid_lib.standin_feature_extractor(device=device),
            cache_dir=os.path.join(os.path.dirname(s_paths[0]), ".fid_cache"),
            reference_cache_dir=os.path.join(os.path.dirname(r_paths[0]),
                                             ".fid_cache"),
            device=device)
        res["wall_s_fid"] = time.perf_counter() - t1
    print(json.dumps(res, indent=2), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=2)
    return res


if __name__ == "__main__":
    main()
