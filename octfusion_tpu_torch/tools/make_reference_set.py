"""Export held-out ground-truth meshes of the synthetic dataset (port of
the JAX package's ``tools/make_reference_set.py``).

The quality evaluation needs a reference shape set to compare generated
samples against, in the role of the ShapeNet test split of the
reference's protocol (``metrics/1-NNA.py:22-27``).  The synthetic dataset
is procedurally seeded per index (``data/dataset.SyntheticDataset``), so
any index range disjoint from the training range [0, size) is a held-out
draw from the same distribution.  This tool marches the analytic SDF of
each held-out shape on the device and writes an ``.obj``:

    python -m octfusion_tpu_torch.tools.make_reference_set \\
        --out data/ref_synthetic --start 10000 --count 512 --resolution 128

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.dataset import SyntheticDataset
from ..utils import mesh as mesh_utils
from ..utils.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--start", type=int, default=10_000,
                   help="first shape index (training uses [0, 1000))")
    p.add_argument("--count", type=int, default=512)
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--bbox", type=float, default=0.9,
                   help="grid half-extent (reference sdf_scale)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    ds = SyntheticDataset()
    n = args.resolution
    ax = np.linspace(-args.bbox, args.bbox, n).astype(np.float32)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    grid = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1)

    written = []
    for k in range(args.count):
        idx = args.start + k
        rng = np.random.RandomState(idx * 9176 + 13)
        sdf = ds._make_sdf(rng)(grid).reshape(n, n, n)
        v, f = mesh_utils.marching_tetrahedra(
            torch.as_tensor(sdf, dtype=torch.float32, device=dev))
        if f.shape[0] == 0:
            print(f"[!] shape {idx}: empty surface, skipped")
            continue
        # voxel coordinates -> the grid's world coordinates
        v = v.cpu().numpy() / (n - 1) * (2 * args.bbox) - args.bbox
        path = os.path.join(args.out, f"ref_{idx:06d}.obj")
        mesh_utils.save_obj(path, v, f.cpu().numpy())
        written.append(path)
        if (k + 1) % 50 == 0:
            print(f"[*] {k + 1}/{args.count}")
    print(f"[*] wrote {len(written)} reference meshes to {args.out}")
    return written


if __name__ == "__main__":
    main()
