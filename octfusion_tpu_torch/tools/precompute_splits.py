"""Precompute the lr stage's split grids of a ShapeNet-format dataset
(port of the JAX package's ``tools/precompute_splits.py``; the reference's
``tools/gen_split.py``): for each shape of a filelist, build its octree on
the device and store ``split_small`` (the dense full-depth split grid,
[S, S, S, 8]) as ``<location>/<shape>/split_small.npz``, which
``data.load_split_small`` reads, so the lr stage trains without touching
point clouds.

    python -m octfusion_tpu_torch.tools.precompute_splits \\
        --config configs/octfusion_snet_uncond.yaml \\
        --location data/prepared --filelist data/prepared/filelist.txt

Runs on the card unless ``--device cpu``.  As in the JAX tool, each
shape's ``points_per_shape`` points are drawn from its file by an
unseeded generator (the dataset's own draw).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config import load_config
from ..data.dataset import ShapeNetDataset
from ..models.common import batch_to_octree
from ..octree import split_codec
from ..utils.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--location", required=True)
    p.add_argument("--filelist", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    spec = cfg.capacity.octree_spec(cfg.model.depth, cfg.model.full_depth, 1)
    ds = ShapeNetDataset(
        args.location, args.filelist, cfg.data.point_scale,
        point_sample_num=1, points_per_shape=cfg.data.points_per_shape,
        load_sdf=False,
    )
    for i in range(len(ds)):
        s = ds[i]
        pts, nrm = (torch.as_tensor(s[k], device=dev)[None]
                    for k in ("points", "normals"))
        split = split_codec.octree2split_small(batch_to_octree(pts, nrm, spec))
        out = os.path.join(args.location, ds.filenames[i], "split_small.npz")
        np.savez(out, split_small=split[0].cpu().numpy())
        print(f"[{i + 1}/{len(ds)}] {ds.filenames[i]}")


if __name__ == "__main__":
    main()
