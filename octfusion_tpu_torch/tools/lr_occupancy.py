"""Diagnose the lr stage's split occupancy from a trained checkpoint
(port of the JAX package's ``tools/lr_occupancy.py``).

The unconditional lr diffusion stage denoises the depth-full_depth split
grid, whose ground truth is ~95% empty; an under-trained model collapses
toward the all-empty grid, which the ancestral sampler's sign snapping
below the truncation time then locks in.  This tool samples ``--count``
split grids per sampler from the EMA lr U-Net of a run's latest
checkpoint (an lr, hr or 3-stage run: only ``ema_df_unet_lr`` is read)
and compares their positive-entry occupancy with the dataset's ground
truth (``--gt_count`` shapes): a cheap check before the cascade's
downstream stages.

    python -m octfusion_tpu_torch.tools.lr_occupancy \\
        --config configs/synthetic_medium_v2.yaml --run logs/lr \\
        [--count 32] [--samplers ancestral,ddim,dpmpp] [--steps 100]

``ddim`` is the ancestral loop with eta 0; ``dpmpp`` runs half the
steps.  Sample i of a sampler draws from a generator seeded from
(``--seed``, i).  Prints one line per set, then the results as one JSON
object.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from ..config import load_config
from ..data.dataset import collate, get_dataset
from ..generate import shape_seed
from ..models.common import batch_to_device, batch_to_octree
from ..models.union_solver import UnionSolver
from ..octree import split_codec
from ..utils import ckpt as ckpt_lib
from ..utils.device import resolve_device, use_fp32_math


def _stats(fracs: np.ndarray) -> dict:
    return {"n": len(fracs), "mean": float(fracs.mean()),
            "median": float(np.median(fracs)), "min": float(fracs.min()),
            "max": float(fracs.max())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--run", required=True,
                    help="run dir containing ckpt/ (e.g. logs/lr)")
    ap.add_argument("--count", type=int, default=32)
    ap.add_argument("--gt_count", type=int, default=64)
    ap.add_argument("--samplers", default="ancestral,ddim,dpmpp")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    use_fp32_math()
    cfg = load_config(args.config)
    ds = get_dataset(cfg.data)
    solver = UnionSolver(cfg, stage_flag="lr", device=dev)

    # ground-truth occupancy over dataset shapes
    gt = []
    for i in range(args.gt_count):
        b = batch_to_device(collate([ds[i % len(ds)]]), dev)
        split = split_codec.octree2split_small(
            batch_to_octree(b["points"], b["normals"], solver.spec1))
        gt.append(float((split > 0).float().mean()))
    res = {"gt": _stats(np.asarray(gt))}
    g = res["gt"]
    print(f"[gt]  n={g['n']}  occupancy mean {g['mean']:.4f}  median "
          f"{g['median']:.4f}  min {g['min']:.4f}  max {g['max']:.4f}")

    path = ckpt_lib.latest_path(os.path.join(args.run, "ckpt"))
    if path is None:
        raise SystemExit(f"no checkpoint under {args.run}/ckpt")
    tree = ckpt_lib.restore(path)
    weights = tree["ema_df_unet_lr"]
    step = tree.get("train_state", {}).get("step")
    print(f"[ckpt] {path} (step {step})")

    steps = args.steps or cfg.diffusion.ddim_steps
    for name in (n.strip() for n in args.samplers.split(",")):
        eta = 0.0 if name == "ddim" else 1.0
        cfg_s = dataclasses.replace(cfg, diffusion=dataclasses.replace(
            cfg.diffusion,
            sampler="dpmpp" if name == "dpmpp" else "ancestral"))
        sv = UnionSolver(cfg_s, stage_flag="lr", device=dev)
        sv.df.unet_lr.load_state_dict(weights, strict=True)
        n_steps = steps // 2 if name == "dpmpp" else steps
        fracs = []
        for i in range(args.count):
            gen = torch.Generator(device=dev).manual_seed(
                shape_seed(args.seed, i))
            split = sv.sample_lr(1, steps=n_steps, eta=eta, generator=gen)
            fracs.append(float((split > 0).float().mean()))
        fracs = np.asarray(fracs)
        r = res[name] = {**_stats(fracs), "steps": n_steps,
                         "all_empty": float((fracs == 0).mean()),
                         "gt_ratio": float(fracs.mean()
                                           / max(g["mean"], 1e-9))}
        print(f"[{name:9s}] steps={n_steps:3d}  occupancy mean "
              f"{r['mean']:.4f}  median {r['median']:.4f}  min "
              f"{r['min']:.4f}  max {r['max']:.4f}  all-empty "
              f"{100 * r['all_empty']:.0f}%  (gt-ratio {r['gt_ratio']:.2f})")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
