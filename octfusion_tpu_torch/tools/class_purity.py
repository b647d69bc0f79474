"""Class consistency of conditional generation (port of the JAX
package's ``tools/class_purity.py``).

The reference's conditional workload conditions the lr / hr U-Nets on a
5-class label embedding but ships no class metric.  On the synthetic
family stand-in (``data.class_families``) it is measurable: each
generated mesh takes the class of its Chamfer-nearest reference cloud,
and purity is the share that took the conditioning class (chance: one
over the classes).

    python -m octfusion_tpu_torch.tools.class_purity --root logs/cond_hr \\
        --config configs/synthetic_cond.yaml [--refs_per_class 16] \\
        [--points 1024] [--out purity.json]

Expects a sample dir ``results_<category>`` per class under ``--root``
(label order of ``data/shapenet.category_5_to_label``).  Reference and
sample clouds are normalised to a unit bounding box; the reference points
are drawn by a numpy generator seeded 0, mesh i's samples with seed
1000 + i.  Prints a line per class and the overall purity, then the
result as one JSON object.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from ..config import load_config
from ..data.dataset import get_dataset
from ..data.shapenet import category_5_to_label
from ..metrics.distances import pairwise_cd_emd
from ..utils import mesh as mesh_utils
from ..utils.device import resolve_device


def normalise(v: np.ndarray) -> np.ndarray:
    """Centre the bounding box at the origin, its longest side 1."""
    centre = (v.min(0) + v.max(0)) / 2
    scale = (v.max(0) - v.min(0)).max()
    return (v - centre) / max(scale, 1e-9)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="run dir containing results_<category>/ subdirs")
    ap.add_argument("--config", required=True)
    ap.add_argument("--refs_per_class", type=int, default=16)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    if not cfg.data.class_families:
        raise SystemExit("the config must set data.class_families")
    ds = get_dataset(cfg.data)
    n_cls = cfg.diffusion.num_classes
    rng = np.random.RandomState(0)

    # reference clouds per class, normalised like the samples
    ref, ref_lab = [], []
    for c in range(n_cls):
        for idx in list(range(c, len(ds), n_cls))[:args.refs_per_class]:
            pts = ds[idx]["points"]
            ref.append(normalise(pts[rng.randint(0, len(pts), args.points)]))
            ref_lab.append(c)
    ref_t = torch.as_tensor(np.stack(ref).astype(np.float32), device=dev)
    ref_lab = np.asarray(ref_lab)

    classes = sorted(((c, l) for c, l in category_5_to_label.items()
                      if l < n_cls), key=lambda kv: kv[1])
    per_class, n_total, n_pure = {}, 0, 0
    for cat, label in classes:
        paths = sorted(glob.glob(os.path.join(args.root, f"results_{cat}",
                                              "*.obj")))
        clouds = []
        for i, p in enumerate(paths):
            v, f = mesh_utils.load_obj(p)
            if len(f):
                clouds.append(mesh_utils.sample_surface(
                    normalise(v), f, args.points, seed=1000 + i))
        if not clouds:
            print(f"[warn] no meshes for class {label} ({cat})")
            per_class[cat] = {"n": 0, "purity": 0.0}
            continue
        s = torch.as_tensor(np.stack(clouds).astype(np.float32), device=dev)
        d, _ = pairwise_cd_emd(s, ref_t, emd=False)    # [samples, refs]
        pred = ref_lab[np.argmin(d, axis=1)]
        pure = int((pred == label).sum())
        # the confusion row, and the margin: the mean CD to the own class
        # over the best class's (near 1: boundary blurs; large: another
        # family)
        conf = {c: int((pred == lab).sum()) for c, lab in classes}
        own = float(np.mean([d[i, ref_lab == label].min()
                             for i in range(len(clouds))]))
        best = float(d.min(1).mean())
        per_class[cat] = {
            "n": len(clouds), "purity": pure / len(clouds),
            "confusion": conf, "mean_own_class_cd": own,
            "mean_best_cd": best, "margin": own / max(best, 1e-9)}
        n_total += len(clouds)
        n_pure += pure
        print(f"[class {label} {cat:9s}] n={len(clouds):3d} purity="
              f"{pure / len(clouds):.2f}  margin="
              f"{per_class[cat]['margin']:.2f}  confusion={conf}")

    res = {"per_class": per_class,
           "overall_purity": n_pure / max(n_total, 1),
           "n_total": n_total, "chance": 1.0 / n_cls}
    print(f"[overall] purity {res['overall_purity']:.3f} over {n_total} "
          f"meshes (chance {res['chance']:.2f})")
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=2)
    return res


if __name__ == "__main__":
    main()
