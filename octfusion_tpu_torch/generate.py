"""Generate shapes with the union diffusion model: the counterpart of
``train.py --model union --stage hr --mode generate`` on one device.

    python -m octfusion_tpu_torch.generate \\
        --config configs/octfusion_snet_uncond.yaml --name run --count 4 \\
        --sampler dpmpp --sample_steps 25 [--device cpu]

Each shape runs the whole cascade (``UnionSolver.sample``: lr sampling,
grow, hr sampling, growing decode), then the SDF grid and marching
tetrahedra on the device, and is written to
``<logs_dir>/<name>/results_<category>/<i>.obj``.  The diffusion model takes
the EMA weights of ``--ckpt`` or of the run's latest checkpoint
(``<logs_dir>/<name>/ckpt``), in the reference's checkpoint layout; the
VAE those of ``--vq_ckpt`` (a reference ``.pth`` or a bare state dict).
Without them the weights are random, seeded from ``--seed``.  Shape i
draws its noise from a generator seeded from (seed, i) alone, so it does
not depend on ``--count`` or on which shapes were made before; indices
whose ``.obj`` exists are skipped.  ``OCTFUSION_CONV_KPACK=1`` runs the
depth-``depth_stop`` graph convs through the packed kernel K5.

Runs on the card unless ``--device cpu``; without a card the default
raises.  Computes in fp32 with TF32 off, as the reference.  Prints ``[*] wrote <path>`` per mesh, then one line with the
stage seconds per shape, the graph-conv kernels' launches and the peak
memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import time

import numpy as np
import torch

from . import config as config_lib
from .data.shapenet import category_5_to_label
from .models.union_solver import UnionSolver
from .ops import graph_conv_cuda
from .utils import ckpt as ckpt_lib
from .utils import params as params_lib
from .utils import sdf as sdf_utils
from .utils.device import peak_memory, resolve_device, use_fp32_math


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--name", default=None)
    p.add_argument("--logs_dir", default=None)
    p.add_argument("--ckpt", default=None,
                   help="diffusion checkpoint (reference layout); default: "
                        "the run's latest")
    p.add_argument("--vq_ckpt", default=None,
                   help="frozen VAE checkpoint (.pth)")
    p.add_argument("--category", default="airplane")
    p.add_argument("--count", type=int, default=4,
                   help="number of shapes to generate")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--sampler", choices=["ancestral", "dpmpp"], default=None,
                   help="override diffusion.sampler (dpmpp = "
                        "DPM-Solver++(2M))")
    p.add_argument("--sample_steps", type=int, default=None,
                   help="override diffusion.ddim_steps")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def configure(args) -> config_lib.Config:
    """The config file of ``args.config`` with the run name, logs
    directory, sampler and sampling steps of ``args`` where given."""
    cfg = config_lib.load_config(args.config)
    train = {k: v for k, v in (("name", args.name),
                               ("logs_dir", args.logs_dir)) if v}
    diff = {k: v for k, v in (("sampler", args.sampler),
                              ("ddim_steps", args.sample_steps)) if v}
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, **train),
        diffusion=dataclasses.replace(cfg.diffusion, **diff))


def shape_seed(seed: int, i: int) -> int:
    """The seed of shape ``i``'s generator: a function of (seed, i) only."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1)[0])


def _load_weights(solver, args, ckpt_dir) -> None:
    path = args.ckpt or ckpt_lib.latest_path(ckpt_dir)
    if path:
        params_lib.load_union_checkpoint(solver.df, ckpt_lib.restore(path))
        print(f"[*] loaded EMA diffusion weights from {path}")
    else:
        print(f"[warn] no --ckpt given and none in {ckpt_dir}; using random "
              "diffusion weights")
    if args.vq_ckpt:
        params_lib.load_vae_checkpoint(solver.vae, args.vq_ckpt)
        print(f"[*] loaded VAE weights from {args.vq_ckpt}")
    else:
        print("[warn] no --vq_ckpt given; using random VAE weights")


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    use_fp32_math()
    cfg = configure(args)
    run_dir = os.path.join(cfg.train.logs_dir, cfg.train.name)
    rdir = os.path.join(run_dir, f"results_{args.category}")
    os.makedirs(rdir, exist_ok=True)

    todo = [i for i in range(args.count)
            if not os.path.exists(os.path.join(rdir, f"{i}.obj"))]
    if len(todo) < args.count:
        print(f"[*] {args.count - len(todo)}/{args.count} meshes already "
              "present; generating the rest")
    if not todo:
        return []

    torch.manual_seed(args.seed)
    solver = UnionSolver(cfg, stage_flag="hr", device=dev)
    _load_weights(solver, args, os.path.join(run_dir, "ckpt"))
    label = None
    if cfg.diffusion.num_classes is not None:
        label = torch.full((1,), category_5_to_label[args.category],
                           dtype=torch.int64, device=dev)

    m, sscale = cfg.model, cfg.solver.sdf_scale
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    stages, written = [], []
    for i in todo:
        path = os.path.join(rdir, f"{i}.obj")
        gen = torch.Generator(device=dev).manual_seed(shape_seed(args.seed, i))
        out = solver.sample(batch_size=1, label=label, generator=gen,
                            compute_sdf=False)
        if bool(out["overflow"]):
            print(f"[!] static capacity overflow while generating {path} -- "
                  "raise capacity.finest_cap/edge_factor")
        dec = out["decode_out"]
        seconds = dict(out["seconds"])
        t0 = time.perf_counter()
        sdfs = sdf_utils.calc_sdf(
            dec["reg_voxs"][m.depth_out], dec["octree_out"], m.full_depth,
            m.depth_out, size=cfg.solver.resolution, bbmin=-sscale,
            bbmax=sscale)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        seconds["sdf"] = t1 - t0
        done = sdf_utils.export_meshes(sdfs, [path], bbmin=-sscale,
                                       bbmax=sscale,
                                       mesh_scale=cfg.data_test.point_scale)
        seconds["mesh"] = time.perf_counter() - t1
        stages.append(seconds)
        if done[0] is None:
            print(f"[!] empty mesh, skipped {path}")
            continue
        written.append(path)
        print(f"[*] wrote {path}", flush=True)

    print(summary(stages, dev), flush=True)
    return written


def summary(stages, dev) -> str:
    """The closing line of a generation run: the mean seconds per shape
    of each stage in ``stages`` (one dict per shape) and their sum, the
    graph-conv kernels' launches and the peak memory."""
    per_shape = {k: statistics.mean(s[k] for s in stages) for k in stages[0]}
    return (f"[*] generated {len(stages)} shapes on {dev}: "
            f"s_per_shape={sum(per_shape.values()):.3f} "
            + " ".join(f"{k}_s={v:.3f}" for k, v in per_shape.items())
            + "".join(f" {k}_launches={n}"
                      for k, n in graph_conv_cuda.launches.items() if n)
            + " " + peak_memory(dev))


if __name__ == "__main__":
    main()
