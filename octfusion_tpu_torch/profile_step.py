"""Device-time profile of the port's steps at the full width of the
reference-parity model, fp32 with TF32 off, seeded random weights, on one
CUDA card.

Without options: one lr and one hr denoise step at batch 1 (default
configuration, caps from finest_cap 131072).  A two-step cascade grows
the depth-``depth_stop`` graph the hr step runs on; then each stage's
denoise call is warmed up and run ``--steps`` times.  ``hr_kpack`` is the
same hr step with the graph's levels packed, so its graph convs run the
packed kernel K5 instead of K1.  With ``--train``, a train step of
``configs/octfusion_snet_uncond.yaml`` on seeded lumpy spheres of 65536
points, by ``--stage``:

* ``hr`` (default): the hr-stage step (``UnionSolver.make_train_step``,
  batch 4), with fixed encoder eps, times and noise;
* ``lr``: the lr-stage step (``stage_flag="lr"``, batch 4: the split grid
  built from the points), with fixed times and noise;
* ``vae``: the VAE step (``VAESolver.make_train_step``, batch 2 with
  ``data.point_sample_num`` SDF samples per shape, fixed eps) as
  ``vae_full``, its loss alone without the backward (``vae_fwd``) and the
  batch's octree and dual graph alone (``vae_graph``);
* ``hr_3t`` / ``feature``: the 3-stage model's hr (split_large) or
  feature step (``Union3TSolver.make_train_step``, batch 2), on the
  obja-3t-d10 configuration: ``configs/octfusion_obja_uncond.yaml`` over
  the depth-10 VAE of ``configs/vae_obja_depth1084.yaml``
  (``config.with_vae``), with fixed times and noise (and the feature
  stage's encoder eps), the lumpy spheres at ``SHAPE_SCALE_3T`` of their
  size so they fit the Objaverse caps.

``--stage hr_3t`` or ``feature`` without ``--train`` profiles that
stage's denoise step at batch 1 instead, on the graphs of a two-step
3-stage cascade from the split grid of a seeded lumpy sphere (depth 6
for ``hr_3t``, ``depth_stop`` 8 for ``feature``), and the same step on
the packed graph (``_kpack``, K5).

Each profiled call is warmed up, timed ``--steps`` times on the host clock
(device synchronised at the end) and run ``--steps`` times under
``torch.profiler``.  It prints the wall ms per step, the device ms per
step (the summed duration of the kernels, memcpys and memsets the trace
holds; one stream, so they do not overlap), the idle share
``1 - device / wall``, the device operations launched per step, and the
eight kernels that take the most device time, with their launches per
step.  The last line is the same as one JSON object.

Usage: ``python -m octfusion_tpu_torch.profile_step [--steps N]
[--train] [--stage hr|lr|vae|hr_3t|feature]``.
"""

import argparse
import collections
import json
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .config import Config, load_config, with_vae
from .models.common import batch_to_graph, batch_to_octree
from .models.union_3t_solver import Union3TSolver
from .models.union_solver import UnionSolver
from .models.vae_solver import VAESolver
from .octree import split_codec
from .octree.dual_graph import with_packed_levels
from .utils.device import use_fp32_math
from .utils.shapes import lumpy_sphere_batch, lumpy_spheres

TOP = 8     # kernels listed per stage
SEED = 0
VAE_BATCH = 2
_CONFIGS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
TRAIN_CONFIG = os.path.join(_CONFIGS, "octfusion_snet_uncond.yaml")
# the 3-stage model: diffusion, data, solver, train | model, capacity
CONFIG_3T = (os.path.join(_CONFIGS, "octfusion_obja_uncond.yaml"),
             os.path.join(_CONFIGS, "vae_obja_depth1084.yaml"))


# the lumpy spheres, sized for the default caps, overflow the Objaverse
# caps at depths 6-8 (4096 / 16384 / 65536 a sample); at 0.8 of their size
# they fit every level
SHAPE_SCALE_3T = 0.8


def config_3t() -> Config:
    """The obja-3t-d10 configuration (see the module docstring)."""
    return with_vae(*(load_config(p) for p in CONFIG_3T))


def _steps_wall_ms(fn, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def profile_stage(fn, steps):
    """-> wall and device ms per step, idle share, launches per step and
    the top kernels."""
    for _ in range(3):
        fn()
    wall = _steps_wall_ms(fn, steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name][0] += e.device_time_total / 1e3 / steps
            per_kernel[e.name][1] += 1
    device = sum(ms for ms, _ in per_kernel.values())
    if not device > 0:
        raise RuntimeError("the trace holds no device time")
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "wall_ms": wall, "device_ms": device, "idle_share": 1 - device / wall,
        "launches": sum(n for _, n in per_kernel.values()) / steps,
        "top": [{"kernel": name, "ms": ms, "share": ms / device,
                 "launches": n / steps} for name, (ms, n) in ranked],
    }


def _denoise_steps(dev, steps):
    cfg = Config()
    m = cfg.model
    torch.manual_seed(SEED)
    solver = UnionSolver(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        g = solver.sample(steps=2, generator=gen)["graph"]
    lvl = g.level(solver.small_depth)
    t = solver.log_snr(torch.tensor([0.5], device=dev))
    x_hr = torch.randn(lvl.g_cap, m.embed_dim, device=dev, generator=gen)
    x_hr = torch.where(lvl.node_mask[:, None], x_hr, torch.zeros_like(x_hr))
    s = 2**m.full_depth
    x_lr = torch.randn(1, s, s, s, 8, device=dev, generator=gen)
    x_lr_self = torch.zeros_like(x_lr)
    g_packed = with_packed_levels(g)
    with torch.no_grad():
        return {
            "hr": profile_stage(lambda: solver.df("hr", x_hr, t, g=g), steps),
            "hr_kpack": profile_stage(
                lambda: solver.df("hr", x_hr, t, g=g_packed), steps),
            "lr": profile_stage(
                lambda: solver.df("lr", x_lr, t, x_self_cond=x_lr_self),
                steps),
        }


def _denoise_steps_3t(dev, steps, stage):
    cfg = config_3t()
    torch.manual_seed(SEED)
    solver = Union3TSolver(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pts, nrm = lumpy_spheres(1, cfg.data.points_per_shape, SEED, device=dev)
    split = split_codec.octree2split_small(
        batch_to_octree(pts * SHAPE_SCALE_3T, nrm, solver.spec1))
    with torch.no_grad():
        out = solver.sample(steps=2, split_small=split, generator=gen,
                            compute_sdf=False)
    if stage == "hr_3t":
        g, depth, c, kind = out["graph_small"], solver.hr_depth, 8, "hr"
    else:
        g, depth, c, kind = (out["graph"], solver.code_depth,
                             cfg.model.embed_dim, "feature")
    lvl = g.level(depth)
    t = solver.log_snr(torch.tensor([0.5], device=dev))
    x = torch.randn(lvl.g_cap, c, device=dev, generator=gen)
    x = torch.where(lvl.node_mask[:, None], x, torch.zeros_like(x))
    g_packed = with_packed_levels(g)
    with torch.no_grad():
        return {
            stage: profile_stage(lambda: solver.df(kind, x, t, g=g), steps),
            f"{stage}_kpack": profile_stage(
                lambda: solver.df(kind, x, t, g=g_packed), steps),
        }


def _train_step(dev, steps, stage):
    cfg = (config_3t() if stage in ("hr_3t", "feature")
           else load_config(TRAIN_CONFIG))
    torch.manual_seed(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if stage == "vae":
        solver = VAESolver(cfg, device=dev)
        batch = lumpy_sphere_batch(VAE_BATCH, cfg.data.points_per_shape,
                                   cfg.data.point_sample_num, SEED, dev)
        eps = torch.randn(solver.code_shape(VAE_BATCH), device=dev,
                          generator=gen)
        step = solver.make_train_step()

        def forward():
            with torch.no_grad():
                solver.loss_fn(batch, eps=eps)

        return {
            "vae_full": profile_stage(lambda: step(batch, eps=eps), steps),
            "vae_fwd": profile_stage(forward, steps),
            "vae_graph": profile_stage(lambda: batch_to_graph(
                batch["points"], batch["normals"], solver.spec1,
                solver.edge_factor), steps),
        }
    b = cfg.data.batch_size
    pts, nrm = lumpy_spheres(b, cfg.data.points_per_shape, SEED, device=dev)
    batch = {"points": pts, "normals": nrm}
    s = 2**cfg.model.full_depth
    if stage in ("hr_3t", "feature"):
        batch["points"] = pts * SHAPE_SCALE_3T
        solver = Union3TSolver(cfg, stage_flag=stage.replace("_3t", ""),
                               device=dev)
        shape = solver.train_shape(b)
    else:
        solver = UnionSolver(cfg, stage_flag=stage, device=dev)
        shape = (solver.code_shape(b) if stage == "hr" else (b, s, s, s, 8))
    draws = {"times": torch.rand(b, device=dev, generator=gen),
             "noise": torch.randn(shape, device=dev, generator=gen)}
    if stage in ("hr", "feature"):
        draws["eps"] = torch.randn(shape, device=dev, generator=gen)
    step = solver.make_train_step()
    return {f"train_{stage}": profile_stage(lambda: step(batch, **draws),
                                            steps)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5,
                    help="steps profiled per stage")
    ap.add_argument("--train", action="store_true",
                    help="profile a train step instead of the denoise "
                         "steps")
    ap.add_argument("--stage", choices=("hr", "lr", "vae", "hr_3t",
                                        "feature"), default="hr",
                    help="the train step --train profiles; hr_3t and "
                         "feature also the 3-stage denoise steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    use_fp32_math()
    dev = torch.device("cuda")
    if args.train:
        result = _train_step(dev, args.steps, args.stage)
    elif args.stage in ("hr_3t", "feature"):
        result = _denoise_steps_3t(dev, args.steps, args.stage)
    else:
        result = _denoise_steps(dev, args.steps)
    for stage, r in result.items():
        print(f"{stage}: wall_ms/step={r['wall_ms']:.3f} "
              f"device_ms/step={r['device_ms']:.3f} "
              f"idle_share={r['idle_share']:.3f} "
              f"launches/step={r['launches']:g}", flush=True)
        for k in r["top"]:
            print(f"  {k['ms']:9.4f} ms {k['share']:6.1%} "
                  f"x{k['launches']:g}  {k['kernel'][:100]}", flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
