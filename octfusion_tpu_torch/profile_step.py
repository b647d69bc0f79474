"""Device-time profile of the port's steps at the full width of the
reference-parity model, fp32 with TF32 off, seeded random weights, on one
CUDA card.

Without options: one lr and one hr denoise step at batch 1 (default
configuration, caps from finest_cap 131072).  A two-step cascade grows
the depth-``depth_stop`` graph the hr step runs on; then each stage's
denoise call is warmed up and run ``--steps`` times.  ``hr_kpack`` is the
same hr step with the graph's levels packed, so its graph convs run the
packed kernel K5 instead of K1.  With ``--train``:
the hr-stage train step (``UnionSolver.make_train_step``; batch 4 of
65536-point lumpy spheres, ``configs/octfusion_snet_uncond.yaml``), with
fixed encoder eps, times and noise.

Each profiled call is warmed up, timed ``--steps`` times on the host clock
(device synchronised at the end) and run ``--steps`` times under
``torch.profiler``.  It prints the wall ms per step, the device ms per
step (the summed duration of the kernels, memcpys and memsets the trace
holds; one stream, so they do not overlap), the idle share
``1 - device / wall``, the device operations launched per step, and the
eight kernels that take the most device time, with their launches per
step.  The last line is the same as one JSON object.

Usage: ``python -m octfusion_tpu_torch.profile_step [--steps N] [--train]``.
"""

import argparse
import collections
import json
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .config import Config, load_config
from .models.union_solver import UnionSolver
from .octree.dual_graph import with_packed_levels
from .utils.shapes import lumpy_spheres

TOP = 8     # kernels listed per stage
SEED = 0
TRAIN_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "octfusion_snet_uncond.yaml")


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


def _train_step(dev, steps):
    cfg = load_config(TRAIN_CONFIG)
    torch.manual_seed(SEED)
    solver = UnionSolver(cfg, device=dev)
    b = cfg.data.batch_size
    pts, nrm = lumpy_spheres(b, cfg.data.points_per_shape, SEED, device=dev)
    batch = {"points": pts, "normals": nrm}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shape = solver.code_shape(b)
    draws = {"eps": torch.randn(shape, device=dev, generator=gen),
             "times": torch.rand(b, device=dev, generator=gen),
             "noise": torch.randn(shape, device=dev, generator=gen)}
    step = solver.make_train_step()
    return {"train": profile_stage(lambda: step(batch, **draws), steps)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5,
                    help="steps profiled per stage")
    ap.add_argument("--train", action="store_true",
                    help="profile the hr train step instead of the denoise "
                         "steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    result = (_train_step if args.train else _denoise_steps)(dev, args.steps)
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
