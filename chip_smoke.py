"""Smoke run of the PyTorch port (``octfusion_tpu_torch``) on one NVIDIA GPU.

Drives the port's main paths (sampling and hr training at the full width
of the reference-parity model with seeded random weights, the evaluation
metrics from meshes at the reference's 2048-point protocol, and the
DPM-Solver++ generation path with its CLI), and checks the hand-written
CUDA kernels they run (the graph conv's K1 forward, K2 column buffer, K3
input gradient and K5 packed forward; the Chamfer kernel K4):

1. device: the card's name and power limit; TF32 off for matmul and cuDNN;
2. build: ``graph_conv.cu`` and ``chamfer.cu`` are compiled from
   ``octfusion_tpu_torch/csrc``, one ``nvcc`` each, both at once;
3. K1 vs plain: on the graph levels 4-8 of a short warm-up cascade, at
   every (C, C') pair the cascade's graph convs use, the kernel against its
   plain PyTorch version on the same tensors (rtol = atol = 1e-4), timed
   with CUDA events beside its bound (``ops/roofline.py``);
4. one full-width hr denoise step on the card (kernel) against the CPU
   (plain path), same weights and inputs (rtol = atol = 1e-3);
5. the generation cascade (``UnionSolver.sample``: lr sampling, grow, hr
   sampling, growing VAE decode, 256³ SDF grid; depth 8, caps from
   finest_cap 131072, 200 + 200 ancestral steps, fp32, batch 1), with K1's
   launch count checked against the number of GraphConv calls, stage
   seconds, node counts, overflow flags and peak memory; the decoded SDF
   grid must be finite, and a mesh is extracted from the analytic
   lumpy-sphere planes over the grown octree (random weights decode noise,
   so iso-surfacing the decoded field would measure a pathological
   surface);
6. K1, K2 and K3 vs plain at the training shapes: at every (level, C, C')
   the hr train step's graph convs use on the batch-4 training graph (K1:
   the frozen encoder's levels 6-8 and the hr U-Net's levels 4-6; K2 and
   K3: the differentiable convs of levels 4-6), each kernel against its
   plain version on the same tensors (rtol = atol = 1e-4), timed with CUDA
   events;
7. one full-width hr train step (``UnionSolver.loss_fn`` and its backward)
   on the card against the CPU, batch 1, all weights perturbed with seeded
   noise (the zero-initialised convs would otherwise give trivially zero
   gradient blocks), the same injected encoder eps, times and noise: the
   loss and every trainable gradient (rtol = atol = 1e-3, and each leaf's
   largest error within 1e-4 of its own largest |gradient|, which is
   printed), and every hr U-Net parameter must get a gradient that is not
   all zero;
8. training (``UnionSolver.make_train_step``; the hr stage of
   ``configs/octfusion_snet_uncond.yaml``: batch 4, 65536 points per shape
   from seeded lumpy spheres with exact normals): ``TRAIN_STEPS`` (12)
   steps on one fixed batch with fixed times and noise.  The graph must
   not overflow, the loss must be finite and fall, the frozen lr U-Net
   must stay bit for bit, K1 launches must equal the GraphConv forward calls (encoder and
   checkpoint recomputes included) and K2 launches = K3 launches = the
   backward calls of the graph conv; it prints the median ms/step after 2
   warm-up steps, the stage split and the peak memory;
9. K4 vs plain: the 2048-point evaluation protocol at B = 16, 64 and 256
   pairs, the ragged B = 2, N = 700, M = 1100, and near-duplicate clouds
   (a and a + 1e-3 noise), all in the unit cube: the kernel against its
   plain version (rtol 1e-4, atol 1e-6), with kernel / plain / library
   (``torch.cdist`` squared and both minima, a yardstick the port never
   calls) / bound ms and the share of the bound; then CD (K4), EMD fp32
   and EMD bf16-stored pairs/s at B = 16, 64, 256, and bf16 vs fp32 EMD
   at B = 16 (rtol 2.5e-3);
10. evaluation (``python -m octfusion_tpu_torch.evaluate``): 32 sample and
   32 reference ``.obj`` meshes, marching tetrahedra over seeded
   lumpy-sphere fields on a 64³ grid from two seeds, to 1-NNA / COV / MMD
   over CD and EMD at 2048 points and batch 8 on the card.  Every metric
   must be finite, COV and 1-NNA in [0, 1], K4 launches = the tiles of the
   three matrices, and the first 8 x 8 block of the CD and EMD matrices
   equal to the CPU plain path's on the same clouds (CD rtol 1e-4, atol
   1e-6; EMD rtol 1e-3).  Prints the metrics, pairs/s and peak memory;
11. K5 vs plain and vs K1 (run right after phase 3, on its warm-up graph):
   at every (level, C, C') of levels 4-6 that phase 3 saw (the hr U-Net's
   convs and the decoder's depth-6 convs, which K5 runs when the sampling
   graph is packed) and the ragged 515 -> 512 and 131 -> 128, K5 against
   its plain version (rtol = atol = 1e-4), timed with K1 on the same
   tensors (CUDA events, median of 20) beside its bound at the TF32
   tensor-core rate; then K5 under autograd must raise, launching nothing;
12. the DPM-Solver++(2M) cascade at full width (``Config()`` with
   ``sampler="dpmpp"``, 25 + 25 steps, batch 1, 256³ SDF grid), seeded
   weights perturbed with seeded noise (the zero-initialised hr output
   conv would otherwise make the hr stage ignore its convs) and the same
   injected initial noise, once with ``kpack=True`` (K5 on the packed
   depth <= 6 graph) and once with ``kpack=False`` (K1): the same octree
   and graph, codes within 1e-3 of their own max |code|, finite codes and
   grid, K5 launches = the GraphConv calls on packed levels and K1
   launches = the rest; prints each run's stage seconds and peak memory;
13. the CLI, ``python -m octfusion_tpu_torch.generate`` as a subprocess
   with ``OCTFUSION_CONV_KPACK=1``: 4 shapes at full width with ``--sampler
   dpmpp --sample_steps 25`` from the phase-12 weights, which the phase
   first writes with ``utils/ckpt.save`` (reference checkpoint layout, and
   the VAE's ``autoencoder`` entry), into a temp dir, with a temp config
   whose one change is ``solver.resolution: 64`` (random weights decode
   noise, whose 256³ mesh is ~10^8 faces of text): 4 non-empty ``.obj``
   files, 4 ``[*] wrote`` lines and K5 launches in its summary line; a
   second run must skip all 4.

Prints the kernel summary as a JSON line (each kernel's ``launches`` is
its count over the counted runs of phases 5, 8 and 12, K4's over phase
10; ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` sum the shapes
of phases 3 and 6, 9, or 11, and K5's ``k1_ms`` is K1 on phase 11's
shapes; ``bound_by`` is the larger of the summed operation and byte
times), then the card's name and power limit, and last ``{"ok": true,
"device": {...}}``.  Any failure raises: there is no CPU fallback.  The
run uses one card, the first visible one.  Usage:
``python3 chip_smoke.py [--steps N] [--seed S]``.
"""

import argparse
import concurrent.futures
import copy
import dataclasses
import glob
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np

# One card: expose only the first visible device, so the device count
# reported on the last line is the number of cards the run used.
_visible = os.environ.get("CUDA_VISIBLE_DEVICES")
os.environ["CUDA_VISIBLE_DEVICES"] = ("0" if _visible is None
                                      else _visible.split(",")[0])

import torch  # noqa: E402  (after the device pinning above)

TOL_KERNEL = dict(rtol=1e-4, atol=1e-4)  # fp32, different summation order
TOL_STEP = dict(rtol=1e-3, atol=1e-3)    # fp32 through ~40 layers
TOL_GRAD_SCALE = 1e-4   # card vs CPU gradient error / the leaf's max |grad|
RESOLUTION = 256        # SDF grid side, as the reference
TRAIN_STEPS = 12        # phase 8; at least 10, the first 2 are warm-up
TRAIN_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "configs", "octfusion_snet_uncond.yaml")
# phases 9 and 10
EVAL_POINTS = 2048      # points per cloud, the reference's protocol
TOL_CHAMFER = dict(rtol=1e-4, atol=1e-6)   # fp32 clouds in the unit cube
TOL_EMD_CARD = dict(rtol=1e-3, atol=0.0)   # card vs CPU: reduction order
TOL_EMD_BF16 = dict(rtol=2.5e-3, atol=0.0)
# phase 9: (case, B, N, M)
CHAMFER_CASES = [("eval", 16, EVAL_POINTS, EVAL_POINTS),
                 ("eval", 64, EVAL_POINTS, EVAL_POINTS),
                 ("eval", 256, EVAL_POINTS, EVAL_POINTS),
                 ("ragged", 2, 700, 1100),
                 ("near_duplicate", 16, EVAL_POINTS, EVAL_POINTS)]
# phase 10
EVAL_SHAPES = 32        # sample meshes, and as many reference meshes
EVAL_GRID = 64
EVAL_BATCH = 8
EVAL_ROW_BLOCK = 4      # pairwise_cd_emd's default
EVAL_BLOCK = 8          # card vs CPU block of the matrices
# phases 11-13
RAGGED_PACKED = {(4, 515, 512), (6, 131, 128)}   # (level, C, C')
DPMPP_STEPS = 25        # per stage, as bench.py's dpmpp_25step_s_per_shape
TOL_KPACK_CODE = 1e-3   # K5 vs K1 codes / max |code|
CLI_SHAPES = 4
CLI_RESOLUTION = 64
REPO = os.path.dirname(os.path.abspath(__file__))
_CSRC = "octfusion_tpu_torch/csrc"
SOURCES = {"graph_conv_fwd": f"{_CSRC}/graph_conv.cu",
           "graph_conv_col": f"{_CSRC}/graph_conv.cu",
           "graph_conv_bwd_dx": f"{_CSRC}/graph_conv.cu",
           "chamfer": f"{_CSRC}/chamfer.cu",
           "graph_conv_fwd_packed": f"{_CSRC}/graph_conv.cu"}
_PALLAS = "octfusion_tpu/ops/pallas/graph_conv_kernel.py"
REPLACES = {"graph_conv_fwd": f"{_PALLAS}:41",
            "graph_conv_col": f"{_PALLAS}:80",
            "graph_conv_bwd_dx": f"{_PALLAS}:110",
            "chamfer": "octfusion_tpu/ops/pallas/chamfer_kernel.py:30",
            "graph_conv_fwd_packed": f"{_PALLAS}:297"}


@dataclasses.dataclass
class KernelStats:
    """One kernel over the shapes a phase checks it at: the largest error,
    and the summed median times of the kernel, its plain version and the
    library yardstick, and of its bound (with the operation and byte
    times behind it)."""
    max_abs_err: float = 0.0
    ms: float = 0.0
    plain_ms: float = 0.0
    bound_ms: float = 0.0
    ops_ms: float = 0.0
    bytes_ms: float = 0.0
    library_ms: Optional[float] = None
    k1_ms: Optional[float] = None

    def add(self, err, ms, plain_ms, cost, library_ms=None, flops_rate=None,
            k1_ms=None) -> float:
        """Adds one shape, ``cost`` = (flops, bytes) with the flops at
        ``flops_rate`` (default: the fp32 peak); returns its bound."""
        from octfusion_tpu_torch.ops import roofline

        ops, nbytes = roofline.times_ms(
            *cost, flops_rate=flops_rate or roofline.FP32_FLOPS)
        bound = max(ops, nbytes)
        if k1_ms is not None:
            self.k1_ms = (self.k1_ms or 0.0) + k1_ms
        self.max_abs_err = max(self.max_abs_err, err)
        self.ms += ms
        self.plain_ms += plain_ms
        self.bound_ms += bound
        self.ops_ms += ops
        self.bytes_ms += nbytes
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + library_ms
        return bound

    def merge(self, other: "KernelStats") -> None:
        self.max_abs_err = max(self.max_abs_err, other.max_abs_err)
        for f in ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms"):
            setattr(self, f, getattr(self, f) + getattr(other, f))

    def entry(self) -> dict:
        out = {"max_abs_err": self.max_abs_err, "ms": self.ms,
               "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
               "bound_by": ("operations" if self.ops_ms >= self.bytes_ms
                            else "bytes"),
               "library_ms": self.library_ms}
        if self.k1_ms is not None:
            out["k1_ms"] = self.k1_ms
        return out


def smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def analytic_reg(octree, full_depth, depth_out):
    """Per-node lumpy-sphere planes (n, r - radius) over ``octree``: the same
    shapes as the decoder's planes, a realistic iso-surface."""
    out = {}
    for dd in range(full_depth, depth_out + 1):
        x, y, z, _ = octree.xyzb(dd)
        c = (torch.stack([x, y, z], -1).float() + 0.5) / 2**dd * 2.0 - 1.0
        r = c.norm(dim=-1, keepdim=True)
        n = c / r.clamp(min=1e-9)
        rad = 0.55 + 0.08 * torch.sin(5 * c[:, :1]) * torch.cos(4 * c[:, 1:2])
        reg = torch.cat([n, r - rad], -1)
        out[dd] = torch.where(octree.node_mask(dd)[:, None], reg,
                              torch.zeros_like(reg))
    return out


def perturb_(modules, gen, scale=0.02):
    """Add seeded noise to every parameter, so no layer is zero."""
    with torch.no_grad():
        for mod in modules:
            for p in mod.parameters():
                p.add_(scale * torch.randn(p.shape, generator=gen).to(p))


def conv_shape_hooks(modules, shapes):
    """Forward hooks noting (level, C incl. node types, C') of every
    GraphConv call; returns the handles."""
    from octfusion_tpu_torch.nn.modules import GraphConv

    def hook(mod, args, out):
        w = mod.weights
        shapes.add((args[1].d, w.shape[0] // 7, w.shape[1]))

    return [m.register_forward_hook(hook) for mod in modules
            for m in mod.modules() if isinstance(m, GraphConv)]


def check_kernel(graph, shapes, gen) -> KernelStats:
    """Phases 3 and 6: K1 vs its plain version at each (level, C, C') of
    ``graph``."""
    from octfusion_tpu_torch.ops import graph_conv_cuda as k1
    from octfusion_tpu_torch.ops import roofline

    dev = torch.device("cuda")
    stats = KernelStats()
    for d, c, cout in sorted(shapes):
        lvl = graph.level(d)
        row_ptr, col, scale = lvl.csr()
        x = torch.randn(lvl.g_cap, c, device=dev, generator=gen)
        w = torch.randn(7 * c, cout, device=dev, generator=gen) / (7 * c) ** 0.5
        got = k1.graph_conv(x, w, row_ptr, col, scale)
        ref = k1.graph_conv_plain(x, w, lvl.edge_row, lvl.edge_col,
                                  lvl.edge_dir, lvl.edge_scale)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        if not ref_max > 0:
            raise AssertionError(f"all-zero reference at d={d} C={c}")
        torch.testing.assert_close(got, ref, **TOL_KERNEL)
        tk = cuda_ms(lambda: k1.graph_conv(x, w, row_ptr, col, scale))
        tp = cuda_ms(lambda: k1.graph_conv_plain(
            x, w, lvl.edge_row, lvl.edge_col, lvl.edge_dir, lvl.edge_scale))
        e = int(lvl.n_edges)
        bound = stats.add(err, tk, tp,
                          roofline.graph_conv_fwd_cost(lvl.g_cap, c, cout, e))
        print(f"k1 d={d} G={lvl.g_cap} E={e} C={c} C'={cout}"
              f" max_abs_err={err:.3e} max_rel_err={err / ref_max:.3e}"
              f" tol=rtol {TOL_KERNEL['rtol']:g} atol {TOL_KERNEL['atol']:g}"
              f" kernel_ms={tk:.4f} plain_ms={tp:.4f} bound_ms={bound:.4f}",
              flush=True)
    return stats


def check_hr_step(solver, g, seed):
    """Phase 4: one full-width hr denoise step, card vs CPU.  Every weight
    gets seeded noise so zero-initialised layers carry signal."""
    df = copy.deepcopy(solver.df).cpu()
    gen = torch.Generator().manual_seed(seed)
    perturb_([df], gen)
    lvl = g.level(solver.small_depth)
    x = torch.randn(lvl.g_cap, solver.cfg.model.embed_dim, generator=gen)
    x = torch.where(lvl.node_mask.cpu()[:, None], x, torch.zeros_like(x))
    t = solver.log_snr(torch.tensor([0.5]))
    with torch.no_grad():
        ref = df("hr", x, t, g=g.to("cpu"))
        dev = torch.device("cuda")
        got = df.to(dev)("hr", x.to(dev), t.to(dev), g=g).cpu()
    err = (got - ref).abs().max().item()
    print(f"hr_step G={lvl.g_cap} max_abs_err={err:.3e} "
          f"max_abs_ref={ref.abs().max().item():.3e} "
          f"tol=rtol {TOL_STEP['rtol']:g} atol {TOL_STEP['atol']:g}",
          flush=True)
    torch.testing.assert_close(got, ref, **TOL_STEP)


def check_backward_kernels(graph, shapes, gen):
    """Phase 6: K2 and K3 vs their plain versions at each (level, C, C')
    -> {kernel: KernelStats}."""
    from octfusion_tpu_torch.ops import graph_conv_cuda as k
    from octfusion_tpu_torch.ops import roofline

    dev = torch.device("cuda")
    res = {"graph_conv_col": KernelStats(),
           "graph_conv_bwd_dx": KernelStats()}
    for d, c, cout in sorted(shapes):
        lvl = graph.level(d)
        csr, csr_t = lvl.csr(), lvl.csr_t()
        edges = (lvl.edge_row, lvl.edge_col, lvl.edge_dir, lvl.edge_scale)
        x = torch.randn(lvl.g_cap, c, device=dev, generator=gen)
        dout = torch.randn(lvl.g_cap, cout, device=dev, generator=gen)
        w = torch.randn(7 * c, cout, device=dev, generator=gen) / (7 * c) ** 0.5
        e = int(lvl.n_edges)
        runs = {
            "graph_conv_col": (
                lambda: k.graph_conv_col(x, *csr),
                lambda: k.graph_conv_col_plain(x, *edges),
                roofline.graph_conv_col_cost(lvl.g_cap, c, e)),
            "graph_conv_bwd_dx": (
                lambda: k.graph_conv_bwd_dx(dout, w, *csr_t),
                lambda: k.graph_conv_bwd_dx_plain(dout, w, *edges),
                roofline.graph_conv_bwd_dx_cost(lvl.g_cap, c, cout, e)),
        }
        line = [f"d={d} G={lvl.g_cap} E={e} C={c} C'={cout}"]
        for name, (kern, plain, cost) in runs.items():
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            if not ref.abs().max().item() > 0:
                raise AssertionError(f"all-zero {name} reference at {line}")
            torch.testing.assert_close(got, ref, **TOL_KERNEL)
            del got, ref
            tk, tp = cuda_ms(kern), cuda_ms(plain)
            bound = res[name].add(err, tk, tp, cost)
            line.append(f"{name} max_abs_err={err:.3e} kernel_ms={tk:.4f} "
                        f"plain_ms={tp:.4f} bound_ms={bound:.4f}")
        print("k2k3 " + " | ".join(line) + f" tol=rtol "
              f"{TOL_KERNEL['rtol']:g} atol {TOL_KERNEL['atol']:g}",
              flush=True)
    return res


def check_train_step(solver, cfg, batch, draws, seed):
    """Phase 7: one full-width hr train step's loss and gradients, card vs
    CPU, from the same perturbed weights and injected draws."""
    from octfusion_tpu_torch.models.union_solver import UnionSolver

    cpu = UnionSolver(cfg, device="cpu")
    cpu.df.load_state_dict(solver.df.state_dict())
    cpu.vae.load_state_dict(solver.vae.state_dict())
    perturb_([cpu.df, cpu.vae], torch.Generator().manual_seed(seed))
    card = UnionSolver(cfg, device="cuda")
    card.df.load_state_dict(cpu.df.state_dict())
    card.vae.load_state_dict(cpu.vae.state_dict())
    out = {}
    for name, s in (("card", card), ("cpu", cpu)):
        s.df.train()
        s.df.unet_lr.requires_grad_(False)
        dev = s.device
        t0 = time.perf_counter()
        loss, _ = s.loss_fn({k: v.to(dev) for k, v in batch.items()},
                            **{k: v.to(dev) for k, v in draws.items()})
        loss.backward()
        out[name] = (loss.item(), {n: p.grad for n, p in
                                   s.df.named_parameters() if p.requires_grad},
                     time.perf_counter() - t0)
    (l_card, g_card, t_card), (l_cpu, g_cpu, t_cpu) = out["card"], out["cpu"]
    missing = [n for n, g in g_card.items()
               if n.startswith("unet_hr.") and (g is None or not g.abs().max() > 0)]
    if missing or not any(n.startswith("unet_hr.") for n in g_card):
        raise AssertionError(f"hr U-Net parameters without gradient: {missing}")
    torch.testing.assert_close(torch.tensor(l_card), torch.tensor(l_cpu),
                               **TOL_STEP)
    worst, worst_rel = 0.0, 0.0
    for n, g in g_card.items():
        g = g.cpu()
        torch.testing.assert_close(g, g_cpu[n], **TOL_STEP, msg=n)
        err = (g - g_cpu[n]).abs().max().item()
        scale = g_cpu[n].abs().max().item()
        print(f"grad {n} max_abs_cpu={scale:.3e} max_abs_err={err:.3e}",
              flush=True)
        # relative to the leaf's own scale: the absolute atol above would
        # pass any leaf whose gradients are all below it
        if not err <= TOL_GRAD_SCALE * scale:
            raise AssertionError(f"gradient {n}: max abs err {err:.3e} > "
                                 f"{TOL_GRAD_SCALE:g} * max |grad| "
                                 f"{scale:.3e}")
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / scale if scale else 0.0)
    print(f"train_step card vs cpu B=1: loss card={l_card:.6f} cpu={l_cpu:.6f}"
          f" params={len(g_card)} grad max_abs_err={worst:.3e} "
          f"max_err_over_leaf_max={worst_rel:.3e} tol=rtol "
          f"{TOL_STEP['rtol']:g} atol {TOL_STEP['atol']:g} and err <= "
          f"{TOL_GRAD_SCALE:g} * leaf max card_s={t_card:.3f} "
          f"cpu_s={t_cpu:.3f}",
          flush=True)


def run_training(solver, batch, draws, n_steps):
    """Phase 8: ``n_steps`` train steps on one fixed batch; returns the
    launch counts of the run."""
    from octfusion_tpu_torch.nn.modules import GraphConv
    from octfusion_tpu_torch.ops import graph_conv_cuda as k

    step = solver.make_train_step()
    lr_before = {n: p.detach().clone()
                 for n, p in solver.df.unet_lr.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    k.reset_launches()
    GraphConv.calls = 0
    k.GraphConvFunction.backward_calls = 0
    losses, walls, stages = [], [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        out = step(batch, timed=True, **draws)
        walls.append(time.perf_counter() - t0)
        losses.append(out["loss"].item())
        stages.append(out["seconds"])
        if out["overflow"].item():
            raise AssertionError("the training batch's graph overflows")
    launches = dict(k.launches)
    calls, bwd = GraphConv.calls, k.GraphConvFunction.backward_calls
    peak = torch.cuda.max_memory_allocated()
    print("train losses " + " ".join(f"{v:.6f}" for v in losses), flush=True)
    warm = slice(2, None)
    split = {name: statistics.median(s[name] for s in stages[warm]) * 1e3
             for name in stages[0]}
    print(f"train: B={batch['points'].shape[0]} steps={n_steps} "
          f"ms_per_step={statistics.median(walls[warm]) * 1e3:.3f} (median "
          f"after 2 warm-up) first_step_ms={walls[0] * 1e3:.3f} "
          + " ".join(f"{n}_ms={v:.3f}" for n, v in split.items()), flush=True)
    print(f"train launches fwd={launches['graph_conv_fwd']} "
          f"col={launches['graph_conv_col']} "
          f"bwd_dx={launches['graph_conv_bwd_dx']} graph_conv_calls={calls} "
          f"graph_conv_backward_calls={bwd}", flush=True)
    print(f"train peak_memory_bytes={peak} ({peak / 2**30:.2f} GiB)",
          flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    for n, p in solver.df.unet_lr.named_parameters():
        if not torch.equal(p, lr_before[n]):
            raise AssertionError(f"frozen lr U-Net parameter {n} changed")
    if launches["graph_conv_fwd"] != calls:
        raise AssertionError(f"K1 launches {launches['graph_conv_fwd']} != "
                             f"GraphConv calls {calls}")
    if not (launches["graph_conv_col"] == launches["graph_conv_bwd_dx"]
            == bwd > 0):
        raise AssertionError(f"K2 {launches['graph_conv_col']} / K3 "
                             f"{launches['graph_conv_bwd_dx']} launches vs "
                             f"{bwd} graph-conv backward calls")
    return launches


def check_training(seed):
    """Phases 6-8 on the hr stage of ``configs/octfusion_snet_uncond.yaml``
    -> (K1 / K2 / K3 measurements at the training shapes, the training
    run's launch counts)."""
    from octfusion_tpu_torch.config import load_config
    from octfusion_tpu_torch.models.union_solver import UnionSolver
    from octfusion_tpu_torch.utils.shapes import lumpy_spheres

    dev = torch.device("cuda")
    tcfg = load_config(TRAIN_CONFIG)
    torch.manual_seed(seed)
    trainer = UnionSolver(tcfg, device=dev)
    bsz = tcfg.data.batch_size
    pts, nrm = lumpy_spheres(bsz, tcfg.data.points_per_shape, seed,
                             device=dev)
    batch = {"points": pts, "normals": nrm}
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    shape = trainer.code_shape(bsz)
    draws = {"eps": torch.randn(shape, device=dev, generator=gen),
             "times": torch.rand(bsz, device=dev, generator=gen),
             "noise": torch.randn(shape, device=dev, generator=gen)}
    g_train = trainer.batch_graph(batch)
    print("train graph: nnum " + " ".join(
        f"d{d}={int(n)}" for d, n in enumerate(g_train.octree.nnum.tolist()))
        + " G " + " ".join(f"d{lvl.d}={lvl.g_cap}" for lvl in g_train.levels)
        + " E " + " ".join(f"d{lvl.d}={int(lvl.n_edges)}"
                           for lvl in g_train.levels), flush=True)
    if g_train.any_overflow().item():
        raise AssertionError("the training batch's graph overflows")
    # K1 runs at every conv's shape, the frozen encoder's included; K2 and
    # K3 only at the differentiable convs of the hr U-Net
    fwd_shapes, shapes = set(), set()
    hooks = (conv_shape_hooks([trainer.vae], fwd_shapes)
             + conv_shape_hooks([trainer.df], shapes))
    with torch.no_grad():
        trainer.hr_loss(g_train,
                        trainer.vae.extract_code(g_train, eps=draws["eps"]),
                        times=draws["times"], noise=draws["noise"])
    for h in hooks:
        h.remove()
    gen = torch.Generator(device=dev).manual_seed(seed)
    measured = {"graph_conv_fwd": check_kernel(g_train, fwd_shapes | shapes,
                                               gen),
                **check_backward_kernels(g_train, shapes, gen)}
    del g_train

    one = {k: v[:1] for k, v in batch.items()}
    shape1 = trainer.code_shape(1)
    gen1 = torch.Generator().manual_seed(seed + 3)
    check_train_step(trainer, tcfg, one, {
        "eps": torch.randn(shape1, generator=gen1),
        "times": torch.rand(1, generator=gen1),
        "noise": torch.randn(shape1, generator=gen1)}, seed)

    return measured, run_training(trainer, batch, draws, TRAIN_STEPS)


def cdist_minima(a, b):
    """The library yardstick of K4: one ``torch.cdist``, squared, and both
    minima (the port never calls it)."""
    d = torch.cdist(a, b).square()
    return d.amin(2), d.amin(1)


def check_chamfer(seed) -> KernelStats:
    """Phase 9: K4 vs its plain version at the cases of ``CHAMFER_CASES``,
    then CD / EMD pairs/s at the evaluation batches."""
    from octfusion_tpu_torch.metrics import distances
    from octfusion_tpu_torch.ops import chamfer_cuda as k4
    from octfusion_tpu_torch.ops import roofline

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    stats = KernelStats()
    cd_ms = {}
    for case, bsz, n, m in CHAMFER_CASES:
        a = torch.rand(bsz, n, 3, device=dev, generator=gen) - 0.5
        if case == "near_duplicate":
            b = a + 1e-3 * torch.randn(a.shape, device=dev, generator=gen)
        else:
            b = torch.rand(bsz, m, 3, device=dev, generator=gen) - 0.5
        got, ref = k4.chamfer(a, b), k4.chamfer_plain(a, b)
        torch.cuda.synchronize()
        err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, **TOL_CHAMFER)
            if torch.signbit(g).any():
                raise AssertionError(f"-0.0 in K4's output at {case}")
        del got, ref
        tk = cuda_ms(lambda: k4.chamfer(a, b))
        tp = cuda_ms(lambda: k4.chamfer_plain(a, b))
        tl = cuda_ms(lambda: cdist_minima(a, b))
        bound = stats.add(err, tk, tp, roofline.chamfer_cost(bsz, n, m), tl)
        if case == "eval":
            cd_ms[bsz] = tk
        print(f"k4 {case} B={bsz} N={n} M={m} max_abs_err={err:.3e} "
              f"tol=rtol {TOL_CHAMFER['rtol']:g} atol {TOL_CHAMFER['atol']:g}"
              f" kernel_ms={tk:.4f} plain_ms={tp:.4f} library_ms={tl:.4f} "
              f"bound_ms={bound:.4f} share_of_bound={bound / tk:.3f}",
              flush=True)
    for bsz, tk in cd_ms.items():
        a = torch.rand(bsz, EVAL_POINTS, 3, device=dev, generator=gen) - 0.5
        b = torch.rand(bsz, EVAL_POINTS, 3, device=dev, generator=gen) - 0.5
        emd_ms = {}
        for store in (torch.float32, torch.bfloat16):
            emd_ms[store] = cuda_ms(
                lambda: distances.emd_approx(a, b, store_dtype=store),
                reps=5, warmup=1)
        if bsz == min(cd_ms):
            e32 = distances.emd_approx(a, b)
            e16 = distances.emd_approx(a, b, store_dtype=torch.bfloat16)
            rel = ((e16 - e32).abs() / e32.abs()).max().item()
            print(f"emd bf16 vs fp32 B={bsz} max_rel_diff={rel:.3e} tol=rtol"
                  f" {TOL_EMD_BF16['rtol']:g}", flush=True)
            torch.testing.assert_close(e16, e32, **TOL_EMD_BF16)
        print(f"pairs_per_s B={bsz} P={EVAL_POINTS} cd_k4={bsz / tk * 1e3:.1f} "
              f"emd_fp32={bsz / emd_ms[torch.float32] * 1e3:.1f} "
              f"emd_bf16={bsz / emd_ms[torch.bfloat16] * 1e3:.1f} "
              f"(ms: {tk:.4f} / {emd_ms[torch.float32]:.3f} / "
              f"{emd_ms[torch.bfloat16]:.3f})", flush=True)
    return stats


def write_meshes(root, seed):
    """Phase 10's meshes: ``EVAL_SHAPES`` lumpy spheres per set, marching
    tetrahedra on the card over their fields on a ``EVAL_GRID``³ grid, one
    seed per set -> the two globs."""
    from octfusion_tpu_torch.utils import mesh as mesh_utils
    from octfusion_tpu_torch.utils.shapes import lumpy_sphere_fields

    dev = torch.device("cuda")
    globs, faces_n = [], []
    for kind, s in (("samples", seed + 100), ("reference", seed + 200)):
        os.makedirs(os.path.join(root, kind))
        fields = lumpy_sphere_fields(EVAL_SHAPES, EVAL_GRID, s, device=dev)
        for i, field in enumerate(fields):
            verts, faces = mesh_utils.marching_tetrahedra(field)
            faces_n.append(faces.shape[0])
            mesh_utils.save_obj(os.path.join(root, kind, f"{i:03d}.obj"),
                                verts.cpu().numpy(), faces.cpu().numpy())
        globs.append(os.path.join(root, kind, "*.obj"))
    if min(faces_n) == 0:
        raise AssertionError("an empty evaluation mesh")
    print(f"eval meshes: {EVAL_SHAPES}+{EVAL_SHAPES} lumpy spheres, "
          f"{EVAL_GRID}^3 grid, faces {min(faces_n)}-{max(faces_n)}",
          flush=True)
    return globs


def check_evaluation(seed) -> int:
    """Phase 10: ``python -m octfusion_tpu_torch.evaluate`` from meshes on
    the card -> K4's launches in it."""
    from octfusion_tpu_torch import evaluate
    from octfusion_tpu_torch.metrics import distances
    from octfusion_tpu_torch.ops import chamfer_cuda as k4

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        samples, reference = write_meshes(root, seed)
        t_mesh = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        k4.reset_launches()
        t0 = time.perf_counter()
        res = evaluate.main(["--samples", samples, "--reference", reference,
                             "--points", str(EVAL_POINTS), "--emd",
                             "--batch", str(EVAL_BATCH)])
        wall = time.perf_counter() - t0
        launches = k4.launches["chamfer"]
        peak = torch.cuda.max_memory_allocated()

        s = r = EVAL_SHAPES
        tiles = sum(-(-rows // EVAL_ROW_BLOCK) * -(-cols // EVAL_BATCH)
                    for rows, cols in ((s, r), (s, s), (r, r)))
        pairs = s * r + s * s + r * r
        print(f"eval: S={s} R={r} P={EVAL_POINTS} batch={EVAL_BATCH} "
              f"mesh_s={t_mesh:.3f} wall_s={wall:.3f} sampling_s="
              f"{res['wall_s_pointcloud_sampling']:.3f} pairwise_s="
              f"{res['wall_s_pairwise_metrics']:.3f} pairs={pairs} "
              f"pairs_per_s={pairs / res['wall_s_pairwise_metrics']:.1f} "
              f"k4_launches={launches} tiles={tiles} peak_memory_bytes="
              f"{peak} ({peak / 2**30:.2f} GiB)", flush=True)
        print("eval metrics " + " ".join(f"{k}={v}" for k, v in res.items()),
              flush=True)
        if not all(math.isfinite(v) for v in res.values()):
            raise AssertionError(f"non-finite metric: {res}")
        for k in ("cov_cd", "cov_emd", "1nna_cd", "1nna_emd"):
            if not 0.0 <= res[k] <= 1.0:
                raise AssertionError(f"{k} = {res[k]} outside [0, 1]")
        if launches != tiles:
            raise AssertionError(f"K4 launches {launches} != tiles {tiles}")

        # the first block of the sample x reference matrices, recomputed
        # through the same tiles on the card and on the CPU (plain path)
        k = EVAL_BLOCK
        sp, _ = evaluate.meshes_to_pointclouds(
            sorted(glob.glob(samples))[:k], EVAL_POINTS, seed=0)
        rp, _ = evaluate.meshes_to_pointclouds(
            sorted(glob.glob(reference))[:k], EVAL_POINTS, seed=10_000)
        t0 = time.perf_counter()
        card = distances.pairwise_cd_emd(
            torch.tensor(sp, device=dev), torch.tensor(rp, device=dev),
            EVAL_BATCH)
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = distances.pairwise_cd_emd(torch.tensor(sp), torch.tensor(rp),
                                        EVAL_BATCH)
        t_cpu = time.perf_counter() - t0
    errs = [np.abs(c - p).max() / np.abs(p).max() for c, p in zip(card, cpu)]
    print(f"eval {k}x{k} block card vs cpu: cd max_err/max={errs[0]:.3e} "
          f"emd max_err/max={errs[1]:.3e} tol cd rtol "
          f"{TOL_CHAMFER['rtol']:g} atol {TOL_CHAMFER['atol']:g}, emd rtol "
          f"{TOL_EMD_CARD['rtol']:g} card_s={t_card:.3f} cpu_s={t_cpu:.3f}",
          flush=True)
    np.testing.assert_allclose(card[0], cpu[0], **TOL_CHAMFER)
    np.testing.assert_allclose(card[1], cpu[1], **TOL_EMD_CARD)
    return launches


def check_packed_kernel(graph, shapes, gen) -> KernelStats:
    """Phase 11: K5 vs its plain version and K1 at each (level, C, C'),
    then K5 under autograd."""
    from octfusion_tpu_torch.octree.dual_graph import with_packed_levels
    from octfusion_tpu_torch.ops import graph_conv_cuda as k
    from octfusion_tpu_torch.ops import graph_ops, roofline

    dev = torch.device("cuda")
    stats = KernelStats()
    for d, c, cout in sorted(shapes):
        lvl = graph.level(d)
        csr = lvl.csr()
        edges = (lvl.edge_row, lvl.edge_col, lvl.edge_dir, lvl.edge_scale)
        x = torch.randn(lvl.g_cap, c, device=dev, generator=gen)
        w = torch.randn(7 * c, cout, device=dev, generator=gen) / (7 * c) ** 0.5
        got = k.graph_conv_packed(x, w, *csr)
        ref = k.graph_conv_packed_plain(x, w, *edges)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        if not ref_max > 0:
            raise AssertionError(f"all-zero reference at d={d} C={c}")
        torch.testing.assert_close(got, ref, **TOL_KERNEL)
        del got, ref
        tk = cuda_ms(lambda: k.graph_conv_packed(x, w, *csr))
        tp = cuda_ms(lambda: k.graph_conv_packed_plain(x, w, *edges))
        t1 = cuda_ms(lambda: k.graph_conv(x, w, *csr))
        e = int(lvl.n_edges)
        bound = stats.add(err, tk, tp,
                          roofline.graph_conv_fwd_cost(lvl.g_cap, c, cout, e),
                          flops_rate=roofline.TF32_FLOPS, k1_ms=t1)
        print(f"k5 d={d} G={lvl.g_cap} E={e} C={c} C'={cout}"
              f" max_abs_err={err:.3e} max_rel_err={err / ref_max:.3e}"
              f" tol=rtol {TOL_KERNEL['rtol']:g} atol {TOL_KERNEL['atol']:g}"
              f" kernel_ms={tk:.4f} plain_ms={tp:.4f} k1_ms={t1:.4f}"
              f" bound_ms={bound:.4f} share_of_bound={bound / tk:.3f}",
              flush=True)

    # forward only: a gradient through a packed level raises, unlaunched
    packed = with_packed_levels(graph)
    lvl = packed.level(graph.spec.full_depth)
    x = torch.randn(lvl.g_cap, 8, device=dev, generator=gen)
    w = torch.randn(7 * 8, 8, device=dev, generator=gen).requires_grad_()
    n0 = k.launches["graph_conv_fwd_packed"]
    for call in (lambda: graph_ops.graph_conv(x, w, lvl),
                 lambda: k.graph_conv_packed(x, w, *lvl.csr())):
        try:
            call()
        except RuntimeError as exc:
            if "forward-only" not in str(exc):
                raise
        else:
            raise AssertionError("K5 ran under autograd")
    if k.launches["graph_conv_fwd_packed"] != n0:
        raise AssertionError("K5 launched under autograd")
    with torch.no_grad():
        graph_ops.graph_conv(x, w, lvl)
    print("k5 under autograd: raises (graph_ops.graph_conv on a packed "
          "level and the wrapper); under no_grad it runs", flush=True)
    return stats


def assert_same_tensors(a, b, what: str) -> None:
    """Every tensor of two (nested) dataclasses / sequences is equal."""
    if isinstance(a, torch.Tensor):
        if not torch.equal(a, b):
            raise AssertionError(f"{what} differs")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{what}: {len(a)} vs {len(b)} entries")
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tensors(x, y, f"{what}[{i}]")
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if f.init:
                assert_same_tensors(getattr(a, f.name), getattr(b, f.name),
                                    f"{what}.{f.name}")


def dpmpp_solver(cfg, seed):
    """Phases 12-13's model: ``cfg`` with the DPM-Solver++ sampler, seeded
    weights perturbed with seeded noise."""
    from octfusion_tpu_torch.models.union_solver import UnionSolver

    cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(
        cfg.diffusion, sampler="dpmpp"))
    torch.manual_seed(seed)
    solver = UnionSolver(cfg, device="cuda")
    perturb_([solver.df, solver.vae], torch.Generator().manual_seed(seed + 4))
    return solver


def check_dpmpp(solver, seed):
    """Phase 12: the dpmpp-25 cascade with K5 and with K1 on the same
    weights and injected noise -> (K5 launches, K1 launches) of the two
    counted runs."""
    from octfusion_tpu_torch.nn.modules import GraphConv
    from octfusion_tpu_torch.ops import graph_conv_cuda as k

    dev = solver.device
    m = solver.cfg.model
    s = 2**m.full_depth
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    noise = {"lr_noise": torch.randn(1, 1, 8, s, s, s, device=dev,
                                     generator=gen),
             "hr_noise": torch.randn((1,) + solver.code_shape(1), device=dev,
                                     generator=gen)}
    packed_calls = [0]

    def count_packed(mod, args, out):
        packed_calls[0] += bool(args[1].packed)

    hooks = [mod.register_forward_hook(count_packed)
             for net in (solver.df, solver.vae) for mod in net.modules()
             if isinstance(mod, GraphConv)]
    runs = {}
    for kpack in (True, False):
        solver.sample(steps=2, resolution=RESOLUTION, kpack=kpack, **noise)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k.reset_launches()
        GraphConv.calls = 0
        packed_calls[0] = 0
        t0 = time.perf_counter()
        out = solver.sample(steps=DPMPP_STEPS, resolution=RESOLUTION,
                            kpack=kpack, **noise)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, calls = dict(k.launches), GraphConv.calls
        peak = torch.cuda.max_memory_allocated()
        print(f"dpmpp cascade kpack={kpack}: steps={DPMPP_STEPS}+"
              f"{DPMPP_STEPS} wall_s={wall:.3f} "
              + " ".join(f"{n}_s={v:.3f}" for n, v in out["seconds"].items())
              + f" peak_memory_bytes={peak} ({peak / 2**30:.2f} GiB) "
              f"k1_launches={launches['graph_conv_fwd']} k5_launches="
              f"{launches['graph_conv_fwd_packed']} graph_conv_calls={calls}"
              f" on_packed_levels={packed_calls[0]} overflow="
              f"{bool(out['overflow'])}", flush=True)
        want_k5 = packed_calls[0] if kpack else 0
        if not (launches["graph_conv_fwd_packed"] == want_k5
                and launches["graph_conv_fwd"] == calls - want_k5
                and calls > want_k5 and (want_k5 > 0 or not kpack)):
            raise AssertionError(f"kpack={kpack}: launches {launches} vs "
                                 f"{calls} GraphConv calls, {packed_calls[0]}"
                                 " on packed levels")
        if not (torch.isfinite(out["code"]).all()
                and torch.isfinite(out["sdfs"]).all()):
            raise AssertionError(f"kpack={kpack}: non-finite codes or SDF")
        runs[kpack] = (out, launches)
    for h in hooks:
        h.remove()

    (o5, l5), (o1, l1) = runs[True], runs[False]
    assert_same_tensors(o5["graph"], o1["graph"], "graph")
    err = (o5["code"] - o1["code"]).abs().max().item()
    scale = o1["code"].abs().max().item()
    print(f"dpmpp K5 vs K1: same octree and graph; codes max_abs_err="
          f"{err:.3e} max_abs_code={scale:.3e} ratio={err / scale:.3e} "
          f"tol {TOL_KPACK_CODE:g}", flush=True)
    if not (scale > 0 and err <= TOL_KPACK_CODE * scale):
        raise AssertionError(f"K5 vs K1 codes: {err:.3e} > "
                             f"{TOL_KPACK_CODE:g} * {scale:.3e}")
    return (l5["graph_conv_fwd_packed"],
            l5["graph_conv_fwd"] + l1["graph_conv_fwd"])


def check_cli(solver, cfg, seed):
    """Phase 13: ``python -m octfusion_tpu_torch.generate`` from a
    checkpoint of ``solver``'s weights, twice."""
    from octfusion_tpu_torch.config import dump_config
    from octfusion_tpu_torch.utils import ckpt, params

    with tempfile.TemporaryDirectory() as root:
        ckpt_path = ckpt.save(os.path.join(root, "ckpt"),
                              params.union_checkpoint(solver.df), step=0)
        vae_path = ckpt.save(
            os.path.join(root, "vae"),
            {"autoencoder": {n: v.cpu() for n, v in
                             solver.vae.state_dict().items()}}, step=0)
        cfg_path = os.path.join(root, "config.yaml")
        dump_config(dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, resolution=CLI_RESOLUTION)), cfg_path)
        cmd = [sys.executable, "-m", "octfusion_tpu_torch.generate",
               "--config", cfg_path, "--logs_dir", root, "--name", "gen",
               "--ckpt", ckpt_path, "--vq_ckpt", vae_path,
               "--count", str(CLI_SHAPES), "--sampler", "dpmpp",
               "--sample_steps", str(DPMPP_STEPS), "--seed", str(seed)]
        env = dict(os.environ, OCTFUSION_CONV_KPACK="1")
        rdir = os.path.join(root, "gen", "results_airplane")
        outs = []
        for attempt in (1, 2):
            t0 = time.perf_counter()
            res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                                 text=True, timeout=900)
            wall = time.perf_counter() - t0
            if res.returncode != 0:
                raise AssertionError(f"generate run {attempt} failed "
                                     f"({res.returncode}):\n"
                                     f"{res.stderr[-3000:]}")
            lines = res.stdout.splitlines()
            outs.append(lines)
            print(f"cli run {attempt}: wall_s={wall:.3f} "
                  f"(resolution {CLI_RESOLUTION}, the one cut: random "
                  "weights decode noise)", flush=True)
            for line in lines:
                print(f"  {line}", flush=True)
        wrote = [ln for ln in outs[0] if ln.startswith("[*] wrote ")]
        summary = [ln for ln in outs[0] if ln.startswith("[*] generated")]
        if len(wrote) != CLI_SHAPES or not any(
                ln.startswith("[*] loaded EMA") for ln in outs[0]):
            raise AssertionError(f"generate: {len(wrote)} meshes written of "
                                 f"{CLI_SHAPES}, or no checkpoint loaded")
        if not summary or "graph_conv_fwd_packed_launches=" not in summary[0]:
            raise AssertionError("generate ran no K5 launch")
        sizes = []
        for i in range(CLI_SHAPES):
            with open(os.path.join(rdir, f"{i}.obj"), "rb") as fh:
                data = fh.read()
            if b"\nf " not in data:
                raise AssertionError(f"{i}.obj has no face")
            sizes.append(len(data))
        if any(ln.startswith("[*] wrote ") for ln in outs[1]) or not any(
                f"{CLI_SHAPES}/{CLI_SHAPES} meshes already present" in ln
                for ln in outs[1]):
            raise AssertionError("the second generate run did not skip "
                                 "every mesh")
    print(f"cli: {CLI_SHAPES} non-empty meshes, bytes {sizes}; the rerun "
          "skipped all of them", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200,
                    help="ancestral steps of each diffusion stage")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    # ---- 1. device ---------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs "
                         "only on an NVIDIA GPU")
    from octfusion_tpu_torch.config import Config
    from octfusion_tpu_torch.models.union_solver import UnionSolver
    from octfusion_tpu_torch.nn.modules import GraphConv
    from octfusion_tpu_torch.ops import chamfer_cuda, graph_conv_cuda
    from octfusion_tpu_torch.utils import mesh as mesh_utils
    from octfusion_tpu_torch.utils import sdf as sdf_utils

    dev = torch.device("cuda")
    card = smi()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build: one nvcc per source, all at once ------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        builds = [pool.submit(mod.build) for mod in (graph_conv_cuda,
                                                     chamfer_cuda)]
        for fut in builds:
            fut.result()
    print(f"build: graph_conv.cu (K1, K2, K3, K5) and chamfer.cu (K4) "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    cfg = Config()
    m = cfg.model
    torch.manual_seed(args.seed)
    solver = UnionSolver(cfg, device=dev)
    gen = torch.Generator(device=dev)

    # ---- 3. kernel vs plain on a warm-up cascade's levels -------------
    shapes = set()
    hooks = conv_shape_hooks([solver.df, solver.vae], shapes)
    warm = solver.sample(steps=2, resolution=RESOLUTION, kpack=False,
                         generator=gen.manual_seed(args.seed + 1))
    for h in hooks:
        h.remove()
    g_warm = warm["decode_out"]["graph_out"]
    k1 = check_kernel(
        g_warm, shapes, torch.Generator(device=dev).manual_seed(args.seed))

    # ---- 11. K5 vs plain and K1 on the sampling graph's levels 4-6 -----
    k5 = check_packed_kernel(
        warm["graph"], {sh for sh in shapes if sh[0] <= m.depth_stop}
        | RAGGED_PACKED,
        torch.Generator(device=dev).manual_seed(args.seed + 6))

    # ---- 4. one full-width hr denoise step, card vs CPU ---------------
    check_hr_step(solver, warm["graph"], args.seed)
    del warm, g_warm    # the peak below is the cascade's alone

    # ---- 5. the cascade ----------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    graph_conv_cuda.reset_launches()
    GraphConv.calls = 0
    t0 = time.perf_counter()
    out = solver.sample(steps=args.steps, resolution=RESOLUTION, kpack=False,
                        generator=gen.manual_seed(args.seed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cascade_launches = graph_conv_cuda.launches["graph_conv_fwd"]
    calls = GraphConv.calls
    peak = torch.cuda.max_memory_allocated()
    print(f"cascade: steps={args.steps}+{args.steps} wall_s={wall:.3f} "
          + " ".join(f"{k}_s={v:.3f}" for k, v in out["seconds"].items()),
          flush=True)
    print(f"k1 launches={cascade_launches} graph_conv_calls={calls}",
          flush=True)
    if not (cascade_launches == calls and cascade_launches > 0):
        raise AssertionError(f"kernel launches {cascade_launches} != "
                             f"GraphConv calls {calls}")

    dec = out["decode_out"]
    octree = dec["octree_out"]
    print("nnum " + " ".join(f"d{d}={int(n)}" for d, n in
                             enumerate(octree.nnum.tolist())), flush=True)
    print(f"overflow grow_graph={bool(out['overflow'])} "
          f"decoded_graph={bool(dec['graph_out'].any_overflow())} "
          f"per_depth={octree.overflow.int().tolist()}", flush=True)
    code, sdfs = out["code"], out["sdfs"]
    if code.shape != (out["graph"].level(m.depth_stop).g_cap, m.embed_dim):
        raise AssertionError(f"code shape {tuple(code.shape)}")
    if sdfs.shape != (1,) + (RESOLUTION,) * 3:
        raise AssertionError(f"sdf shape {tuple(sdfs.shape)}")
    if not (torch.isfinite(code).all() and torch.isfinite(sdfs).all()):
        raise AssertionError("non-finite codes or SDF values")
    print(f"sdf decoded: shape={tuple(sdfs.shape)} "
          f"min={sdfs.min().item():.4f} max={sdfs.max().item():.4f}",
          flush=True)

    t0 = time.perf_counter()
    grid = sdf_utils.calc_sdf(analytic_reg(octree, m.full_depth, m.depth_out),
                              octree, m.full_depth, m.depth_out,
                              size=RESOLUTION,
                              bbmin=-cfg.solver.sdf_scale,
                              bbmax=cfg.solver.sdf_scale)
    torch.cuda.synchronize()
    t_grid = time.perf_counter() - t0
    t0 = time.perf_counter()
    verts, faces = mesh_utils.marching_tetrahedra(grid[0])
    torch.cuda.synchronize()
    t_march = time.perf_counter() - t0
    print(f"mesh analytic planes: sdf_s={t_grid:.3f} marching_s={t_march:.3f}"
          f" verts={verts.shape[0]} faces={faces.shape[0]}", flush=True)
    if faces.shape[0] == 0:
        raise AssertionError("empty mesh")
    print(f"peak_memory_bytes={peak} ({peak / 2**30:.2f} GiB)", flush=True)

    del out, dec, octree, grid, verts, faces, solver

    # ---- 12-13. the DPM-Solver++ cascade with K5 and K1; the CLI -------
    dsolver = dpmpp_solver(cfg, args.seed)
    k5_launches, dpmpp_k1_launches = check_dpmpp(dsolver, args.seed)
    check_cli(dsolver, cfg, args.seed)
    del dsolver

    # ---- 6-8. training ------------------------------------------------
    measured, train_launches = check_training(args.seed)
    # K1's entry covers both phases: the worst error, the summed times
    k1.merge(measured["graph_conv_fwd"])
    measured["graph_conv_fwd"] = k1
    launches = {name: train_launches[name] for name in measured}
    launches["graph_conv_fwd"] += cascade_launches + dpmpp_k1_launches

    # ---- 9. K4 vs plain; CD / EMD pairs/s ----------------------------
    measured["chamfer"] = check_chamfer(args.seed)

    # ---- 10. evaluation from meshes ----------------------------------
    launches["chamfer"] = check_evaluation(args.seed)
    measured["graph_conv_fwd_packed"] = k5
    launches["graph_conv_fwd_packed"] = k5_launches

    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": launches[name],
        **stats.entry(),
    } for name, stats in measured.items()]}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
