"""Smoke run of the PyTorch port (``octfusion_tpu_torch``) on one NVIDIA GPU.

Drives the port's main paths (sampling and the training of every stage
at the full width of the reference-parity model with seeded random
weights, the evaluation metrics from meshes at the reference's
2048-point protocol, the DPM-Solver++ generation path with its CLI, and
the training CLI on a ShapeNet-format set), and checks the hand-written
CUDA kernels they run (the graph conv's K1 forward, K2 column buffer, K3
input gradient and K5 packed forward; the Chamfer kernel K4):

1. device: the card's name and power limit; TF32 off for matmul and cuDNN;
2. build: ``graph_conv.cu`` and ``chamfer.cu`` are compiled from
   ``octfusion_tpu_torch/csrc``, one ``nvcc`` each, both at once;
3. K1 vs plain: on the graph levels 4-8 of a short warm-up cascade, at
   every (C, C') pair the cascade's graph convs use, the kernel against its
   plain PyTorch version on the same tensors (rtol = atol = 1e-4), timed
   with CUDA events beside the GEMM alone on the materialised column
   buffer (``gemm_ms``: ``col @ W``, a yardstick the port never calls) and
   its bound (``ops/roofline.py``: at the TF32 tensor-core rate, and at
   the fp32 rate beside it), then the sums over the shapes;
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
   events, K1 and K3 beside the GEMM alone (K3: ``dout @ W^T``, as in its
   plain version), then the sums; the training graph's line gives each
   level's largest CSR and transposed-CSR slot;
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
9. K4 vs plain (run first, right after the build: its device times come
   from ``torch.profiler`` traces, which a fresh process takes reliably):
   the 2048-point evaluation protocol at B = 16, 32 (the evaluation's
   launch, phase 10's tiles), 64 and 256 pairs, the ragged B = 2, N = 700,
   M = 1100, near-duplicate clouds (a and a + 1e-3 noise) and a NaN
   coordinate in a[0, 2] and b[1, 5], and infinite and 1e20 coordinates
   in a and b (NaN or +inf by the signs, as the plain version), all in
   the unit cube: the kernel against its plain version (rtol 1e-4, atol
   1e-6, NaN and +inf exactly where the plain version has them, no -0.0
   elsewhere), with kernel ms (CUDA events)
   and device ms (profiler), plain / library (``torch.cdist`` squared and
   both minima, a yardstick the port never calls) ms, the bound
   (``roofline.bound_times``) and its share, and the fp32 bound of
   ``roofline.chamfer_cost`` (the direct form's 8 FLOP per pair) and its
   share; then CD (K4), EMD fp32 and EMD bf16-stored
   pairs/s at the four evaluation B, and bf16 vs fp32 EMD at B = 16 (rtol
   2.5e-3);
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
   graph is packed) and the ragged 515 -> 512 and 131 -> 128, K5 (K1's
   template over the flat 7C axis) against its plain version (rtol = atol
   = 1e-4), timed with K1 on the same tensors (CUDA events, median of 20)
   beside its bound at the TF32 tensor-core rate; then K5 under autograd
   must raise, launching nothing;
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
   noise, whose 256³ mesh is ~10^8 faces of text; the CLI sets fp32 with
   TF32 off itself): 4 non-empty ``.obj``
   files, 4 ``[*] wrote`` lines and K5 launches in its summary line; a
   second run must skip all 4;
14. lr training (the lr stage of ``configs/octfusion_snet_uncond.yaml``:
   lr U-Net 64 ch, mult (1, 2, 4); the split grid built from 65536-point
   lumpy spheres at the caps from finest_cap 131072): one step card vs
   CPU at batch 1 with ``lr_pos_weight`` 1.75, all weights perturbed with
   seeded noise and the same injected times and noise (the loss and every
   gradient at phase 7's tolerances), then ``LR_TRAIN_STEPS`` (12) steps
   at batch 4 on one fixed batch with fixed times and noise: no
   overflow, a finite, falling loss, the median ms/step after 2 warm-up
   steps with its stage split, and the peak memory;
15. K1, K2 and K3 vs plain at the VAE's training shapes: every (level, C,
   C') of the VAE step's graph convs on the batch-2 training graph
   (levels 6-8 of the encoder and the decoder; C = 11, 31, 37, 38 with
   the node-type one-hot, none a multiple of 4), as phase 6 does; the
   graph's line gives each level's largest CSR and transposed-CSR slot;
16. one full-width VAE train step (``VAESolver.loss_fn`` and its
   backward) on the card against the CPU at batch 1, all weights
   perturbed with seeded noise, the same injected eps: the loss, every
   term of the loss dict and every gradient at phase 7's tolerances, and
   every VAE parameter must get a gradient that is not all zero.  Both
   sides run under ``torch.use_deterministic_algorithms``: at the VAE's
   gradients of ~1e3 the atomic and parallel accumulations moved an
   element by about the elementwise atol from run to run;
17. VAE training (``VAESolver.make_train_step`` with the YAML's
   ``model``, ``capacity`` and ``loss``: depth 8, stop 6, out 8,
   checkpointed res blocks, edge_factor 10, ``sdf_reg_loss``, kl 0.1):
   ``VAE_TRAIN_STEPS`` (8) steps at batch 2 (65536 surface points and
   ``data.point_sample_num`` SDF samples per shape) on one fixed batch
   with a fixed eps.  No overflow, a finite, falling loss, K1 launches =
   GraphConv forward calls (checkpoint recomputes included) and K2 = K3
   launches = graph-conv backward calls; prints the median ms/step after
   2 warm-up steps split into graph / forward / backward / optimizer, and
   the peak memory;
18. VAE reconstruction (``VAESolver.reconstruct``) of phase 17's 2 shapes
   from its trained weights: the SDF grid at the YAML's 256³ must be
   finite and K1 launches = GraphConv calls; then meshes at 64³ into a
   temp dir (barely trained weights decode noise, as phase 13 says of
   random ones); prints each stage's seconds;
19. the training CLI, ``python -m octfusion_tpu_torch.train`` as
   subprocesses on a ShapeNet-format set it writes (8 seeded lumpy
   spheres, 100000 surface points with normals and 100000 SDF samples
   with gradients each, points scaled by ``data.point_scale`` as the
   reference's files are) with ``configs/octfusion_snet_uncond.yaml``
   changed only in ``data.location`` / ``data.filelist``,
   ``train.print_freq`` 1, ``save_latest_freq`` 2, ``display_freq`` 3 and
   ``solver.resolution`` 64 (noise meshes, as phase 13): the VAE at batch
   2 for 3 steps, then resumed to 5; lr at batch 4 for 4 steps; hr at
   batch 4 for 3 steps with the VAE run as ``--vq_ckpt`` and the lr run
   as ``--pretrain_ckpt``; generate mode of the hr run (dpmpp-25, one
   shape) and of the VAE (one reconstruction); then
   ``python -m octfusion_tpu_torch.tools.vae_recon_eval`` on the VAE run
   (2 held-out synthetic shapes, their Chamfer distances through K4).
   ``python -m octfusion_tpu_torch.tools.loader_bench`` measures the
   loader's own pace.  Each run must exit 0 with finite losses, K1 launches = GraphConv calls and K2 = K3 launches
   = graph-conv backward calls, no display-eval failure (the display
   meshes and the generated ones must have faces), the resume at step 3,
   the hr run's frozen ``unet_lr`` bit for bit the lr run's and its EMA
   other than its live weights; an overflow stops a run.  Prints each
   run's summary line and wall, ms/step and ``data_s`` per stage, and
   the phase's seconds.

Prints the kernel summary as a JSON line (each kernel's ``launches`` is
its count over the counted runs of phases 5, 8, 12, 17, 18 and 19, K4's
over phases 10 and 19; ``ms``, ``plain_ms``, ``bound_ms`` and
``library_ms`` sum the shapes of phases 3, 6 and 15, 9, or 11, K1's and K3's ``gemm_ms`` the
GEMM-alone
yardstick over the same shapes, and K5's ``k1_ms`` is K1 on phase 11's
shapes; ``bound_by`` is the larger of the summed operation and byte
times; every bound is ``roofline.bound_times``: the operations at
``roofline.FLOPS_RATE``, the rate of the units the kernel runs on, and
K4's minima at ``roofline.MINIMA_RATE``), then the card's name and power
limit, and last
``{"ok": true, "device": {...}}``.  Any failure raises: there is no CPU fallback.  The
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
                 ("eval", 32, EVAL_POINTS, EVAL_POINTS),
                 ("eval", 64, EVAL_POINTS, EVAL_POINTS),
                 ("eval", 256, EVAL_POINTS, EVAL_POINTS),
                 ("ragged", 2, 700, 1100),
                 ("near_duplicate", 16, EVAL_POINTS, EVAL_POINTS),
                 ("nan", 4, EVAL_POINTS, EVAL_POINTS),
                 ("non_finite", 4, EVAL_POINTS, EVAL_POINTS)]
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
# phases 14-18
LR_POS_WEIGHT = 1.75    # phase 14's card-vs-CPU step
LR_TRAIN_STEPS = 12     # at least 10, the first 2 are warm-up
VAE_BATCH = 2
VAE_TRAIN_STEPS = 8     # the first 2 are warm-up
VAE_MESH_RESOLUTION = 64
# phase 19
CLI_DATA_SHAPES = 8
CLI_DATA_POINTS = 100000   # surface points and SDF samples per shape file
CLI_TRAIN_RESOLUTION = 64  # SDF grid of the display evals and generate
CLI_TIMEOUT = 600          # seconds per CLI run
CLI_RECON_SHAPES = 2       # held-out shapes of tools/vae_recon_eval
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
    and the summed median times of the kernel, its plain version, the
    library yardstick and the GEMM-alone yardstick, and of its bound (with
    the operation and byte times behind it) at the rate of the units it
    runs on and, for continuity, at the fp32 rate."""
    max_abs_err: float = 0.0
    ms: float = 0.0
    plain_ms: float = 0.0
    bound_ms: float = 0.0
    ops_ms: float = 0.0
    bytes_ms: float = 0.0
    bound_fp32_ms: float = 0.0
    library_ms: Optional[float] = None
    gemm_ms: Optional[float] = None
    k1_ms: Optional[float] = None

    def add(self, err, ms, plain_ms, name, cost, library_ms=None,
            gemm_ms=None, k1_ms=None) -> float:
        """Adds one shape of the kernel behind entry point ``name``, ``cost``
        = (flops, bytes), bounded by ``roofline.bound_times``; returns its
        bound."""
        from octfusion_tpu_torch.ops import roofline

        ops, nbytes = roofline.bound_times(name, *cost)
        bound = max(ops, nbytes)
        self.max_abs_err = max(self.max_abs_err, err)
        self.ms += ms
        self.plain_ms += plain_ms
        self.bound_ms += bound
        self.ops_ms += ops
        self.bytes_ms += nbytes
        self.bound_fp32_ms += max(roofline.times_ms(*cost))
        for f, v in (("library_ms", library_ms), ("gemm_ms", gemm_ms),
                     ("k1_ms", k1_ms)):
            if v is not None:
                setattr(self, f, (getattr(self, f) or 0.0) + v)
        return bound

    def merge(self, other: "KernelStats") -> None:
        self.max_abs_err = max(self.max_abs_err, other.max_abs_err)
        for f in ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms",
                  "bound_fp32_ms"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        for f in ("library_ms", "gemm_ms", "k1_ms"):
            if getattr(other, f) is not None:
                setattr(self, f, (getattr(self, f) or 0.0) + getattr(other, f))

    def summary(self, label: str) -> None:
        """Prints the sums over the phase's shapes and the shares of the
        bound at both rates."""
        extra = "".join(f" {f}={getattr(self, f):.4f}"
                        for f in ("gemm_ms", "library_ms", "k1_ms")
                        if getattr(self, f) is not None)
        print(f"{label} sums: ms={self.ms:.4f} plain_ms={self.plain_ms:.4f}"
              f"{extra} bound_ms={self.bound_ms:.4f} (by "
              f"{self.entry()['bound_by']}) share_of_bound="
              f"{self.bound_ms / self.ms:.3f} bound_fp32_ms="
              f"{self.bound_fp32_ms:.4f} share_of_fp32_bound="
              f"{self.bound_fp32_ms / self.ms:.3f} max_abs_err="
              f"{self.max_abs_err:.3e}", flush=True)

    def entry(self) -> dict:
        out = {"max_abs_err": self.max_abs_err, "ms": self.ms,
               "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
               "bound_by": ("operations" if self.ops_ms >= self.bytes_ms
                            else "bytes"),
               "library_ms": self.library_ms}
        for f in ("gemm_ms", "k1_ms"):
            if getattr(self, f) is not None:
                out[f] = getattr(self, f)
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


def device_ms(fn, reps=20, warmup=3, tries=5):
    """Mean device milliseconds of ``fn`` per call: the summed durations of
    the kernels and copies it ran in ``reps`` calls under
    ``torch.profiler``, so the host's time between launches does not count
    (``cuda_ms`` reads a call shorter than its own launch overhead as that
    overhead).  A trace without device events is taken again, up to
    ``tries`` times, then raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / reps
    raise RuntimeError("the profiler's traces hold no device time")


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
    ``graph``, timed beside the GEMM alone on the materialised column
    buffer (``col @ W``, a yardstick the port never calls)."""
    from octfusion_tpu_torch.ops import graph_conv_cuda as k1
    from octfusion_tpu_torch.ops import roofline

    dev = torch.device("cuda")
    stats = KernelStats()
    for d, c, cout in sorted(shapes):
        lvl = graph.level(d)
        row_ptr, col, scale = lvl.csr()
        edges = (lvl.edge_row, lvl.edge_col, lvl.edge_dir, lvl.edge_scale)
        x = torch.randn(lvl.g_cap, c, device=dev, generator=gen)
        w = torch.randn(7 * c, cout, device=dev, generator=gen) / (7 * c) ** 0.5
        got = k1.graph_conv(x, w, row_ptr, col, scale)
        ref = k1.graph_conv_plain(x, w, *edges)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        if not ref_max > 0:
            raise AssertionError(f"all-zero reference at d={d} C={c}")
        torch.testing.assert_close(got, ref, **TOL_KERNEL)
        del got, ref
        tk = cuda_ms(lambda: k1.graph_conv(x, w, row_ptr, col, scale))
        tp = cuda_ms(lambda: k1.graph_conv_plain(x, w, *edges))
        cbuf = k1.graph_conv_col_plain(x, *edges)
        tg = cuda_ms(lambda: torch.matmul(cbuf, w))
        del cbuf
        e = int(lvl.n_edges)
        cost = roofline.graph_conv_fwd_cost(lvl.g_cap, c, cout, e)
        bound = stats.add(err, tk, tp, "graph_conv_fwd", cost, gemm_ms=tg)
        print(f"k1 d={d} G={lvl.g_cap} E={e} C={c} C'={cout}"
              f" max_abs_err={err:.3e} max_rel_err={err / ref_max:.3e}"
              f" tol=rtol {TOL_KERNEL['rtol']:g} atol {TOL_KERNEL['atol']:g}"
              f" kernel_ms={tk:.4f} plain_ms={tp:.4f} gemm_ms={tg:.4f}"
              f" bound_ms={bound:.4f} share_of_bound={bound / tk:.3f}"
              f" bound_fp32_ms={max(roofline.times_ms(*cost)):.4f}",
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
    """Phase 6: K2 and K3 vs their plain versions at each (level, C, C'),
    K3 timed beside the GEMM alone (``dout @ W^T``, as in its plain
    version) -> {kernel: KernelStats}."""
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
                roofline.graph_conv_col_cost(lvl.g_cap, c, e), None),
            "graph_conv_bwd_dx": (
                lambda: k.graph_conv_bwd_dx(dout, w, *csr_t),
                lambda: k.graph_conv_bwd_dx_plain(dout, w, *edges),
                roofline.graph_conv_bwd_dx_cost(lvl.g_cap, c, cout, e),
                lambda: torch.matmul(dout, w.t())),
        }
        line = [f"d={d} G={lvl.g_cap} E={e} C={c} C'={cout}"]
        for name, (kern, plain, cost, gemm) in runs.items():
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            if not ref.abs().max().item() > 0:
                raise AssertionError(f"all-zero {name} reference at {line}")
            torch.testing.assert_close(got, ref, **TOL_KERNEL)
            del got, ref
            tk, tp = cuda_ms(kern), cuda_ms(plain)
            tg = cuda_ms(gemm) if gemm else None
            bound = res[name].add(err, tk, tp, name, cost, gemm_ms=tg)
            line.append(f"{name} max_abs_err={err:.3e} kernel_ms={tk:.4f} "
                        f"plain_ms={tp:.4f} "
                        + (f"gemm_ms={tg:.4f} " if gemm else "")
                        + f"bound_ms={bound:.4f} share_of_bound="
                        f"{bound / tk:.3f}")
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
    runs = {}
    for name, s in (("card", card), ("cpu", cpu)):
        s.df.train()
        s.df.unet_lr.requires_grad_(False)
        runs[name] = timed_step(s.df, lambda: s.loss_fn(
            to_device(batch, s.device), **to_device(draws, s.device)))
    compare_steps("train_step", runs, "unet_hr.")


def to_device(batch, device):
    """A dict of tensors on ``device``."""
    return {k: v.to(device) for k, v in batch.items()}


def timed_step(net, loss_fn):
    """``loss_fn()`` -> (loss, dict) and its backward -> (the dict's
    scalars as floats, the trainable parameters' gradients, seconds)."""
    t0 = time.perf_counter()
    loss, terms = loss_fn()
    loss.backward()
    secs = time.perf_counter() - t0
    scalars = {k: float(v.detach()) for k, v in terms.items()}
    return (scalars, {n: p.grad for n, p in net.named_parameters()
                      if p.requires_grad}, secs)


def compare_steps(label, runs, prefix):
    """Phases 7, 14 and 16: one train step's loss terms and every gradient,
    card (``runs["card"]``) vs CPU (``runs["cpu"]``), each (terms,
    gradients, seconds) from :func:`timed_step`.  Every parameter whose
    name starts with ``prefix`` must get a gradient that is not all
    zero."""
    (l_card, g_card, t_card), (l_cpu, g_cpu, t_cpu) = runs["card"], runs["cpu"]
    missing = [n for n, g in g_card.items()
               if n.startswith(prefix) and (g is None or not g.abs().max() > 0)]
    if missing or not any(n.startswith(prefix) for n in g_card):
        raise AssertionError(f"{prefix} parameters without gradient: "
                             f"{missing}")
    if sorted(l_card) != sorted(l_cpu):
        raise AssertionError(f"loss terms {sorted(l_card)} vs {sorted(l_cpu)}")
    for k in l_card:
        torch.testing.assert_close(torch.tensor(l_card[k]),
                                   torch.tensor(l_cpu[k]), **TOL_STEP,
                                   msg=k)
    worst, worst_rel, worst_share = 0.0, 0.0, 0.0
    for n, g in g_card.items():
        g = g.cpu()
        torch.testing.assert_close(g, g_cpu[n], **TOL_STEP, msg=n)
        err = (g - g_cpu[n]).abs().max().item()
        scale = g_cpu[n].abs().max().item()
        # the worst element's error over the error assert_close allows it
        share = ((g - g_cpu[n]).abs() / (TOL_STEP["atol"] + TOL_STEP["rtol"]
                                         * g_cpu[n].abs())).max().item()
        worst_share = max(worst_share, share)
        print(f"grad {n} max_abs_cpu={scale:.3e} max_abs_err={err:.3e} "
              f"share_of_tol={share:.3f}", flush=True)
        # relative to the leaf's own scale: the absolute atol above would
        # pass any leaf whose gradients are all below it
        if not err <= TOL_GRAD_SCALE * scale:
            raise AssertionError(f"gradient {n}: max abs err {err:.3e} > "
                                 f"{TOL_GRAD_SCALE:g} * max |grad| "
                                 f"{scale:.3e}")
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / scale if scale else 0.0)
    if len(l_card) > 1:
        print(f"{label} terms card / cpu: " + " ".join(
            f"{k}={l_card[k]:.6f}/{l_cpu[k]:.6f}" for k in sorted(l_card)),
            flush=True)
    print(f"{label} card vs cpu B=1: loss card={l_card['loss']:.6f} "
          f"cpu={l_cpu['loss']:.6f}"
          f" params={len(g_card)} grad max_abs_err={worst:.3e} "
          f"max_err_over_leaf_max={worst_rel:.3e} "
          f"share_of_tol={worst_share:.3f} tol=rtol "
          f"{TOL_STEP['rtol']:g} atol {TOL_STEP['atol']:g} and err <= "
          f"{TOL_GRAD_SCALE:g} * leaf max card_s={t_card:.3f} "
          f"cpu_s={t_cpu:.3f}",
          flush=True)


def run_steps(label, step, batch, n_steps, counted: bool, **kw):
    """Phases 14 and 17: ``n_steps`` timed steps of ``step`` on one fixed
    batch; prints the losses, the median ms/step after 2 warm-up steps
    with its stage split, and the peak memory; raises on overflow or a
    loss that is not finite or does not fall.  With ``counted`` the
    graph-conv launch counts are set to 0 first and checked after
    against the GraphConv forward and backward calls -> the run's
    launches."""
    from octfusion_tpu_torch.nn.modules import GraphConv
    from octfusion_tpu_torch.ops import graph_conv_cuda as k

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k.reset_launches()
    GraphConv.calls = 0
    k.GraphConvFunction.backward_calls = 0
    losses, walls, stages = [], [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        out = step(batch, timed=True, **kw)
        walls.append(time.perf_counter() - t0)
        losses.append(out["loss"].item())
        stages.append(out["seconds"])
        if "overflow" not in out or out["overflow"].item():
            raise AssertionError(f"{label}: the batch overflows (or no flag)")
    launches = dict(k.launches)
    calls, bwd = GraphConv.calls, k.GraphConvFunction.backward_calls
    peak = torch.cuda.max_memory_allocated()
    print(f"{label} losses " + " ".join(f"{v:.6f}" for v in losses),
          flush=True)
    warm = slice(2, None)
    split = {name: statistics.median(s[name] for s in stages[warm]) * 1e3
             for name in stages[0]}
    print(f"{label}: B={batch['points'].shape[0]} steps={n_steps} "
          f"ms_per_step={statistics.median(walls[warm]) * 1e3:.3f} (median "
          f"after 2 warm-up) first_step_ms={walls[0] * 1e3:.3f} "
          + " ".join(f"{n}_ms={v:.3f}" for n, v in split.items())
          + f" peak_memory_bytes={peak} ({peak / 2**30:.2f} GiB)",
          flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall: {losses}")
    if counted:
        print(f"{label} launches fwd={launches['graph_conv_fwd']} "
              f"col={launches['graph_conv_col']} "
              f"bwd_dx={launches['graph_conv_bwd_dx']} graph_conv_calls="
              f"{calls} graph_conv_backward_calls={bwd}", flush=True)
        if launches["graph_conv_fwd"] != calls:
            raise AssertionError(f"K1 launches {launches['graph_conv_fwd']}"
                                 f" != GraphConv calls {calls}")
        if not (launches["graph_conv_col"] == launches["graph_conv_bwd_dx"]
                == bwd > 0):
            raise AssertionError(f"K2 {launches['graph_conv_col']} / K3 "
                                 f"{launches['graph_conv_bwd_dx']} launches "
                                 f"vs {bwd} graph-conv backward calls")
    return launches


def run_training(solver, batch, draws, n_steps):
    """Phase 8: ``n_steps`` train steps on one fixed batch; the frozen lr
    U-Net must stay bit for bit -> the launch counts of the run."""
    lr_before = {n: p.detach().clone()
                 for n, p in solver.df.unet_lr.named_parameters()}
    launches = run_steps("train", solver.make_train_step(), batch, n_steps,
                         True, **draws)
    for n, p in solver.df.unet_lr.named_parameters():
        if not torch.equal(p, lr_before[n]):
            raise AssertionError(f"frozen lr U-Net parameter {n} changed")
    return launches


def print_graph(label, g) -> None:
    """A training graph's node counts, vertex and edge counts and each
    level's largest CSR and transposed-CSR slot; raises if it
    overflows."""
    print(f"{label} graph: nnum " + " ".join(
        f"d{d}={int(n)}" for d, n in enumerate(g.octree.nnum.tolist()))
        + " G " + " ".join(f"d{lvl.d}={lvl.g_cap}" for lvl in g.levels)
        + " E " + " ".join(f"d{lvl.d}={int(lvl.n_edges)}" for lvl in g.levels)
        + " largest slot (csr/csr_t) " + " ".join(
            f"d{lvl.d}={int(lvl.csr()[0].diff().max())}/"
            f"{int(lvl.csr_t()[0].diff().max())}" for lvl in g.levels),
        flush=True)
    if g.any_overflow().item():
        raise AssertionError(f"the {label} batch's graph overflows")


def training_setup(seed):
    """The hr stage of ``configs/octfusion_snet_uncond.yaml`` on the card
    -> (trainer, config, batch, draws, the batch's graph, the (level, C,
    C') of every conv of a train step's forward (K1: the frozen encoder's
    included), those of the differentiable convs (K2, K3)).  Prints the
    graph's sizes; raises if it overflows."""
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
    print_graph("train", g_train)
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
    return trainer, tcfg, batch, draws, g_train, fwd_shapes | shapes, shapes


def check_training(seed):
    """Phases 6-8 on the hr stage of ``configs/octfusion_snet_uncond.yaml``
    -> (K1 / K2 / K3 measurements at the training shapes, the training
    run's launch counts)."""
    dev = torch.device("cuda")
    trainer, tcfg, batch, draws, g_train, fwd_shapes, shapes = \
        training_setup(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    measured = {"graph_conv_fwd": check_kernel(g_train, fwd_shapes, gen),
                **check_backward_kernels(g_train, shapes, gen)}
    for name, label in (("graph_conv_fwd", "k1 phase 6 (training)"),
                        ("graph_conv_col", "k2 phase 6 (training)"),
                        ("graph_conv_bwd_dx", "k3 phase 6 (training)")):
        measured[name].summary(label)
    del g_train

    one = {k: v[:1] for k, v in batch.items()}
    shape1 = trainer.code_shape(1)
    gen1 = torch.Generator().manual_seed(seed + 3)
    check_train_step(trainer, tcfg, one, {
        "eps": torch.randn(shape1, generator=gen1),
        "times": torch.rand(1, generator=gen1),
        "noise": torch.randn(shape1, generator=gen1)}, seed)

    return measured, run_training(trainer, batch, draws, TRAIN_STEPS)


def check_lr_training(seed):
    """Phase 14: the lr stage of ``configs/octfusion_snet_uncond.yaml``,
    one step card vs CPU at batch 1 (``lr_pos_weight`` 1.75), then
    ``LR_TRAIN_STEPS`` steps at batch 4."""
    from octfusion_tpu_torch.config import load_config
    from octfusion_tpu_torch.models.union_solver import UnionSolver
    from octfusion_tpu_torch.utils.shapes import lumpy_spheres

    dev = torch.device("cuda")
    tcfg = load_config(TRAIN_CONFIG)
    s = 2**tcfg.model.full_depth
    wcfg = dataclasses.replace(tcfg, diffusion=dataclasses.replace(
        tcfg.diffusion, lr_pos_weight=LR_POS_WEIGHT))
    torch.manual_seed(seed)
    cpu = UnionSolver(wcfg, stage_flag="lr", device="cpu")
    perturb_([cpu.df], torch.Generator().manual_seed(seed + 8))
    card = UnionSolver(wcfg, stage_flag="lr", device=dev)
    card.df.load_state_dict(cpu.df.state_dict())
    pts, nrm = lumpy_spheres(1, tcfg.data.points_per_shape, seed)
    gen = torch.Generator().manual_seed(seed + 9)
    draws = {"times": torch.rand(1, generator=gen),
             "noise": torch.randn(1, s, s, s, 8, generator=gen)}
    runs = {}
    for name, sol in (("card", card), ("cpu", cpu)):
        sol.df.train()
        runs[name] = timed_step(sol.df, lambda: sol.loss_fn(
            to_device({"points": pts, "normals": nrm}, sol.device),
            **to_device(draws, sol.device)))
    compare_steps(f"lr_step (lr_pos_weight {LR_POS_WEIGHT:g})", runs,
                  "unet_lr.")
    del cpu, card

    torch.manual_seed(seed)
    trainer = UnionSolver(tcfg, stage_flag="lr", device=dev)
    bsz = tcfg.data.batch_size
    pts, nrm = lumpy_spheres(bsz, tcfg.data.points_per_shape, seed,
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    draws = {"times": torch.rand(bsz, device=dev, generator=gen),
             "noise": torch.randn(bsz, s, s, s, 8, device=dev,
                                  generator=gen)}
    run_steps("lr train", trainer.make_train_step(),
              {"points": pts, "normals": nrm}, LR_TRAIN_STEPS, False,
              **draws)


def vae_setup(seed):
    """The VAE of ``configs/octfusion_snet_uncond.yaml`` on the card ->
    (solver, config, the batch-2 batch, eps, its graph, the (level, C,
    C') of every graph conv of a train step).  Prints the graph's sizes;
    raises if it overflows."""
    from octfusion_tpu_torch.config import load_config
    from octfusion_tpu_torch.models.common import batch_to_graph
    from octfusion_tpu_torch.models.vae_solver import VAESolver
    from octfusion_tpu_torch.utils.shapes import lumpy_sphere_batch

    dev = torch.device("cuda")
    cfg = load_config(TRAIN_CONFIG)
    torch.manual_seed(seed)
    solver = VAESolver(cfg, device=dev)
    batch = lumpy_sphere_batch(VAE_BATCH, cfg.data.points_per_shape,
                               cfg.data.point_sample_num, seed, device=dev)
    eps = torch.randn(solver.code_shape(VAE_BATCH), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(
                          seed + 11))
    g = batch_to_graph(batch["points"], batch["normals"], solver.spec1,
                       solver.edge_factor)[1]
    print_graph("vae", g)
    shapes = set()
    hooks = conv_shape_hooks([solver.vae], shapes)
    with torch.no_grad():
        solver.vae(g, g, eps=eps)
    for h in hooks:
        h.remove()
    return solver, cfg, batch, eps, g, shapes


def check_vae_step(solver, cfg, batch, seed):
    """Phase 16: one full-width VAE train step's loss terms and gradients,
    card vs CPU at batch 1, from the same perturbed weights and eps, both
    under deterministic algorithms.  The VAE's gradients reach ~1e3, where
    the atomic and parallel accumulations (``index_add_``, ``index_put_``
    with ``accumulate``) change an element's fp32 sum from run to run by
    about the elementwise atol itself; deterministically, each side gives
    the same bits on every run, and the kernels are unchanged."""
    from octfusion_tpu_torch.models.vae_solver import VAESolver

    cpu = VAESolver(cfg, device="cpu")
    cpu.vae.load_state_dict(solver.vae.state_dict())
    perturb_([cpu.vae], torch.Generator().manual_seed(seed + 12))
    card = VAESolver(cfg, device="cuda")
    card.vae.load_state_dict(cpu.vae.state_dict())
    one = {k: v[:1].cpu() for k, v in batch.items()}
    eps = torch.randn(cpu.code_shape(1),
                      generator=torch.Generator().manual_seed(seed + 13))
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for name, sol in (("card", card), ("cpu", cpu)):
            sol.vae.train()
            runs[name] = timed_step(sol.vae, lambda: sol.loss_fn(
                to_device(one, sol.device), eps=eps.to(sol.device)))
    finally:
        torch.use_deterministic_algorithms(False)
    compare_steps("vae_step", runs, "")


def check_vae_training(seed):
    """Phases 15-18 on the VAE of ``configs/octfusion_snet_uncond.yaml``
    -> (K1 / K2 / K3 measurements at the VAE's training shapes, the
    launches of the training run (phase 17) and of the reconstruction
    (phase 18))."""
    from octfusion_tpu_torch.nn.modules import GraphConv
    from octfusion_tpu_torch.ops import graph_conv_cuda as k

    dev = torch.device("cuda")
    solver, cfg, batch, eps, g, shapes = vae_setup(seed)
    # ---- 15 -------------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    measured = {"graph_conv_fwd": check_kernel(g, shapes, gen),
                **check_backward_kernels(g, shapes, gen)}
    for name, label in (("graph_conv_fwd", "k1 phase 15 (vae training)"),
                        ("graph_conv_col", "k2 phase 15 (vae training)"),
                        ("graph_conv_bwd_dx", "k3 phase 15 (vae training)")):
        measured[name].summary(label)
    del g
    # ---- 16 -------------------------------------------------------------
    check_vae_step(solver, cfg, batch, seed)
    # ---- 17 -------------------------------------------------------------
    train_launches = run_steps("vae train", solver.make_train_step(), batch,
                               VAE_TRAIN_STEPS, True, eps=eps)
    # ---- 18 -------------------------------------------------------------
    m = cfg.model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k.reset_launches()
    GraphConv.calls = 0
    sdfs, out = solver.reconstruct(batch)
    recon_launches, calls = dict(k.launches), GraphConv.calls
    peak = torch.cuda.max_memory_allocated()
    octree = out["octree_out"]
    print("vae reconstruct: " + " ".join(
        f"{n}_s={v:.3f}" for n, v in out["seconds"].items())
        + f" resolution={sdfs.shape[1]} nnum " + " ".join(
            f"d{d}={int(n)}" for d, n in enumerate(octree.nnum.tolist()))
        + f" overflow={bool(out['graph_out'].any_overflow())} "
        f"k1_launches={recon_launches['graph_conv_fwd']} graph_conv_calls="
        f"{calls} peak_memory_bytes={peak} ({peak / 2**30:.2f} GiB)",
        flush=True)
    want = (VAE_BATCH,) + (cfg.solver.resolution,) * 3
    if tuple(sdfs.shape) != want or not torch.isfinite(sdfs).all():
        raise AssertionError(f"reconstruct: sdf {tuple(sdfs.shape)} (want "
                             f"{want}) or non-finite values")
    if not recon_launches["graph_conv_fwd"] == calls > 0:
        raise AssertionError(f"reconstruct: K1 launches "
                             f"{recon_launches['graph_conv_fwd']} != "
                             f"GraphConv calls {calls}")
    print(f"vae reconstruct sdf: min={sdfs.min().item():.4f} "
          f"max={sdfs.max().item():.4f}", flush=True)
    del sdfs, out, octree
    with tempfile.TemporaryDirectory() as root:
        paths = [os.path.join(root, f"{i}.obj") for i in range(VAE_BATCH)]
        _, out = solver.reconstruct(batch, resolution=VAE_MESH_RESOLUTION,
                                    save_paths=paths)
        sizes = [os.path.getsize(p) if os.path.exists(p) else 0
                 for p in paths]
    print(f"vae reconstruct meshes at {VAE_MESH_RESOLUTION}^3 (barely "
          "trained weights decode noise): " + " ".join(
              f"{n}_s={v:.3f}" for n, v in out["seconds"].items())
          + f" obj_bytes={sizes}", flush=True)
    launches = {name: train_launches[name] for name in measured}
    launches["graph_conv_fwd"] += recon_launches["graph_conv_fwd"]
    return measured, launches


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
        if case == "nan":
            a[0, 2, 1] = float("nan")
            b[1, 5, 0] = float("nan")
        if case == "non_finite":
            a[0, 3, 2] = float("inf")
            a[1, 4, 0] = 1e20
            b[2, 6, 1] = -float("inf")
            b[3, 9, 2] = -1e20
        got, ref = k4.chamfer(a, b), k4.chamfer_plain(a, b)
        torch.cuda.synchronize()
        err = max((g - r).nan_to_num(0.0).abs().max().item()
                  for g, r in zip(got, ref))
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, equal_nan=True, **TOL_CHAMFER)
            if torch.signbit(g[~g.isnan()]).any():
                raise AssertionError(f"-0.0 in K4's output at {case}")
        if case == "nan" and not (got[0][1].isnan().all()
                                  and got[1][0].isnan().all()):
            raise AssertionError("K4 dropped a NaN")
        if case == "non_finite" and not (got[0][0, 3].isnan()
                                         and got[0][1, 4].isinf()):
            raise AssertionError("K4 dropped an infinity")
        del got, ref
        tk = cuda_ms(lambda: k4.chamfer(a, b))
        tkd = device_ms(lambda: k4.chamfer(a, b))
        tp = cuda_ms(lambda: k4.chamfer_plain(a, b))
        tl = cuda_ms(lambda: cdist_minima(a, b))
        cost = roofline.chamfer_cost(bsz, n, m)
        bound = stats.add(err, tk, tp, "chamfer", cost, library_ms=tl)
        bound_fp32 = max(roofline.times_ms(*cost))
        if case == "eval":
            cd_ms[bsz] = tk
        print(f"k4 {case} B={bsz} N={n} M={m} max_abs_err={err:.3e} "
              f"tol=rtol {TOL_CHAMFER['rtol']:g} atol {TOL_CHAMFER['atol']:g}"
              f" kernel_ms={tk:.4f} kernel_dev_ms={tkd:.4f} plain_ms="
              f"{tp:.4f} library_ms={tl:.4f} bound_ms={bound:.4f} "
              f"share_of_bound={bound / tk:.3f} share_of_bound_dev="
              f"{bound / tkd:.3f} bound_fp32_ms={bound_fp32:.4f} "
              f"share_of_fp32_bound_dev={bound_fp32 / tkd:.3f}", flush=True)
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
        bound = stats.add(err, tk, tp, "graph_conv_fwd_packed",
                          roofline.graph_conv_fwd_cost(lvl.g_cap, c, cout, e),
                          k1_ms=t1)
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
        # untrained weights: the EMA a trainer would hold is the weights
        ckpt_path = ckpt.save(os.path.join(root, "ckpt"),
                              params.union_checkpoint(solver.df, ema=None),
                              step=0)
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


def cli_config(root, location, filelist) -> str:
    """Phase 19's YAML: ``configs/octfusion_snet_uncond.yaml`` with the
    changes its first line lists."""
    from octfusion_tpu_torch.config import dump_config, load_config

    cfg = load_config(TRAIN_CONFIG)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, location=location,
                                      filelist=filelist),
        train=dataclasses.replace(cfg.train, print_freq=1,
                                  save_latest_freq=2, display_freq=3),
        solver=dataclasses.replace(cfg.solver,
                                   resolution=CLI_TRAIN_RESOLUTION))
    path = os.path.join(root, "config.yaml")
    dump_config(cfg, path)
    with open(path) as fh:
        body = fh.read()
    with open(path, "w") as fh:
        fh.write("# configs/octfusion_snet_uncond.yaml with these changes: "
                 "data.location and data.filelist (a seeded lumpy-sphere\n"
                 "# set), train.print_freq 1, train.save_latest_freq 2, "
                 f"train.display_freq 3, solver.resolution "
                 f"{CLI_TRAIN_RESOLUTION}\n# (barely trained weights decode "
                 "noise, whose 256^3 mesh is ~10^8 faces of text)\n" + body)
    return path


def run_cli(label, argv):
    """One ``python -m octfusion_tpu_torch.train`` run -> (its stdout
    lines, the key=value fields of its last ``[*] trained`` or ``[*]
    generated`` line, the wall seconds).  Raises if it fails or a display
    eval failed."""
    cmd = [sys.executable, "-m", "octfusion_tpu_torch.train", *argv]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=CLI_TIMEOUT)
    wall = time.perf_counter() - t0
    lines = res.stdout.splitlines()
    if res.returncode != 0:
        raise AssertionError(f"{label} failed ({res.returncode}):\n"
                             + "\n".join(lines[-20:])
                             + f"\n{res.stderr[-3000:]}")
    if any("display eval failed" in ln for ln in lines):
        raise AssertionError(f"{label}: a display eval failed:\n"
                             f"{res.stdout[-3000:]}")
    summary = [ln for ln in lines if ln.startswith(("[*] trained",
                                                    "[*] generated"))]
    if not summary:
        raise AssertionError(f"{label}: no summary line:\n"
                             + "\n".join(lines[-20:]))
    fields = dict(tok.split("=", 1) for tok in summary[-1].split()
                  if "=" in tok)
    print(f"cli {label}: wall_s={wall:.3f} | {summary[-1]}", flush=True)
    return lines, fields, wall


def run_recon_eval(root, cfg_path) -> dict:
    """``python -m octfusion_tpu_torch.tools.vae_recon_eval`` on phase
    19's VAE run: ``CLI_RECON_SHAPES`` held-out synthetic shapes at
    ``CLI_TRAIN_RESOLUTION``, scored by K4 -> its JSON line.  Raises unless
    it exits 0, keeps every shape and gives each a finite Chamfer
    distance."""
    cmd = [sys.executable, "-m", "octfusion_tpu_torch.tools.vae_recon_eval",
           "--config", cfg_path, "--run", os.path.join(root, "vae"),
           "--out", os.path.join(root, "recon"), "--count",
           str(CLI_RECON_SHAPES), "--resolution", str(CLI_TRAIN_RESOLUTION)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=CLI_TIMEOUT)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"vae_recon_eval failed ({res.returncode}):\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    out = json.loads(res.stdout.splitlines()[-1])
    if (len(out["shapes"]) != CLI_RECON_SHAPES
            or not all(math.isfinite(cd) for cd in out["cd"])
            or out["chamfer_launches"] < 1):
        raise AssertionError(f"vae_recon_eval: {out}")
    print(f"cli vae_recon_eval: wall_s={wall:.3f} shapes={out['shapes']} "
          f"cd={out['cd']} chamfer_launches={out['chamfer_launches']}",
          flush=True)
    return out


def check_cli_launches(label, f) -> dict:
    """A training run's losses must be finite, K1 launches = GraphConv
    calls and K2 = K3 launches = graph-conv backward calls -> its K1 / K2
    / K3 launches."""
    for k in ("loss_first", "loss_last"):
        if not math.isfinite(float(f[k])):
            raise AssertionError(f"{label}: {k} = {f[k]}")
    got = {k: int(f[f"{k}_launches"]) for k in
           ("graph_conv_fwd", "graph_conv_col", "graph_conv_bwd_dx")}
    calls, bwd = int(f["graph_conv_calls"]), int(
        f["graph_conv_backward_calls"])
    if got["graph_conv_fwd"] != calls or not (
            got["graph_conv_col"] == got["graph_conv_bwd_dx"] == bwd):
        raise AssertionError(f"{label}: launches {got} vs GraphConv calls "
                             f"{calls} and backward calls {bwd}")
    return got


def nonempty_mesh(path) -> int:
    """-> the faces of the ``.obj`` at ``path``; raises if it has none."""
    with open(path) as fh:
        faces = sum(ln.startswith("f ") for ln in fh)
    if not faces:
        raise AssertionError(f"{path} has no face")
    return faces


def check_train_cli(seed) -> dict:
    """Phase 19: the training CLI at the reference-parity widths on a
    ShapeNet-format set: the VAE (then resumed), lr and hr stages
    (grafted, with the VAE as ``--vq_ckpt``), then generate mode of the
    union model and of the VAE, then the VAE's reconstruction Chamfer ->
    the runs' K1 / K2 / K3 / K4 launches."""
    from octfusion_tpu_torch.config import load_config
    from octfusion_tpu_torch.utils import ckpt
    from octfusion_tpu_torch.utils.shapes import write_shapenet_set

    t_phase = time.perf_counter()
    launches = dict.fromkeys(("graph_conv_fwd", "graph_conv_col",
                              "graph_conv_bwd_dx"), 0)
    with tempfile.TemporaryDirectory() as root:
        location, filelist = write_shapenet_set(
            os.path.join(root, "data"), CLI_DATA_SHAPES, CLI_DATA_POINTS,
            load_config(TRAIN_CONFIG).data.point_scale, seed)
        cfg_path = cli_config(root, location, filelist)
        base = ["--config", cfg_path, "--logs_dir", root, "--seed",
                str(seed)]
        vae_ckpt = os.path.join(root, "vae", "ckpt", "steps-latest")
        lr_ckpt = os.path.join(root, "lr", "ckpt", "steps-latest")
        runs = [
            ("vae train", ["--model", "vae", "--name", "vae",
                           "--batch_size", "2", "--max_steps", "3"]),
            ("vae resume", ["--model", "vae", "--name", "vae",
                            "--batch_size", "2", "--max_steps", "5"]),
            ("lr train", ["--model", "union", "--stage", "lr", "--name",
                          "lr", "--batch_size", "4", "--max_steps", "4"]),
            ("hr train", ["--model", "union", "--stage", "hr", "--name",
                          "hr", "--batch_size", "4", "--max_steps", "3",
                          "--vq_ckpt", vae_ckpt, "--pretrain_ckpt",
                          lr_ckpt]),
            ("hr generate", ["--model", "union", "--stage", "hr", "--name",
                             "hr", "--mode", "generate", "--count", "1",
                             "--sampler", "dpmpp", "--sample_steps",
                             str(DPMPP_STEPS), "--vq_ckpt", vae_ckpt]),
            ("vae generate", ["--model", "vae", "--name", "vae", "--mode",
                              "generate", "--count", "1"]),
        ]
        out = {}
        for label, argv in runs:
            out[label] = run_cli(label, base + argv)
            fields = out[label][1]
            if label.endswith("generate"):
                launches["graph_conv_fwd"] += int(
                    fields.get("graph_conv_fwd_launches", 0))
                continue
            for k, v in check_cli_launches(label, fields).items():
                launches[k] += v
        if not any("at step 3" in ln and ln.startswith("[*] resumed")
                   for ln in out["vae resume"][0]):
            raise AssertionError("the second VAE run did not resume at 3")
        if int(out["vae resume"][1]["steps"]) != 2:
            raise AssertionError("the resumed VAE run did not take 2 steps")
        if not any(ln.startswith("[*] grafted unet_lr")
                   for ln in out["hr train"][0]):
            raise AssertionError("the hr run grafted no unet_lr")
        # the graft (as the JAX package's train.py:219-234): the frozen
        # unet_lr is the lr run's, bit for bit, through hr training
        lr_tree = ckpt.restore(lr_ckpt)
        hr_tree = ckpt.restore(os.path.join(root, "hr", "ckpt",
                                            "steps-latest"))
        for k, v in lr_tree["df_unet_lr"].items():
            if not torch.equal(hr_tree["df_unet_lr"][k], v):
                raise AssertionError(f"hr run's unet_lr.{k} changed")
        if all(torch.equal(v, hr_tree["ema_df_unet_hr"][k])
               for k, v in hr_tree["df_unet_hr"].items()):
            raise AssertionError("the hr checkpoint's EMA is its live "
                                 "weights")
        recon = run_recon_eval(root, cfg_path)
        launches["chamfer"] = recon["chamfer_launches"]
        faces = {
            "vae display": nonempty_mesh(os.path.join(
                root, "vae", "train_temp", "recon_3.obj")),
            "hr display": nonempty_mesh(os.path.join(
                root, "hr", "train_temp", "sample_3.obj")),
            "hr generate": nonempty_mesh(os.path.join(
                root, "hr", "results_airplane", "0.obj")),
            "vae generate": nonempty_mesh(os.path.join(
                root, "vae", "results_airplane", "0.obj")),
        }
    for label in ("vae train", "vae resume", "lr train", "hr train"):
        f = out[label][1]
        print(f"cli {label}: ms_per_step={f['ms_per_step']} "
              f"data_s={f['data_s']} first_data_s={f['first_data_s']} "
              f"loss {f['loss_first']} -> "
              f"{f['loss_last']} wall_s={out[label][2]:.3f}", flush=True)
    print(f"cli meshes (faces): {faces}; phase 19 "
          f"{time.perf_counter() - t_phase:.1f} s; launches {launches}",
          flush=True)
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200,
                    help="ancestral steps of each diffusion stage")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

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
    from octfusion_tpu_torch.utils.device import use_fp32_math

    dev = torch.device("cuda")
    card = smi()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    use_fp32_math()

    # ---- 2. build: one nvcc per source, all at once ------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        builds = [pool.submit(mod.build) for mod in (graph_conv_cuda,
                                                     chamfer_cuda)]
        for fut in builds:
            fut.result()
    print(f"build: graph_conv.cu (K1, K2, K3, K5) and chamfer.cu (K4) "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 9. K4 vs plain; CD / EMD pairs/s (first: its device times come
    # from profiler traces, which a fresh process takes reliably) ---------
    k4 = check_chamfer(args.seed)
    k4.summary("k4 phase 9")

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
    k1.summary("k1 phase 3 (sampling)")

    # ---- 11. K5 vs plain and K1 on the sampling graph's levels 4-6 -----
    k5 = check_packed_kernel(
        warm["graph"], {sh for sh in shapes if sh[0] <= m.depth_stop}
        | RAGGED_PACKED,
        torch.Generator(device=dev).manual_seed(args.seed + 6))
    k5.summary("k5 phase 11")

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

    # ---- 14. lr training ----------------------------------------------
    check_lr_training(args.seed)

    # ---- 15-18. VAE training and reconstruction -----------------------
    vae_measured, vae_launches = check_vae_training(args.seed)
    for name, stats in vae_measured.items():
        measured[name].merge(stats)
        launches[name] += vae_launches[name]

    measured["chamfer"] = k4

    # ---- 10. evaluation from meshes ----------------------------------
    launches["chamfer"] = check_evaluation(args.seed)
    measured["graph_conv_fwd_packed"] = k5
    launches["graph_conv_fwd_packed"] = k5_launches

    # ---- 19. the training CLI -----------------------------------------
    for name, n in check_train_cli(args.seed).items():
        launches[name] += n

    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
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
