"""Smoke run of the PyTorch port (``octfusion_tpu_torch``) on one NVIDIA GPU.

Drives the port's two main paths at the full width of the reference-parity
model with seeded random weights, and checks the hand-written CUDA
graph-conv kernels they run (K1 forward, K2 column buffer, K3 input
gradient):

1. device: the card's name and power limit; TF32 off for matmul and cuDNN;
2. build: the kernels are compiled from ``octfusion_tpu_torch/csrc``;
3. K1 vs plain: on the graph levels 4-8 of a short warm-up cascade, at
   every (C, C') pair the cascade's graph convs use, the kernel against its
   plain PyTorch version on the same tensors (rtol = atol = 1e-4), timed
   with CUDA events;
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
   warm-up steps, the stage split and the peak memory.

Prints the kernel summary as a JSON line (each kernel's ``launches`` is
its count over the counted runs of phases 5 and 8; ``ms`` / ``plain_ms``
sum the median times of phases 3 and 6), then the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Any failure raises:
there is no CPU fallback.  The run uses one card, the first visible one.
Usage: ``python3 chip_smoke.py [--steps N] [--seed S]``.
"""

import argparse
import copy
import json
import math
import os
import statistics
import subprocess
import time

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
SOURCE = "octfusion_tpu_torch/csrc/graph_conv.cu"
_PALLAS = "octfusion_tpu/ops/pallas/graph_conv_kernel.py"
REPLACES = {"graph_conv_fwd": f"{_PALLAS}:41",
            "graph_conv_col": f"{_PALLAS}:80",
            "graph_conv_bwd_dx": f"{_PALLAS}:110"}


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


def check_kernel(graph, shapes, gen):
    """Phases 3 and 6: K1 vs its plain version at each (level, C, C') of
    ``graph`` -> (max abs err, summed kernel ms, summed plain ms)."""
    from octfusion_tpu_torch.ops import graph_conv_cuda as k1

    dev = torch.device("cuda")
    worst, ms_k, ms_p = 0.0, 0.0, 0.0
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
        tk = cuda_ms(lambda: k1.graph_conv(x, w, row_ptr, col, scale))
        tp = cuda_ms(lambda: k1.graph_conv_plain(
            x, w, lvl.edge_row, lvl.edge_col, lvl.edge_dir, lvl.edge_scale))
        print(f"k1 d={d} G={lvl.g_cap} E={int(lvl.n_edges)} C={c} C'={cout}"
              f" max_abs_err={err:.3e} max_rel_err={err / ref_max:.3e}"
              f" tol=rtol {TOL_KERNEL['rtol']:g} atol {TOL_KERNEL['atol']:g}"
              f" kernel_ms={tk:.4f} plain_ms={tp:.4f}", flush=True)
        torch.testing.assert_close(got, ref, **TOL_KERNEL)
        worst = max(worst, err)
        ms_k += tk
        ms_p += tp
    return worst, ms_k, ms_p


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
    -> {kernel: (max abs err, summed kernel ms, summed plain ms)}."""
    from octfusion_tpu_torch.ops import graph_conv_cuda as k

    dev = torch.device("cuda")
    res = {"graph_conv_col": [0.0, 0.0, 0.0],
           "graph_conv_bwd_dx": [0.0, 0.0, 0.0]}
    for d, c, cout in sorted(shapes):
        lvl = graph.level(d)
        csr, csr_t = lvl.csr(), lvl.csr_t()
        edges = (lvl.edge_row, lvl.edge_col, lvl.edge_dir, lvl.edge_scale)
        x = torch.randn(lvl.g_cap, c, device=dev, generator=gen)
        dout = torch.randn(lvl.g_cap, cout, device=dev, generator=gen)
        w = torch.randn(7 * c, cout, device=dev, generator=gen) / (7 * c) ** 0.5
        runs = {
            "graph_conv_col": (lambda: k.graph_conv_col(x, *csr),
                               lambda: k.graph_conv_col_plain(x, *edges)),
            "graph_conv_bwd_dx": (
                lambda: k.graph_conv_bwd_dx(dout, w, *csr_t),
                lambda: k.graph_conv_bwd_dx_plain(dout, w, *edges)),
        }
        line = [f"d={d} G={lvl.g_cap} E={int(lvl.n_edges)} C={c} C'={cout}"]
        for name, (kern, plain) in runs.items():
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            if not ref.abs().max().item() > 0:
                raise AssertionError(f"all-zero {name} reference at {line}")
            torch.testing.assert_close(got, ref, **TOL_KERNEL)
            del got, ref
            tk, tp = cuda_ms(kern), cuda_ms(plain)
            r = res[name]
            r[0], r[1], r[2] = max(r[0], err), r[1] + tk, r[2] + tp
            line.append(f"{name} max_abs_err={err:.3e} kernel_ms={tk:.4f} "
                        f"plain_ms={tp:.4f}")
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
    from octfusion_tpu_torch.ops import graph_conv_cuda
    from octfusion_tpu_torch.utils import mesh as mesh_utils
    from octfusion_tpu_torch.utils import sdf as sdf_utils

    dev = torch.device("cuda")
    card = smi()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build ----------------------------------------------------
    t0 = time.perf_counter()
    graph_conv_cuda.build()
    print(f"build: graph_conv.cu (K1, K2, K3) {time.perf_counter() - t0:.2f} s",
          flush=True)

    cfg = Config()
    m = cfg.model
    torch.manual_seed(args.seed)
    solver = UnionSolver(cfg, device=dev)
    gen = torch.Generator(device=dev)

    # ---- 3. kernel vs plain on a warm-up cascade's levels -------------
    shapes = set()
    hooks = conv_shape_hooks([solver.df, solver.vae], shapes)
    warm = solver.sample(steps=2, resolution=RESOLUTION,
                         generator=gen.manual_seed(args.seed + 1))
    for h in hooks:
        h.remove()
    g_warm = warm["decode_out"]["graph_out"]
    k1 = check_kernel(
        g_warm, shapes, torch.Generator(device=dev).manual_seed(args.seed))

    # ---- 4. one full-width hr denoise step, card vs CPU ---------------
    check_hr_step(solver, warm["graph"], args.seed)
    del warm, g_warm    # the peak below is the cascade's alone

    # ---- 5. the cascade ----------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    graph_conv_cuda.reset_launches()
    GraphConv.calls = 0
    t0 = time.perf_counter()
    out = solver.sample(steps=args.steps, resolution=RESOLUTION,
                        generator=gen.manual_seed(args.seed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = graph_conv_cuda.launches["graph_conv_fwd"]
    calls = GraphConv.calls
    peak = torch.cuda.max_memory_allocated()
    print(f"cascade: steps={args.steps}+{args.steps} wall_s={wall:.3f} "
          + " ".join(f"{k}_s={v:.3f}" for k, v in out["seconds"].items()),
          flush=True)
    print(f"k1 launches={launches} graph_conv_calls={calls}", flush=True)
    if not (launches == calls and launches > 0):
        raise AssertionError(f"kernel launches {launches} != GraphConv "
                             f"calls {calls}")

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

    # ---- 6-8. training ------------------------------------------------
    measured, train_launches = check_training(args.seed)
    # K1's entry covers both phases: the worst error, the summed times
    k1_train = measured["graph_conv_fwd"]
    measured["graph_conv_fwd"] = (max(k1[0], k1_train[0]), k1[1] + k1_train[1],
                                  k1[2] + k1_train[2])
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": SOURCE,
        "replaces": REPLACES[name],
        "launches": train_launches[name] + (
            launches if name == "graph_conv_fwd" else 0),
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
    } for name, (err, ms, plain_ms) in measured.items()]}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
