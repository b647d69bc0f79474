"""Training / generation entry point of the port: the counterpart of the
JAX package's ``train.py``, on one card or, under ``torchrun``, one
process per card.

    python -m octfusion_tpu_torch.train --model vae --mode train \\
        --config configs/octfusion_snet_uncond.yaml --name vae
    python -m octfusion_tpu_torch.train --model union --stage lr \\
        --mode train --config ... --name lr
    python -m octfusion_tpu_torch.train --model union --stage hr \\
        --mode train --config ... --name hr \\
        --vq_ckpt logs/vae/ckpt/steps-latest \\
        --pretrain_ckpt logs/lr/ckpt/steps-latest
    python -m octfusion_tpu_torch.train --model union --stage hr \\
        --mode generate --config ... --name hr --count 4 \\
        --vq_ckpt logs/vae/ckpt/steps-latest

The 3-stage model (``--model union_3t``; a config whose
``diffusion.unet_type`` is lr, hr, feature, e.g.
``configs/octfusion_obja_uncond.yaml``'s diffusion over a VAE whose
``depth_stop`` is ``input_depth[2]``) trains stage by stage:

    python -m octfusion_tpu_torch.train --model union_3t --stage lr \\
        --config cfg3t.yaml --name lr3
    python -m octfusion_tpu_torch.train --model union_3t --stage hr \\
        --config cfg3t.yaml --name hr3 \\
        --pretrain_ckpt logs/lr3/ckpt/steps-latest
    python -m octfusion_tpu_torch.train --model union_3t --stage feature \\
        --config cfg3t.yaml --name feat3 \\
        --vq_ckpt logs/vae10/ckpt/steps-latest \\
        --pretrain_ckpt logs/hr3/ckpt/steps-latest
    python -m octfusion_tpu_torch.train --model union_3t --stage feature \\
        --mode generate --config cfg3t.yaml --name feat3 --count 4 \\
        --vq_ckpt logs/vae10/ckpt/steps-latest

Train mode reads ``data`` of the config (``name: synthetic`` or the
reference's ShapeNet layout), skips samples whose octree or dual graph
would overflow the static capacities, and trains ``--max_steps`` steps
(default: the loader's batches per epoch times ``train.epochs``).  Step
``it`` prints its losses when ``it % train.print_freq == 0``, writes a
reconstruction (vae) or sample (union hr, union_3t feature) mesh at
``min(resolution, 128)``
under ``<run>/train_temp`` every ``train.display_freq`` steps, and saves
``<run>/ckpt/steps-<N>.pth`` every ``train.save_latest_freq`` steps and at
the end (the newest ``train.ckpt_num`` are kept).  A run resumes from
``--ckpt`` or from its own latest checkpoint; as in the JAX package, the
resumed run restarts its data order and random draws from ``--seed``.
A union checkpoint holds the reference layout (``df_unet_<kind>``,
``ema_df_unet_<kind>``) and ``train_state``; a VAE checkpoint holds
``autoencoder`` and ``train_state``, so it serves as ``--vq_ckpt``.
``--vq_ckpt`` also reads the reference's ``.pth``; it cannot read the JAX
package's orbax checkpoint directories; the hr (union) and feature
(union_3t) stages without it warn and train on random VAE weights.
``--pretrain_ckpt`` grafts the earlier stages' U-Nets (weights and EMA)
of a previous run: ``unet_lr`` into an hr run, ``unet_lr`` and
``unet_hr`` into a feature run; the grafted U-Nets stay frozen.  The 3-stage
model's checkpoints add ``df_unet_feature`` / ``ema_df_unet_feature``.
The run ends with one
line: ms/step (median after the first), the seconds per step spent
waiting on the loader (``data_s``, mean after the first; the first
step's own wait is ``first_data_s``), the first and last loss, the
graph-conv kernels' launches, the GraphConv forward and backward calls,
and the peak memory.

Generate mode: ``--model union --stage hr`` and ``--model union_3t
--stage feature`` run ``generate.main`` on the run's latest (or
``--ckpt``'s) EMA weights; ``--stage lr`` writes each shape's sampled
split grid as ``results_<category>/<i>.npz`` (``split_small``, the layout
``data.load_split_small`` reads), and ``--model union_3t --stage hr``
adds its ``split_large`` ([G_cap, 8] on the depth-``input_depth[1]``
graph's layout); ``--model vae`` reconstructs dataset item i into
``results_<category>/<i>.obj``.

Several cards (data parallelism, ``parallel/``):

    torchrun --nproc_per_node N -m octfusion_tpu_torch.train --model vae \\
        --config ... --name vae

Each process joins the group (NCCL; gloo where the host runs more ranks
than it has cards, which then share them) and takes
``cuda:$LOCAL_RANK``.  The ranks form the
config's ``mesh`` (``data_axis`` x ``model_axis``; -1 = every rank the
model axis leaves); the global batch ``data.batch_size`` is rounded down
to a multiple of the data axis (at least one row per data index), the
loader of data index d yields the rows of its stripe (model-axis peers
the same rows; the VAE splits their SDF queries over the model axis), and
each step averages the gradients and losses over all ranks
(``parallel/train_step``).  Rank 0 alone prints, writes the visualiser,
the display meshes and the checkpoints; every rank resumes from the same
file.  ``--mode generate`` stripes the shapes over a mesh of W data
indices (``parallel.train_step.stripe``): rank r makes r, r + W, ...

Runs on the card unless ``--device cpu``; without a card the default
raises.  Computes in fp32 with TF32 off, as the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import time
import traceback
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import config as config_lib
from . import generate as generate_lib
from .data import loader as loader_lib
from .data.dataset import CapacityFilteredDataset, collate, get_dataset
from .data.shapenet import category_5_to_label
from .models.common import batch_to_device
from .models.union_3t_solver import Union3TSolver
from .models.union_solver import UnionSolver
from .models.vae_solver import VAESolver, VAETrainStep
from .nn.modules import GraphConv
from .ops import graph_conv_cuda
from .parallel import dist as pdist
from .parallel import train_step as pts
from .parallel.mesh import make_mesh
from .utils import ckpt as ckpt_lib
from .utils import params as params_lib
from .utils import sdf as sdf_utils
from .utils import trace
from .utils.device import peak_memory, resolve_device, use_fp32_math
from .utils.overflow import OverflowMonitor
from .utils.visualizer import Visualizer
from .utils.watchdog import StallWatchdog

# the U-Nets ``--pretrain_ckpt`` grafts into each stage
GRAFTS = {"hr": ("lr",), "feature": ("lr", "hr")}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=["vae", "union", "union_3t"],
                   default="vae")
    p.add_argument("--stage", choices=["lr", "hr", "feature"], default="hr")
    p.add_argument("--mode", choices=["train", "generate"], default="train")
    p.add_argument("--config", required=True)
    p.add_argument("--name", default=None)
    p.add_argument("--logs_dir", default=None)
    p.add_argument("--ckpt", default=None,
                   help="checkpoint to resume from (train) or to load "
                        "(generate); default: the run's latest")
    p.add_argument("--vq_ckpt", default=None,
                   help="frozen VAE checkpoint file: a VAE run's "
                        "steps-<N>.pth or the reference's .pth (orbax "
                        "directories of the JAX package are not read)")
    p.add_argument("--pretrain_ckpt", default=None,
                   help="an earlier stage's checkpoint: its unet_lr is "
                        "grafted into an hr run, its unet_lr and unet_hr "
                        "into a feature run")
    p.add_argument("--category", default="airplane")
    p.add_argument("--count", type=int, default=4,
                   help="number of shapes to generate")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--sampler", choices=["ancestral", "dpmpp"], default=None,
                   help="override diffusion.sampler (dpmpp = "
                        "DPM-Solver++(2M))")
    p.add_argument("--sample_steps", type=int, default=None,
                   help="override diffusion.ddim_steps for generation")
    p.add_argument("--pos_weight", type=float, default=None,
                   help="override diffusion.lr_pos_weight (occupancy-"
                        "weighted lr split loss; 1.0 = reference parity)")
    p.add_argument("--profile", type=int, default=0,
                   help="trace N steps with torch.profiler (written to "
                        "<run_dir>/profile/trace.json), with the program's "
                        "own spans on: the stages octf.train.*, the "
                        "gathers octf.gather.* and the all-reduce")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def configure(args) -> config_lib.Config:
    """The config file with the command line's overrides: those of
    ``generate.configure``, the batch size and ``lr_pos_weight``."""
    cfg = generate_lib.configure(args)
    if args.batch_size:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, batch_size=args.batch_size))
    if args.pos_weight is not None:
        cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(
            cfg.diffusion, lr_pos_weight=args.pos_weight))
    return cfg


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------
def training_checkpoint(step) -> Dict:
    """The checkpoint tree of a ``TrainStep`` or ``VAETrainStep``: the
    weights (reference layout, the EMA under ``ema_df_unet_*``; or
    ``autoencoder``) and ``train_state`` (step, optimizer, scheduler)."""
    state = step.state_dict()
    if isinstance(step, VAETrainStep):
        return {"autoencoder": {k: v.detach().cpu() for k, v in
                                step.solver.vae.state_dict().items()},
                "train_state": state}
    ema = state.pop("ema")
    return {**params_lib.union_checkpoint(step.solver.df, ema),
            "train_state": state}


def restore_training(step, tree: Dict) -> None:
    """Load :func:`training_checkpoint`'s ``tree`` into ``step`` and its
    solver's modules."""
    if "train_state" not in tree:
        raise ValueError("the checkpoint holds no train_state: it was not "
                         "written by this trainer")
    if isinstance(step, VAETrainStep):
        step.solver.vae.load_state_dict(tree["autoencoder"], strict=True)
        step.load_state_dict(tree["train_state"])
        return
    params_lib.load_union_checkpoint(step.solver.df, tree, ema=False)
    step.load_state_dict({**tree["train_state"],
                          "ema": params_lib.union_ema(tree)})


# ----------------------------------------------------------------------
# the training loop
# ----------------------------------------------------------------------
def train_loop(step, batches, n_steps: int, start: int = 0,
               draws: Optional[Callable[[int], Dict]] = None,
               generator: Optional[torch.Generator] = None, device="cpu",
               print_freq: int = 0, vis: Optional[Visualizer] = None,
               save_freq: int = 0, save: Optional[Callable] = None,
               display_freq: int = 0, display: Optional[Callable] = None,
               profile: int = 0, profile_dir: Optional[str] = None) -> Dict:
    """Steps ``start .. n_steps - 1`` of ``step`` (a ``TrainStep`` or
    ``VAETrainStep``), step ``it`` on the next collated batch of the
    iterator ``batches`` (moved to ``device``) with the random draws
    ``draws(it)`` (the step's keyword draws: eps / times / noise) or, by
    default, drawn from ``generator``.  Every step feeds an
    ``OverflowMonitor``.  When ``it % print_freq == 0``, ``vis`` prints
    the losses with the t/it since the previous print, the monitor checks
    and the stall watchdog is poked; after step ``it``, ``display(it)``
    runs when ``(it + 1) % display_freq == 0`` and ``save(it + 1)`` when
    ``(it + 1) % save_freq == 0``.  ``profile`` > 0 traces steps
    ``start + 1 .. start + profile`` into ``profile_dir``, with the
    program's spans (``utils/trace``) on while it records.  The monitor
    checks again at the end.  -> {"step_s": wall seconds of each step
    (the device synchronised at its end), "data_s": seconds of each step
    spent waiting on ``batches``, "loss": each step's loss, "last": the
    last step's loss dict}."""
    device = torch.device(device)
    sync = ((lambda: torch.cuda.synchronize(device))
            if device.type == "cuda" else (lambda: None))
    step_s, data_s, losses, out = [], [], [], {}
    ovf = OverflowMonitor()
    dog = StallWatchdog()
    prof = None
    t_print, last_print = time.perf_counter(), start - 1
    try:
        for it in range(start, n_steps):
            if profile and it == start + 1:
                prof = _profiler(device)
                prof.start()
            t0 = time.perf_counter()
            raw = next(batches)
            t1 = time.perf_counter()
            batch = batch_to_device(raw, device)
            kw = draws(it) if draws is not None else {"generator": generator}
            out = step(batch, **kw)
            ovf.update(out)
            sync()
            step_s.append(time.perf_counter() - t0)
            data_s.append(t1 - t0)
            losses.append(float(out["loss"]))
            if print_freq and it % print_freq == 0:
                now = time.perf_counter()
                dt = (now - t_print) / max(it - last_print, 1)
                t_print, last_print = now, it
                if vis is not None:
                    vis.print_current_errors(it, out, dt)
                ovf.check()
                dog.poke()
            if prof is not None and it == start + profile:
                _stop_profiler(prof, profile_dir)
                prof = None
            if display_freq and (it + 1) % display_freq == 0:
                display(it)
            if save_freq and (it + 1) % save_freq == 0:
                save(it + 1)
    finally:
        dog.stop()
        if prof is not None:
            _stop_profiler(prof, profile_dir)
    ovf.check()
    return {"step_s": step_s, "data_s": data_s, "loss": losses, "last": out}


def _profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    trace.enable()
    return torch.profiler.profile(activities=acts)


def _stop_profiler(prof, profile_dir) -> None:
    prof.stop()
    trace.disable()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[*] profile written to {path}", flush=True)


def loop_summary(stats: Dict, what: str, dev, sync=None) -> str:
    """The run's final line; ``sync``, a data-parallel step's
    ``GradSync``, adds the gradient all-reduce's bytes and median ms."""
    walls, waits = stats["step_s"], stats["data_s"]
    later = slice(1, None) if len(walls) > 1 else slice(None)
    timing = (f"ms_per_step={statistics.median(walls[later]) * 1e3:.3f} "
              f"(median after the first) first_step_ms={walls[0] * 1e3:.3f} "
              f"data_s={statistics.mean(waits[later]):.4f} (mean wait on "
              f"the loader per step after the first) first_data_s="
              f"{waits[0]:.4f} loss_first="
              f"{stats['loss'][0]:.6f} loss_last={stats['loss'][-1]:.6f}"
              if walls else "ms_per_step=n/a data_s=n/a")
    return (f"[*] trained {what} on {dev}: steps={len(walls)} {timing}"
            + "".join(f" {k}_launches={n}"
                      for k, n in graph_conv_cuda.launches.items())
            + f" graph_conv_calls={GraphConv.calls} graph_conv_backward_calls="
            f"{graph_conv_cuda.GraphConvFunction.backward_calls} "
            + (f"world={pdist.world_size()} allreduce_bytes={sync.bytes} "
               f"allreduce_ms={statistics.median(sync.seconds) * 1e3:.3f} "
               if sync is not None and sync.seconds else "")
            + peak_memory(dev))


# ----------------------------------------------------------------------
# modes
# ----------------------------------------------------------------------
def _label(cfg, category, dev):
    if cfg.diffusion.num_classes is None:
        return None
    return torch.full((1,), category_5_to_label[category], dtype=torch.int64,
                      device=dev)


def _one(dataset, i, dev):
    """Dataset item ``i`` (modulo its length) as a batch of one on
    ``dev``."""
    return batch_to_device(collate([dataset[i % len(dataset)]]), dev)


def _solver_class(args):
    return Union3TSolver if args.model == "union_3t" else UnionSolver


def _makes_mesh(args) -> bool:
    """Whether the model and stage decode a shape (the VAE, the 2-stage
    hr stage, the 3-stage feature stage)."""
    return (args.model == "vae" or args.stage == "feature"
            or (args.model == "union" and args.stage == "hr"))


def generate_mode(args, cfg, run_dir, dev):
    """-> the paths written."""
    if args.model != "vae" and _makes_mesh(args):
        argv = ["--config", os.path.join(run_dir, "config.yaml"),
                "--category", args.category, "--count", str(args.count),
                "--seed", str(args.seed), "--device", str(dev)]
        for flag, v in (("--ckpt", args.ckpt), ("--vq_ckpt", args.vq_ckpt)):
            if v:
                argv += [flag, v]
        return generate_lib.main(argv)
    rdir = os.path.join(run_dir, f"results_{args.category}")
    os.makedirs(rdir, exist_ok=True)
    ext = "obj" if args.model == "vae" else "npz"
    mine = pts.stripe(range(args.count), make_mesh())
    todo = [i for i in mine
            if not os.path.exists(os.path.join(rdir, f"{i}.{ext}"))]
    if len(todo) < len(mine):
        print(f"[*] {len(mine) - len(todo)}/{len(mine)} results already "
              "present; generating the rest")
    path = args.ckpt or ckpt_lib.latest_path(os.path.join(run_dir, "ckpt"))
    tree = ckpt_lib.restore(path) if path else None
    if tree is None:
        print(f"[warn] no checkpoint given or in {run_dir}/ckpt; using "
              "random weights")
    torch.manual_seed(args.seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    written, stages = [], []
    if args.model == "vae":
        solver = VAESolver(cfg, device=dev)
        if tree is not None:
            solver.vae.load_state_dict(tree["autoencoder"], strict=True)
        dataset = get_dataset(cfg.data)
        for i in todo:
            out = os.path.join(rdir, f"{i}.obj")
            stages.append(solver.reconstruct(_one(dataset, i, dev),
                                             save_paths=[out])[1]["seconds"])
            if os.path.exists(out):     # an empty mesh writes no file
                written.append(out)
                print(f"[*] wrote {out}", flush=True)
            else:
                print(f"[!] empty mesh, skipped {out}")
    else:
        solver = _solver_class(args)(cfg, stage_flag=args.stage, device=dev)
        if tree is not None:
            params_lib.load_union_checkpoint(solver.df, tree)
        label = _label(cfg, args.category, dev)
        for i in todo:
            gen = torch.Generator(device=dev).manual_seed(
                generate_lib.shape_seed(args.seed, i))
            out = solver.sample(batch_size=1, label=label, generator=gen)
            path = os.path.join(rdir, f"{i}.npz")
            arrays = {"split_small": out["split_small"][0]}
            if "split_large" in out:
                arrays["split_large"] = out["split_large"]
            np.savez(path, **{k: v.cpu().numpy() for k, v in arrays.items()})
            stages.append(out["seconds"])
            written.append(path)
            print(f"[*] wrote {path}", flush=True)
    if stages:
        print(generate_lib.summary(stages, dev), flush=True)
    return written


def striped_loader(dataset, cfg, mesh=None, say=print):
    """The training loader: the whole batch in one process; under the
    data-parallel ``mesh``, the global batch ``data.batch_size`` rounded
    down to a multiple of the data axis (at least one row per data index)
    and this rank's data index's stripe of the sampler, so that
    model-axis peers load the same rows."""
    batch_size, data_index, n_data = cfg.data.batch_size, 0, 1
    if mesh is not None:
        data_index, n_data = mesh.coords()[0], mesh.data
        global_batch = max(n_data, batch_size // n_data * n_data)
        if global_batch != batch_size:
            say(f"[*] global batch {batch_size} -> {global_batch} (a "
                f"multiple of the data axis, {n_data})")
        batch_size = global_batch // n_data
        say(f"[*] data parallel over {mesh.size} ranks: mesh data "
            f"{mesh.data} x model {mesh.model}, {batch_size} rows per data "
            "index")
    return loader_lib.DataLoader(dataset, batch_size, cfg.data.shuffle,
                                 cfg.train.seed, cfg.data.num_workers,
                                 rank=data_index, world_size=n_data)


def shard_rows(batches, mesh, vae: bool):
    """A rank-striped loader's batches with the VAE's SDF queries split
    over the model axis (``parallel.train_step.shard_batch``); closing it
    closes ``batches``."""
    try:
        for b in batches:
            yield pts.shard_batch(b, mesh, vae, rows_local=True)
    finally:
        batches.close()


def train_mode(args, cfg, run_dir, dev) -> Dict:
    m = cfg.model
    ckpt_dir = os.path.join(run_dir, "ckpt")
    main_rank = pdist.is_main()
    say = print if main_rank else (lambda *a, **k: None)
    vis = Visualizer(run_dir, enabled=main_rank)
    # reject samples that would overflow the static octree and graph
    # capacities before they poison a step
    dataset = CapacityFilteredDataset(
        get_dataset(cfg.data), cfg.capacity.octree_spec(m.depth, m.full_depth),
        edge_factor=cfg.capacity.edge_factor)
    mesh = (make_mesh(cfg.mesh.data_axis, cfg.mesh.model_axis)
            if pdist.world_size() > 1 else None)
    dl = striped_loader(dataset, cfg, mesh, say)
    total_steps = args.max_steps or len(dl) * cfg.train.epochs

    torch.manual_seed(args.seed)
    if args.model == "vae":
        solver = VAESolver(cfg, device=dev)
        step = (pts.make_vae_dp_train_step(solver, mesh, total_steps,
                                           args.seed) if mesh is not None
                else solver.make_train_step(total_steps))
        what = "vae"
    else:
        solver = _solver_class(args)(cfg, stage_flag=args.stage, device=dev)
        step = (pts.make_union_dp_train_step(solver, mesh, args.seed)
                if mesh is not None else solver.make_train_step())
        what = f"{args.model} {args.stage}"
        if args.vq_ckpt:
            params_lib.load_vae_checkpoint(solver.vae, args.vq_ckpt)
            say(f"[*] loaded VAE weights from {args.vq_ckpt}")
        elif _makes_mesh(args):
            # the stages that encode (training) or decode (display) shapes
            say("[warn] no --vq_ckpt given; using random VAE weights")
        if args.pretrain_ckpt:
            for kind in params_lib.graft_union_checkpoint(
                    solver.df, step.ema, ckpt_lib.restore(args.pretrain_ckpt),
                    GRAFTS.get(args.stage, ())):
                say(f"[*] grafted unet_{kind} from {args.pretrain_ckpt}")

    pdist.barrier()     # every rank resumes from the same file
    resume = args.ckpt or ckpt_lib.latest_path(ckpt_dir)
    if resume:
        restore_training(step, ckpt_lib.restore(resume))
        say(f"[*] resumed from {resume} at step {step.step}")
        if args.pretrain_ckpt and args.model != "vae" and args.stage != "lr":
            # the resumed state holds this run's own (frozen) earlier
            # U-Nets: an extended earlier run does not reach a resumed one
            say("[!] NOTE: --pretrain_ckpt graft is superseded by the "
                "resumed checkpoint's own (frozen) subtrees; start a "
                "fresh run dir to re-graft an updated pretrain stage")

    ddir = os.path.join(run_dir, "train_temp")
    res = min(cfg.solver.resolution, 128)

    def display(it):
        # a periodic qualitative check must not stop training
        os.makedirs(ddir, exist_ok=True)
        try:
            if args.model == "vae":
                solver.reconstruct(
                    _one(dataset, it, dev), resolution=res,
                    save_paths=[os.path.join(ddir, f"recon_{it + 1}.obj")])
            else:
                gen = torch.Generator(device=dev).manual_seed(
                    generate_lib.shape_seed(args.seed, it))
                with step.ema_weights():
                    out = solver.sample(batch_size=1, resolution=res,
                                        generator=gen)
                s = cfg.solver.sdf_scale
                sdf_utils.export_meshes(
                    out["sdfs"], [os.path.join(ddir, f"sample_{it + 1}.obj")],
                    bbmin=-s, bbmax=s, mesh_scale=cfg.data_test.point_scale)
            print(f"[*] display eval written under {ddir}")
        except Exception:
            print("[warn] display eval failed:")
            traceback.print_exc()

    def save(n):
        if main_rank:
            ckpt_lib.save(ckpt_dir, training_checkpoint(step), n,
                          cfg.train.ckpt_num)
            print(f"[*] saved checkpoint at step {n}")

    graph_conv_cuda.reset_launches()
    GraphConv.calls = 0
    graph_conv_cuda.GraphConvFunction.backward_calls = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t = cfg.train
    batches = iter(dl)
    if mesh is not None:
        batches = shard_rows(batches, mesh, args.model == "vae")
    # a data-parallel step draws from its rank's generator
    gen = getattr(step, "generator", None)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
    try:
        stats = train_loop(
            step, batches, total_steps, start=step.step, generator=gen,
            device=dev, print_freq=t.print_freq, vis=vis,
            save_freq=t.save_latest_freq, save=save,
            # the lr stage (and the 3-stage hr stage) makes no mesh
            display_freq=(t.display_freq if _makes_mesh(args) and main_rank
                          else 0),
            display=display,
            profile=args.profile if main_rank else 0,
            profile_dir=os.path.join(run_dir, "profile"))
    finally:
        batches.close()
        vis.close()
    save(total_steps)
    pdist.barrier()     # the last checkpoint exists before any rank ends
    say(loop_summary(stats, what, dev, getattr(step, "sync", None)),
        flush=True)
    return stats


def main(argv=None):
    args = parse_args(argv)
    if args.model == "union" and args.stage == "feature":
        raise SystemExit("--stage feature is the 3-stage model's: use "
                         "--model union_3t")
    # under torchrun: join the process group before anything else
    joined = pdist.maybe_initialize(args.device)
    try:
        dev = resolve_device(pdist.local_device(args.device))
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        use_fp32_math()
        if joined:
            pdist.announce(dev)
        cfg = configure(args)
        run_dir = os.path.join(cfg.train.logs_dir, cfg.train.name)
        if pdist.is_main():
            os.makedirs(run_dir, exist_ok=True)
            config_lib.dump_config(cfg, os.path.join(run_dir, "config.yaml"))
        pdist.barrier()
        if args.mode == "generate":
            return generate_mode(args, cfg, run_dir, dev)
        return train_mode(args, cfg, run_dir, dev)
    finally:
        if joined:
            pdist.shutdown()


if __name__ == "__main__":
    main()
