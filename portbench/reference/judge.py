"""The comparisons that decide a run's ``correct``: the program's outputs
against this package's plain reference, computed again from the inputs the
benchmark made (weights, noise, batches, draws) and never from anything
the program derived from them.

Generation (:func:`judge_gen`).  A cascade's topology is a discrete
function of its samples (the lr stage snaps its x0 predictions to signs
inside the loop; each grow splits on a sign, the decoder on an argmax), so
a decision that rounding flips would part the two cascades for good.  The
judge therefore follows the checked run step by step:

* every U-Net call of the run is recomputed by the reference from the
  run's own input, time and self-condition, on the graph the reference
  grew itself, and the outputs are compared;
* the reference's sampler is replayed on the run's U-Net outputs, from
  the initial noise the benchmark made, and each state it reaches is
  compared with the state the run fed its next call, and the last with
  the stage's output;
* the reference grows each graph from the run's stage output, and decodes
  the run's codes with the split decisions the run's own logits make
  (``GraphVAE.decode_grow(labels=...)``), comparing the logits, the
  finest planes and the SDF grid it computes from them.

Each stage gives one number, the worst relative gap over its calls and
states: ``max |run - ref| / max |ref|`` over the valid rows.

Training (:func:`judge_train`): the reference builds the same model from
the same weights and takes the same three steps on the same batches and
draws; compared are each step's loss, the first gradient as the optimizer
got it (AdamW's first moment after one step over ``1 - beta1``) and the
change of the parameters and of their EMA after three steps, leaf by leaf
by their norms.  The window's first steps are then followed from the
program's own state at the window's start (parameters, EMA, AdamW
moments: what the three checked steps left, which the change compares),
and their losses join the steps' losses.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List

import torch

from .. import inputs
from .diffusion import sampler
from .models.union_3t_solver import Union3TSolver
from .models.union_solver import UnionSolver
from .utils import sdf as sdf_utils
from .utils.device import use_fp32_math


def gap(run: torch.Tensor, ref: torch.Tensor, mask=None) -> float:
    """``max |run - ref| / max |ref|`` over the rows ``mask`` keeps; inf
    where the shapes differ or a value is not finite."""
    run = run.to(ref.device, torch.float64)
    ref = ref.to(torch.float64)
    if run.shape != ref.shape:
        return math.inf
    if mask is not None:
        run, ref = run[mask], ref[mask]
    if run.numel() == 0:
        return 0.0
    diff = (run - ref).abs().max().item()
    if not math.isfinite(diff):
        return math.inf
    return diff / max(ref.abs().max().item(), 1e-30)


def reference_solver(raw: Dict, seed: int, device, stage_flag=None):
    """The reference solver of a configuration tree (the 3-stage solver
    where the U-Nets hold a feature stage) at ``stage_flag`` (default: the
    last stage), with the benchmark's seeded weights."""
    cfg = inputs.build_config(raw)
    stage = stage_flag or cfg.diffusion.unet_type[-1]
    cls = Union3TSolver if "feature" in cfg.diffusion.unet_type \
        else UnionSolver
    solver = cls(cfg, stage_flag=stage, device=device)
    w = inputs.model_weights(cfg, stage, seed, device)
    inputs.load_weights(solver.df, w["df"])
    inputs.load_weights(solver.vae, w["vae"])
    return cfg, solver


def _stage_gap(solver, calls: List[Dict], kind: str, init: torch.Tensor,
               output: torch.Tensor, shape, batch_size: int, steps: int,
               loop_kwargs: Dict, mask=None, g=None) -> float:
    """One denoising stage: each of the run's U-Net calls recomputed from
    its own inputs, and the reference's sampler replayed on the run's
    outputs from ``init``; -> the worst gap."""
    dev = init.device
    mine = [c for c in calls if c["kind"] == kind]
    if len(mine) != steps:
        return math.inf
    worst = 0.0
    fed = []

    def replay(x, tb, x_start):
        k = len(fed)
        fed.append(x)
        return mine[k]["out"].to(dev)

    final = sampler.sample_loop(replay, shape, batch_size, steps,
                                solver.log_snr, noise_stream=init,
                                device=dev, **loop_kwargs)
    for c, x in zip(mine, fed):
        worst = max(worst, gap(c["x"], x, mask))
        cond = None if c["cond"] is None else c["cond"].to(dev)
        if kind == "lr":
            ref = solver.df("lr", c["x"].to(dev), c["t"].to(dev),
                            x_self_cond=cond)
        else:
            ref = solver.df(kind, c["x"].to(dev), c["t"].to(dev), g=g)
        worst = max(worst, gap(c["out"], ref, mask))
    if mask is not None:
        final = torch.where(mask[:, None], final, torch.zeros_like(final))
    return max(worst, gap(output, final, mask))


@torch.no_grad()
def judge_record(solver, cfg, rec: Dict, noise: Dict[str, torch.Tensor],
                 batch_size: int, steps: int) -> Dict[str, float]:
    """The gaps of one checked item's record against the reference
    ``solver`` (fp32, TF32 off)."""
    use_fp32_math()
    dev = solver.device
    d, m = cfg.diffusion, cfg.model
    df_type = dict(zip(d.unet_type, d.df_type))
    solver.df.eval()
    solver.vae.eval()
    calls = rec["calls"]
    out = {}
    s = 2**m.full_depth
    lr_init = noise["lr_noise"].permute(0, 1, 3, 4, 5, 2)
    out["lr_gap"] = _stage_gap(
        solver, calls, "lr", lr_init, rec["split_small"],
        (batch_size, s, s, s, d.input_channels[0]), batch_size, steps,
        dict(df_type=df_type["lr"], truncated_index=d.truncated_time,
             snap_sign=True, solver=d.sampler))
    split_small = rec["split_small"].to(dev)
    octree_small, g_small = solver._grow_fn(batch_size)(split_small)
    g_code = g_small
    if isinstance(solver, Union3TSolver):
        lvl = g_small.level(solver.hr_depth)
        out["hr_gap"] = _stage_gap(
            solver, calls, "hr", noise["hr_noise"], rec["split_large"],
            (lvl.g_cap, d.input_channels[1]), batch_size, steps,
            dict(df_type=df_type["hr"], solver=d.sampler),
            mask=lvl.node_mask, g=g_small)
        _, g_code = solver.grow_large(octree_small, g_small,
                                      rec["split_large"].to(dev))
        lvl = g_code.level(solver.code_depth)
        out["feature_gap"] = _stage_gap(
            solver, calls, "feature", noise["feature_noise"], rec["code"],
            (lvl.g_cap, m.embed_dim), batch_size, steps,
            dict(df_type=df_type["feature"], solver=d.sampler),
            mask=lvl.node_mask, g=g_code)
    else:
        lvl = g_small.level(solver.small_depth)
        out["hr_gap"] = _stage_gap(
            solver, calls, "hr", noise["hr_noise"], rec["code"],
            (lvl.g_cap, m.embed_dim), batch_size, steps,
            dict(df_type=df_type["hr"], solver=d.sampler),
            mask=lvl.node_mask, g=g_small)
    labels = {dd: torch.argmax(v.to(dev), dim=-1)
              for dd, v in rec["logits"].items()}
    dec = solver.vae.decode_grow(rec["code"].to(dev), g_code, labels=labels)
    octree = dec["octree_out"]
    dgap = 0.0
    for dd, ref in dec["logits"].items():
        run = rec["logits"].get(dd)
        dgap = max(dgap, math.inf if run is None else
                   gap(run, ref, octree.node_mask(dd)))
    for dd, ref in dec["reg_voxs"][m.depth_out].items():
        run = rec["reg_voxs"].get(dd)
        dgap = max(dgap, math.inf if run is None else gap(run, ref))
    out["decode_gap"] = dgap
    sdfs = sdf_utils.calc_sdf(
        dec["reg_voxs"][m.depth_out], octree, m.full_depth, m.depth_out,
        size=cfg.solver.resolution, bbmin=-cfg.solver.sdf_scale,
        bbmax=cfg.solver.sdf_scale)
    out["sdf_gap"] = gap(rec["sdfs"], sdfs)
    return out


def item_noise(raw: Dict, traffic: Dict, seed: int, index: int, device):
    cfg = inputs.build_config(raw)
    return {key: inputs.stage_noise(shape, seed, index, j, device)
            for j, (key, shape) in enumerate(inputs.noise_shapes(
                cfg, traffic["batch_size"], traffic["sampler"],
                traffic["steps"]))}


def judge_gen(raw: Dict, traffic: Dict, seed: int, records: List[Dict],
              device) -> Dict[str, float]:
    """The worst of each gap over the checked items of a generation run
    (``raw``: the configuration tree as the run ran it)."""
    cfg, solver = reference_solver(raw, seed, device)
    worst: Dict[str, float] = {}
    for rec in records:
        noise = item_noise(raw, traffic, seed, rec["index"], device)
        for k, v in judge_record(solver, cfg, rec, noise,
                                 traffic["batch_size"],
                                 traffic["steps"]).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
def first_gradient(step) -> Dict[str, torch.Tensor]:
    """name -> the gradient AdamW took in its first step, from its first
    moment (``(1 - beta1) g``), on the host."""
    opt = step.optimizer
    beta1 = opt.param_groups[0]["betas"][0]
    names = {id(p): n for n, p in step.solver.df.named_parameters()}
    return {names[id(p)]: (st["exp_avg"] / (1.0 - beta1)).detach().cpu()
            for p, st in opt.state.items()}


def trained_state(step) -> Dict[str, torch.Tensor]:
    """name -> each trainable parameter and its EMA (``ema.<name>``), on
    the host."""
    out = {}
    for n, p in step.solver.df.named_parameters():
        if p.requires_grad:
            out[n] = p.detach().to("cpu", copy=True)
            out[f"ema.{n}"] = step.ema[n].detach().to("cpu", copy=True)
    return out


def adam_moments(step) -> Dict[str, Dict[str, torch.Tensor]]:
    """name -> AdamW's state of each trained parameter, on the host."""
    names = {id(p): n for n, p in step.solver.df.named_parameters()}
    return {names[id(p)]: {k: v.detach().to("cpu", copy=True)
                           for k, v in st.items()}
            for p, st in step.optimizer.state.items()}


def load_train_state(step, state: Dict[str, torch.Tensor],
                     moments: Dict[str, Dict[str, torch.Tensor]]) -> None:
    """Put a run's parameters, EMA (:func:`trained_state`) and AdamW
    moments (:func:`adam_moments`) into the reference's ``step``, which
    has taken as many steps (its schedule and counts are the run's)."""
    with torch.no_grad():
        for n, p in step.solver.df.named_parameters():
            if p.requires_grad:
                p.copy_(state[n])
                step.ema[n].copy_(state[f"ema.{n}"])
    for p in list(step.optimizer.state):
        del step.optimizer.state[p]
    for n, p in step.solver.df.named_parameters():
        if n in moments:
            step.optimizer.state[p] = {k: v.to(p.device).clone()
                                       for k, v in moments[n].items()}


def run_train_steps(step, batches: List[Dict], draws: List[Dict], device):
    """Three (or ``len(batches)``) steps of ``step`` -> {"losses", "grad1",
    "state3"} as :func:`judge_train` compares them."""
    losses, grad1 = [], None
    for k, (batch, dr) in enumerate(zip(batches, draws)):
        out = step({n: t.to(device) for n, t in batch.items()},
                   **{n: t.to(device) for n, t in dr.items()})
        losses.append(float(out["loss"]))
        if k == 0:
            grad1 = first_gradient(step)
    return {"losses": losses, "grad1": grad1, "state3": trained_state(step)}


def _norm_gap(run: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep) -> float:
    """Worst leaf of ``| |run| - |ref| | / max(|ref|, median |ref|)`` over
    the leaves ``keep`` names; inf where a leaf is missing."""
    norms = {n: ref[n].double().norm().item() for n in keep}
    if not norms:
        return 0.0
    med = sorted(norms.values())[len(norms) // 2]
    worst, where = 0.0, None
    for n in keep:
        if n not in run:
            return math.inf
        diff = abs(run[n].double().norm().item() - norms[n])
        if not math.isfinite(diff):
            return math.inf
        g = diff / max(norms[n], med, 1e-30)
        if g > worst:
            worst, where = g, n
    if where is not None:
        print(f"[judge] worst leaf {where}: {worst!r} (|ref| "
              f"{norms[where]!r}, median {med!r})", file=sys.stderr)
    return worst


def compare_train(run: Dict, ref: Dict, init: Dict[str, torch.Tensor],
                  moved_floor: float = 1e-3) -> Dict[str, float]:
    """The numbers of a training check: ``loss_gap`` (worst step's
    relative gap), ``grad_gap`` and ``update_gap`` (worst leaf, see
    :func:`_norm_gap`).  A leaf whose reference gradient is under
    ``moved_floor`` of the median leaf's moves under AdamW by round-off
    alone: it is left out of the change, with its EMA."""
    losses = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(run["losses"], ref["losses"])]
    loss_gap = (max(losses) if len(run["losses"]) == len(ref["losses"])
                and all(math.isfinite(x) for x in losses) else math.inf)
    gnames = sorted(ref["grad1"])
    grad_gap = _norm_gap(run["grad1"], ref["grad1"], gnames)
    gnorm = {n: ref["grad1"][n].double().norm().item() for n in gnames}
    med = sorted(gnorm.values())[len(gnorm) // 2] if gnorm else 0.0
    moved = [n for n in gnames if gnorm[n] >= moved_floor * med]
    keep = moved + [f"ema.{n}" for n in moved]
    change = {}
    for side, state in (("run", run["state3"]), ("ref", ref["state3"])):
        change[side] = {n: state[n] - init[n.removeprefix("ema.")].cpu()
                        for n in keep if n in state}
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "update_gap": _norm_gap(change["run"], change["ref"], keep)}


def judge_train(raw: Dict, stage: str, seed: int, run: Dict,
                batches: List[Dict], draws: List[Dict], device
                ) -> Dict[str, float]:
    """The reference's three steps from the seeded weights on the run's
    first batches and draws, compared with the run's readings ``run``;
    where ``run`` has ``window_losses``, the window's steps that follow
    (the last of ``batches`` and ``draws``) from the run's state at the
    window's start (``state3``, ``moments``), their losses compared too."""
    use_fp32_math()
    cfg, solver = reference_solver(raw, seed, device, stage)
    init = {n: p.detach().cpu().clone()
            for n, p in solver.df.named_parameters()}
    n = len(run["losses"])
    step = solver.make_train_step()
    ref = run_train_steps(step, batches[:n], draws[:n], device)
    out = compare_train(run, ref, init)
    w = len(run.get("window_losses", ()))
    if w:
        load_train_state(step, run["state3"], run["moments"])
        win = run_train_steps(step, batches[n:n + w], draws[n:n + w],
                              device)
        gaps = [abs(a - b) / max(abs(b), 1e-30)
                for a, b in zip(run["window_losses"], win["losses"])]
        worst = max(gaps) if all(math.isfinite(x) for x in gaps) \
            else math.inf
        out["loss_gap"] = max(out["loss_gap"], worst)
    return out
