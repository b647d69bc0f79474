"""The comparison that decides a VAE training run's ``correct``, as
:func:`judge.judge_train` decides a diffusion stage's: the reference VAE
(``models/vae_solver.py``) built from the benchmark's seeded weights
takes the run's checked steps on the same batches and ``eps``; compared
are each step's loss, the first gradient as AdamW got it and the change of
the parameters after the checked steps, leaf by leaf by their norms
(``loss_gap``, ``grad_gap``, ``update_gap``).  The reference then loads
the program's state at the window's start (parameters and AdamW moments)
and takes the window's first steps, whose losses join ``loss_gap``.  The
VAE keeps no EMA, so the change is of the parameters alone.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .. import inputs
from . import judge
from .models.vae_solver import VAESolver
from .nn.vae import GraphVAE
from .utils.device import use_fp32_math


def vae_weights(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """The VAE's seeded weights: the ``vae`` entry of
    ``inputs.model_weights``, drawn without the U-Nets'."""
    m = cfg.model
    with torch.device("meta"):
        vae = GraphVAE(depth=m.depth, channel_in=m.channel_in,
                       full_depth=m.full_depth, depth_stop=m.depth_stop,
                       depth_out=m.depth_out, embed_dim=m.embed_dim,
                       resblk_num=m.resblk_num, channels=tuple(m.channels),
                       use_checkpoint=m.use_checkpoint)
    return inputs.seeded_weights(vae, seed, inputs.SALT["vae"], device)


def reference_vae(raw: Dict, seed: int, device):
    """-> (config, the reference VAESolver with the seeded weights)."""
    cfg = inputs.build_config(raw)
    solver = VAESolver(cfg, device=device)
    inputs.load_weights(solver.vae, vae_weights(cfg, seed, device))
    return cfg, solver


def _names(step) -> Dict[int, str]:
    return {id(p): n for n, p in step.solver.vae.named_parameters()}


def first_gradient(step) -> Dict[str, torch.Tensor]:
    """name -> the gradient AdamW took in its first step, from its first
    moment, on the host."""
    beta1 = step.optimizer.param_groups[0]["betas"][0]
    names = _names(step)
    return {names[id(p)]: (st["exp_avg"] / (1.0 - beta1)).detach().cpu()
            for p, st in step.optimizer.state.items()}


def trained_state(step) -> Dict[str, torch.Tensor]:
    """name -> each parameter of the VAE, on the host."""
    return {n: p.detach().to("cpu", copy=True)
            for n, p in step.solver.vae.named_parameters()}


def adam_moments(step) -> Dict[str, Dict[str, torch.Tensor]]:
    """name -> AdamW's state of each parameter, on the host."""
    names = _names(step)
    return {names[id(p)]: {k: v.detach().to("cpu", copy=True)
                           for k, v in st.items()}
            for p, st in step.optimizer.state.items()}


def load_train_state(step, state, moments) -> None:
    """Put a run's parameters and AdamW moments into the reference's
    ``step``, which has taken as many steps."""
    with torch.no_grad():
        for n, p in step.solver.vae.named_parameters():
            p.copy_(state[n])
    for p in list(step.optimizer.state):
        del step.optimizer.state[p]
    for n, p in step.solver.vae.named_parameters():
        if n in moments:
            step.optimizer.state[p] = {k: v.to(p.device).clone()
                                       for k, v in moments[n].items()}


def run_steps(step, batches: List[Dict], eps: List[torch.Tensor], device):
    """The steps of ``step`` on ``batches`` with ``eps`` -> {"losses",
    "grad1", "state3"}."""
    losses, grad1 = [], None
    for k, (batch, e) in enumerate(zip(batches, eps)):
        out = step({n: t.to(device) for n, t in batch.items()},
                   eps=e.to(device))
        losses.append(float(out["loss"]))
        if k == 0:
            grad1 = first_gradient(step)
    return {"losses": losses, "grad1": grad1, "state3": trained_state(step)}


def compare(run: Dict, ref: Dict, init: Dict[str, torch.Tensor],
            moved_floor: float = 1e-3) -> Dict[str, float]:
    """``loss_gap``, ``grad_gap`` and ``update_gap`` as
    :func:`judge.compare_train` takes them, over the parameters alone."""
    losses = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(run["losses"], ref["losses"])]
    loss_gap = (max(losses) if len(run["losses"]) == len(ref["losses"])
                and all(math.isfinite(x) for x in losses) else math.inf)
    gnames = sorted(ref["grad1"])
    grad_gap = judge._norm_gap(run["grad1"], ref["grad1"], gnames)
    gnorm = {n: ref["grad1"][n].double().norm().item() for n in gnames}
    med = sorted(gnorm.values())[len(gnorm) // 2] if gnorm else 0.0
    keep = [n for n in gnames if gnorm[n] >= moved_floor * med]
    change = {side: {n: state[n] - init[n].cpu() for n in keep if n in state}
              for side, state in (("run", run["state3"]),
                                  ("ref", ref["state3"]))}
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "update_gap": judge._norm_gap(change["run"], change["ref"],
                                          keep)}


def judge_train(raw: Dict, seed: int, run: Dict, batches: List[Dict],
                eps: List[torch.Tensor], device) -> Dict[str, float]:
    """The reference's checked steps from the seeded weights on the run's
    first batches, compared with the run's readings ``run``; where
    ``run`` has ``window_losses``, the window's steps that follow, from
    the run's state at the window's start (``state3``, ``moments``)."""
    use_fp32_math()
    _, solver = reference_vae(raw, seed, device)
    init = {n: p.detach().cpu().clone()
            for n, p in solver.vae.named_parameters()}
    n = len(run["losses"])
    step = solver.make_train_step()
    ref = run_steps(step, batches[:n], eps[:n], device)
    out = compare(run, ref, init)
    w = len(run.get("window_losses", ()))
    if w:
        load_train_state(step, run["state3"], run["moments"])
        win = run_steps(step, batches[n:n + w], eps[n:n + w], device)
        gaps = [abs(a - b) / max(abs(b), 1e-30)
                for a, b in zip(run["window_losses"], win["losses"])]
        worst = max(gaps) if all(math.isfinite(x) for x in gaps) \
            else math.inf
        out["loss_gap"] = max(out["loss_gap"], worst)
    return out
