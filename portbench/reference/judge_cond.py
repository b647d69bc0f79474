"""The comparison that decides a class-conditional generation run's
``correct``: :func:`judge.judge_record` on each checked item, with the
reference's U-Nets given the labels the benchmark asked for
(``traffic["labels"]``), never those the run passed on.  A run whose
program dropped or moved a label so computes other outputs than the
reference does from the same inputs."""

from __future__ import annotations

from typing import Dict, List

import torch

from . import judge


class Labelled(torch.nn.Module):
    """``df`` called with ``labels`` in place of any label given."""

    def __init__(self, df: torch.nn.Module, labels: torch.Tensor):
        super().__init__()
        self.df = df
        self.labels = labels

    def forward(self, unet_type, x, timesteps, g=None, x_self_cond=None,
                label=None):
        return self.df(unet_type, x, timesteps, g=g, x_self_cond=x_self_cond,
                       label=self.labels)


def labels_of(traffic: Dict, device) -> torch.Tensor:
    """The class of each shape of a call, as the mix gives them."""
    return torch.tensor(traffic["labels"], dtype=torch.int64, device=device)


def judge_gen(raw: Dict, traffic: Dict, seed: int, records: List[Dict],
              device) -> Dict[str, float]:
    """The worst of each gap over the checked items of a conditional
    generation run, as :func:`judge.judge_gen` takes them."""
    cfg, solver = judge.reference_solver(raw, seed, device)
    solver.df = Labelled(solver.df, labels_of(traffic, device))
    worst: Dict[str, float] = {}
    for rec in records:
        noise = judge.item_noise(raw, traffic, seed, rec["index"], device)
        for k, v in judge.judge_record(solver, cfg, rec, noise,
                                       traffic["batch_size"],
                                       traffic["steps"]).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst
