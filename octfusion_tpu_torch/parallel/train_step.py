"""Data-parallel training steps and rank-striped generation (port of
``octfusion_tpu/parallel/train_step.py``).

Each rank holds one shard of the global batch (:func:`shard_batch`): the
point clouds split over the mesh's data axis, and the VAE's SDF queries
(``pos`` / ``sdf`` / ``grad``) also over its model axis along the query
axis.  A step runs the solver's own loss and backward on the local shard,
then averages every trainable gradient over all ranks with one flattened
all-reduce before the optimizer (:class:`GradSync`; JAX's ``pmean`` over
'model' then 'data' is the same mean, the shards being equal in size),
and averages the loss dict the same way; the optimizer step and the EMA
then run on each rank on identical values.  Parameters start identical:
the step broadcasts rank 0's when it is built.  A rank's random draws
come from a generator seeded from (seed, data index, model index), the
counterpart of ``_fold_axis_keys``; ``times=`` / ``noise=`` / ``eps=``
still inject them.

The explicit all-reduce after ``backward()`` stands in for
``DistributedDataParallel``: the union stages freeze ``unet_lr`` (and
``unet_hr`` for the feature stage), whose parameters get no gradient, and
``use_checkpoint`` runs reentrant checkpoints, which DDP's hooks handle
badly.  Overlapping it with the backward is later work.

Generation stripes shapes over the data axis (:func:`stripe`): each rank
runs whole cascades (``solver.dp_cascade``) for its own shapes, with no
collective.  Shape i draws from a generator seeded from (seed, i) alone,
never from the rank.  Both CLIs (``generate.py`` and ``train.py --mode
generate``) stripe over a mesh whose data axis is every rank;
:func:`make_dp_sample` is the same loop returning the dense SDF grids in
memory.  The JAX package's compact active-cell transfer is not ported."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as tdist

from ..models.union_solver import TrainStep
from ..models.vae_solver import VAETrainStep
from . import dist
from .mesh import Mesh

# batch key -> the axis it is split on: "data" (rows) or "query" (rows by
# the data index, then the query axis by the model index)
SPECS = {"points": "data", "normals": "data", "label": "data",
         "split_small": "data", "point_colors": "data",
         "pos": "query", "sdf": "query", "grad": "query"}


def rank_seed(seed: int, data_index: int, model_index: int) -> int:
    """The seed of a rank's generator: a function of (seed, data index,
    model index) only."""
    return int(np.random.SeedSequence(
        [seed, data_index, model_index]).generate_state(1)[0])


def rank_generator(seed: int, mesh: Mesh, device,
                   rank: Optional[int] = None) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        rank_seed(seed, *mesh.coords(rank)))


def _part(v, axis: int, i: int, n: int):
    size = v.shape[axis]
    if size % n:
        raise ValueError(f"axis {axis} of size {size} does not split over "
                         f"{n} ranks")
    k = size // n
    return v[i * k:(i + 1) * k] if axis == 0 else v[:, i * k:(i + 1) * k]


def shard_batch(batch: Dict, mesh: Mesh, vae: bool,
                rank: Optional[int] = None, rows_local: bool = False) -> Dict:
    """This rank's part of ``batch`` (numpy arrays or tensors) by
    :data:`SPECS`; ``filename`` is dropped, and so are the SDF queries
    unless ``vae``.  With ``rows_local`` the batch already holds only this
    data index's rows (a rank-striped loader's), so only the queries are
    split, over the model axis."""
    di, mi = mesh.coords(rank)
    out = {}
    for k, v in batch.items():
        if k == "filename":
            continue
        kind = SPECS[k]
        if kind == "query" and not vae:
            continue
        if not rows_local:
            v = _part(v, 0, di, mesh.data)
        if kind == "query":
            v = _part(v, 1, mi, mesh.model)
        out[k] = v
    return out


class GradSync:
    """Averages the gradients of ``params`` (a fixed list, the same on
    every rank) and loss dicts over all ranks.  A parameter without a
    gradient on every rank is left without one; one that has a gradient
    on some rank gets zeros where it has none, so the flattened buffer has
    one layout everywhere.  Records the bytes and wall seconds of each
    gradient all-reduce (the device synchronised around it)."""

    def __init__(self, params: List[torch.Tensor]):
        self.params = list(params)
        self.bytes = 0
        self.seconds: List[float] = []

    def _sync(self, t: torch.Tensor) -> None:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)

    def grads(self) -> None:
        world = dist.world_size()
        if world == 1 or not self.params:
            return
        ref = self.params[0]
        has = torch.tensor([p.grad is not None for p in self.params],
                           dtype=torch.float32, device=ref.device)
        tdist.all_reduce(has)     # gloo reduces CUDA tensors by sum only
        keep = [p for p, h in zip(self.params, has.tolist()) if h > 0]
        if not keep:
            return
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in keep])
        self._sync(flat)
        t0 = time.perf_counter()
        tdist.all_reduce(flat)
        self._sync(flat)
        self.seconds.append(time.perf_counter() - t0)
        self.bytes = flat.numel() * flat.element_size()
        flat.div_(world)
        off = 0
        for p in keep:
            n = p.numel()
            p.grad = flat[off:off + n].view_as(p)
            off += n

    def mean_dict(self, out: Dict) -> Dict:
        """``out`` with its tensor scalars averaged over all ranks (other
        entries kept)."""
        world = dist.world_size()
        keys = sorted(k for k, v in out.items()
                      if isinstance(v, torch.Tensor) and v.numel() == 1)
        if world == 1 or not keys:
            return out
        vals = torch.stack([out[k].detach().to(torch.float32).reshape(())
                            for k in keys])
        tdist.all_reduce(vals)
        vals.div_(world)
        return {**out, **dict(zip(keys, vals.unbind()))}


class UnionDPTrainStep(TrainStep):
    """``UnionSolver.make_train_step``'s step (any stage, the 3-stage
    solver's too) on this rank's shard, its gradients and loss dict
    averaged over all ranks."""

    def __init__(self, solver, mesh: Mesh, seed: int = 0):
        dist.broadcast_modules(solver.df, solver.vae)
        super().__init__(solver)
        self.mesh = mesh
        self.generator = rank_generator(seed, mesh, solver.device)
        self.sync = GradSync([p for p in solver.df.parameters()
                              if p.requires_grad])

    def apply_gradients(self) -> None:
        self.sync.grads()
        super().apply_gradients()

    def __call__(self, batch, times=None, noise=None, eps=None,
                 generator=None, timed: bool = False) -> Dict:
        if generator is None:
            generator = self.generator
        out = super().__call__(batch, times, noise, eps, generator, timed)
        return self.sync.mean_dict(out)


class VAEDPTrainStep(VAETrainStep):
    """``VAESolver.make_train_step``'s step on this rank's shard, its
    gradients and loss dict averaged over all ranks."""

    def __init__(self, solver, mesh: Mesh, total_steps: int, seed: int = 0):
        dist.broadcast_modules(solver.vae)
        super().__init__(solver, total_steps)
        self.mesh = mesh
        self.generator = rank_generator(seed, mesh, solver.device)
        self.sync = GradSync([p for p in solver.vae.parameters()
                              if p.requires_grad])

    def apply_gradients(self) -> None:
        self.sync.grads()
        super().apply_gradients()

    def __call__(self, batch, eps=None, generator=None,
                 timed: bool = False) -> Dict:
        if generator is None:
            generator = self.generator
        out = super().__call__(batch, eps, generator, timed)
        return self.sync.mean_dict(out)


def make_union_dp_train_step(solver, mesh: Mesh,
                             seed: int = 0) -> UnionDPTrainStep:
    """Data-parallel diffusion train step (lr, hr or feature stage)."""
    return UnionDPTrainStep(solver, mesh, seed)


def make_vae_dp_train_step(solver, mesh: Mesh, total_steps: int = 100_000,
                           seed: int = 0) -> VAEDPTrainStep:
    """Data-parallel (and query-sharded over the model axis) VAE step."""
    return VAEDPTrainStep(solver, mesh, total_steps, seed)


def stripe(indices, mesh: Mesh, rank: Optional[int] = None) -> list:
    """This rank's share of ``indices``: every ``mesh.data``-th from its
    data index (model-axis peers get the same share)."""
    di, _ = mesh.coords(rank)
    return list(indices)[di::mesh.data]


def make_dp_sample(solver, mesh: Mesh, steps: Optional[int] = None,
                   resolution: int = 256):
    """Data-parallel generation -> ``sample(indices, seed, label=None)``,
    which runs, for each index i of this rank's :func:`stripe`, the whole
    cascade (``solver.dp_cascade`` from a generator seeded from (seed, i))
    and the dense SDF grid, and returns {i: grid [R, R, R] float32}."""
    from ..generate import shape_seed
    from ..utils import sdf as sdf_utils

    m, s = solver.cfg.model, solver.cfg.solver

    def sample(indices, seed: int, label=None) -> Dict[int, torch.Tensor]:
        out = {}
        for i in stripe(indices, mesh):
            gen = torch.Generator(device=solver.device).manual_seed(
                shape_seed(seed, i))
            dec = solver.dp_cascade(label=label, steps=steps, generator=gen)
            out[i] = sdf_utils.calc_sdf(
                dec["reg_voxs"][m.depth_out], dec["octree_out"],
                m.full_depth, m.depth_out, size=resolution,
                bbmin=-s.sdf_scale, bbmax=s.sdf_scale)[0]
        return out

    return sample
