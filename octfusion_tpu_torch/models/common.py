"""Batch -> octree / dual graph preparation shared by the solvers (port
of ``batch_to_octree`` / ``batch_to_graph`` / ``flatten_pos`` in
``octfusion_tpu/models/common.py``), a loader batch's move to the
device, and the solvers' stage timer.  Everything
runs on the points' device: per-sample octree builds, their merge and the
dual-graph construction are index math that never waits for the host."""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from ..octree.dual_graph import DualGraph, GraphSpec, build_dual_graph
from ..octree.octree import Octree, OctreeSpec, build_octree, merge_octrees


def batch_to_octree(points: torch.Tensor, normals: torch.Tensor,
                    spec_single: OctreeSpec,
                    features: Optional[torch.Tensor] = None) -> Octree:
    """points, normals [B, N, 3] (and per-point ``features`` [B, N, F],
    e.g. colours, averaged into the signal) -> one merged octree of B
    samples."""
    octs = [build_octree(points[i], normals[i], spec_single,
                         None if features is None else features[i])
            for i in range(points.shape[0])]
    return merge_octrees(octs) if len(octs) > 1 else octs[0]


def batch_to_graph(points: torch.Tensor, normals: torch.Tensor,
                   spec_single: OctreeSpec, edge_factor: int = 9,
                   up_to: Optional[int] = None,
                   features: Optional[torch.Tensor] = None):
    """-> (octree, dual graph of levels full_depth..``up_to``, default all);
    ``features`` as in :func:`batch_to_octree`."""
    octree = batch_to_octree(points, normals, spec_single, features)
    graph: DualGraph = build_dual_graph(octree, edge_factor, up_to=up_to)
    return octree, graph


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A collated numpy batch (``data/dataset.collate``) as tensors on
    ``device``: ``filename`` dropped, ``label`` int64 (an embedding index;
    the collate gives int32), every other array (``points``, ``normals``,
    ``pos`` / ``sdf`` / ``grad``, ``split_small``, ``point_colors``) as it
    is."""
    out = {}
    for k, v in batch.items():
        if k == "filename":
            continue
        t = torch.as_tensor(v)
        out[k] = t.to(device, torch.int64 if k == "label" else t.dtype)
    return out


def code_shape(cfg, batch_size: int):
    """Shape of the level-``depth_stop`` latent codes of a training batch
    of ``batch_size`` under ``cfg`` (the VAE posterior's ``eps``, and the
    hr loss's noise): [G_cap(depth_stop), embed_dim]."""
    m = cfg.model
    spec1 = cfg.capacity.octree_spec(m.depth, m.full_depth, 1)
    spec = GraphSpec(spec1.with_batch_size(batch_size),
                     cfg.capacity.edge_factor)
    return (spec.g_cap(m.depth_stop), m.embed_dim)


def flatten_pos(pos: torch.Tensor):
    """[B, M, 3] query points -> ([B*M, 3], batch ids [B*M])."""
    b, m, _ = pos.shape
    pb = torch.arange(b, device=pos.device).repeat_interleave(m)
    return pos.reshape(b * m, 3), pb


class Laps:
    """Wall seconds of named stages; the device is synchronised at each
    stage end, so a stage's seconds include its device work."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = {}
        self._t0 = time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = now - self._t0
        self._t0 = now
