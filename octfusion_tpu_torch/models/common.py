"""Batch -> octree / dual graph preparation shared by the training steps
(port of ``batch_to_octree`` / ``batch_to_graph`` in
``octfusion_tpu/models/common.py``).  Everything runs on the points'
device: per-sample octree builds, their merge and the dual-graph
construction are index math that never waits for the host."""

from __future__ import annotations

from typing import Optional

import torch

from ..octree.dual_graph import DualGraph, build_dual_graph
from ..octree.octree import Octree, OctreeSpec, build_octree, merge_octrees


def batch_to_octree(points: torch.Tensor, normals: torch.Tensor,
                    spec_single: OctreeSpec) -> Octree:
    """points, normals [B, N, 3] -> one merged octree of B samples."""
    octs = [build_octree(points[i], normals[i], spec_single)
            for i in range(points.shape[0])]
    return merge_octrees(octs) if len(octs) > 1 else octs[0]


def batch_to_graph(points: torch.Tensor, normals: torch.Tensor,
                   spec_single: OctreeSpec, edge_factor: int = 9,
                   up_to: Optional[int] = None):
    """-> (octree, dual graph of levels full_depth..``up_to``, default all)."""
    octree = batch_to_octree(points, normals, spec_single)
    graph: DualGraph = build_dual_graph(octree, edge_factor, up_to=up_to)
    return octree, graph
