"""Dense SDF grid of the decoded MPU and its meshes (port of ``calc_sdf``,
``mode="dense"``, and ``export_meshes`` in ``octfusion_tpu/utils/sdf.py``).

The grid stays a float32 tensor on the octree's device and the marching
runs there too: the JAX package's fp16 transfer and compact active-cell
extraction answered a slow link to the TPU and are not ported (its
marching gives the same triangles as the dense grid's).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..octree.octree import Octree
from ..ops import mpu as mpu_ops
from . import mesh as mesh_utils


def calc_sdf(
    reg_levels: Dict[int, torch.Tensor],
    octree: Octree,
    full_depth: int,
    depth_end: int,
    size: int = 256,
    bbmin: float = -0.9,
    bbmax: float = 0.9,
) -> torch.Tensor:
    """[B, size, size, size] SDF values by dense trilinear resampling."""
    return mpu_ops.mpu_grid_eval(reg_levels, octree, full_depth, depth_end,
                                 size, bbmin, bbmax)


def export_meshes(
    sdfs: torch.Tensor,
    save_paths,
    level: float = 0.0,
    bbmin: float = -0.9,
    bbmax: float = 0.9,
    mesh_scale: float = 1.0,
) -> List[Optional[str]]:
    """Marching tetrahedra over each [S, S, S] grid of ``sdfs`` on its
    device, vertices scaled from voxels to ``[bbmin, bbmax]`` and by
    ``mesh_scale``, one ``.obj`` per path.  An empty mesh writes no file.
    Returns the paths written, None for the empty meshes."""
    size = sdfs.shape[1]
    written = []
    for sdf, path in zip(sdfs, save_paths):
        verts, faces = mesh_utils.marching_tetrahedra(sdf, level)
        if verts.shape[0] == 0:
            written.append(None)
            continue
        verts = (verts * ((bbmax - bbmin) / size) + bbmin) * mesh_scale
        mesh_utils.save_obj(path, verts.cpu().numpy(), faces.cpu().numpy())
        written.append(path)
    return written
