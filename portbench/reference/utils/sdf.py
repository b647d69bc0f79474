"""Dense SDF grid of the decoded MPU (port of ``calc_sdf``,
``mode="dense"``, in ``octfusion_tpu/utils/sdf.py``).

The grid stays a float32 tensor on the octree's device: the JAX package's
fp16 transfer answered a slow link to the TPU and is not ported.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..octree.octree import Octree
from ..ops import mpu as mpu_ops


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
