"""Split-bit codecs between octrees and the dense split grid (port of
``octree2split_small`` / ``split2octree_small`` in
``octfusion_tpu/octree/split_codec.py``).

``split_small`` is the depth-(full_depth+1) child-occupancy pattern as a
dense ``[B, S, S, S, 8]`` grid (NDHWC), values in {-1, +1}: the lr
diffusion stage's state."""

from __future__ import annotations

import torch

from .octree import Octree, OctreeSpec, create_full_octree


def octree2split_small(octree: Octree) -> torch.Tensor:
    """-> [B, S, S, S, 8] in {-1, +1}, S = 2**full_depth: each full-depth
    node's 8 child-occupancy bits."""
    fd = octree.spec.full_depth
    cap1 = octree.spec.node_caps[fd + 1]
    occ8 = octree.nempty_mask(fd + 1).to(torch.float32).reshape(cap1 // 8, 8)
    vox = octree.to_voxel(octree.pad_nempty(occ8, fd), fd)
    return 2.0 * vox - 1.0


def split2octree_small(split: torch.Tensor, spec: OctreeSpec) -> Octree:
    """Grow a full_depth+2-deep topology from a dense split grid
    ``[B, S, S, S, 8]`` (NDHWC, positive = occupied).  The returned octree
    has ``spec.depth`` static levels but is populated to full_depth + 2."""
    fd = spec.full_depth
    occ = split > 0
    out = create_full_octree(spec, split.device)

    # level fd: split where any child occupied
    nonempty = occ.any(dim=-1)
    label_fd = out.from_voxel(nonempty[..., None].to(torch.int64), fd)[:, 0]
    out = out.octree_split(label_fd, fd)
    out = out.octree_grow(fd + 1)

    # level fd+1: each node's own occupancy bit from its parent's channel;
    # padded slots decode to garbage coordinates, clamped here (the
    # reference's gather clamps them implicitly) and masked below
    x, y, z, b = out.xyzb(fd + 1)
    s = 2**fd - 1
    px, py, pz = (x >> 1).clamp(0, s), (y >> 1).clamp(0, s), (z >> 1).clamp(0, s)
    octant = ((x & 1) << 2) | ((y & 1) << 1) | (z & 1)
    bits = occ[b.clamp(0, spec.batch_size - 1), px, py, pz, octant]
    label_p1 = (bits & out.node_mask(fd + 1)).to(torch.int64)
    out = out.octree_split(label_p1, fd + 1)
    return out.octree_grow(fd + 2)
