"""Split-bit codecs between octrees and split tensors (port of
``octfusion_tpu/octree/split_codec.py``).

``split_small`` is the depth-(full_depth+1) child-occupancy pattern as a
dense ``[B, S, S, S, 8]`` grid (NDHWC), values in {-1, +1}: the lr
diffusion stage's state.  ``split_large`` holds the 8 child-occupancy
bits of every node at ``small_depth``, ``[cap_sd, 8]`` in {-1, +1}: the
3-stage model's hr state."""

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


def octree2split_large(octree: Octree, small_depth: int) -> torch.Tensor:
    """-> [cap_sd, 8] in {-1, +1} over all nodes at ``small_depth``: each
    node's 8 child-occupancy bits; empty and padded rows are -1."""
    cap1 = octree.spec.node_caps[small_depth + 1]
    occ8 = octree.nempty_mask(small_depth + 1).to(torch.float32).reshape(
        cap1 // 8, 8)
    return 2.0 * octree.pad_nempty(occ8, small_depth) - 1.0


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


def split2octree_large(octree: Octree, split: torch.Tensor,
                       small_depth: int) -> Octree:
    """Grow two more levels below ``small_depth`` from per-node split
    vectors ``split`` [cap_sd, 8] (positive = occupied): a valid node
    splits where any bit is set, and child k of a split node is non-empty
    where its bit k is."""
    occ = split > 0
    nonempty = occ.any(dim=-1) & octree.node_mask(small_depth)
    out = octree.octree_split(nonempty.to(torch.int64), small_depth)
    out = out.octree_grow(small_depth + 1)

    # nodes at small_depth+1 are the children of the split nodes in order:
    # child k of the i-th split node sits at slot 8 i + k
    occ8 = out.depad_nempty(occ.to(torch.int64), small_depth)
    cap1 = out.spec.node_caps[small_depth + 1]
    label_p1 = (occ8.reshape(-1)[:cap1] > 0) & out.node_mask(small_depth + 1)
    out = out.octree_split(label_p1.to(torch.int64), small_depth + 1)
    return out.octree_grow(small_depth + 2)
