"""Functional graph primitives on :class:`GraphLevel` index tensors.

* ``graph_conv`` — scatter-mean over the 7 (row, dir) slots, then one GEMM,
  in plain PyTorch on every device (gather, ``index_add``, ``matmul``),
  differentiable by autograd;
* ``dual_group_norm`` — per-sample statistics over valid vertices with the
  reference's ``1/(count + eps)`` and ``var = E[x²] - mean²`` conventions;
* ``downsample_splice`` / ``upsample_splice`` — the leaf-preserving level
  moves, as static-segment gathers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..octree.dual_graph import N_EDGE_TYPE, DualGraph, GraphLevel
from ..octree.octree import set_where


def graph_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    lvl: GraphLevel,
    n_node_type: int = 0,
) -> torch.Tensor:
    """x: [G, C]; w: [7*(C+node_ch), C_out].  Returns [G, C_out]; vertices
    without edges produce zero rows.  The column buffer ``col(x)`` [G, 7C]
    holds each (row, dir) slot's scale-weighted sum of its neighbours
    (invalid edges, ``row >= G``, land in a dropped slot); then one GEMM."""
    if n_node_type > 1:
        onehot = F.one_hot(lvl.node_type, n_node_type).to(x.dtype)
        onehot = onehot * lvl.node_mask[:, None].to(x.dtype)
        x = torch.cat([x, onehot], dim=-1)
    g, c = x.shape
    gathered = x[lvl.edge_col.clamp(0, g - 1)] * lvl.edge_scale[:, None].to(
        x.dtype)
    slots = torch.where(lvl.edge_row < g, lvl.edge_row * N_EDGE_TYPE
                        + lvl.edge_dir, g * N_EDGE_TYPE)
    col = torch.zeros((g * N_EDGE_TYPE + 1, c), dtype=x.dtype,
                      device=x.device).index_add(0, slots, gathered)
    return col[:-1].reshape(g, N_EDGE_TYPE * c) @ w


def dual_group_norm(
    x: torch.Tensor,
    lvl: GraphLevel,
    scale: torch.Tensor,
    bias: torch.Tensor,
    group: int,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Group norm over per-sample variable-length vertex sets."""
    gcap, c = x.shape
    bsz = lvl.spec.ospec.batch_size
    cpg = c // group
    xf = x.to(torch.float32)
    mask = lvl.node_mask
    onehot = (
        (lvl.node_batch[:, None] == torch.arange(bsz, device=x.device)[None])
        & mask[:, None]
    ).to(torch.float32)                                  # [G, B]
    count = onehot.sum(0)[:, None] * cpg
    inv_count = 1.0 / (count + eps)

    def group_adjust(t):  # [B, C] -> per-group sums broadcast back
        if cpg == 1:
            return t
        t = t.reshape(bsz, group, cpg).sum(-1, keepdim=True)
        return t.expand(bsz, group, cpg).reshape(bsz, c)

    sums = onehot.t() @ torch.cat([xf, xf * xf], dim=-1)
    mean = group_adjust(sums[:, :c]) * inv_count
    ex2 = group_adjust(sums[:, c:]) * inv_count
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    bidc = lvl.node_batch.clamp(0, bsz - 1)
    out = xf - mean[bidc]
    out = torch.where(mask[:, None], out, torch.zeros_like(out))
    out = out * torch.rsqrt(var + eps)[bidc]
    out = out * scale.reshape(1, c) + bias.reshape(1, c)
    out = torch.where(mask[:, None], out, torch.zeros_like(out))
    return out.to(x.dtype)


def add_batch_embedding(
    x: torch.Tensor, emb: torch.Tensor, lvl: GraphLevel
) -> torch.Tensor:
    """x[i] += emb[batch(i)] on valid vertices."""
    gathered = emb[lvl.node_batch.clamp(0, emb.shape[0] - 1)]
    gathered = torch.where(lvl.node_mask[:, None], gathered,
                           torch.zeros_like(gathered))
    return x + gathered.to(x.dtype)


# ----------------------------------------------------------------------
# level moves
# ----------------------------------------------------------------------
def _cur_segment(x: torch.Tensor, g: DualGraph, d: int) -> torch.Tensor:
    off = g.spec.cur_off(d)
    return x[off: off + g.spec.ospec.node_caps[d]]


def downsample_splice(
    x: torch.Tensor,
    parents: torch.Tensor,
    g: DualGraph,
    d: int,
) -> torch.Tensor:
    """Splice level-d features into the level-(d-1) vertex layout:
    ``parents`` [cap_d/8, C] feed the non-empty nodes of depth d-1, leaves
    keep their features from x's leaf segment."""
    spec = g.spec
    fd = spec.full_depth
    o = g.octree
    cap_prev = spec.ospec.node_caps[d - 1]

    child = o.child[d - 1]
    leaf_rank = g.leaf_rank[d - 1 - fd]
    leaf_off = spec.leaf_off(d, d - 1)
    is_leaf = (child < 0) & o.node_mask(d - 1)
    leaf_feats = x[leaf_off + leaf_rank.clamp(0, cap_prev - 1)]
    par_feats = parents[child.clamp(0, parents.shape[0] - 1)]
    new_cur = torch.where(
        is_leaf[:, None], leaf_feats,
        torch.where((child >= 0)[:, None], par_feats,
                    torch.zeros_like(par_feats)),
    )
    return torch.cat([x[: spec.cur_off(d - 1)], new_cur], dim=0)


def upsample_splice(
    x: torch.Tensor,
    g: DualGraph,
    d: int,
    up_fn,
) -> torch.Tensor:
    """Splice level-(d-1) features into the level-d vertex layout;
    ``up_fn`` maps compact non-empty parent features [cap_d/8, C] to their
    8 children [cap_d, C']."""
    spec = g.spec
    fd = spec.full_depth
    o = g.octree
    cap_prev = spec.ospec.node_caps[d - 1]
    cur = _cur_segment(x, g, d - 1)
    ar = torch.arange(cap_prev, device=x.device)

    leaf_pos = g.leaf_pos[d - 1 - fd]
    k_ok = ar < g.lnum[d - 1]
    leaf_seg = cur[leaf_pos.clamp(0, cap_prev - 1)]
    leaf_seg = torch.where(k_ok[:, None], leaf_seg, torch.zeros_like(leaf_seg))

    ne_pos = o.nonempty_position(d - 1)
    k2_ok = ar < o.nnum_nempty[d - 1]
    ne_feats = cur[ne_pos]
    ne_feats = torch.where(k2_ok[:, None], ne_feats, torch.zeros_like(ne_feats))
    ne_feats = ne_feats[: spec.ospec.node_caps[d] // 8]
    children = up_fn(ne_feats)
    children = torch.where(o.node_mask(d)[:, None], children,
                           torch.zeros_like(children))
    return torch.cat([x[: spec.cur_off(d - 1)], leaf_seg, children], dim=0)


def level_input_feature(g: DualGraph) -> torch.Tensor:
    """Initial feature of the level-``depth`` graph: the octree's finest ND
    signal on current-level vertices, zeros on the coarser leaves."""
    d = g.spec.depth
    sig = g.octree.signal
    return torch.cat([sig.new_zeros((g.spec.cur_off(d), sig.shape[1])), sig])


def graph_to_level_arrays(x: torch.Tensor, g: DualGraph, d: int):
    """Scatter level-d vertex values into per-depth all-node octree arrays
    (zeros on internal nodes of depths < d), the layout the MPU reads."""
    spec = g.spec
    fd = spec.full_depth
    out = {}
    for dd in range(fd, d):
        cap = spec.ospec.node_caps[dd]
        off = spec.leaf_off(d, dd)
        k_ok = torch.arange(cap, device=x.device) < g.lnum[dd]
        out[dd] = set_where(
            torch.zeros((cap, x.shape[1]), dtype=x.dtype, device=x.device),
            g.leaf_pos[dd - fd], x[off: off + cap], k_ok,
        )
    cur = _cur_segment(x, g, d)
    out[d] = torch.where(g.octree.node_mask(d)[:, None], cur,
                         torch.zeros_like(cur))
    return out
