"""Functional graph primitives on :class:`GraphLevel` index tensors
(port of ``octfusion_tpu/ops/graph_ops.py``).

* ``graph_conv`` — scatter-mean over the 7 (row, dir) slots, then one GEMM,
  differentiable: a CUDA tensor goes through the hand-written kernels
  (``ops/graph_conv_cuda.py``; K1 forward, K2 and K3 backward), a CPU
  tensor through their plain versions; a packed level
  (``dual_graph.with_packed_levels``) takes the forward-only K5 instead;
* ``dual_group_norm`` — per-sample statistics over valid vertices with the
  reference's ``1/(count + eps)`` and ``var = E[x²] - mean²`` conventions;
* ``downsample_splice`` / ``upsample_splice`` — the leaf-preserving level
  moves, as static-segment gathers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..octree.dual_graph import DualGraph, GraphLevel
from ..octree.octree import set_where
from ..utils import trace
from . import graph_conv_cuda


def graph_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    lvl: GraphLevel,
    n_node_type: int = 0,
) -> torch.Tensor:
    """x: [G, C]; w: [7*(C+node_ch), C_out].  Returns [G, C_out]; vertices
    without edges produce zero rows.  The node-type one-hot columns are
    concatenated before the autograd function, so autograd slices their
    gradient away.  A packed level runs the forward-only K5 (or its plain
    version on the CPU) and raises where a gradient would be needed."""
    if n_node_type > 1:
        onehot = F.one_hot(lvl.node_type, n_node_type).to(x.dtype)
        onehot = onehot * lvl.node_mask[:, None].to(x.dtype)
        x = torch.cat([x, onehot], dim=-1)
    if lvl.packed:
        return graph_conv_cuda.packed_forward(x, w, lvl)
    return graph_conv_cuda.GraphConvFunction.apply(x, w, lvl)


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
    with trace.span("octf.gather.norm"):
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
    with trace.span("octf.gather.embed"):
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
    with trace.span("octf.gather.move"):
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
    with trace.span("octf.gather.move"):
        leaf_seg = cur[leaf_pos.clamp(0, cap_prev - 1)]
    leaf_seg = torch.where(k_ok[:, None], leaf_seg, torch.zeros_like(leaf_seg))

    ne_pos = o.nonempty_position(d - 1)
    k2_ok = ar < o.nnum_nempty[d - 1]
    with trace.span("octf.gather.move"):
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
        with trace.span("octf.gather.move"):
            out[dd] = set_where(
                torch.zeros((cap, x.shape[1]), dtype=x.dtype,
                            device=x.device),
                g.leaf_pos[dd - fd], x[off: off + cap], k_ok,
            )
    cur = _cur_segment(x, g, d)
    out[d] = torch.where(g.octree.node_mask(d)[:, None], cur,
                         torch.zeros_like(cur))
    return out
