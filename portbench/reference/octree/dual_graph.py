"""Dual-octree graph as padded index tensors
(port of ``octfusion_tpu/octree/dual_graph.py``).

The level-d graph has one vertex per octree leaf at depths
``full_depth..d-1`` plus one per node at depth ``d``, laid out in static
segments (one leaf segment per shallower depth, then the current depth).
Edges carry a direction ``0..5`` (+z,-z,+y,-y,+x,-x seen from the source) or
``6`` for self-loops, and are sorted by ``row * 7 + dir``; invalid edge slots
hold ``row = col = g_cap``.  Every array, padding included, equals the
reference's; the sorts are stable and use the reference's int32 sentinel.

Beyond the reference, a :class:`GraphLevel` caches the CSR row pointer over
its ``G * 7`` (row, dir) slots, which the CUDA graph convolution reads, and
the transposed CSR over its (col, dir) slots, which the convolution's
input-gradient kernel reads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import morton
from .octree import Octree, OctreeSpec, set_where, tensors_to

# 6 face-neighbour offsets; row k gives the direction labelled k
NGH = np.array(
    [[0, 0, 1], [0, 0, -1], [0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0]],
    np.int64,
)
# children of a node lying on face k (octant ids)
DIR_TABLE = np.array(
    [[1, 3, 5, 7], [0, 2, 4, 6], [2, 3, 6, 7], [0, 1, 4, 5],
     [4, 5, 6, 7], [0, 1, 2, 3]],
    np.int64,
)
# opposite face
REMAP = np.array([1, 0, 3, 2, 5, 4], np.int64)
# the 24 sibling (within an 8-block) edges
INTER_ROW = np.array(
    [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 7],
    np.int64,
)
INTER_COL = np.array(
    [1, 2, 4, 0, 3, 5, 0, 3, 6, 1, 2, 7, 0, 5, 6, 1, 4, 7, 2, 4, 7, 3, 5, 6],
    np.int64,
)
INTER_DIR = np.array(
    [0, 2, 4, 1, 2, 4, 3, 0, 4, 3, 1, 4, 5, 0, 2, 5, 1, 2, 5, 3, 0, 5, 3, 1],
    np.int64,
)

N_EDGE_TYPE = 7  # 6 faces + self-loop
# sort key of invalid edge slots (the reference's int32 max)
_BIG = 2**31 - 1


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(a, device=device)


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Static layout of the dual graph derived from an :class:`OctreeSpec`."""

    ospec: OctreeSpec
    edge_factor: int = 9

    @property
    def depth(self) -> int:
        return self.ospec.depth

    @property
    def full_depth(self) -> int:
        return self.ospec.full_depth

    def goff(self, dd: int) -> int:
        return sum(self.ospec.node_caps[self.full_depth:dd])

    @property
    def gtotal(self) -> int:
        return self.goff(self.depth + 1)

    def leaf_off(self, d: int, dd: int) -> int:
        """Offset of the depth-``dd`` leaf segment inside the level-d graph."""
        assert self.full_depth <= dd < d
        return sum(self.ospec.node_caps[self.full_depth:dd])

    def cur_off(self, d: int) -> int:
        return sum(self.ospec.node_caps[self.full_depth:d])

    def g_cap(self, d: int) -> int:
        return self.cur_off(d) + self.ospec.node_caps[d]

    def e_cap(self, d: int) -> int:
        if d == self.full_depth:
            return 7 * self.g_cap(d)
        return self.edge_factor * self.g_cap(d)


def csr_of_edges(edge_row, edge_col, edge_dir, edge_scale, g: int):
    """``(row_ptr, col, scale)`` of an edge list sorted by ``row*7 + dir``:
    ``row_ptr[s]..row_ptr[s+1]`` are the edges of slot ``s = row*7 + dir``
    (int32, ``g*7 + 1`` entries).  Invalid edges carry ``row = g`` and so
    fall past the last slot."""
    slot = edge_row * N_EDGE_TYPE + edge_dir
    bounds = torch.arange(g * N_EDGE_TYPE + 1, device=slot.device)
    return (torch.searchsorted(slot, bounds).to(torch.int32),
            edge_col.to(torch.int32).contiguous(),
            edge_scale.to(torch.float32).contiguous())


def csr_t_of_edges(edge_row, edge_col, edge_dir, edge_scale, g: int):
    """``(trow_ptr, t_row, t_scale)``: the valid edges (``row < g``) stably
    sorted by ``col*7 + dir``; ``trow_ptr[s]..trow_ptr[s+1]`` are the edges
    of slot ``s = col*7 + dir`` (int32, ``g*7 + 1`` entries), ``t_row``
    their rows (int32) and ``t_scale`` their scales.  Invalid edges are
    keyed past the last slot, so no kernel reads them."""
    key = torch.where(edge_row < g, edge_col * N_EDGE_TYPE + edge_dir,
                      g * N_EDGE_TYPE)
    key, order = torch.sort(key, stable=True)
    bounds = torch.arange(g * N_EDGE_TYPE + 1, device=key.device)
    return (torch.searchsorted(key, bounds).to(torch.int32),
            edge_row[order].to(torch.int32),
            edge_scale[order].to(torch.float32))


@dataclasses.dataclass(frozen=True)
class GraphLevel:
    """The level-d dual graph: padded edge lists + per-vertex metadata."""

    d: int
    spec: GraphSpec
    edge_row: torch.Tensor    # [E] sorted by row*7+dir, invalid = g_cap
    edge_col: torch.Tensor    # [E]
    edge_dir: torch.Tensor    # [E]
    edge_scale: torch.Tensor  # [E] f32: 1/|edges with same (row, dir)|, 0 pad
    n_edges: torch.Tensor
    node_type: torch.Tensor   # [G] native depth - full_depth
    node_batch: torch.Tensor  # [G] batch_size on padding
    node_mask: torch.Tensor   # [G] bool
    node_depthv: torch.Tensor  # [G] native octree depth
    node_slot: torch.Tensor   # [G] slot in that depth's octree arrays
    n_nodes: torch.Tensor
    overflow: torch.Tensor    # bool: edge capacity exceeded
    # CSR of the sorted edges, built on first use (see :meth:`csr`)
    _csr: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    # transposed CSR, built on first use (see :meth:`csr_t`)
    _csr_t: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def g_cap(self) -> int:
        return self.spec.g_cap(self.d)

    def to(self, device) -> "GraphLevel":
        return tensors_to(self, device)

    def csr(self):
        """:func:`csr_of_edges` of this level (the CUDA graph
        convolution's CSR), built once."""
        if self._csr is None:
            object.__setattr__(self, "_csr", csr_of_edges(
                self.edge_row, self.edge_col, self.edge_dir, self.edge_scale,
                self.g_cap))
        return self._csr

    def csr_t(self):
        """:func:`csr_t_of_edges` of this level (K3's transposed CSR),
        built once on the device."""
        if self._csr_t is None:
            object.__setattr__(self, "_csr_t", csr_t_of_edges(
                self.edge_row, self.edge_col, self.edge_dir, self.edge_scale,
                self.g_cap))
        return self._csr_t


@dataclasses.dataclass(frozen=True)
class CarriedEdges:
    """Pre-self-loop edges of a level in global octree-node index space,
    threaded from one refinement level to the next."""

    d: int
    row: torch.Tensor  # sentinel = gtotal
    col: torch.Tensor
    dir: torch.Tensor
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DualGraph:
    """Dual graphs for levels ``full_depth..last_depth`` plus the octree;
    ``carried`` lets the graph be extended one level at a time."""

    spec: GraphSpec
    octree: Octree
    levels: Tuple[GraphLevel, ...]
    carried: CarriedEdges
    leaf_rank: Tuple[torch.Tensor, ...]
    leaf_pos: Tuple[torch.Tensor, ...]
    lnum: torch.Tensor  # [depth+1] (entries < full_depth unused)

    replace = dataclasses.replace

    @property
    def last_depth(self) -> int:
        return self.spec.full_depth + len(self.levels) - 1

    def level(self, d: int) -> GraphLevel:
        return self.levels[d - self.spec.full_depth]

    def to(self, device) -> "DualGraph":
        return tensors_to(self, device)

    def any_overflow(self) -> torch.Tensor:
        """True if the octree or any built level hit a static capacity."""
        ovf = self.octree.overflow.any()
        for lvl in self.levels:
            ovf = ovf | lvl.overflow
        return ovf


# ----------------------------------------------------------------------
# global node attribute table
# ----------------------------------------------------------------------
def _global_attrs(octree: Octree, spec: GraphSpec):
    xyzs, depths, childs = [], [], []
    for dd in range(spec.full_depth, spec.depth + 1):
        x, y, z, _ = octree.xyzb(dd)
        xyzs.append(torch.stack([x, y, z], -1))
        depths.append(torch.full((spec.ospec.node_caps[dd],), dd,
                                 dtype=torch.int64, device=octree.device))
        childs.append(octree.child[dd])
    return torch.cat(xyzs, 0), torch.cat(depths, 0), torch.cat(childs, 0)


def _relative_dir(xyz_g, depth_g, vi, vj, depth: int, rescale):
    """Face of node ``vi`` (native depth ``depth``) through which ``vj`` is
    seen; ``rescale`` (per edge) scales vj's coords up to vi's depth."""
    gt = xyz_g.shape[0]
    xi = xyz_g[vi.clamp(0, gt - 1)]
    vj_c = vj.clamp(0, gt - 1)
    xj = xyz_g[vj_c]
    dj = depth_g[vj_c]
    scale = torch.where(
        rescale, 2 ** (depth - dj).clamp(0, 30), torch.ones_like(dj))
    xj = xj * scale[:, None]
    xn = xi[:, None, :] + _t(NGH, xi.device)[None, :, :]
    inbox = (xn >= xj[:, None, :]) & (xn < (xj + scale[:, None])[:, None, :])
    # first True face (argmax of a bool row); 0 when none matches
    return inbox.all(dim=-1).to(torch.uint8).argmax(dim=-1)


# ----------------------------------------------------------------------
# level builders
# ----------------------------------------------------------------------
def dense_level_edges(octree: Octree, spec: GraphSpec) -> CarriedEdges:
    """All 6-neighbour edges of the full level at ``full_depth``."""
    fd = spec.full_depth
    b = octree.batch_size
    num = 8**fd
    gt = spec.gtotal
    dev = octree.device

    ki = torch.arange(num, device=dev)
    x, y, z = morton.key2xyz(ki, fd)
    xi = torch.stack([x, y, z], -1)
    xj = xi[:, None, :] + _t(NGH, dev)[None]
    inb = ((xj >= 0) & (xj < 2**fd)).all(dim=-1)
    xjc = xj.clamp(0, 2**fd - 1)
    kj = morton.xyz2key(xjc[..., 0], xjc[..., 1], xjc[..., 2], fd)
    base = spec.goff(fd) + torch.arange(b, device=dev)[:, None, None] * num
    row = ki[None, :, None].expand(b, num, 6) + base
    col = kj[None] + base
    dirs = torch.arange(6, device=dev)[None, None, :].expand(b, num, 6)
    ok = inb[None].expand(b, num, 6)
    return CarriedEdges(
        d=fd,
        row=torch.where(ok, row, gt).reshape(-1),
        col=torch.where(ok, col, gt).reshape(-1),
        dir=torch.where(ok, dirs, 0).reshape(-1),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
    )


def expand_level_edges(
    octree: Octree, spec: GraphSpec, prev: CarriedEdges
) -> CarriedEdges:
    """Refine level d-1 edges to level d with at most 4 child slots per
    parent edge, plus the 24 sibling edges of every new 8-block."""
    d = prev.d + 1
    gt = spec.gtotal
    dev = octree.device
    xyz_g, depth_g, child_g = _global_attrs(octree, spec)

    row, col, dirs = prev.row, prev.col, prev.dir
    e_valid = row < gt
    neg = torch.full_like(row, -1)
    ci = torch.where(e_valid, child_g[row.clamp(0, gt - 1)], neg)
    cj = torch.where(e_valid, child_g[col.clamp(0, gt - 1)], neg)
    i_int = ci >= 0
    j_int = cj >= 0

    rel_i = _relative_dir(xyz_g, depth_g, row, col, d - 1, rescale=~j_int)
    rel_j = _relative_dir(xyz_g, depth_g, col, row, d - 1,
                          rescale=torch.ones_like(j_int))

    goff_d = spec.goff(d)
    dt = _t(DIR_TABLE, dev)
    rm = _t(REMAP, dev)

    # case both-leaf: carry (slot 0 only)
    out_r0 = torch.where((~i_int) & (~j_int) & e_valid, row,
                         torch.full_like(row, gt))
    out_c0 = col
    out_d0 = dirs

    e = row.shape[0]
    # case row internal (col leaf): children of i facing j -> j
    chi = goff_d + ci * 8
    r_i = chi[:, None] + dt[rel_i]
    c_i = col[:, None].expand(e, 4)
    d_i = rel_i[:, None].expand(e, 4)
    # case col internal (row leaf): i -> children of j facing i
    chj = goff_d + cj * 8
    r_j = row[:, None].expand(e, 4)
    c_j = chj[:, None] + dt[rel_j]
    d_j = rm[rel_j][:, None].expand(e, 4)
    # case both internal: matched face children
    r_b = chi[:, None] + dt[rel_i]
    c_b = chj[:, None] + dt[rm[rel_i]]
    d_b = rel_i[:, None].expand(e, 4)

    sel_i = (i_int & ~j_int & e_valid)[:, None]
    sel_j = (~i_int & j_int & e_valid)[:, None]
    sel_b = (i_int & j_int & e_valid)[:, None]
    gt4 = torch.full((e, 4), gt, dtype=torch.int64, device=dev)
    zero4 = torch.zeros((e, 4), dtype=torch.int64, device=dev)
    out_r4 = torch.where(sel_i, r_i, torch.where(
        sel_j, r_j, torch.where(sel_b, r_b, gt4)))
    out_c4 = torch.where(sel_i, c_i, torch.where(
        sel_j, c_j, torch.where(sel_b, c_b, gt4)))
    out_d4 = torch.where(sel_i, d_i, torch.where(
        sel_j, d_j, torch.where(sel_b, d_b, zero4)))

    # sibling edges inside every new 8-block at depth d
    nblk = spec.ospec.node_caps[d] // 8
    blk = torch.arange(nblk, device=dev)[:, None]
    blk_ok = blk * 8 < octree.nnum[d]
    ir = goff_d + blk * 8 + _t(INTER_ROW, dev)[None]
    ic = goff_d + blk * 8 + _t(INTER_COL, dev)[None]
    idd = _t(INTER_DIR, dev)[None].expand(nblk, 24)
    ir = torch.where(blk_ok, ir, gt)
    ic = torch.where(blk_ok, ic, gt)

    cand_r = torch.cat([out_r0, out_r4.reshape(-1), ir.reshape(-1)])
    cand_c = torch.cat([out_c0, out_c4.reshape(-1), ic.reshape(-1)])
    cand_d = torch.cat([out_d0, out_d4.reshape(-1), idd.reshape(-1)])
    cand_ok = cand_r < gt
    cand_c = torch.where(cand_ok, cand_c, gt)
    cand_d = torch.where(cand_ok, cand_d, 0)

    # compact valid edges to the front (stable sort by row*7+dir) and
    # truncate to the static capacity
    key = torch.where(cand_ok, cand_r * N_EDGE_TYPE + cand_d, _BIG)
    key, order = torch.sort(key, stable=True)
    cap = spec.e_cap(d)
    key = key[:cap]
    col = cand_c[order[:cap]]
    valid = key != _BIG
    n_valid = cand_ok.sum()
    return CarriedEdges(
        d=d,
        row=torch.where(valid, key // N_EDGE_TYPE, gt),
        col=torch.where(valid, col, gt),
        dir=torch.where(valid, key % N_EDGE_TYPE, 0),
        overflow=prev.overflow | (n_valid > cap),
    )


def _leaf_maps(octree: Octree, dd: int):
    """(leaf_rank, leaf_pos, lnum) for depth dd."""
    cap = octree.spec.node_caps[dd]
    leaf = octree.node_mask(dd) & (octree.child[dd] < 0)
    rank = torch.cumsum(leaf.to(torch.int64), 0) - 1
    leaf_rank = torch.where(leaf, rank, torch.full_like(rank, cap))
    ar = torch.arange(cap, device=octree.device)
    pos = set_where(torch.full_like(ar, cap), rank, ar, leaf)
    return leaf_rank, pos, leaf.sum()


def finalize_level(
    octree: Octree,
    spec: GraphSpec,
    carried: CarriedEdges,
    leaf_maps=None,
) -> GraphLevel:
    """Remap carried (global-index) edges into the level-d vertex layout,
    add self-loops, sort by row*7+dir and precompute scatter-mean scales."""
    d = carried.d
    fd = spec.full_depth
    gt = spec.gtotal
    gcap = spec.g_cap(d)
    dev = octree.device
    i64 = dict(dtype=torch.int64, device=dev)

    remap_segs = []
    node_type, node_batch, node_mask, node_depthv, node_slot = [], [], [], [], []
    n_nodes = torch.zeros((), **i64)
    for dd in range(fd, d):
        cap = spec.ospec.node_caps[dd]
        if leaf_maps is not None:
            leaf_rank, leaf_pos, lnum = leaf_maps[dd]
        else:
            leaf_rank, leaf_pos, lnum = _leaf_maps(octree, dd)
        off = spec.leaf_off(d, dd)
        remap_segs.append(torch.where(leaf_rank < cap, off + leaf_rank,
                                      torch.full_like(leaf_rank, gcap)))
        k_ok = torch.arange(cap, device=dev) < lnum
        slot = leaf_pos.clamp(0, cap - 1)
        zero = torch.zeros(cap, **i64)
        node_type.append(torch.where(k_ok, dd - fd, zero))
        node_batch.append(torch.where(
            k_ok, octree.batch[dd][slot],
            torch.full_like(zero, octree.batch_size)))
        node_mask.append(k_ok)
        node_depthv.append(torch.where(k_ok, dd, zero))
        node_slot.append(torch.where(k_ok, slot, zero))
        n_nodes = n_nodes + lnum
    cap_d = spec.ospec.node_caps[d]
    cur_off = spec.cur_off(d)
    cur_ok = octree.node_mask(d)
    ar = torch.arange(cap_d, device=dev)
    zero = torch.zeros(cap_d, **i64)
    remap_segs.append(torch.where(cur_ok, cur_off + ar,
                                  torch.full_like(ar, gcap)))
    node_type.append(torch.where(cur_ok, d - fd, zero))
    node_batch.append(torch.where(cur_ok, octree.batch[d],
                                  torch.full_like(zero, octree.batch_size)))
    node_mask.append(cur_ok)
    node_depthv.append(torch.where(cur_ok, d, zero))
    node_slot.append(torch.where(cur_ok, ar, zero))
    n_nodes = n_nodes + octree.nnum[d]

    remap = torch.cat(remap_segs)
    remap = torch.cat([remap, torch.full((gt - remap.shape[0],), gcap, **i64)])

    e_ok = carried.row < gt
    row = torch.where(e_ok, remap[carried.row.clamp(0, gt - 1)], gcap)
    col = torch.where(e_ok, remap[carried.col.clamp(0, gt - 1)], gcap)
    bad = (row >= gcap) | (col >= gcap)
    row = torch.where(bad, gcap, row)
    col = torch.where(bad, gcap, col)
    dirs = torch.where(bad, 0, carried.dir)

    # self-loops (dir 6) on vertices that have at least one edge
    has_edge = set_where(torch.zeros(gcap, dtype=torch.bool, device=dev),
                         row, torch.ones_like(bad), row < gcap)
    loop_idx = torch.arange(gcap, device=dev)
    loop_row = torch.where(has_edge, loop_idx, gcap)

    all_row = torch.cat([row, loop_row])
    all_col = torch.cat([col, loop_row])
    all_dir = torch.cat([dirs, torch.full((gcap,), 6, **i64)])

    sort_key = torch.where(all_row < gcap, all_row * N_EDGE_TYPE + all_dir,
                           _BIG)
    sort_key, order = torch.sort(sort_key, stable=True)
    all_col = all_col[order]
    valid_e = sort_key != _BIG
    all_row = torch.where(valid_e, sort_key // N_EDGE_TYPE, gcap)
    all_dir = torch.where(valid_e, sort_key % N_EDGE_TYPE, 0)
    n_edges = valid_e.sum()

    # per-edge scatter-mean scale from run lengths of the sorted slots
    # (running max of run starts, reversed running min of run ends)
    n_all = sort_key.shape[0]
    eidx = torch.arange(n_all, device=dev)
    newrun = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        sort_key[1:] != sort_key[:-1]])
    run_start = torch.cummax(torch.where(newrun, eidx, -1), 0).values
    bound = torch.where(newrun, eidx, n_all)
    nxt = torch.flip(torch.cummin(torch.flip(bound, [0]), 0).values, [0])
    run_end = torch.cat([nxt[1:], torch.full((1,), n_all, **i64)])
    run_len = (run_end - run_start).clamp(min=1).to(torch.float32)
    scale = torch.where(valid_e, 1.0 / run_len, torch.zeros_like(run_len))

    return GraphLevel(
        d=d, spec=spec,
        edge_row=all_row, edge_col=all_col, edge_dir=all_dir,
        edge_scale=scale, n_edges=n_edges,
        node_type=torch.cat(node_type), node_batch=torch.cat(node_batch),
        node_mask=torch.cat(node_mask), node_depthv=torch.cat(node_depthv),
        node_slot=torch.cat(node_slot), n_nodes=n_nodes,
        overflow=carried.overflow,
    )


def build_dual_graph(
    octree: Octree, edge_factor: int = 9, up_to: int = None
) -> DualGraph:
    """Dual graphs for levels full_depth..``up_to`` (default: depth)."""
    spec = GraphSpec(octree.spec, edge_factor)
    fd = spec.full_depth
    last = spec.depth if up_to is None else up_to

    leaf_maps = {dd: _leaf_maps(octree, dd) for dd in range(fd, last + 1)}
    carried = dense_level_edges(octree, spec)
    levels = [finalize_level(octree, spec, carried, leaf_maps)]
    for _ in range(fd + 1, last + 1):
        carried = expand_level_edges(octree, spec, carried)
        levels.append(finalize_level(octree, spec, carried, leaf_maps))

    lnum = torch.zeros(spec.depth + 1, dtype=torch.int64, device=octree.device)
    for dd in range(fd, last + 1):
        lnum[dd] = leaf_maps[dd][2]
    return DualGraph(
        spec=spec, octree=octree, levels=tuple(levels), carried=carried,
        leaf_rank=tuple(leaf_maps[dd][0] for dd in range(fd, last + 1)),
        leaf_pos=tuple(leaf_maps[dd][1] for dd in range(fd, last + 1)),
        lnum=lnum,
    )


def extend_dual_graph(g: DualGraph, octree: Octree) -> DualGraph:
    """Add the next level's graph after the octree grew one depth deeper
    (``octree`` = ``g.octree`` split at ``g.last_depth`` and grown)."""
    spec = g.spec
    fd = spec.full_depth
    d_prev = g.last_depth
    d_new = d_prev + 1

    lm_prev = _leaf_maps(octree, d_prev)
    lm_new = _leaf_maps(octree, d_new)
    leaf_maps = {dd: (g.leaf_rank[i], g.leaf_pos[i], g.lnum[dd])
                 for i, dd in enumerate(range(fd, d_prev))}
    leaf_maps[d_prev] = lm_prev
    leaf_maps[d_new] = lm_new

    carried = expand_level_edges(octree, spec, g.carried)
    lvl = finalize_level(octree, spec, carried, leaf_maps)

    lnum = g.lnum.clone()
    lnum[d_prev] = lm_prev[2]
    lnum[d_new] = lm_new[2]
    return g.replace(
        octree=octree,
        levels=g.levels + (lvl,),
        carried=carried,
        leaf_rank=g.leaf_rank[: d_prev - fd] + (lm_prev[0], lm_new[0]),
        leaf_pos=g.leaf_pos[: d_prev - fd] + (lm_prev[1], lm_new[1]),
        lnum=lnum,
    )
