"""The neural multi-level partition-of-unity SDF (port of
``octfusion_tpu/ops/mpu.py``).

Each octree node at depths ``full_depth..d`` carries a plane ``(n, b)``; a
query's SDF is the trilinear-weighted blend of ``n·Δx + b`` over its 8
corner nodes per depth, normalised by the blended weights.

* Scattered queries (training): ``octree_corner_info`` finds each query's
  8 corner nodes per depth by key search (or a dense ``lookup_table``),
  ``mpu_eval`` blends them, ``mpu_eval_grad`` adds the closed-form
  spatial gradient in the same pass, and ``neural_mpu`` evaluates every
  target depth with the corner lookups shared.  Every query keeps its
  static 8 corner slots per depth with masks.  The absolute value in the
  trilinear basis (``abs_one``) has derivative sign(x) with sign(0) = +1,
  as the reference's custom gradient.  ``mpu_interp`` blends per-node
  constant values (the colour VAE's colours) with the same weights.
* A regular grid (inference): the corner weights are trilinear
  interpolation weights, so the blend becomes six dense per-node channels
  per depth resampled by three axis-separable lerps (see the JAX module
  for the derivation).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..octree import morton
from ..octree.octree import Octree
from ..utils import trace

# corner offsets, x-major
_CORNERS = ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
            (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))


def _sign1(x: torch.Tensor) -> torch.Tensor:
    """sign(x) with sign(0) = +1."""
    return torch.where(x < 0, -1.0, 1.0).to(x.dtype)


class _AbsOne(torch.autograd.Function):
    """|x| with derivative sign(x), sign(0) = +1 (``torch.abs`` has 0
    there), in reverse and forward mode."""

    @staticmethod
    def forward(x):
        return x.abs()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * _sign1(x)

    @staticmethod
    def jvp(ctx, tangent):
        (x,) = ctx.saved_tensors
        return tangent * _sign1(x)


def abs_one(x: torch.Tensor) -> torch.Tensor:
    return _AbsOne.apply(x)


def linear_basis(x: torch.Tensor) -> torch.Tensor:
    return 1.0 - abs_one(x)


def octree_corner_info(octree: Octree, depth: int, pos: torch.Tensor,
                       pt_batch: torch.Tensor, table=None):
    """The 8 trilinear corner nodes at ``depth`` of queries ``pos`` [N, 3]
    in [-1, 1]^3 of samples ``pt_batch`` [N].  ``table``
    (``octree.lookup_table(depth)``) replaces the binary search with one
    gather.  Returns (idx [N, 8] node slot or -1, coordsf [N, 8, 3]
    offsets in the query's scale, weights [N, 8] trilinear · depth²/50,
    valid [N, 8])."""
    scale = 2**depth
    xyzf = (pos + 1.0) * (scale / 2.0) - 0.5
    xyzi = torch.floor(xyzf)
    corners = xyzi[:, None, :] + torch.tensor(
        _CORNERS, dtype=pos.dtype, device=pos.device)[None]     # [N, 8, 3]
    coordsf = xyzf[:, None, :] - corners
    inb = ((corners > -1) & (corners < scale)).all(dim=-1)      # [N, 8]
    ci = corners.clamp(0, scale - 1).to(torch.int64)
    key = morton.xyz2key(ci[..., 0], ci[..., 1], ci[..., 2], depth)
    qb = pt_batch[:, None].expand(key.shape)
    if table is not None:
        n = octree.batch_size * 8**depth
        addr = qb.clamp(0, octree.batch_size - 1) * 8**depth + key
        idx = table[addr.clamp(0, n - 1)]
    else:
        idx = octree.search_key(key.reshape(-1), qb.reshape(-1),
                                depth).reshape(key.shape)
    valid = inb & (idx >= 0)
    w = torch.prod(linear_basis(coordsf), dim=-1) * (depth**2 / 50.0)
    return idx, coordsf * (2.0 / scale), w, valid


def _level_terms(octree, dd, depth_end, pos, pt_batch, reg_levels,
                 corner_cache, tables):
    """One depth's corners: (coordsf, w, use mask, gathered planes
    [N, 8, 4], plane values [N, 8]).  Corners at depths below
    ``depth_end`` count only on octree leaves."""
    if corner_cache is not None and dd in corner_cache:
        idx, coordsf, w, valid = corner_cache[dd]
    else:
        idx, coordsf, w, valid = octree_corner_info(
            octree, dd, pos, pt_batch,
            table=None if tables is None else tables.get(dd))
    idx_c = idx.clamp(0, octree.spec.node_caps[dd] - 1)
    use = valid if dd == depth_end else (
        valid & (octree.child[dd][idx_c] < 0))
    with trace.span("octf.gather.mpu"):
        reg = reg_levels[dd][idx_c.reshape(-1)].reshape(pos.shape[0], 8, 4)
    fval = torch.sum(reg[..., :3] * coordsf, dim=-1) + reg[..., 3]
    return coordsf, w, use, valid, reg, fval


def mpu_eval(pos: torch.Tensor, pt_batch: torch.Tensor,
             reg_levels: Dict[int, torch.Tensor], octree: Octree,
             full_depth: int, depth_end: int, corner_cache=None,
             tables=None):
    """Blend per-node planes into SDF values at ``pos``.
    ``reg_levels[dd]`` is the [node_caps[dd], 4] plane array of depth dd
    (zeros off the graph).  Returns (sdf [N], covered [N]: some corner of
    depth ``depth_end`` exists)."""
    n = pos.shape[0]
    num = pos.new_zeros(n)
    den = pos.new_zeros(n)
    covered = torch.zeros(n, dtype=torch.bool, device=pos.device)
    for dd in range(full_depth, depth_end + 1):
        _, w, use, valid, _, fval = _level_terms(
            octree, dd, depth_end, pos, pt_batch, reg_levels, corner_cache,
            tables)
        if dd == depth_end:
            covered = valid.any(dim=-1)
        wm = torch.where(use, w, torch.zeros_like(w))
        num = num + torch.sum(wm * fval, dim=-1)
        den = den + torch.sum(wm, dim=-1)
    return num / (den + 1e-8), covered


def mpu_eval_grad(pos: torch.Tensor, pt_batch: torch.Tensor,
                  reg_levels: Dict[int, torch.Tensor], octree: Octree,
                  full_depth: int, depth_end: int, corner_cache=None,
                  tables=None):
    """``mpu_eval`` and its spatial gradient in one pass, in closed form:
    (sdf [N], dsdf/dpos [N, 3]).  With f_c = n_c·Δx_c + b_c, ∂f_c/∂pos =
    n_c; the weight w_c = (d²/50)·Π_a(1 - |r_a|) (r the in-cell offset)
    has ∂w_c/∂pos_a = (d²/50)·(S/2)·(-sign r_a)·Π_{b≠a}(1 - |r_b|) with
    sign(0) = +1, as ``abs_one``; the quotient rule finishes
    N / (D + eps).  No double backward: the result is differentiable in
    the planes by ordinary reverse mode."""
    n = pos.shape[0]
    num = pos.new_zeros(n)
    den = pos.new_zeros(n)
    dnum = pos.new_zeros(n, 3)
    dden = pos.new_zeros(n, 3)
    for dd in range(full_depth, depth_end + 1):
        coordsf, w, use, _, reg, fval = _level_terms(
            octree, dd, depth_end, pos, pt_batch, reg_levels, corner_cache,
            tables)
        scale = 2**dd
        wm = torch.where(use, w, torch.zeros_like(w))             # [N, 8]
        num = num + torch.sum(wm * fval, dim=-1)
        den = den + torch.sum(wm, dim=-1)
        # the raw in-cell offsets; products of the other two bases, so
        # |r| = 1 edges (w = 0, ∂w != 0) stay exact
        r = coordsf * (scale / 2.0)                               # [N, 8, 3]
        basis = 1.0 - r.abs()
        pe = torch.stack([basis[..., 1] * basis[..., 2],
                          basis[..., 0] * basis[..., 2],
                          basis[..., 0] * basis[..., 1]], dim=-1)
        dw = (dd * dd / 50.0) * (scale / 2.0) * (-_sign1(r)) * pe
        dwm = torch.where(use[..., None], dw, torch.zeros_like(dw))
        dnum = dnum + torch.sum(
            dwm * fval[..., None] + wm[..., None] * reg[..., :3], dim=1)
        dden = dden + torch.sum(dwm, dim=1)
    d_eps = den + 1e-8
    sdf = num / d_eps
    grad = (dnum * d_eps[:, None] - num[:, None] * dden) / (
        d_eps * d_eps)[:, None]
    return sdf, grad


def neural_mpu(pos: torch.Tensor, pt_batch: torch.Tensor,
               reg_voxs: Dict[int, Dict[int, torch.Tensor]], octree: Octree,
               full_depth: int, depth_stop: int, depth_end: int):
    """Every target depth: {d: (sdf, covered)} for d in
    depth_stop..depth_end, the corner lookups shared across depths."""
    cache = {dd: octree_corner_info(octree, dd, pos, pt_batch)
             for dd in range(full_depth, depth_end + 1)}
    return {d: mpu_eval(pos, pt_batch, reg_voxs[d], octree, full_depth, d,
                        corner_cache=cache)
            for d in range(depth_stop, depth_end + 1)}


def mpu_interp(pos: torch.Tensor, pt_batch: torch.Tensor,
               val_levels: Dict[int, torch.Tensor], octree: Octree,
               full_depth: int, depth_end: int) -> torch.Tensor:
    """Partition-of-unity blend of per-node *constant* values (e.g.
    predicted colours): ``mpu_eval``'s blend with the node's value in
    place of its plane.  ``val_levels[dd]``: [node_caps[dd], C] -> [N, C].
    Corners at depths below ``depth_end`` count only on octree leaves."""
    n = pos.shape[0]
    c = val_levels[depth_end].shape[1]
    num = pos.new_zeros(n, c)
    den = pos.new_zeros(n)
    for dd in range(full_depth, depth_end + 1):
        idx, _, w, valid = octree_corner_info(octree, dd, pos, pt_batch)
        idx_c = idx.clamp(0, octree.spec.node_caps[dd] - 1)
        use = valid if dd == depth_end else (
            valid & (octree.child[dd][idx_c] < 0))
        with trace.span("octf.gather.mpu"):
            vals = val_levels[dd][idx_c.reshape(-1)].reshape(n, 8, c)
        wm = torch.where(use, w, torch.zeros_like(w))
        num = num + torch.sum(wm[..., None] * vals, dim=1)
        den = den + torch.sum(wm, dim=-1)
    return num / (den[:, None] + 1e-8)


def _axis_taps(xf: torch.Tensor, s: int):
    """The linear taps of positions ``xf`` (input-index units) along an
    axis of ``s`` cells, on that axis compacted to the cells they read ->
    (the cells, sorted; each position's two compact indices; their
    weights, zero for an out-of-range tap)."""
    i0 = torch.floor(xf).to(torch.int64)
    f = xf - i0
    c0, c1 = i0.clamp(0, s - 1), (i0 + 1).clamp(0, s - 1)
    cells = torch.unique(torch.cat([c0, c1]))
    lut = torch.zeros(s, dtype=torch.int64, device=xf.device)
    lut[cells] = torch.arange(cells.shape[0], device=xf.device)
    w0 = (1.0 - f) * ((i0 >= 0) & (i0 < s))
    w1 = f * ((i0 + 1 >= 0) & (i0 + 1 < s))
    return cells, lut[c0], lut[c1], w0, w1


def mpu_dense_channels(reg: torch.Tensor, octree: Octree, dd: int,
                       leaf_only: bool, cells: torch.Tensor) -> torch.Tensor:
    """Scatter per-node MPU channels into a dense [B, T, T, T, 6] grid over
    the depth-``dd`` cells ``cells`` [T] (sorted) of each axis, the cells a
    grid evaluation reads: [m·nx, m·ny, m·nz, m·(n·c), m·b, m] with
    m = valid(·leaf)·dd²/50.  A node off those cells reaches no grid
    point and is left out."""
    s = 2**dd
    t = cells.shape[0]
    bsz = octree.batch_size
    x, y, z, b = octree.xyzb(dd)
    m = octree.node_mask(dd)
    if leaf_only:
        m = m & (octree.child[dd] < 0)
    n = reg[:, :3]
    bias = reg[:, 3:4]
    coords = torch.stack([x, y, z], -1).to(torch.float32)
    ndotc = torch.sum(n * coords, dim=-1, keepdim=True)
    ch = torch.cat([n, ndotc, bias, torch.ones_like(bias)], dim=-1)
    ch = ch * (m.to(torch.float32) * (dd * dd / 50.0))[:, None]
    lut = torch.full((s,), -1, dtype=torch.int64, device=reg.device)
    lut[cells] = torch.arange(t, device=reg.device)
    cx, cy, cz = (lut[c.clamp(0, s - 1)] for c in (x, y, z))
    keep = m & (cx >= 0) & (cy >= 0) & (cz >= 0)
    flat = ((b * t + cx) * t + cy) * t + cz
    # one scratch row past the end takes the dropped nodes
    n_cells = bsz * t**3
    grid = torch.zeros((n_cells + 1, 6), dtype=torch.float32,
                       device=reg.device)
    grid.index_put_((torch.where(keep, flat, n_cells),), ch)
    return grid[:n_cells].view(bsz, t, t, t, 6)


def _lerp_axis(arr: torch.Tensor, j0: torch.Tensor, j1: torch.Tensor,
               w0: torch.Tensor, w1: torch.Tensor, axis: int) -> torch.Tensor:
    """1-D linear interpolation of ``arr`` along ``axis`` from the taps
    ``j0`` / ``j1`` with weights ``w0`` / ``w1`` (:func:`_axis_taps`)."""
    shape = [1] * arr.dim()
    shape[axis] = j0.shape[0]
    return (torch.index_select(arr, axis, j0) * w0.reshape(shape)
            + torch.index_select(arr, axis, j1) * w1.reshape(shape))


def mpu_grid_eval(
    reg_levels: Dict[int, torch.Tensor],
    octree: Octree,
    full_depth: int,
    depth_end: int,
    size: int,
    bbmin: float,
    bbmax: float,
) -> torch.Tensor:
    """SDF of the MPU on a regular ``size``³ grid over [bbmin, bbmax]³
    (grid point i at bbmin + i·(bbmax-bbmin)/size).  Returns
    [B, size, size, size] float32.  Each depth's channels are made dense
    over the cells the grid's taps read only (at most 2 ``size`` a side:
    at depth 10 and 256³, 512³ cells where the full grid has 1024³)."""
    bsz = octree.batch_size
    dev = octree.device
    step = (bbmax - bbmin) / size
    idx = torch.arange(size, dtype=torch.float32, device=dev)
    num = torch.zeros((bsz, size, size, size), dtype=torch.float32, device=dev)
    den = torch.zeros_like(num)
    for dd in range(full_depth, depth_end + 1):
        s = 2**dd
        xf = (idx * step + bbmin + 1.0) * (s / 2.0) - 0.5
        cells, *taps = _axis_taps(xf, s)
        dense = mpu_dense_channels(reg_levels[dd], octree, dd,
                                   leaf_only=dd < depth_end, cells=cells)
        t = _lerp_axis(dense, *taps, axis=1)
        t = _lerp_axis(t, *taps, axis=2)
        t = _lerp_axis(t, *taps, axis=3)        # [B, R, R, R, 6]
        xg = xf[:, None, None]
        yg = xf[None, :, None]
        zg = xf[None, None, :]
        ndotx = t[..., 0] * xg + t[..., 1] * yg + t[..., 2] * zg
        num = num + (2.0 / s) * (ndotx - t[..., 3]) + t[..., 4]
        den = den + t[..., 5]
    return num / (den + 1e-8)
