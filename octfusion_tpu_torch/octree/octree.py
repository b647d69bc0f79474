"""Batched octrees as static-capacity struct-of-tensors
(port of ``octfusion_tpu/octree/octree.py``).

Each depth ``d`` owns tensors padded to ``spec.node_caps[d]`` with a valid
prefix of length ``nnum[d]`` (a device tensor, so growing never waits for
the host).  Layout invariants, as in the reference:

* per depth, valid nodes occupy slots ``[0, nnum[d])``, sorted ascending by
  ``(batch, morton_key)``;
* for ``d > 0`` the children of the k-th non-empty node of depth ``d-1``
  occupy slots ``[8k, 8k+8)``;
* ``child[d][i] >= 0`` iff node ``i`` is non-empty, and it is the node's rank
  among the non-empty nodes of depth ``d``;
* padded slots carry ``key = INVALID_KEY``, ``batch = batch_size``,
  ``child = -1``.

Integer tensors are int64 (PyTorch's index type); values equal the
reference's int32 values.  Where the reference relies on JAX dropping an
out-of-range scatter or clamping an out-of-range gather, the port masks or
clamps explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..utils import trace
from . import morton
from .morton import INVALID_KEY


def tensors_to(obj, device):
    """Copy every tensor of a (nested) dataclass / list / tuple / dict to
    ``device``; other leaves are kept."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(tensors_to(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: tensors_to(v, device) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tensors_to(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init
        })
    return obj


def set_where(out: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
              keep: torch.Tensor) -> torch.Tensor:
    """``out`` with ``out[idx[i]] = val[i]`` wherever ``keep[i]``: the
    reference's ``.at[idx].set(val, mode="drop")`` with the dropped rows
    named.  Dropped rows go to a scratch row past the end, so no
    data-dependent shape (and no device sync) is involved."""
    n = out.shape[0]
    buf = torch.cat([out, out[:1]], 0)
    tgt = torch.where(keep, idx, torch.full_like(idx, n))
    buf.index_put_((tgt,), val.to(out.dtype))
    return buf[:n]


@dataclasses.dataclass(frozen=True)
class OctreeSpec:
    """Static shape descriptor for an :class:`Octree`.  ``node_caps[d]`` is
    the padded node capacity of depth ``d`` for the whole batch."""

    depth: int
    full_depth: int
    batch_size: int
    node_caps: Tuple[int, ...]

    def __post_init__(self):
        assert 0 < self.full_depth <= self.depth <= morton.MAX_DEPTH
        assert len(self.node_caps) == self.depth + 1
        for d in range(self.full_depth + 1):
            assert self.node_caps[d] == self.batch_size * 8**d, (
                f"full levels must have exact capacity, got {self.node_caps[d]} "
                f"at depth {d}"
            )
        for d in range(self.full_depth + 1, self.depth + 1):
            assert self.node_caps[d] % 8 == 0
            assert self.node_caps[d] <= 8 * self.node_caps[d - 1]

    @staticmethod
    def create(
        depth: int,
        full_depth: int,
        batch_size: int = 1,
        finest_cap_per_sample: int = 65536,
        decay: float = 4.0,
        caps_override: Optional[Sequence[int]] = None,
    ) -> "OctreeSpec":
        """Full levels exact, sparse levels decaying geometrically from
        ``finest_cap_per_sample`` (same rule as the reference)."""
        caps = []
        for d in range(depth + 1):
            if d <= full_depth:
                caps.append(batch_size * 8**d)
            else:
                c = int(finest_cap_per_sample / decay ** (depth - d))
                floor = min(8**d, 8**full_depth)
                c = min(8**d, max(c, floor, 64)) * batch_size
                caps.append(-(-c // 8) * 8)
        if caps_override is not None:
            for d, c in enumerate(caps_override):
                if c is not None:
                    caps[d] = c
        return OctreeSpec(depth, full_depth, batch_size, tuple(caps))

    def with_batch_size(self, batch_size: int) -> "OctreeSpec":
        per = [c // self.batch_size for c in self.node_caps]
        return OctreeSpec(
            self.depth, self.full_depth, batch_size,
            tuple(p * batch_size for p in per),
        )


@dataclasses.dataclass(frozen=True)
class Octree:
    """A batch of octrees, all tensors statically shaped (see module docs)."""

    spec: OctreeSpec
    keys: List[torch.Tensor]      # per depth [node_caps[d]] int64 Morton codes
    batch: List[torch.Tensor]     # int64 batch ids
    child: List[torch.Tensor]     # int64, -1 = empty / leaf
    nnum: torch.Tensor            # [depth+1] int64 valid counts
    nnum_nempty: torch.Tensor     # [depth+1] int64 non-empty counts
    signal: torch.Tensor          # [node_caps[depth], 4] float32
    overflow: torch.Tensor        # [depth+1] bool: a level needed more slots

    replace = dataclasses.replace

    @property
    def batch_size(self) -> int:
        return self.spec.batch_size

    @property
    def device(self) -> torch.device:
        return self.nnum.device

    def _arange(self, n: int) -> torch.Tensor:
        return torch.arange(n, device=self.device)

    def node_mask(self, d: int) -> torch.Tensor:
        """[cap_d] bool: valid (non-padding) nodes."""
        return self._arange(self.spec.node_caps[d]) < self.nnum[d]

    def nempty_mask(self, d: int) -> torch.Tensor:
        """[cap_d] bool: valid and non-empty nodes."""
        return self.child[d] >= 0

    def batch_id(self, d: int) -> torch.Tensor:
        return self.batch[d]

    def xyzb(self, d: int):
        """Decode keys of depth ``d`` to (x, y, z, b); padded slots give
        garbage coords and ``b == batch_size``."""
        x, y, z = morton.key2xyz(self.keys[d], d)
        return x, y, z, self.batch[d]

    def nonempty_position(self, d: int) -> torch.Tensor:
        """[cap_d] slot of the k-th non-empty node; entries past
        ``nnum_nempty[d]`` are 0 and must be masked by the caller."""
        cap = self.spec.node_caps[d]
        ne = self.nempty_mask(d)
        pos = torch.zeros(cap, dtype=torch.int64, device=self.device)
        return set_where(pos, self.child[d], self._arange(cap), ne)

    def to_voxel(self, data: torch.Tensor, d: int) -> torch.Tensor:
        """Scatter node data into a dense [B, S, S, S, C] grid (NDHWC)."""
        size = 2**d
        x, y, z, b = self.xyzb(d)
        flat = ((b * size + x) * size + y) * size + z
        grid = torch.zeros(
            (self.batch_size * size**3, data.shape[-1]),
            dtype=data.dtype, device=data.device,
        )
        with trace.span("octf.gather.move"):
            grid = set_where(grid, flat, data, self.node_mask(d))
        return grid.view(self.batch_size, size, size, size, -1)

    def from_voxel(self, grid: torch.Tensor, d: int) -> torch.Tensor:
        """Gather voxel-grid values at node coordinates -> [cap_d, C]."""
        s = 2**d - 1
        x, y, z, b = self.xyzb(d)
        m = self.node_mask(d)
        with trace.span("octf.gather.move"):
            vals = grid[b.clamp(0, self.batch_size - 1), x.clamp(0, s),
                        y.clamp(0, s), z.clamp(0, s)]
        return torch.where(m[:, None], vals, torch.zeros_like(vals))

    def pad_nempty(self, data: torch.Tensor, d: int) -> torch.Tensor:
        """Data on the non-empty nodes (compact, [n, C]) -> all nodes at
        ``d``, zeros on empty and padded ones (ocnn ``octree_pad``)."""
        gathered = data[self.child[d].clamp(0, data.shape[0] - 1)]
        return torch.where(self.nempty_mask(d)[:, None], gathered,
                           torch.zeros_like(gathered))

    def depad_nempty(self, data: torch.Tensor, d: int) -> torch.Tensor:
        """Data on all nodes at ``d`` -> the non-empty nodes' rows,
        compact, zeros past ``nnum_nempty[d]`` (ocnn ``octree_depad``)."""
        valid = self._arange(self.spec.node_caps[d]) < self.nnum_nempty[d]
        rows = data[self.nonempty_position(d)]
        return torch.where(valid[:, None], rows, torch.zeros_like(rows))

    # ------------------------------------------------------------------
    # key search (the MPU's corner lookups)
    # ------------------------------------------------------------------
    def search_key(self, qkey: torch.Tensor, qbatch: torch.Tensor,
                   d: int) -> torch.Tensor:
        """Slots of the (batch, key) queries at depth ``d``; -1 where
        absent.  The valid prefix is sorted by (batch, key) and padded
        slots (batch ``batch_size``, key ``INVALID_KEY``) sort last, so one
        binary search suffices; a query that lands in the padded tail is
        absent."""
        from ..ops.search import searchsorted_pair

        idx = searchsorted_pair(self.batch[d], self.keys[d], qbatch, qkey)
        idx_c = idx.clamp(0, self.spec.node_caps[d] - 1)
        found = ((idx < self.nnum[d]) & (self.keys[d][idx_c] == qkey)
                 & (self.batch[d][idx_c] == qbatch))
        return torch.where(found, idx_c, torch.full_like(idx_c, -1))

    def lookup_table(self, d: int) -> torch.Tensor:
        """Dense (batch, morton key) -> node slot table, -1 where absent:
        [batch_size * 8^d] int64, one gather in place of a search.  It
        costs B * 8^d entries, so it serves grid evaluation, not the
        training loss."""
        n = self.batch_size * 8**d
        addr = self.batch[d] * 8**d + self.keys[d]
        cap = self.spec.node_caps[d]
        return set_where(
            torch.full((n,), -1, dtype=torch.int64, device=self.device),
            addr, self._arange(cap), self.node_mask(d))

    # ------------------------------------------------------------------
    # growth (decode path)
    # ------------------------------------------------------------------
    def octree_split(self, label: torch.Tensor, d: int) -> "Octree":
        """Set the non-empty flags of depth ``d`` from 0/1 ``label`` over all
        (padded) nodes (ocnn ``octree_split``)."""
        lab = (label > 0) & self.node_mask(d)
        ranks = torch.cumsum(lab.to(torch.int64), 0) - 1
        child = list(self.child)
        child[d] = torch.where(lab, ranks, torch.full_like(ranks, -1))
        nnum_nempty = self.nnum_nempty.clone()
        nnum_nempty[d] = lab.sum()
        return self.replace(child=child, nnum_nempty=nnum_nempty)

    def octree_grow(self, d: int) -> "Octree":
        """Materialise depth ``d`` as the 8 children of every non-empty node
        of ``d-1`` (ocnn ``octree_grow``)."""
        cap = self.spec.node_caps[d]
        dev = self.device
        ne = self.nempty_mask(d - 1)
        blk = self.child[d - 1]
        keep = ne & (blk < cap // 8)
        pkeys = set_where(
            torch.zeros(cap // 8, dtype=torch.int64, device=dev),
            blk, self.keys[d - 1], keep,
        )
        pbatch = set_where(
            torch.full((cap // 8,), self.batch_size, dtype=torch.int64,
                       device=dev),
            blk, self.batch[d - 1], keep,
        )
        octant = torch.arange(8, device=dev)
        new_keys = (pkeys[:, None] * 8 + octant[None, :]).reshape(-1)
        new_batch = pbatch[:, None].expand(cap // 8, 8).reshape(-1)
        n_new = 8 * self.nnum_nempty[d - 1]
        vmask = self._arange(cap) < n_new
        keys, batch, child = list(self.keys), list(self.batch), list(self.child)
        keys[d] = torch.where(vmask, new_keys,
                              torch.full_like(new_keys, INVALID_KEY))
        batch[d] = torch.where(vmask, new_batch,
                               torch.full_like(new_batch, self.batch_size))
        child[d] = torch.full((cap,), -1, dtype=torch.int64, device=dev)
        nnum = self.nnum.clone()
        nnum[d] = torch.clamp(n_new, max=cap)
        nnum_nempty = self.nnum_nempty.clone()
        nnum_nempty[d] = 0
        overflow = self.overflow.clone()
        overflow[d] = overflow[d] | (n_new > cap)
        return self.replace(
            keys=keys, batch=batch, child=child, nnum=nnum,
            nnum_nempty=nnum_nempty, overflow=overflow,
        )


def create_full_octree(spec: OctreeSpec, device="cpu") -> Octree:
    """Octrees full up to ``full_depth`` with empty deeper levels; all
    full-depth nodes are marked non-empty, awaiting ``octree_split``."""
    keys, batch, child, nnum, nnum_nempty = [], [], [], [], []
    for d in range(spec.depth + 1):
        cap = spec.node_caps[d]
        if d <= spec.full_depth:
            idx = torch.arange(cap, dtype=torch.int64, device=device)
            keys.append(idx % (8**d))
            batch.append(idx // (8**d))
            child.append(idx)
            nnum.append(cap)
            nnum_nempty.append(cap)
        else:
            keys.append(torch.full((cap,), INVALID_KEY, dtype=torch.int64,
                                   device=device))
            batch.append(torch.full((cap,), spec.batch_size,
                                    dtype=torch.int64, device=device))
            child.append(torch.full((cap,), -1, dtype=torch.int64,
                                    device=device))
            nnum.append(0)
            nnum_nempty.append(0)
    return Octree(
        spec=spec, keys=keys, batch=batch, child=child,
        nnum=torch.tensor(nnum, dtype=torch.int64, device=device),
        nnum_nempty=torch.tensor(nnum_nempty, dtype=torch.int64,
                                 device=device),
        signal=torch.zeros((spec.node_caps[spec.depth], 4),
                           dtype=torch.float32, device=device),
        overflow=torch.zeros(spec.depth + 1, dtype=torch.bool, device=device),
    )


def _unique_sorted(codes: torch.Tensor, valid: torch.Tensor, cap: int):
    """Compact the unique values of an ascending (masked) int tensor into
    ``cap`` slots padded with INVALID_KEY.  Returns
    ``(unique[cap], rank_per_input, n_unique)``; ``n_unique`` may exceed
    ``cap`` (the caller flags the overflow)."""
    first = torch.cat([valid[:1], (codes[1:] != codes[:-1]) & valid[1:]])
    first = first & valid
    rank = torch.cumsum(first.to(torch.int64), 0) - 1
    uniq = set_where(
        torch.full((cap,), INVALID_KEY, dtype=torch.int64, device=codes.device),
        rank, codes, first & (rank < cap))
    return uniq, rank, first.sum()


def _scatter_add(cap: int, idx: torch.Tensor, val: torch.Tensor):
    """[cap, C] sums of ``val`` rows by ``idx``; indices past ``cap`` are
    dropped (the reference's ``.at[idx].add`` on a [cap, C] buffer)."""
    buf = val.new_zeros((cap + 1, val.shape[1]))
    buf.index_add_(0, torch.where(idx < cap, idx, cap), val)
    return buf[:cap]


def build_octree(points: torch.Tensor, normals: torch.Tensor,
                 spec: OctreeSpec,
                 features: Optional[torch.Tensor] = None) -> Octree:
    """A single-sample octree from points in [-1, 1]^3 with unit normals.

    The finest-level signal is the ND input feature: the per-node averaged
    unit normal (3 channels) plus the mean displacement of the node's
    points along it, from the node centre in node units (1 channel).
    Optional per-point ``features`` [N, F] (e.g. colours) are averaged per
    node and appended after those 4 channels.  Runs
    on the points' device without waiting for the host; a level that needs
    more than its cap keeps the first ``cap`` nodes and flags
    ``overflow``."""
    assert spec.batch_size == 1
    depth, full_depth = spec.depth, spec.full_depth
    size = 2**depth
    dev = points.device
    i64 = dict(dtype=torch.int64, device=dev)

    scaled = (points.to(torch.float32) + 1.0) * (size / 2.0)
    xyz = torch.floor(scaled).to(torch.int64).clamp(0, size - 1)
    code = morton.xyz2key(xyz[:, 0], xyz[:, 1], xyz[:, 2], depth)
    scode, order = torch.sort(code, stable=True)
    snormals = normals.to(torch.float32)[order]
    # fractional position inside the node, in [0,1)^3
    sfrac = (scaled - xyz.to(torch.float32))[order]
    valid = torch.ones(points.shape[0], dtype=torch.bool, device=dev)

    # occupied (distinct) codes per depth, finest -> full_depth
    occ_keys, occ_n = {}, {}
    occ_keys[depth], rank, occ_n[depth] = _unique_sorted(
        scode, valid, spec.node_caps[depth])
    for d in range(depth - 1, full_depth - 1, -1):
        child_keys = occ_keys[d + 1]
        pvalid = child_keys != INVALID_KEY
        pcodes = torch.where(pvalid, child_keys >> 3, INVALID_KEY)
        occ_keys[d], _, occ_n[d] = _unique_sorted(
            pcodes, pvalid, spec.node_caps[d])

    # per-occupied-node averaged signal at the finest depth
    cap_f = spec.node_caps[depth]
    cnt = _scatter_add(cap_f, rank, torch.ones_like(snormals[:, :1]))
    cnt = cnt.clamp(min=1.0)
    navg = _scatter_add(cap_f, rank, snormals) / cnt
    navg = navg / navg.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    favg = _scatter_add(cap_f, rank, sfrac) / cnt
    disp = (navg * (favg - 0.5)).sum(-1, keepdim=True)
    occ_signal = torch.cat([navg, disp], -1)
    if features is not None:
        fmean = _scatter_add(cap_f, rank,
                             features.to(torch.float32)[order]) / cnt
        occ_signal = torch.cat([occ_signal, fmean], -1)

    keys, batch, child, nnum, nnum_nempty, overflow = [], [], [], [], [], []
    signal = None
    octant = torch.arange(8, **i64)
    for d in range(depth + 1):
        cap = spec.node_caps[d]
        ar = torch.arange(cap, **i64)
        if d <= full_depth:
            k, b = ar % 8**d, ar // 8**d
            nn = torch.tensor(cap, **i64)
        else:
            # children of occupied nodes at d-1
            pk = occ_keys[d - 1]
            k = torch.where((pk != INVALID_KEY)[:, None],
                            pk[:, None] * 8 + octant[None, :],
                            INVALID_KEY).reshape(-1)[:cap]
            nn = occ_n[d - 1] * 8
            b = torch.where(ar < nn, 0, spec.batch_size)
        if d < full_depth:
            c, ne = ar, nn
        else:
            # non-empty = member of the occupied set of depth d
            idx = torch.searchsorted(occ_keys[d], k).clamp(0, cap - 1)
            hit = (occ_keys[d][idx] == k) & (k != INVALID_KEY)
            c = torch.where(hit, idx, -1)
            ne = occ_n[d]
            if d == depth:
                signal = torch.where(hit[:, None], occ_signal[idx],
                                     torch.zeros_like(occ_signal))
        overflow.append(nn > cap)
        nn = nn.clamp(max=cap)
        vmask = ar < nn
        keys.append(torch.where(vmask, k, INVALID_KEY))
        batch.append(torch.where(vmask, b, spec.batch_size))
        child.append(torch.where(vmask, c, -1))
        nnum.append(nn)
        nnum_nempty.append(ne.clamp(max=cap))

    return Octree(
        spec=spec, keys=keys, batch=batch, child=child,
        nnum=torch.stack(nnum), nnum_nempty=torch.stack(nnum_nempty),
        signal=signal, overflow=torch.stack(overflow),
    )


def merge_octrees(octrees: Sequence[Octree]) -> Octree:
    """Concatenate single-sample octrees into one batch: per depth, the
    samples' valid prefixes are packed batch-major and ``child`` ranks are
    offset by the cumulative non-empty counts (``ocnn.merge_octrees``)."""
    b = len(octrees)
    spec0 = octrees[0].spec
    for o in octrees:
        assert o.spec == spec0 and o.spec.batch_size == 1
    mspec = spec0.with_batch_size(b)
    dev = octrees[0].device

    nnum = torch.stack([o.nnum for o in octrees])            # [B, D+1]
    nnum_ne = torch.stack([o.nnum_nempty for o in octrees])  # [B, D+1]
    off = torch.cumsum(nnum, 0) - nnum
    off_ne = torch.cumsum(nnum_ne, 0) - nnum_ne
    sample = torch.arange(b, dtype=torch.int64, device=dev)[:, None]

    keys, batch, child = [], [], []
    signal = None
    for d in range(spec0.depth + 1):
        cap1, capm = spec0.node_caps[d], mspec.node_caps[d]
        i = torch.arange(cap1, dtype=torch.int64, device=dev)[None, :]
        tgt = off[:, d, None] + i
        keep = ((i < nnum[:, d, None]) & (tgt < capm)).reshape(-1)
        tgt = tgt.reshape(-1)

        def pack(fill, vals):
            buf = torch.full((capm,) + vals.shape[2:], fill, dtype=vals.dtype,
                             device=dev)
            return set_where(buf, tgt, vals.reshape((-1,) + vals.shape[2:]),
                             keep)

        keys.append(pack(INVALID_KEY, torch.stack([o.keys[d] for o in octrees])))
        batch.append(pack(b, sample.expand(b, cap1)))
        c = torch.stack([o.child[d] for o in octrees])
        child.append(pack(-1, torch.where(c >= 0, c + off_ne[:, d, None], -1)))
        if d == spec0.depth:
            signal = pack(0.0, torch.stack([o.signal for o in octrees]))

    caps = torch.tensor(mspec.node_caps, dtype=torch.int64, device=dev)
    tot = nnum.sum(0)
    overflow = torch.stack([o.overflow for o in octrees]).any(0) | (tot > caps)
    return Octree(
        spec=mspec, keys=keys, batch=batch, child=child,
        nnum=torch.minimum(tot, caps), nnum_nempty=nnum_ne.sum(0),
        signal=signal, overflow=overflow,
    )
