"""Graph levels for the edge cases of the CUDA graph conv's K1 / K3 / K5
and K2, shared by the card-only kernel tests and the CPU tests of the CSR
contract (no JAX here).

``synthetic_level`` builds a level with: one (row, dir) slot and one
(col, dir) slot of thousands of edges, so the edge range of a 64-row tile
exceeds the kernel's staging buffer in the CSR and in the transposed CSR;
row tiles without any edge (no edge has its row or its column there); a
tile of many light slots whose range straddles a staging piece; padding
edges (``row = col = G``, as a graph level pads); and G not a multiple of
64.  ``tiny_graph`` is a dual graph at ``configs/synthetic_tiny.yaml``'s
caps.  ``walk_reference`` is the gather-GEMM kernels' tiling walk in numpy
(K1 / K3 by direction, K5 over the flat 7C axis), ``col_stream_reference``
K2's stretches and 4-float units."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from octfusion_tpu_torch.octree.dual_graph import (build_dual_graph,
                                                   csr_of_edges,
                                                   csr_t_of_edges)
from octfusion_tpu_torch.octree.octree import OctreeSpec
from octfusion_tpu_torch.octree.split_codec import split2octree_small

N_EDGE_TYPE = 7
TILE_ROWS = 64        # GM of gather_gemm_kernel (csrc/graph_conv.cu)
EDGE_STAGE = 1024     # its kEdgeStage: edges staged per piece
CHUNK = 32            # its GK: columns of a gathered chunk
COL_FLOATS = 8192     # K2's kColFloats: col floats a block aims at
COL_SLOTS = N_EDGE_TYPE * TILE_ROWS   # K2's kColSlots
H100_SMS = 132        # the SMs K2 shares its stretches over
HEAVY_ROW_SLOT = (5, 2)      # (row, dir) with `heavy` edges
HEAVY_COL_SLOT = (300, 4)    # (col, dir) with `heavy_t` edges
EMPTY_ROWS = (64, 192)       # tiles 1-2: no edge's row or col in here
DENSE_ROWS = (192, 256)      # tile 3: 20 edges a row


@dataclasses.dataclass
class SyntheticLevel:
    """The fields of a ``GraphLevel`` that the graph conv reads."""
    g_cap: int
    edge_row: torch.Tensor
    edge_col: torch.Tensor
    edge_dir: torch.Tensor
    edge_scale: torch.Tensor

    def edges(self):
        return self.edge_row, self.edge_col, self.edge_dir, self.edge_scale

    def csr(self):
        return csr_of_edges(*self.edges(), self.g_cap)

    def csr_t(self):
        return csr_t_of_edges(*self.edges(), self.g_cap)

    def to(self, device) -> "SyntheticLevel":
        return SyntheticLevel(self.g_cap, *(t.to(device) for t in self.edges()))


def synthetic_level(g: int = 1000, seed: int = 0, heavy: int = 2500,
                    heavy_t: int = 2100, device="cpu") -> SyntheticLevel:
    """The level of the module docstring, edges sorted by ``row*7 + dir``
    and scaled by ``1/sqrt(|slot|)`` (so sums over heavy slots stay O(1))."""
    rng = np.random.RandomState(seed)
    lo, hi = EMPTY_ROWS

    def cols(n):      # uniform over the columns outside the empty tiles
        c = rng.randint(0, g - (hi - lo), size=n)
        return np.where(c >= lo, c + (hi - lo), c)

    light = [r for r in range(g) if not lo <= r < hi]
    counts = [20 if DENSE_ROWS[0] <= r < DENSE_ROWS[1] else rng.randint(3, 10)
              for r in light]
    row = np.repeat(light, counts)
    drn = rng.randint(0, N_EDGE_TYPE, size=row.size)
    col = cols(row.size)
    # the heavy (row, dir) slot; the heavy (col, dir) slot, from rows of
    # the light tiles past the dense one
    t_rows = rng.randint(DENSE_ROWS[1], g, size=heavy_t)
    row = np.concatenate([row, np.full(heavy, HEAVY_ROW_SLOT[0]), t_rows])
    drn = np.concatenate([drn, np.full(heavy, HEAVY_ROW_SLOT[1]),
                          np.full(heavy_t, HEAVY_COL_SLOT[1])])
    col = np.concatenate([col, cols(heavy), np.full(heavy_t, HEAVY_COL_SLOT[0])])
    key = row * N_EDGE_TYPE + drn
    order = np.argsort(key, kind="stable")
    row, col, drn, key = row[order], col[order], drn[order], key[order]
    scale = 1.0 / np.sqrt(np.bincount(key)[key])
    pad = 16
    row = np.concatenate([row, np.full(pad, g)])
    col = np.concatenate([col, np.full(pad, g)])
    drn = np.concatenate([drn, np.zeros(pad, np.int64)])
    scale = np.concatenate([scale, np.zeros(pad)])
    as_t = lambda a, dt: torch.tensor(a, dtype=dt, device=device)  # noqa: E731
    return SyntheticLevel(g, as_t(row, torch.int64), as_t(col, torch.int64),
                          as_t(drn, torch.int64), as_t(scale, torch.float32))


def tiny_graph(seed: int = 0, device="cpu"):
    """A dual graph at ``configs/synthetic_tiny.yaml``'s caps (depth 4,
    full depth 2, finest_cap 2048, decay 1, edge_factor 10) from a seeded
    random split grid."""
    rng = np.random.RandomState(seed)
    split = torch.tensor(
        np.where(rng.rand(1, 4, 4, 4, 8) < 0.3, 1.0, -1.0).astype(np.float32),
        device=device)
    spec = OctreeSpec.create(4, 2, 1, finest_cap_per_sample=2048, decay=1.0)
    return build_dual_graph(split2octree_small(split, spec), 10, up_to=4)


def tile_ranges(row_ptr: np.ndarray, g: int):
    """-> [(m0, rows, first edge, end edge)] of each 64-row tile."""
    return [(m0, min(TILE_ROWS, g - m0), int(row_ptr[m0 * N_EDGE_TYPE]),
             int(row_ptr[min(m0 + TILE_ROWS, g) * N_EDGE_TYPE]))
            for m0 in range(0, g, TILE_ROWS)]


def walk_reference(src: np.ndarray, w: np.ndarray, csr, g: int,
                   transposed: bool, flat: bool = False) -> np.ndarray:
    """``gather_gemm_kernel``'s walk in float64: per 64-row tile its edge
    range in pieces of ``EDGE_STAGE`` edges; per piece and direction with
    edges in it, the slots' ranges clamped to the piece, gathered and
    multiplied by ``B_d`` (``w``'s rows of direction d, or for K3 its
    block of rows transposed), every piece's product added into the tile.
    ``flat`` (K5): per piece, the flat 7C axis in chunks of ``CHUNK``
    columns instead (:func:`_flat_piece`).  ``src`` [G, K], ``csr`` as
    ``csr_of_edges`` (K1, K5) or ``csr_t_of_edges`` (K3)."""
    ptr, idx, scale = (t.cpu().numpy() for t in csr)
    src = src.astype(np.float64)
    w = w.astype(np.float64)
    k = src.shape[1]
    n = w.shape[0] // N_EDGE_TYPE if transposed else w.shape[1]
    out = np.zeros((g, n))
    for m0, rows, e0, e1 in tile_ranges(ptr, g):
        slots = ptr[m0 * N_EDGE_TYPE:(m0 + rows) * N_EDGE_TYPE + 1]
        for pe in range(e0, e1, EDGE_STAGE):
            local = np.clip(slots - pe, 0, min(EDGE_STAGE, e1 - pe))
            if flat:
                out[m0:m0 + rows] += _flat_piece(src, w, idx[pe:],
                                                 scale[pe:], local, rows)
                continue
            for d in range(N_EDGE_TYPE):
                b = local[d:rows * N_EDGE_TYPE:N_EDGE_TYPE]
                e = local[d + 1:rows * N_EDGE_TYPE + 1:N_EDGE_TYPE]
                if not (e > b).any():
                    continue
                a = np.zeros((rows, k))
                for r in np.nonzero(e > b)[0]:
                    es = slice(pe + b[r], pe + e[r])
                    a[r] = scale[es] @ src[idx[es]]
                bd = (w[d * n:(d + 1) * n].T if transposed
                      else w[d * k:(d + 1) * k])
                out[m0:m0 + rows] += a @ bd
    return out


def _flat_piece(src, w, idx, scale, local, rows):
    """One piece of K5's walk: ``local`` the tile's slot pointers clamped
    to the piece (offsets into ``idx`` / ``scale``).  Chunk k0 gives lane
    j the flat column k0 + j, direction d = (k0 + j) // C and channel
    (k0 + j) - d*C, which reads slot (row, d); a chunk whose directions
    have no edge in the piece is skipped, and only the chunk's 8-deep
    steps that reach a column below 7C are multiplied (W's rows past 7C
    are zeros)."""
    k = src.shape[1]
    kw = N_EDGE_TYPE * k
    b = local[:-1].reshape(rows, N_EDGE_TYPE)
    e = local[1:].reshape(rows, N_EDGE_TYPE)
    live = (e > b).any(axis=0)
    slot_sum = np.zeros((rows, N_EDGE_TYPE, k))      # each (row, d) slot
    for r, d in zip(*np.nonzero(e > b)):
        es = slice(b[r, d], e[r, d])
        slot_sum[r, d] = scale[es] @ src[idx[es]]
    out = np.zeros((rows, w.shape[1]))
    for k0 in range(0, kw, CHUNK):
        col = k0 + np.arange(CHUNK)
        ok = col < kw
        d = col // k
        ch = col - d * k
        if not live[d[ok]].any():
            continue
        a = np.zeros((rows, CHUNK))
        a[:, ok] = slot_sum[:, d[ok], ch[ok]]
        steps = -(-min(CHUNK, kw - k0) // 8)
        wc = np.zeros((CHUNK, w.shape[1]))
        wc[:min(CHUNK, kw - k0)] = w[k0:k0 + CHUNK]
        out += a[:, :8 * steps] @ wc[:8 * steps]
    return out


def col_stretch_slots(c: int, slots: int, sms: int = H100_SMS) -> int:
    """K2's stretch (``col_stretch_slots`` in ``csrc/graph_conv.cu``):
    about ``COL_FLOATS`` floats, few enough slots that each of ``sms`` SMs
    gets two stretches, at most ``COL_SLOTS`` slots, a multiple of 4."""
    return min(max(min(COL_FLOATS // c, slots // (2 * sms)) // 4 * 4, 4),
               COL_SLOTS)


def col_stream_reference(x: np.ndarray, csr, g: int):
    """K2's stream in float64 -> (col [G, 7C], stats).  Block b owns the
    slots [b*S, (b+1)*S) (S = ``col_stretch_slots``), whose floats start
    16-byte aligned.  A stretch without edges is zeros; one whose edge
    range overflows ``EDGE_STAGE`` is shared out as (slot, 32-channel)
    pieces, one float a lane; any other is staged and cut into units of 4
    consecutive floats: 4 channels of one slot, or floats that each take
    their own slot where the unit crosses a slot boundary or ends the
    stretch.  Every float of ``col`` is written exactly once.  ``stats``:
    units in all, units that cross a slot, stretches of zeros, stretches
    read in place."""
    ptr, idx, scale = (t.cpu().numpy() for t in csr)
    x = x.astype(np.float64)
    c = x.shape[1]
    slots = g * N_EDGE_TYPE
    per = col_stretch_slots(c, slots)
    out = np.zeros(slots * c)
    written = np.zeros(slots * c, np.int64)
    stats = {"units": 0, "crossing": 0, "zeros": 0, "in_place": 0}

    def slot_sum(sl):
        es = slice(ptr[sl], ptr[sl + 1])
        return scale[es] @ x[idx[es]]

    for s0 in range(0, slots, per):
        ns = min(per, slots - s0)
        assert s0 * c % 4 == 0                  # a 16-byte aligned start
        e0, e1 = ptr[s0], ptr[s0 + ns]
        if e1 == e0:
            stats["zeros"] += 1
            written[s0 * c:(s0 + ns) * c] += 1
            continue
        if e1 - e0 > EDGE_STAGE:                # (slot, 32 channels) pieces
            stats["in_place"] += 1
            for sl in range(s0, s0 + ns):
                for k0 in range(0, c, CHUNK):
                    ks = slice(sl * c + k0, sl * c + min(k0 + CHUNK, c))
                    out[ks] = slot_sum(sl)[k0:k0 + CHUNK]
                    written[ks] += 1
            continue
        sums = np.stack([slot_sum(sl) for sl in range(s0, s0 + ns)])
        f = np.arange(0, ns * c, 4)             # each unit's first float
        one_slot = f % c + 4 <= c
        elems = f[:, None] + np.arange(4)
        valid = elems < ns * c
        assert valid[one_slot].all()
        sl, ch = elems // c, elems % c
        assert (sl[one_slot] == (f[one_slot] // c)[:, None]).all()
        np.add.at(written, s0 * c + elems[valid], 1)
        out[s0 * c + elems[valid]] = sums[sl[valid], ch[valid]]
        stats["units"] += f.size
        stats["crossing"] += int((~one_slot).sum())
    assert (written == 1).all()
    return out.reshape(g, N_EDGE_TYPE * c), stats
