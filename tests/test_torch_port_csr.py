"""The CSR contract that the graph conv's K1 / K3 / K5 kernel
(``gather_gemm_kernel`` in ``octfusion_tpu_torch/csrc/graph_conv.cu``) and
its K2 rely on, on the CPU: ``csr_of_edges`` / ``csr_t_of_edges`` against
brute-force slot counts, each 64-row tile's edges one contiguous range,
the synthetic edge-case level's cases present, the kernel's walk (tile
edge ranges in staging pieces, clamped slot ranges, directions or K5's
flat chunks without edges skipped, the k8 tail) equal to the plain
versions, and K2's stream (aligned stretches of slots, 4-float units,
staged or in-place edges) equal to its plain version."""

import numpy as np
import pytest
import torch

import test_torch_port_csr_cases as cases
from octfusion_tpu_torch.ops import graph_conv_cuda

N = cases.N_EDGE_TYPE


def _level(which):
    if which == "synthetic":
        return cases.synthetic_level()
    return cases.tiny_graph().level(int(which[-1]))


def _check_csr(ptr, keys, payload, csr_payload, g):
    """``ptr`` over the g*7 slots against the slot ``keys`` of the valid
    edges, whose ``payload`` (in edge order) the CSR must list slot by
    slot, stably."""
    assert ptr.dtype == np.int32 and ptr.shape == (g * N + 1,)
    assert ptr[0] == 0 and np.all(np.diff(ptr) >= 0)
    np.testing.assert_array_equal(np.diff(ptr),
                                  np.bincount(keys, minlength=g * N))
    order = np.argsort(keys, kind="stable")
    for got, want in zip(csr_payload, payload):
        np.testing.assert_array_equal(got[:ptr[-1]], want[order])


@pytest.mark.parametrize("which", ["tiny-d2", "tiny-d3", "tiny-d4",
                                   "synthetic"])
def test_csr_matches_brute_force_counts(which):
    lvl = _level(which)
    g = lvl.g_cap
    row, col, drn, scale = (t.numpy() for t in (lvl.edge_row, lvl.edge_col,
                                                 lvl.edge_dir, lvl.edge_scale))
    ok = row < g
    assert ok.sum() > 0
    ptr, idx, sc = (t.numpy() for t in lvl.csr())
    _check_csr(ptr, (row * N + drn)[ok], (col[ok], scale[ok]), (idx, sc), g)
    tptr, trow, tsc = (t.numpy() for t in lvl.csr_t())
    _check_csr(tptr, (col * N + drn)[ok], (row[ok], scale[ok]), (trow, tsc), g)
    # a 64-row tile's edges are the range [ptr[m0*7], ptr[(m0+rows)*7]):
    # exactly the valid edges whose row (K3: col) lies in the tile
    for p, owner in ((ptr, row), (tptr, col)):
        for m0, rows, e0, e1 in cases.tile_ranges(p, g):
            assert e1 - e0 == np.sum(ok & (owner >= m0) & (owner < m0 + rows))


def test_synthetic_level_has_its_cases():
    """The card-only tests' level holds every case they are meant to hit."""
    lvl = cases.synthetic_level()
    g = lvl.g_cap
    assert g % cases.TILE_ROWS
    for csr, (node, d) in ((lvl.csr(), cases.HEAVY_ROW_SLOT),
                           (lvl.csr_t(), cases.HEAVY_COL_SLOT)):
        ptr = csr[0].numpy()
        tiles = cases.tile_ranges(ptr, g)
        assert ptr[node * N + d + 1] - ptr[node * N + d] >= 2000
        heavy = tiles[node // cases.TILE_ROWS]
        assert heavy[3] - heavy[2] > 2 * cases.EDGE_STAGE   # >= 3 pieces
        for m0, rows, e0, e1 in tiles:
            if cases.EMPTY_ROWS[0] <= m0 < cases.EMPTY_ROWS[1]:
                assert e0 == e1
    # the dense tile: 2 pieces, and a slot straddles their boundary
    ptr = lvl.csr()[0].numpy()
    m0, rows, e0, e1 = cases.tile_ranges(ptr, g)[
        cases.DENSE_ROWS[0] // cases.TILE_ROWS]
    assert e1 - e0 > cases.EDGE_STAGE
    cut = e0 + cases.EDGE_STAGE
    s = np.searchsorted(ptr, cut, side="right") - 1
    assert ptr[s] < cut < ptr[s + 1]


@pytest.mark.parametrize("c,cout", [(31, 24), (131, 128), (8, 72),
                                    (6, 40), (515, 512)])
@pytest.mark.parametrize("kernel", ["k1", "k3", "k5"])
def test_walk_matches_plain(kernel, c, cout):
    """The kernels' tiling walk (``cases.walk_reference``; K5 over the
    flat 7C axis, chunks across up to six directions at C = 6) gives the
    plain versions' result on the synthetic level and a tiny-graph
    level: float64 walk against the fp32 plain version, rtol = atol =
    1e-4."""
    rng = np.random.RandomState(c * 7 + cout)
    for lvl in (cases.synthetic_level(), cases.tiny_graph().level(4)):
        g = lvl.g_cap
        edges = (lvl.edge_row, lvl.edge_col, lvl.edge_dir, lvl.edge_scale)
        w = (rng.normal(size=(N * c, cout)) / np.sqrt(N * c)).astype(np.float32)
        if kernel in ("k1", "k5"):
            x = rng.normal(size=(g, c)).astype(np.float32)
            got = cases.walk_reference(x, w, lvl.csr(), g, transposed=False,
                                       flat=kernel == "k5")
            plain = (graph_conv_cuda.graph_conv_plain if kernel == "k1"
                     else graph_conv_cuda.graph_conv_packed_plain)
            ref = plain(torch.tensor(x), torch.tensor(w), *edges)
        else:
            dout = rng.normal(size=(g, cout)).astype(np.float32)
            got = cases.walk_reference(dout, w, lvl.csr_t(), g, transposed=True)
            ref = graph_conv_cuda.graph_conv_bwd_dx_plain(
                torch.tensor(dout), torch.tensor(w), *edges)
        assert np.abs(got).max() > 0
        np.testing.assert_allclose(got, ref.double().numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("c", [3, 6, 8, 131])
def test_col_stream_matches_plain(c):
    """K2's stream (``cases.col_stream_reference``: stretches of whole
    slots that start 16-byte aligned, zeros, staged 4-float units or
    in-place (slot, 32-channel) pieces, every float written once) gives
    the plain column buffer on the synthetic level and a tiny-graph
    level: float64 against fp32, rtol = atol = 1e-5.  At C = 3 every unit
    crosses a slot, at C = 8 none does; the synthetic level's empty tiles
    give stretches of zeros, its 2500-edge slot a stretch read in place."""
    rng = np.random.RandomState(c)
    for lvl in (cases.synthetic_level(), cases.tiny_graph().level(4)):
        g = lvl.g_cap
        x = rng.normal(size=(g, c)).astype(np.float32)
        got, stats = cases.col_stream_reference(x, lvl.csr(), g)
        ref = graph_conv_cuda.graph_conv_col_plain(
            torch.tensor(x), lvl.edge_row, lvl.edge_col, lvl.edge_dir,
            lvl.edge_scale)
        assert np.abs(got).max() > 0
        np.testing.assert_allclose(got, ref.double().numpy(), rtol=1e-5,
                                   atol=1e-5)
        if c == 3:
            assert stats["crossing"] == stats["units"]
        elif c == 8:
            assert stats["crossing"] == 0
        else:
            assert stats["crossing"] > 0
        if g == 1000:
            assert stats["in_place"] >= 1 and stats["zeros"] >= 1
