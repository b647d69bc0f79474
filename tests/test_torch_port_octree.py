"""Parity of the port's octree and dual-graph builders with the JAX
package: the same inputs (made with numpy from a seed) must give the same
arrays, padding, sentinels and overflow flags included — exactly, except
``edge_scale`` (float32 1/count) to 1e-7 and the octree's ND signal
(averaged normals and displacements) to 1e-6."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from octfusion_tpu.octree import morton as jmorton
from octfusion_tpu.octree import octree as joct
from octfusion_tpu.octree import split_codec as jsplit
from octfusion_tpu.octree.dual_graph import build_dual_graph as j_build
from octfusion_tpu.octree.dual_graph import extend_dual_graph as j_extend
from octfusion_tpu_torch.octree import morton as tmorton
from octfusion_tpu_torch.octree import octree as toct
from octfusion_tpu_torch.octree import split_codec as tsplit
from octfusion_tpu_torch.octree.dual_graph import N_EDGE_TYPE
from octfusion_tpu_torch.octree.dual_graph import build_dual_graph as t_build
from octfusion_tpu_torch.octree.dual_graph import extend_dual_graph as t_extend

from test_torch_port_helpers import (assert_graph_equal, assert_octree_equal,
                                     jspec_of, make_graph, np_, port_octree,
                                     random_split)


def test_morton_roundtrip_matches_jax():
    rng = np.random.RandomState(0)
    for depth in (2, 6, 10):
        xyz = rng.randint(0, 2**depth, size=(3, 500))
        kj = jmorton.xyz2key(*(jnp.asarray(v) for v in xyz), depth)
        kt = tmorton.xyz2key(*(torch.tensor(v) for v in xyz), depth)
        np.testing.assert_array_equal(np_(kt), np_(kj))
        keys = np.concatenate([np_(kj), [jmorton.INVALID_KEY]])
        for a, b in zip(tmorton.key2xyz(torch.tensor(keys), depth),
                        jmorton.key2xyz(jnp.asarray(keys, jnp.int32), depth)):
            np.testing.assert_array_equal(np_(a), np_(b))


def test_full_octree_split_grow_matches_jax():
    tspec = toct.OctreeSpec.create(5, 2, 2, finest_cap_per_sample=512,
                                   decay=2.0)
    jspec = jspec_of(tspec)
    rng = np.random.RandomState(1)
    labels = {d: (rng.rand(tspec.node_caps[d]) < 0.4).astype(np.int64)
              for d in range(2, 5)}

    @jax.jit
    def j_grow(labels):
        jo = joct.create_full_octree(jspec)
        for d in range(2, 5):
            jo = jo.octree_split(labels[d], d).octree_grow(d + 1)
        return jo

    to = toct.create_full_octree(tspec)
    assert_octree_equal(to, joct.create_full_octree(jspec))
    for d in range(2, 5):
        to = to.octree_split(torch.tensor(labels[d]), d).octree_grow(d + 1)
    jo = j_grow({d: jnp.asarray(v, jnp.int32) for d, v in labels.items()})
    assert_octree_equal(to, jo)
    # the 40% split outgrows the depth-5 cap: both flag it
    assert bool(to.overflow[5])
    for d in range(2, 6):
        np.testing.assert_array_equal(np_(to.nonempty_position(d)),
                                      np_(jo.nonempty_position(d)))
        data = rng.normal(size=(tspec.node_caps[d], 3)).astype(np.float32)
        vt = to.to_voxel(torch.tensor(data), d)
        vj = jo.to_voxel(jnp.asarray(data), d)
        np.testing.assert_array_equal(np_(vt), np_(vj))
        np.testing.assert_array_equal(np_(to.from_voxel(vt, d)),
                                      np_(jo.from_voxel(vj, d)))


@pytest.mark.parametrize("batch,p,finest_cap", [(2, 0.05, 2048), (1, 0.3, 256)])
def test_split2octree_and_graph_match_jax(batch, p, finest_cap):
    """Grow stage of the cascade: split grid -> octree -> dual graph up to
    depth_stop, then one decoder-style extension.  The second case's
    caps are too small, so node and edge caps overflow on both sides."""
    tspec = toct.OctreeSpec.create(4, 2, batch,
                                   finest_cap_per_sample=finest_cap, decay=1.0)
    jspec = jspec_of(tspec)
    rng = np.random.RandomState(2)
    split = random_split(rng, batch, 4, p)
    edge_factor = 10 if finest_cap > 256 else 4
    label = (rng.rand(tspec.node_caps[3]) < 0.5).astype(np.int64)

    @jax.jit
    def j_grow(split, label):
        jo = jsplit.split2octree_small(split, jspec)
        jg = j_build(jo, edge_factor, up_to=3)
        jo2 = jo.octree_split(label, 3).octree_grow(4)
        return jg, j_extend(jg.replace(octree=jo2), jo2)

    jg, jg2 = j_grow(jnp.asarray(split), jnp.asarray(label, jnp.int32))
    to = tsplit.split2octree_small(torch.tensor(split), tspec)
    assert_octree_equal(to, jg.octree)
    tg = t_build(to, edge_factor, up_to=3)
    assert_graph_equal(tg, jg)

    to2 = to.octree_split(torch.tensor(label), 3).octree_grow(4)
    tg2 = t_extend(tg.replace(octree=to2), to2)
    assert_graph_equal(tg2, jg2)
    if finest_cap == 256:
        assert bool(tg2.octree.overflow.any())
        assert bool(tg2.level(4).overflow) and bool(tg2.any_overflow())


def test_graph_from_point_octree_matches_jax():
    """Octree built by the JAX package from points (leaves at every depth)
    -> dual graphs of all levels built by both packages."""
    jg = make_graph(seed=7, depth=4, full_depth=2, n=300)
    tg = t_build(port_octree(jg.octree), 9)
    assert_graph_equal(tg, jg)


def test_csr_row_ptr_matches_numpy_count():
    jg = make_graph(seed=3)
    tg = t_build(port_octree(jg.octree), 9)
    for lvl in tg.levels:
        row_ptr, col, scale = lvl.csr()
        row = np_(lvl.edge_row)
        ok = row < lvl.g_cap
        slots = row[ok] * N_EDGE_TYPE + np_(lvl.edge_dir)[ok]
        counts = np.bincount(slots, minlength=lvl.g_cap * N_EDGE_TYPE)
        expect = np.concatenate([[0], np.cumsum(counts)])
        assert row_ptr.dtype == torch.int32 and col.dtype == torch.int32
        np.testing.assert_array_equal(np_(row_ptr), expect)
        assert lvl.csr() is lvl.csr()  # built once per level


def _j_batch_to_octree(points, normals, jspec):
    from octfusion_tpu.models.common import batch_to_octree_jit
    return batch_to_octree_jit(jnp.asarray(points), jnp.asarray(normals),
                               spec_single=jspec)


@pytest.mark.parametrize("batch,finest_cap", [(2, 2048), (3, 160)])
def test_build_and_merge_octrees_match_jax(batch, finest_cap):
    """Point clouds -> per-sample octrees -> merged batch, slot for slot,
    ND signal to 1e-6.  The second case's caps are too small: depths
    overflow on both sides and keep the same first nodes."""
    from octfusion_tpu_torch.models.common import batch_to_octree
    from octfusion_tpu_torch.utils.shapes import lumpy_spheres

    pts, nrm = lumpy_spheres(batch, 1500, seed=batch)
    tspec = toct.OctreeSpec.create(5, 2, 1, finest_cap_per_sample=finest_cap,
                                   decay=2.0)
    jo = _j_batch_to_octree(np_(pts), np_(nrm), jspec_of(tspec))
    to = batch_to_octree(pts, nrm, tspec)
    assert_octree_equal(to, jo)
    np.testing.assert_allclose(np_(to.signal), np_(jo.signal), rtol=1e-6,
                               atol=1e-6)
    assert bool(to.overflow.any()) == (finest_cap == 160)


def test_transposed_csr_matches_numpy_sort():
    jg = make_graph(seed=4)
    tg = t_build(port_octree(jg.octree), 9)
    for lvl in tg.levels:
        trow_ptr, t_row, t_scale = lvl.csr_t()
        row, col = np_(lvl.edge_row), np_(lvl.edge_col)
        ok = row < lvl.g_cap
        key = col[ok] * N_EDGE_TYPE + np_(lvl.edge_dir)[ok]
        order = np.argsort(key, kind="stable")
        counts = np.bincount(key, minlength=lvl.g_cap * N_EDGE_TYPE)
        assert trow_ptr.dtype == t_row.dtype == torch.int32
        np.testing.assert_array_equal(np_(trow_ptr),
                                      np.concatenate([[0], np.cumsum(counts)]))
        n = int(ok.sum())
        np.testing.assert_array_equal(np_(t_row)[:n], row[ok][order])
        np.testing.assert_array_equal(np_(t_scale)[:n],
                                      np_(lvl.edge_scale)[ok][order])
        assert lvl.csr_t() is lvl.csr_t()  # built once per level
