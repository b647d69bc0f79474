"""The port's data path against the JAX package's, bit for bit (numpy on
the host on both sides), at ``configs/synthetic_tiny.yaml`` sizes:

* ``SyntheticDataset`` items with ``class_families`` off and on (and the
  colour field), and ``collate``;
* ``InfiniteSampler`` over two epochs at world 1 and 2 (every rank);
* the port's ``DataLoader`` at 1 and 3 workers against JAX's at 1 worker
  (whose order is the only fixed one): the first 5 batches;
* ``octree_node_counts`` / ``dual_graph_edge_counts`` / ``fits_capacity``
  against JAX and against the port's own build on the device
  (``Octree.nnum``, the graph's carried edge counts);
* ``CapacityFilteredDataset``'s skip;
* ``ShapeNetDataset`` on npz files the test writes, with
  ``numpy.random.RandomState`` seeded on both sides; its rows must come
  from the files with ``pos`` / ``sdf`` / ``grad`` aligned;
* ``models.common.batch_to_device``;
* ``tools/precompute_splits`` against the JAX octree's
  ``octree2split_small``, and ``tools/make_reference_set`` against the JAX
  package's tool."""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octfusion_tpu.data import dataset as jds
from octfusion_tpu.data import loader as jloader
from octfusion_tpu.octree.octree import OctreeSpec as JSpec
from octfusion_tpu_torch.data import dataset as tds
from octfusion_tpu_torch.data import loader as tloader
from octfusion_tpu_torch.models.common import batch_to_device
from octfusion_tpu_torch.octree.dual_graph import build_dual_graph
from octfusion_tpu_torch.octree.octree import OctreeSpec as TSpec
from octfusion_tpu_torch.octree.octree import build_octree
from octfusion_tpu_torch.utils.shapes import (lumpy_sphere_sdf_samples,
                                              lumpy_spheres)

from test_torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(point_sample_num=64, points_per_shape=512)
DEPTH, FULL = 4, 2       # configs/synthetic_tiny.yaml
EDGE_FACTOR = 10
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def assert_item_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("class_families,load_color", [(False, False),
                                                       (True, True)])
def test_synthetic_items_match_jax(class_families, load_color):
    kw = dict(size=6, class_families=class_families, load_color=load_color,
              **SMALL)
    tset, jset = tds.SyntheticDataset(**kw), jds.SyntheticDataset(**kw)
    items = []
    for i in range(len(tset)):
        t, j = tset[i], jset[i]
        assert_item_equal(t, j)
        assert tset[i] is t       # the per-item cache
        items.append((t, j))
    assert len({it[0]["label"] for it in items}) == 5
    got = tds.collate([t for t, _ in items])
    want = jds.collate([j for _, j in items])
    assert got["label"].dtype == np.int32
    assert_item_equal(got, want)


@pytest.mark.parametrize("world", [1, 2])
def test_sampler_matches_jax(world):
    size, seed = 7, 3
    epoch0 = []
    for rank in range(world):
        t = iter(tloader.InfiniteSampler(size, True, seed, rank, world))
        j = iter(jloader.InfiniteSampler(size, True, seed, rank, world))
        n = 2 * len(range(rank, size, world))      # two epochs
        got, want = [next(t) for _ in range(n)], [next(j) for _ in range(n)]
        assert got == want
        assert got[:n // 2] != got[n // 2:]       # reshuffled per epoch
        epoch0 += got[:n // 2]
    assert sorted(epoch0) == list(range(size))    # the ranks split an epoch


@pytest.mark.parametrize("workers", [1, 3])
def test_loader_order_matches_jax_single_worker(workers):
    """Batch i is the collate of the sampler's indices [iB, (i+1)B)."""
    kw = dict(size=5, **SMALL)
    tdl = tloader.DataLoader(tds.SyntheticDataset(**kw), 2, True, 42, workers)
    jdl = jloader.DataLoader(jds.SyntheticDataset(**kw), 2, True, 42, 1)
    assert len(tdl) == len(jdl) == 2
    t_it, j_it = iter(tdl), iter(jdl)
    try:
        for _ in range(5):
            assert_item_equal(next(t_it), next(j_it))
    finally:
        t_it.close()
        jdl.stop()


@pytest.fixture(scope="module")
def clouds():
    """Three lumpy spheres of 2048 points and one tight spec."""
    pts, nrm = lumpy_spheres(3, 2048, seed=4)
    return pts.numpy(), nrm.numpy()


def test_capacity_counts_match_jax_and_the_device_build(clouds):
    pts, nrm = clouds
    tspec = TSpec.create(DEPTH, FULL, 1, finest_cap_per_sample=2048,
                         decay=1.0)
    jspec = JSpec.create(DEPTH, FULL, 1, finest_cap_per_sample=2048,
                         decay=1.0)
    for p, n in zip(pts, nrm):
        nodes = tds.octree_node_counts(p, DEPTH, FULL)
        edges = tds.dual_graph_edge_counts(p, DEPTH, FULL)
        assert nodes == jds.octree_node_counts(p, DEPTH, FULL)
        assert edges == jds.dual_graph_edge_counts(p, DEPTH, FULL)
        for ef in (0, 1, EDGE_FACTOR):
            assert tds.fits_capacity(p, tspec, ef) == jds.fits_capacity(
                p, jspec, ef)
        g = build_dual_graph(build_octree(torch.tensor(p), torch.tensor(n),
                                          tspec), EDGE_FACTOR)
        assert not bool(g.any_overflow())
        for d in range(FULL + 1, DEPTH + 1):
            assert nodes[d] == int(g.octree.nnum[d]), d
        for d in range(FULL, DEPTH + 1):
            lvl = g.level(d)
            assert edges[d] == int(lvl.n_edges) - int(lvl.n_nodes), d
    assert tds.fits_capacity(pts[0], tspec, EDGE_FACTOR)
    assert not tds.fits_capacity(pts[0], tspec, 1)


def test_capacity_filter_skips_as_jax(capsys):
    """Items whose octree would not fit are skipped: the wrapper returns
    the next one that fits, the same one as JAX's."""
    kw = dict(size=6, **SMALL)
    caps = (1, 8, 64, 168, 320)    # too few depth-4 nodes for 2 of 6 shapes
    tspec = TSpec(DEPTH, FULL, 1, caps)
    jspec = JSpec(DEPTH, FULL, 1, caps)
    tset = tds.CapacityFilteredDataset(tds.SyntheticDataset(**kw), tspec,
                                       edge_factor=EDGE_FACTOR)
    jset = jds.CapacityFilteredDataset(jds.SyntheticDataset(**kw), jspec,
                                       edge_factor=EDGE_FACTOR)
    skipped = 0
    for i in range(len(tset)):
        got, want = tset[i], jset[i]
        assert_item_equal(got, want)
        skipped += got["filename"] != f"synthetic/{i}"
        assert tds.fits_capacity(got["points"], tspec, EDGE_FACTOR)
    assert skipped > 0
    assert "exceeds octree capacity; skipped" in capsys.readouterr().out
    never = tds.CapacityFilteredDataset(
        tds.SyntheticDataset(**kw), TSpec(DEPTH, FULL, 1, (1, 8, 64, 8, 8)))
    with pytest.raises(RuntimeError, match="consecutive samples exceed"):
        never[0]


def write_shapenet(root, n_shapes=2, n_points=3000, n_sdf=2000,
                   scale=0.5, seed=0):
    """ShapeNet-format npz files of lumpy spheres (points scaled by
    ``scale`` as the reference's files are) and their filelist."""
    pts, nrm = lumpy_spheres(n_shapes, n_points, seed=seed)
    sdf = lumpy_sphere_sdf_samples(n_shapes, n_sdf, seed=seed,
                                   points_per_shape=n_points)
    names = [f"02958343/shape_{i}" for i in range(n_shapes)]
    for i, name in enumerate(names):
        d = os.path.join(root, name)
        os.makedirs(d)
        np.savez(os.path.join(d, "pointcloud.npz"),
                 points=pts[i].numpy() * scale, normals=nrm[i].numpy())
        np.savez(os.path.join(d, "sdf.npz"),
                 points=sdf["pos"][i].numpy() * scale,
                 grad=sdf["grad"][i].numpy(), sdf=sdf["sdf"][i].numpy())
    filelist = os.path.join(root, "filelist.txt")
    with open(filelist, "w") as fh:
        fh.write("".join(f"{n}\n" for n in names))
    return filelist


class _SeededRandomState(np.random.RandomState):
    """``RandomState()`` seeded: the datasets' unseeded draw, made
    repeatable for the comparison."""

    def __init__(self, seed=None):
        super().__init__(7 if seed is None else seed)


def test_shapenet_dataset_matches_jax(tmp_path, monkeypatch):
    root = str(tmp_path)
    filelist = write_shapenet(root)
    kw = dict(point_scale=0.5, point_sample_num=256, points_per_shape=1024)
    tset = tds.ShapeNetDataset(root, filelist, **kw)
    jset = jds.ShapeNetDataset(root, filelist, **kw)
    assert tset.labels == jset.labels == [1, 1]      # synset 02958343: car
    monkeypatch.setattr(np.random, "RandomState", _SeededRandomState)
    for i in range(len(tset)):
        got, want = tset[i], jset[i]
        assert_item_equal(got, want)
        assert got["points"].shape == (1024, 3)
        # rows of the files, pos / sdf / grad aligned
        name = os.path.join(root, tset.filenames[i])
        pc = np.load(os.path.join(name, "pointcloud.npz"))
        sd = np.load(os.path.join(name, "sdf.npz"))
        file_pts = pc["points"] / np.float32(0.5)
        rows = [np.flatnonzero((file_pts == p).all(1))[0]
                for p in got["points"][:50]]
        np.testing.assert_array_equal(got["normals"][:50], pc["normals"][rows])
        srows = [np.flatnonzero((sd["points"] / np.float32(0.5) == p).all(1))[0]
                 for p in got["pos"][:50]]
        np.testing.assert_array_equal(got["sdf"][:50], sd["sdf"][srows])
        np.testing.assert_array_equal(got["grad"][:50], sd["grad"][srows])


def test_batch_to_device():
    batch = tds.collate([tds.SyntheticDataset(size=2, **SMALL)[i]
                         for i in range(2)])
    got = batch_to_device(batch, "cpu")
    assert "filename" not in got
    assert got["label"].dtype == torch.int64
    assert got["label"].tolist() == [0, 1]
    for k in ("points", "normals", "pos", "sdf", "grad"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), batch[k])


def test_precompute_splits_matches_jax(tmp_path, monkeypatch):
    from octfusion_tpu.models.common import batch_to_octree_jit
    from octfusion_tpu.octree import split_codec as jsplit
    from octfusion_tpu_torch.tools import precompute_splits

    root = str(tmp_path)
    filelist = write_shapenet(root, n_points=2048)
    cfg = os.path.join(REPO, "configs", "synthetic_tiny.yaml")
    monkeypatch.setattr(np.random, "RandomState", _SeededRandomState)
    precompute_splits.main(["--config", cfg, "--location", root,
                            "--filelist", filelist, "--device", "cpu"])
    jset = jds.ShapeNetDataset(root, filelist, 0.5, 1, 2048, load_sdf=False,
                               load_split_small=True)
    spec = JSpec.create(DEPTH, FULL, 1, finest_cap_per_sample=2048,
                        decay=1.0)
    split = jax.jit(lambda p, n: jsplit.octree2split_small(
        batch_to_octree_jit(p[None], n[None], spec)))
    for i in range(len(jset)):
        item = jset[i]       # the same seeded draw as the tool's
        want = np.asarray(split(jnp.asarray(item["points"]),
                                jnp.asarray(item["normals"])))[0]
        np.testing.assert_array_equal(item["split_small"], want)
        assert (want > 0).any()
        t_item = tds.ShapeNetDataset(root, filelist, load_sdf=False,
                                     load_pointcloud=False,
                                     load_split_small=True)[i]
        np.testing.assert_array_equal(t_item["split_small"], want)


def test_make_reference_set_matches_jax_tool(tmp_path, monkeypatch):
    from octfusion_tpu_torch.tools import make_reference_set

    args = ["--start", "10000", "--count", "2", "--resolution", "20"]
    written = make_reference_set.main(
        ["--out", str(tmp_path / "port"), "--device", "cpu"] + args)
    monkeypatch.setattr(sys, "argv", ["make_reference_set.py", "--out",
                                      str(tmp_path / "jax")] + args)
    runpy.run_path(os.path.join(REPO, "tools", "make_reference_set.py"),
                   run_name="__main__")
    assert len(written) == 2
    for path in written:
        with open(path) as fh:
            got = fh.read()
        with open(tmp_path / "jax" / os.path.basename(path)) as fh:
            want = fh.read()
        assert "\nf " in got
        assert got == want
