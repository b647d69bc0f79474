"""Dataset preparation in the port (``octfusion_tpu_torch/tools/
prepare_dataset.py``) against the JAX package's ``tools/prepare_dataset.py``
on the 25³ sphere of ``tests/test_mesh.py::test_winding_number_signs``:
the closed mesh, the mesh with a hole at the +z pole, and
``sign_method="normal"``, at a few thousand samples, on the CPU (the
card's run is in ``test_torch_port_cuda.py``)."""

import os
import sys

import numpy as np
import pytest
from scipy.spatial import cKDTree

from octfusion_tpu.utils import mesh as jmesh
from octfusion_tpu_torch.tools import prepare_dataset

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import prepare_dataset as jprep  # noqa: E402  (the JAX tool)

N_SAMPLES = 3000
# float64 distances to the same sample: the same bits unless the two
# searches pick different samples at a tie; float32 winding numbers in
# another summation order
SDF_ATOL = 1e-6
GRAD_ATOL = 1e-5
WINDING_ATOL = 1e-4
TIE = 1e-3      # |w - 0.5| within which the sign may differ


def sphere(n=25):
    coord = (np.arange(n) + 0.5) / n * 2 - 1
    g = np.stack(np.meshgrid(coord, coord, coord, indexing="ij"), -1)
    v, f = jmesh.marching_tetrahedra(np.linalg.norm(g, axis=-1) - 0.6, 0.0)
    return (v + 0.5) / n * 2 - 1, f


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    root = tmp_path_factory.mktemp("meshes")
    v, f = sphere()
    hole = f[v[f].mean(1)[:, 2] < 0.45]
    out = {}
    for name, faces in (("closed", f), ("hole", hole)):
        out[name] = str(root / f"{name}.obj")
        jmesh.save_obj(out[name], v, faces)
    return out


@pytest.mark.parametrize("mesh,sign_method", [
    ("closed", "winding"), ("hole", "winding"), ("closed", "normal")])
def test_mesh_to_shards_matches_jax(meshes, tmp_path, mesh, sign_method):
    kw = dict(n_surface=N_SAMPLES, n_sdf=N_SAMPLES, seed=3,
              sign_method=sign_method)
    jprep.mesh_to_shards(meshes[mesh], str(tmp_path / "jax"), **kw)
    times = prepare_dataset.mesh_to_shards(meshes[mesh], str(tmp_path / "port"),
                                           device="cpu", **kw)
    assert set(times) == {"nearest_s", "winding_s", "total_s"}
    load = lambda side, name: dict(np.load(tmp_path / side / name))  # noqa
    for name in ("pointcloud.npz", "sdf.npz"):
        assert sorted(load("port", name)) == sorted(load("jax", name))
    jpc, tpc = load("jax", "pointcloud.npz"), load("port", "pointcloud.npz")
    for k in ("points", "normals"):
        np.testing.assert_array_equal(tpc[k], jpc[k])
    jsdf, tsdf = load("jax", "sdf.npz"), load("port", "sdf.npz")
    np.testing.assert_array_equal(tsdf["points"], jsdf["points"])
    assert tsdf["sdf"].dtype == tsdf["grad"].dtype == np.float32
    # the sign: equal wherever the winding number is clear of 1/2
    v, f = jmesh.load_obj(meshes[mesh])
    q = jsdf["points"]
    clear = np.ones(len(q), bool)
    if sign_method == "winding":
        verts = v - (v.min(0) + v.max(0)) / 2
        verts = verts / np.abs(verts).max() * 0.8 * 0.5
        clear = np.abs(jprep.winding_number(verts, f, q) - 0.5) > TIE
    np.testing.assert_array_equal(np.sign(tsdf["sdf"])[clear],
                                  np.sign(jsdf["sdf"])[clear])
    np.testing.assert_allclose(np.abs(tsdf["sdf"]), np.abs(jsdf["sdf"]),
                               rtol=0, atol=SDF_ATOL)
    np.testing.assert_allclose(tsdf["grad"][clear], jsdf["grad"][clear],
                               rtol=0, atol=GRAD_ATOL)


def test_winding_number_matches_jax(meshes):
    """The closed sphere's winding numbers (inside 1, outside 0) and the
    open one's, against the JAX tool's, and the inside test of
    ``test_mesh.py`` away from the surface."""
    rng = np.random.RandomState(0)
    q = rng.uniform(-0.9, 0.9, size=(300, 3)).astype(np.float32)
    r = np.linalg.norm(q, axis=-1)
    clear = np.abs(r - 0.6) > 0.1
    for name in ("closed", "hole"):
        v, f = jmesh.load_obj(meshes[name])
        w = prepare_dataset.winding_number(v, f, q, device="cpu")
        assert w.dtype == np.float32
        np.testing.assert_allclose(w, jprep.winding_number(v, f, q),
                                   rtol=0, atol=WINDING_ATOL)
    far = clear & (q[:, 2] < 0.2)
    np.testing.assert_array_equal((w > 0.5)[far], (r < 0.6)[far])


def test_nearest_surface_matches_kdtree():
    """Brute force in float64 over direct differences: the distances of
    scipy's ``cKDTree.query`` and its samples, here on a grid whose
    queries sit at exact ties too (the first index wins them)."""
    rng = np.random.RandomState(1)
    surf = rng.uniform(-0.5, 0.5, size=(2000, 3))
    q = rng.uniform(-0.6, 0.6, size=(1500, 3)).astype(np.float32)
    dist, idx = prepare_dataset.nearest_surface(q, surf, device="cpu")
    kd_dist, kd_idx = cKDTree(surf).query(q, k=1)
    np.testing.assert_array_equal(idx, kd_idx)
    np.testing.assert_allclose(dist, kd_dist, rtol=1e-15, atol=0)
    grid = np.stack(np.meshgrid(*[np.arange(3.0)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    _, tie_idx = prepare_dataset.nearest_surface(
        np.array([[0.5, 0.0, 0.0]], np.float32), grid, device="cpu")
    assert tie_idx[0] == 0


def test_cli_writes_the_layout(meshes, tmp_path, capsys):
    out = tmp_path / "prepared"
    filelist = tmp_path / "lists" / "filelist.txt"
    times = prepare_dataset.main([
        "--meshes", os.path.join(os.path.dirname(meshes["closed"]), "*.obj"),
        "--out", str(out), "--filelist", str(filelist), "--n_surface", "500",
        "--n_sdf", "400", "--device", "cpu"])
    assert len(times) == 2
    assert filelist.read_text() == "closed\nhole\n"
    for name in ("closed", "hole"):
        sdf = np.load(out / name / "sdf.npz")
        assert sdf["points"].shape == (400, 3) and sdf["sdf"].shape == (400,)
        assert np.load(out / name / "pointcloud.npz")["points"].shape == (
            500, 3)
    assert "[*] prepared 2 meshes on cpu: per mesh nearest_s=" in \
        capsys.readouterr().out
