"""The port's evaluation path against the JAX package's, on the CPU: the
Chamfer terms (K4's plain version) against the XLA ``chamfer`` and the
Pallas kernel in interpret mode, ``emd_approx`` in float32 and
bfloat16-stored, the padded tile loop ``pairwise_cd_emd``, the metrics of
``evaluate_point_sets``, the mesh helpers (``sample_surface`` bit for bit,
``.obj`` round trip), the whole ``python -m octfusion_tpu_torch.evaluate``
against ``tools/evaluate.py``'s pipeline, the roofline arithmetic of
K1-K4, and the device default of the entry points.  Inputs are made with
numpy from a seed; the JAX side is jitted."""

import importlib.util
import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from octfusion_tpu.metrics import distances as jd
from octfusion_tpu.metrics import evaluation as jev
from octfusion_tpu.ops.pallas.chamfer_kernel import chamfer_pallas
from octfusion_tpu.utils import mesh as jmesh
from octfusion_tpu_torch import evaluate as tevaluate
from octfusion_tpu_torch.metrics import distances as td
from octfusion_tpu_torch.metrics import evaluation as tev
from octfusion_tpu_torch.models.union_solver import UnionSolver
from octfusion_tpu_torch.ops import chamfer_cuda, roofline
from octfusion_tpu_torch.utils import mesh as tmesh
from octfusion_tpu_torch.utils.shapes import lumpy_sphere_fields

from test_torch_port_helpers import tcfg, tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 minima of the same expansion, other summation order
TOL_CD = dict(rtol=1e-4, atol=1e-5)
# the auction's 9 rounds of clamped normalisations carry float32 rounding
# (exp, reduction order) to ~1e-3 relative at n = m = 128: the JAX result
# itself moves by up to 1.0e-3 when d^2 is formed in float64; the same
# bound as ``tests/test_metrics.py`` holds between JAX and the C++ auction
TOL_EMD = dict(rtol=2e-3, atol=1e-6)


def _clouds(b, n, m, seed):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, size=(b, n, 3)).astype(np.float32),
            rng.uniform(-1, 1, size=(b, m, 3)).astype(np.float32))


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
def test_chamfer_matches_jax(reference):
    """The ragged 700 x 1100 shape of ``tests/test_metrics.py``."""
    a, b = _clouds(2, 700, 1100, seed=5)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ref = (jd.chamfer(ja, jb) if reference == "xla"
           else chamfer_pallas(ja, jb, interpret=True))
    n0 = chamfer_cuda.launches["chamfer"]
    got = td.chamfer(torch.tensor(a), torch.tensor(b))
    assert chamfer_cuda.launches["chamfer"] == n0   # the CPU takes plain
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL_CD)


def test_chamfer_kernel_wrapper_rejects_cpu_tensors():
    a, b = _clouds(1, 8, 8, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        chamfer_cuda.chamfer(torch.tensor(a), torch.tensor(b))


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m", [(128, 128), (96, 160)])
def test_emd_approx_matches_jax(store, n, m):
    a, b = _clouds(3, n, m, seed=7)
    ref = np.asarray(jd.emd_approx(jnp.asarray(a), jnp.asarray(b),
                                   store_dtype=jnp.dtype(store)))
    got = td.emd_approx(torch.tensor(a), torch.tensor(b),
                        store_dtype=getattr(torch, store))
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), ref, **TOL_EMD)


def test_pairwise_cd_emd_matches_jax():
    """S = 7 and R = 10 against row_block 3 and batch 4: the last row and
    column blocks are padded and cropped."""
    rng = np.random.RandomState(3)
    s = rng.uniform(-1, 1, size=(7, 48, 3)).astype(np.float32)
    r = rng.uniform(-1, 1, size=(10, 48, 3)).astype(np.float32)
    ref = jd.pairwise_cd_emd(jnp.asarray(s), jnp.asarray(r), batch=4,
                             row_block=3)
    got = td.pairwise_cd_emd(torch.tensor(s), torch.tensor(r), batch=4,
                             row_block=3)
    for g, x, tol in zip(got, ref, (TOL_CD, TOL_EMD)):
        assert g.shape == (7, 10) and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(x), **tol)


def test_evaluate_point_sets_matches_jax():
    """S = R = 12 clouds of 64 points: 1-NNA and COV equal, MMD close."""
    rng = np.random.RandomState(4)
    s = rng.normal(size=(12, 64, 3)).astype(np.float32)
    r = (rng.normal(size=(12, 64, 3)) * 1.1).astype(np.float32)
    ref = jev.evaluate_point_sets(s, r, batch=8, emd=True)
    got = tev.evaluate_point_sets(s, r, batch=8, emd=True, device="cpu")
    assert set(got) == set(ref)
    for k in ("1nna_cd", "cov_cd", "1nna_emd", "cov_emd"):
        assert got[k] == ref[k], k
    np.testing.assert_allclose(got["mmd_cd"], ref["mmd_cd"], **TOL_CD)
    np.testing.assert_allclose(got["mmd_emd"], ref["mmd_emd"], **TOL_EMD)


def test_metric_arithmetic_matches_jax():
    m = np.random.RandomState(5).uniform(size=(3, 9, 9)).astype(np.float32)
    assert tev.compute_1_nna(m[0], m[1], m[2]) == \
        jev.compute_1_nna(m[0], m[1], m[2])
    assert tev.compute_cov_mmd(m[2]) == jev.compute_cov_mmd(m[2])
    assert tev.diversity_topk(m[0], 3) == jev.diversity_topk(m[0], 3)


def _mesh(seed, res=24):
    verts, faces = tmesh.marching_tetrahedra(
        lumpy_sphere_fields(1, res, seed)[0])
    return verts.numpy().astype(np.float64), faces.numpy()


def test_sample_surface_is_bit_identical_to_jax():
    verts, faces = _mesh(0)
    v = tmesh.normalize_unit_cube(verts)
    assert np.allclose(v.max(0) + v.min(0), 0) and np.isclose(
        (v.max(0) - v.min(0)).max(), 1.0)
    for seed in (0, 10_000):
        got = tmesh.sample_surface(v, faces, 512, seed=seed,
                                   return_normals=True)
        ref = jmesh.sample_surface(v, faces, 512, seed=seed,
                                   return_normals=True)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def test_obj_round_trip(tmp_path):
    verts, faces = _mesh(1)
    path = str(tmp_path / "m.obj")
    tmesh.save_obj(path, verts, faces)
    v, f = tmesh.load_obj(path)
    np.testing.assert_array_equal(f, faces)
    np.testing.assert_allclose(v, verts, rtol=0, atol=5e-7)  # %.6f
    jv, jf = jmesh.load_obj(path)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)


def _jax_tools_evaluate():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_evaluate", os.path.join(REPO, "tools", "evaluate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_evaluate_main_matches_jax_pipeline(tmp_path):
    """The whole slice: ``.obj`` meshes -> clouds -> metrics, against
    ``tools/evaluate.py``'s sampling and the JAX package's metrics."""
    for kind, seed in (("s", 10), ("r", 20)):
        os.makedirs(tmp_path / kind)
        for i in range(5):
            tmesh.save_obj(str(tmp_path / kind / f"{i}.obj"),
                           *_mesh(seed + i, res=16))
    out = str(tmp_path / "res.json")
    argv = ["--samples", str(tmp_path / "s" / "*.obj"),
            "--reference", str(tmp_path / "r" / "*.obj"), "--points", "64",
            "--emd", "--batch", "4", "--device", "cpu", "--out", out]
    got = tevaluate.main(argv)
    with open(out) as fh:
        assert json.load(fh) == got
    jtools = _jax_tools_evaluate()
    clouds = []
    for kind, seed in (("s", 0), ("r", 10_000)):
        paths = sorted(str(p) for p in (tmp_path / kind).glob("*.obj"))
        ref_pts, _ = jtools.meshes_to_pointclouds(paths, 64, seed=seed)
        pts, kept = tevaluate.meshes_to_pointclouds(paths, 64, seed=seed)
        np.testing.assert_array_equal(pts, ref_pts)
        assert kept == paths
        clouds.append(pts)
    ref = jev.evaluate_point_sets(*clouds, batch=4, emd=True)
    for k in ("1nna_cd", "cov_cd", "1nna_emd", "cov_emd"):
        assert got[k] == ref[k], k
    np.testing.assert_allclose(got["mmd_cd"], ref["mmd_cd"], **TOL_CD)
    np.testing.assert_allclose(got["mmd_emd"], ref["mmd_emd"], **TOL_EMD)
    assert got["wall_s_pointcloud_sampling"] >= 0
    assert got["wall_s_pairwise_metrics"] >= 0


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, the default device raises instead of running on
    the CPU; ``device="cpu"`` runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UnionSolver(cfg)
    pts = np.zeros((2, 4, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tev.evaluate_point_sets(pts, pts, emd=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tevaluate.main(["--samples", "x", "--reference", "y"])
    assert UnionSolver(cfg, device="cpu").device.type == "cpu"


def test_roofline_bounds():
    """The bound arithmetic of K1-K4 against values computed by hand."""
    # K1, level 4, 515 -> 512, G = 4096, E = 27136:
    # 2*4096*7*515*512 + 2*27136*515 FLOP; (4096*515 + 3605*512 + 4096*512)
    # floats and (28673 + 2*27136) int32 / f32 words
    flops, nbytes = roofline.graph_conv_fwd_cost(4096, 515, 512, 27136)
    assert flops == 15_148_416_000
    assert nbytes == 4 * (2_109_440 + 1_845_760 + 2_097_152) \
        + 4 * (28_673 + 54_272)
    ops_ms, bytes_ms = roofline.times_ms(flops, nbytes)
    assert ops_ms == pytest.approx(0.226096, rel=1e-5)
    assert bytes_ms == pytest.approx(0.0073257, rel=1e-4)
    # K3 is K1 with C and C' exchanged
    assert roofline.graph_conv_bwd_dx_cost(4096, 515, 512, 27136) == (
        2 * 4096 * 7 * 515 * 512 + 2 * 27136 * 512,
        4 * (4096 * 512 + 7 * 515 * 512 + 4096 * 515) + 4 * (28_673 + 54_272))
    # K2, level 6, C = 389, G = 65536, E = 272755: bytes-bound
    flops, nbytes = roofline.graph_conv_col_cost(65536, 389, 272755)
    assert flops == 212_203_390
    assert nbytes == 4 * 65536 * 8 * 389 + 4 * (458_753 + 2 * 272_755)
    ops_ms, bytes_ms = roofline.times_ms(flops, nbytes)
    assert bytes_ms > ops_ms and bytes_ms == pytest.approx(0.244719, rel=1e-5)
    # K4 at N = M = 2048: 33.6 MFLOP per pair, 0.128 ms at batch 256
    flops, nbytes = roofline.chamfer_cost(256, 2048, 2048)
    assert flops == 8 * 256 * 2048 * 2048 == 8_589_934_592
    assert nbytes == 256 * 4096 * 16 == 16_777_216
    ops_ms, bytes_ms = roofline.times_ms(flops, nbytes)
    assert ops_ms == pytest.approx(0.128208, rel=1e-5)
    assert bytes_ms == pytest.approx(0.0050082, rel=1e-4)
