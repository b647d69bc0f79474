"""Shading FID in the port against the JAX package: the triangle
rasteriser (``metrics/render.py``), the stand-in features and their
weights (``metrics/fid.py``, ``utils/jax_prng.py``), the Fréchet
arithmetic, ``render_mesh_set`` / ``per_view_fid``, and
``python -m octfusion_tpu_torch.evaluate --fid_standin``
against ``octfusion_tpu.metrics.fid.shading_fid`` with the stand-in.
Mirrors ``tests/test_render_fid.py`` and ``tests/test_render_golden.py``
on the CPU; the card's runs are in ``test_torch_port_cuda.py``."""

import glob
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octfusion_tpu.metrics import fid as jfid
from octfusion_tpu.metrics import render as jrender
from octfusion_tpu.utils import mesh as jmesh
from octfusion_tpu_torch import evaluate
from octfusion_tpu_torch.metrics import fid, render
from octfusion_tpu_torch.utils import jax_prng
from octfusion_tpu_torch.utils import mesh as mesh_utils
from octfusion_tpu_torch.utils.shapes import lumpy_sphere_fields

from test_render_golden import GOLDEN, VIEWS, _canonical_mesh

# images: the same float64 arithmetic except numpy's matrix products
# (projection, shading), whose rounding can move a pixel on a shared edge
# to the other face: >= 99.9% of the pixels within 1e-6
IMG_ATOL, IMG_SHARE = 1e-6, 0.999
# features: fp32 convolutions in another summation order
FEAT_TOL = dict(rtol=1e-4, atol=1e-5)
# normal draws: XLA:CPU's float32 log1p inside erf_inv is not numpy's; up
# to 2 ulp in erf_inv, 3 after the float32 product with sqrt(2)
NORMAL_ULP = 3
STANDIN_SHAPES = [(3, 3, 1, 8), (3, 3, 8, 16), (3, 3, 16, 32),
                  (3, 3, 32, 128)]


def sphere_mesh(n=33, r=0.6):
    coord = (np.arange(n) + 0.5) / n * 2 - 1
    g = np.stack(np.meshgrid(coord, coord, coord, indexing="ij"), -1)
    v, f = jmesh.marching_tetrahedra(np.linalg.norm(g, axis=-1) - r, 0.0)
    return (v + 0.5) / n * 2 - 1, f


def _assert_images_close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    close = np.abs(got - want) <= IMG_ATOL
    assert close.mean() >= IMG_SHARE, (close.size - close.sum(), close.size)


@pytest.mark.parametrize("mesh", ["sphere", "octahedron"])
def test_raster_matches_jax(mesh):
    v, f = sphere_mesh() if mesh == "sphere" else _canonical_mesh()
    want = jrender.render_mesh_views_raster(v, f, image_size=64, n_views=4)
    got = render.render_mesh_views_raster(v, f, image_size=64, n_views=4,
                                          device="cpu")
    _assert_images_close(got, want)
    assert (got > 0).mean() > 0.1


def test_raster_matches_golden():
    """The JAX test's golden images of the squashed octahedron, within its
    own bound (2e-3, float16 storage)."""
    v, f = _canonical_mesh()
    got = render.render_mesh_views_raster(v, f, image_size=64, device="cpu")
    got = got[list(VIEWS)].astype(np.float16).astype(np.float32)
    want = np.load(GOLDEN).astype(np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-3


def test_raster_empty_chunk():
    """A chunk whose candidate pixels are all rejected (a degenerate
    micro-sliver alone in its chunk, `test_render_fid.py`'s regression)
    renders as the JAX renderer does."""
    sv, sf = sphere_mesh()
    v = np.concatenate([sv, np.array([[0.3, 0.3, 0.0], [0.3 + 1e-9, 0.3, 0.0],
                                      [0.3, 0.3 + 1e-9, 0.0]])])
    f = np.concatenate([sf, np.array([[0, 1, 2]]) + len(sv)])
    kw = dict(image_size=64, n_views=20, face_chunk=len(sf))
    got = render.render_mesh_views_raster(v, f, device="cpu", **kw)
    assert got.shape == (20, 64, 64) and got.max() > 0.3
    _assert_images_close(got, jrender.render_mesh_views_raster(v, f, **kw))


def test_raster_does_not_depend_on_chunking(monkeypatch):
    """Per pixel the least depth, the lowest face at a tie: the images
    are the same bits for any face chunk and pair budget."""
    v, f = sphere_mesh(n=17)
    ref = render.render_mesh_views_raster(v, f, image_size=48, n_views=3,
                                          device="cpu")
    monkeypatch.setattr(render, "PAIR_BUDGET", 97)
    got = render.render_mesh_views_raster(v, f, image_size=48, n_views=3,
                                          face_chunk=113, device="cpu")
    np.testing.assert_array_equal(got, ref)


def test_zbuffer_tie_takes_the_lowest_face():
    """Two faces at the same depth over the same pixels (a duplicated
    face): the lower index wins, within one chunk and across chunks; a
    nearer later face wins over both."""
    size = 8
    sx = torch.tensor([1.0, 7.0, 1.0, 1.0, 7.0, 1.0], dtype=torch.float64)
    sy = torch.tensor([1.0, 1.0, 7.0, 1.0, 1.0, 7.0], dtype=torch.float64)
    z = torch.tensor([2.0, 2.0, 2.0, 1.5, 1.5, 1.5], dtype=torch.float64)
    far = torch.tensor([[0, 1, 2]])
    near = torch.tensor([[3, 4, 5]])
    for chunk in (8, 1):
        face = render._nearest_faces(sx, sy, z, torch.cat([far, far]), size,
                                     chunk)
        assert set(face.tolist()) == {-1, 0}
        face = render._nearest_faces(sx, sy, z,
                                     torch.cat([far, far, near]), size, chunk)
        assert set(face.tolist()) == {-1, 2}


@pytest.mark.parametrize("seed", range(4))
def test_jax_prng_matches_jax_random(seed):
    """Keys, splits and bits bit for bit; normals within ``NORMAL_ULP``
    ulp, at the stand-in's four kernel shapes."""
    jkey = jax.random.PRNGKey(seed)
    key = jax_prng.key(seed)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    jkeys = jax.jit(lambda k: jax.random.split(k, 4))(jkey)
    keys = jax_prng.split(key, 4)
    np.testing.assert_array_equal(keys, np.asarray(jkeys))
    for k, jk, shape in zip(keys, jkeys, STANDIN_SHAPES):
        jbits, jnormal = jax.jit(lambda k: (
            jax.random.bits(k, shape, jnp.uint32),
            jax.random.normal(k, shape, jnp.float32)))(jk)
        np.testing.assert_array_equal(jax_prng.random_bits(k, shape),
                                      np.asarray(jbits))
        got = jax_prng.normal(k, shape)
        assert got.dtype == np.float32 and got.shape == shape
        ulp = np.abs(got.view(np.int32).astype(np.int64)
                     - np.asarray(jnormal).view(np.int32).astype(np.int64))
        # same signs, so the integer views' distance counts ulp
        assert (np.sign(got) == np.sign(np.asarray(jnormal))).all()
        assert ulp.max() <= NORMAL_ULP, ulp.max()


def test_standin_features_match_jax():
    """96 images at 64² (every layer pads (0, 1)) and 4 at 299² (the
    inputs 299 and 75 pad (1, 1), 150 and 38 pad (0, 1))."""
    rng = np.random.RandomState(0)
    for n, size in ((96, 64), (4, 299)):
        imgs = rng.uniform(0, 1, size=(n, size, size)).astype(np.float32)
        want = jfid.standin_feature_extractor(image_size=size)(imgs)
        got = fid.standin_feature_extractor(image_size=size,
                                            device="cpu")(imgs)
        assert got.shape == (n, 256) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **FEAT_TOL)
    assert fid.standin_feature_extractor(device="cpu").cache_tag == \
        "standin_s0_d256"


def test_fid_from_features_matches_jax():
    """The same float64 arithmetic: relative 1e-9, full-rank and
    rank-deficient (64 samples in 256 dimensions, no warning)."""
    rng = np.random.RandomState(3)
    f1, f2 = rng.normal(size=(200, 16)), rng.normal(size=(200, 16))
    for a, b in ((f1, f2), (f1, f2 + 3.0)):
        want = jfid.fid_from_features(a, b)
        assert fid.fid_from_features(a, b) == pytest.approx(want, rel=1e-9)
    f1, f2 = rng.normal(size=(64, 256)), rng.normal(size=(64, 256))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for a, b in ((f1, f1 + 1e-3 * rng.normal(size=f1.shape)),
                     (f1, f2 + 3.0)):
            want = jfid.fid_from_features(a, b)
            got = fid.fid_from_features(a, b)
            assert np.isfinite(got) and got == pytest.approx(want, rel=1e-9)


def _write_meshes(root, kind, seed, n=4, grid=20):
    os.makedirs(os.path.join(root, kind))
    for i, field in enumerate(lumpy_sphere_fields(n, grid, seed)):
        v, f = mesh_utils.marching_tetrahedra(field)
        mesh_utils.save_obj(os.path.join(root, kind, f"{i}.obj"),
                            v.numpy(), f.numpy())
    return os.path.join(root, kind, "*.obj")


def test_render_mesh_set_and_per_view_fid_match_jax(tmp_path):
    """``render_mesh_set`` against the JAX function (images as in
    ``test_raster_matches_jax``), then ``per_view_fid`` of two image sets
    with the stand-in against JAX's on the same images (relative 1e-3, as
    the end-to-end FID below)."""
    paths = {kind: sorted(glob.glob(_write_meshes(str(tmp_path), kind, seed)))
             for kind, seed in (("a", 3), ("b", 4))}
    kw = dict(image_size=48, n_views=3)
    images = {}
    for kind, p in paths.items():
        images[kind] = jfid.render_mesh_set(p, **kw)
        got = fid.render_mesh_set(p, device="cpu", **kw)
        assert got.shape == (4, 3, 48, 48)
        _assert_images_close(got, images[kind])
    want = jfid.per_view_fid(images["a"], images["b"],
                             jfid.standin_feature_extractor(image_size=48))
    got = fid.per_view_fid(images["a"], images["b"],
                           fid.standin_feature_extractor(image_size=48,
                                                         device="cpu"))
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-3)


def test_evaluate_fid_standin_matches_jax(tmp_path, capsys):
    """``evaluate --fid_standin --skip_pairwise --device cpu`` on 4 + 4
    small meshes against the JAX package's ``shading_fid`` with the
    stand-in (relative 1e-3); a second run reads the ``.fid_cache`` of
    each set and gives the same value."""
    samples = _write_meshes(str(tmp_path), "samples", 1)
    reference = _write_meshes(str(tmp_path), "reference", 2)
    argv = ["--samples", samples, "--reference", reference, "--fid_standin",
            "--fid_views", "4", "--skip_pairwise", "--device", "cpu"]
    res = evaluate.main(argv)
    assert set(res) == {"shading_fid_standin", "wall_s_fid"}
    want = jfid.shading_fid(sorted(glob.glob(samples)),
                            sorted(glob.glob(reference)), n_views=4,
                            feature_fn=jfid.standin_feature_extractor())
    assert res["shading_fid_standin"] == pytest.approx(want, rel=1e-3)
    for kind in ("samples", "reference"):
        cached = sorted(os.listdir(tmp_path / kind / ".fid_cache"))
        assert len(cached) == 4 and all(
            c.endswith("-s299v4-standin_s0_d256.npy") for c in cached)
    again = evaluate.main(argv)
    assert again["shading_fid_standin"] == res["shading_fid_standin"]
    assert "shading_fid_standin" in capsys.readouterr().out
