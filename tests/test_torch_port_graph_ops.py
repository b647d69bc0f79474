"""Parity of the port's graph ops with the JAX package, on one graph built
by both and inputs made with numpy from a seed.

``graph_conv`` (the plain CPU version of the CUDA kernel) is held to
rtol = atol = 1e-5 against both JAX forms: the segment-sum path and the
Pallas kernel run in interpret mode through a descriptor plan.  The other
ops are held to 1e-5 as well (fp32, different summation order), and the
gradients of the per-sample broadcasts (group norm, batch embedding;
their one-hot GEMM backward) to ``jax.grad`` on a batch-2 graph."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from octfusion_tpu.octree.dual_graph import build_dual_graph as j_build
from octfusion_tpu.octree.dual_graph import with_conv_plans
from octfusion_tpu.octree.octree import OctreeSpec as JSpec
from octfusion_tpu.octree.octree import build_octree, merge_octrees
from octfusion_tpu.ops import graph_ops as jops
from octfusion_tpu_torch.octree.dual_graph import build_dual_graph as t_build
from octfusion_tpu_torch.ops import graph_conv_cuda
from octfusion_tpu_torch.ops import graph_ops as tops

from test_torch_port_helpers import make_graph, np_, port_octree

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def graphs():
    jg = make_graph(seed=3, depth=4, full_depth=2, n=300)
    return jg, t_build(port_octree(jg.octree), 9)


@pytest.fixture(scope="module")
def graphs_b2():
    """The JAX dual graph of two merged seeded spheres (B = 2, padding rows
    on every level) and the port's graph of the same octree."""
    spec = JSpec.create(4, 2, 1, finest_cap_per_sample=2048, decay=1.0)
    rng = np.random.RandomState(4)
    v = rng.normal(size=(2, 300, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pts = np.array([0.55, 0.4])[:, None, None] * v
    jg = jax.jit(lambda p, n: j_build(merge_octrees(
        [build_octree(p[i], n[i], spec) for i in range(2)]), 9))(
            jnp.asarray(pts.astype(np.float32)),
            jnp.asarray(v.astype(np.float32)))
    return jg, t_build(port_octree(jg.octree), 9)


@pytest.mark.parametrize("n_node_type", [0, 3])
def test_graph_conv_matches_segment_sum_and_pallas(graphs, n_node_type):
    jg, tg = graphs
    jgp = with_conv_plans(jg)
    rng = np.random.RandomState(n_node_type)
    node_ch = n_node_type if n_node_type > 1 else 0
    for d, c, cout in ((2, 8, 16), (3, 16, 8), (4, 5, 24)):
        g = tg.level(d).g_cap
        x = rng.normal(size=(g, c)).astype(np.float32)
        w = (rng.normal(size=(7 * (c + node_ch), cout)) * 0.1).astype(
            np.float32)
        got = np_(tops.graph_conv(torch.tensor(x), torch.tensor(w),
                                  tg.level(d), n_node_type))
        seg = jax.jit(lambda x, w, lvl: jops.graph_conv(x, w, lvl, n_node_type))
        ref = np_(seg(jnp.asarray(x), jnp.asarray(w), jg.level(d)))
        np.testing.assert_allclose(got, ref, **TOL)
        fused = np_(seg(jnp.asarray(x), jnp.asarray(w), jgp.level(d)))
        np.testing.assert_allclose(got, fused, **TOL)


def test_kernel_wrapper_refuses_cpu_tensors(graphs):
    """The CUDA wrappers (K1, K2, K3) launch or raise; they never fall
    back."""
    _, tg = graphs
    lvl = tg.level(3)
    csr, csr_t = lvl.csr(), lvl.csr_t()
    x = torch.zeros(lvl.g_cap, 4)
    w = torch.zeros(28, 4)
    n0 = dict(graph_conv_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        graph_conv_cuda.graph_conv(x, w, *csr)
    with pytest.raises(ValueError, match="CUDA"):
        graph_conv_cuda.graph_conv_col(x, *csr)
    with pytest.raises(ValueError, match="CUDA"):
        graph_conv_cuda.graph_conv_bwd_dx(x, w, *csr_t)
    assert graph_conv_cuda.launches == n0


def test_group_norm_and_batch_embedding(graphs):
    jg, tg = graphs
    rng = np.random.RandomState(5)
    for d, c, group in ((3, 16, 4), (4, 64, 32)):
        g = tg.level(d).g_cap
        x = (rng.normal(size=(g, c)) * 3 + 1).astype(np.float32)
        scale = rng.normal(size=(c,)).astype(np.float32)
        bias = rng.normal(size=(c,)).astype(np.float32)
        got = tops.dual_group_norm(torch.tensor(x), tg.level(d),
                                   torch.tensor(scale), torch.tensor(bias),
                                   group)
        ref = jops.dual_group_norm(jnp.asarray(x), jg.level(d),
                                   jnp.asarray(scale), jnp.asarray(bias),
                                   group)
        np.testing.assert_allclose(np_(got), np_(ref), **TOL)
        emb = rng.normal(size=(1, c)).astype(np.float32)
        got = tops.add_batch_embedding(torch.tensor(x), torch.tensor(emb),
                                       tg.level(d))
        ref = jops.add_batch_embedding(jnp.asarray(x), jnp.asarray(emb),
                                       jg.level(d))
        np.testing.assert_allclose(np_(got), np_(ref), **TOL)


def _broadcast_op(pkg, op, group):
    """(f(x, lvl, *params), its params' shapes) of one broadcasting op."""
    if op == "norm":
        return (lambda x, lvl, s, b: pkg.dual_group_norm(x, lvl, s, b, group),
                lambda c: ((c,), (c,)))
    return (lambda x, lvl, e: pkg.add_batch_embedding(x, e, lvl),
            lambda c: ((2, c),))


@pytest.mark.parametrize("op,d,c,group", [("norm", 3, 16, 4),
                                          ("norm", 4, 64, 32),
                                          ("embed", 3, 16, None),
                                          ("embed", 4, 64, None)])
def test_batch_broadcast_grads_match_jax(graphs_b2, op, d, c, group):
    """The gradients of x and the op's parameters through the one-hot GEMM
    backward against ``jax.grad``; the forward under ``no_grad`` (the plain
    gather) equal to the recorded one bit for bit; the backward counter
    up by the op's broadcasts (two for the norm, one for the embedding)."""
    jg, tg = graphs_b2
    lvl = tg.level(d)
    assert tg.spec.ospec.batch_size == 2 and not bool(lvl.node_mask.all())
    rng = np.random.RandomState(d)
    f, shapes = _broadcast_op(tops, op, group)
    jf, _ = _broadcast_op(jops, op, group)
    x = (rng.normal(size=(lvl.g_cap, c)) * 3 + 1).astype(np.float32)
    params = [rng.normal(size=s).astype(np.float32) for s in shapes(c)]
    ct = rng.normal(size=(lvl.g_cap, c)).astype(np.float32)

    args = [torch.tensor(a, requires_grad=True) for a in [x] + params]
    with torch.no_grad():
        plain = f(args[0], lvl, *args[1:])
    n0 = tops._BatchBroadcast.backward_calls
    out = f(args[0], lvl, *args[1:])
    assert torch.equal(out, plain)
    (out * torch.tensor(ct)).sum().backward()
    assert tops._BatchBroadcast.backward_calls - n0 == (
        2 if op == "norm" else 1)

    grad = jax.jit(jax.grad(
        lambda a, lv, ct: jnp.sum(jf(a[0], lv, *a[1:]) * ct)))
    want = grad([jnp.asarray(a) for a in [x] + params], jg.level(d),
                jnp.asarray(ct))
    for got, ref in zip(args, want):
        ref = np_(ref)
        np.testing.assert_allclose(np_(got.grad), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


def test_splices_and_level_arrays(graphs):
    jg, tg = graphs
    rng = np.random.RandomState(6)
    c = 6
    mix = rng.normal(size=(c, 8 * c)).astype(np.float32)
    for d in (3, 4):
        x = rng.normal(size=(tg.level(d).g_cap, c)).astype(np.float32)
        parents = rng.normal(
            size=(tg.spec.ospec.node_caps[d] // 8, c)).astype(np.float32)
        got = tops.downsample_splice(torch.tensor(x), torch.tensor(parents),
                                     tg, d)
        ref = jops.downsample_splice(jnp.asarray(x), jnp.asarray(parents),
                                     jg, d)
        np.testing.assert_array_equal(np_(got), np_(ref))

        xp = rng.normal(size=(tg.level(d - 1).g_cap, c)).astype(np.float32)
        got = tops.upsample_splice(
            torch.tensor(xp), tg, d,
            lambda h: (h @ torch.tensor(mix)).reshape(-1, c))
        ref = jops.upsample_splice(
            jnp.asarray(xp), jg, d,
            lambda h: jnp.dot(h, jnp.asarray(mix)).reshape(-1, c))
        np.testing.assert_allclose(np_(got), np_(ref), **TOL)

        got = tops.graph_to_level_arrays(torch.tensor(x), tg, d)
        ref = jops.graph_to_level_arrays(jnp.asarray(x), jg, d)
        assert sorted(got) == sorted(ref)
        for dd in ref:
            np.testing.assert_array_equal(np_(got[dd]), np_(ref[dd]))
        np.testing.assert_array_equal(
            np_(tops._cur_segment(torch.tensor(x), tg, d)),
            np_(jops._cur_segment(jnp.asarray(x), jg, d)))
