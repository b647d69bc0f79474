"""Parity of the port's graph ops with the JAX package, on one graph built
by both and inputs made with numpy from a seed.

``graph_conv`` (the plain CPU version of the CUDA kernel) is held to
rtol = atol = 1e-5 against both JAX forms: the segment-sum path and the
Pallas kernel run in interpret mode through a descriptor plan.  The other
ops are held to 1e-5 as well (fp32, different summation order)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from octfusion_tpu.octree.dual_graph import with_conv_plans
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
