"""The port's differentiable graph conv (``GraphConvFunction``) against
the JAX package's, on a graph built by both from a seeded point cloud.  On
the CPU the function runs the plain versions of K1 (forward), K3 (``dx``)
and K2 (the column buffer of ``dW``): ``gradcheck`` in float64, and its
gradients against ``jax.grad`` of the XLA conv and of the Pallas conv in
interpret mode, node-type one-hot columns included (rtol = atol = 1e-3, as
``tests/test_pallas_conv.py`` holds the Pallas gradients)."""

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

GRAD_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def graphs():
    jg = make_graph(seed=5, depth=4, full_depth=2, n=200)
    return jg, t_build(port_octree(jg.octree), 9)


def test_graph_conv_function_gradcheck(graphs):
    _, tg = graphs
    lvl = tg.level(2)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(lvl.g_cap, 3, dtype=torch.float64, generator=gen)
    w = torch.randn(7 * 3, 2, dtype=torch.float64, generator=gen)
    fn = lambda x, w: graph_conv_cuda.GraphConvFunction.apply(x, w, lvl)
    assert torch.autograd.gradcheck(fn, (x.requires_grad_(),
                                         w.requires_grad_()))


@pytest.mark.parametrize("path,n_node_type", [("xla", 0), ("pallas", 0),
                                               ("xla", 3)])
def test_graph_conv_grads_match_jax(graphs, path, n_node_type):
    """Gradients of sum((conv(x, w) - tgt)^2) against jax.grad of the XLA
    segment-sum conv or of the Pallas conv (interpret mode)."""
    jg, tg = graphs
    d, c, cout = 3, 8, 16
    jlvl = (with_conv_plans(jg) if path == "pallas" else jg).level(d)
    node_ch = n_node_type if n_node_type > 1 else 0
    rng = np.random.RandomState(4 + n_node_type)
    g = tg.level(d).g_cap
    x = rng.normal(size=(g, c)).astype(np.float32)
    w = (rng.normal(size=(7 * (c + node_ch), cout)) * 0.1).astype(np.float32)
    tgt = rng.normal(size=(g, cout)).astype(np.float32)

    def jloss(x, w, lvl):
        out = jops.graph_conv(x, w, lvl, n_node_type)
        return jnp.sum((out - tgt) ** 2)

    ref_loss, (gx, gw) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(w), jlvl)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = tops.graph_conv(xt, wt, tg.level(d), n_node_type)
    loss = ((out - torch.tensor(tgt)) ** 2).sum()
    n0 = graph_conv_cuda.GraphConvFunction.backward_calls
    loss.backward()
    assert graph_conv_cuda.GraphConvFunction.backward_calls == n0 + 1
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    np.testing.assert_allclose(np_(xt.grad), np_(gx), **GRAD_TOL)
    np.testing.assert_allclose(np_(wt.grad), np_(gw), **GRAD_TOL)
