"""Card-only tests of the port's CUDA graph-conv kernels (K1 forward, K2
column buffer, K3 input gradient) against their plain PyTorch versions,
and of the differentiable graph conv on the card.  They skip without a
GPU; on one, run them with

    python -m pytest tests/test_torch_port_cuda.py --noconftest -m cuda -q

(``--noconftest`` because the suite's conftest imports JAX, which the GPU
machine does not have).  This file imports no JAX."""

import numpy as np
import pytest
import torch

from octfusion_tpu_torch.octree.dual_graph import build_dual_graph
from octfusion_tpu_torch.octree.octree import OctreeSpec
from octfusion_tpu_torch.octree.split_codec import split2octree_small
from octfusion_tpu_torch.ops import graph_conv_cuda, graph_ops

# fp32 on both sides, different summation order: rtol = atol = 1e-4
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _graph(device, seed=0, depth=8, full_depth=4):
    """Depth-6 graph at the default config's caps (G = 4096, 8192, 16384)
    from a random split grid sparse enough to fit them."""
    rng = np.random.RandomState(seed)
    s = 2**full_depth
    split = torch.tensor(
        np.where(rng.rand(1, s, s, s, 8) < 0.012, 1.0, -1.0).astype(np.float32),
        device=device)
    spec = OctreeSpec.create(depth, full_depth, 1,
                             finest_cap_per_sample=131072, decay=4.0)
    return build_dual_graph(split2octree_small(split, spec), 9,
                            up_to=full_depth + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("c,cout", [(8, 128), (133, 128), (260, 256),
                                    (515, 512), (38, 32), (31, 24)])
def test_kernel_matches_plain(cuda, c, cout):
    g = _graph(cuda)
    gen = torch.Generator(device=cuda).manual_seed(c)
    for d in (4, 5, 6):
        lvl = g.level(d)
        x = torch.randn(lvl.g_cap, c, device=cuda, generator=gen)
        w = torch.randn(7 * c, cout, device=cuda, generator=gen) / (7 * c) ** 0.5
        row_ptr, col, scale = lvl.csr()
        n0 = graph_conv_cuda.launches["graph_conv_fwd"]
        got = graph_conv_cuda.graph_conv(x, w, row_ptr, col, scale)
        assert graph_conv_cuda.launches["graph_conv_fwd"] == n0 + 1
        ref = graph_conv_cuda.graph_conv_plain(
            x, w, lvl.edge_row, lvl.edge_col, lvl.edge_dir, lvl.edge_scale)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_graph_conv_dispatch_and_cpu_parity(cuda):
    """graph_ops.graph_conv on the card (kernel) equals it on the CPU
    (plain), node-type one-hot included."""
    g = _graph(cuda, seed=1)
    lvl = g.level(6)
    rng = np.random.RandomState(2)
    x = rng.normal(size=(lvl.g_cap, 16)).astype(np.float32)
    w = (rng.normal(size=(7 * (16 + 5), 24)) * 0.1).astype(np.float32)
    n0 = graph_conv_cuda.launches["graph_conv_fwd"]
    got = graph_ops.graph_conv(torch.tensor(x, device=cuda),
                               torch.tensor(w, device=cuda), lvl, 5)
    assert graph_conv_cuda.launches["graph_conv_fwd"] == n0 + 1
    ref = graph_ops.graph_conv(torch.tensor(x), torch.tensor(w),
                               lvl.to("cpu"), 5)
    torch.testing.assert_close(got.cpu(), ref, rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("c,cout", [(8, 128), (133, 128), (260, 256),
                                    (772, 256), (31, 24)])
def test_backward_kernels_match_plain(cuda, c, cout):
    """K2 (column buffer) and K3 (dx over the transposed CSR) against
    their plain versions at levels 4-6."""
    g = _graph(cuda, seed=4)
    gen = torch.Generator(device=cuda).manual_seed(c)
    for d in (4, 5, 6):
        lvl = g.level(d)
        edges = (lvl.edge_row, lvl.edge_col, lvl.edge_dir, lvl.edge_scale)
        x = torch.randn(lvl.g_cap, c, device=cuda, generator=gen)
        dout = torch.randn(lvl.g_cap, cout, device=cuda, generator=gen)
        w = torch.randn(7 * c, cout, device=cuda, generator=gen) / (7 * c) ** 0.5
        n0 = dict(graph_conv_cuda.launches)
        col = graph_conv_cuda.graph_conv_col(x, *lvl.csr())
        dx = graph_conv_cuda.graph_conv_bwd_dx(dout, w, *lvl.csr_t())
        assert graph_conv_cuda.launches["graph_conv_col"] == \
            n0["graph_conv_col"] + 1
        assert graph_conv_cuda.launches["graph_conv_bwd_dx"] == \
            n0["graph_conv_bwd_dx"] + 1
        col_ref = graph_conv_cuda.graph_conv_col_plain(x, *edges)
        dx_ref = graph_conv_cuda.graph_conv_bwd_dx_plain(dout, w, *edges)
        torch.cuda.synchronize()
        torch.testing.assert_close(col, col_ref, rtol=TOL, atol=TOL)
        torch.testing.assert_close(dx, dx_ref, rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_graph_conv_is_differentiable_on_the_card(cuda):
    """The repaired fault: on a CUDA tensor the graph conv used to return a
    tensor without ``grad_fn``, so a loss through it gave no gradient
    upstream.  Now its dx and dW match the CPU plain path's autograd."""
    g = _graph(cuda, seed=5)
    lvl = g.level(5)
    rng = np.random.RandomState(6)
    x = rng.normal(size=(lvl.g_cap, 32)).astype(np.float32)
    w = (rng.normal(size=(7 * (32 + 4), 48)) * 0.1).astype(np.float32)
    tgt = rng.normal(size=(lvl.g_cap, 48)).astype(np.float32)
    grads = []
    for dev, level in ((cuda, lvl), ("cpu", lvl.to("cpu"))):
        xt = torch.tensor(x, device=dev).requires_grad_()
        wt = torch.tensor(w, device=dev).requires_grad_()
        out = graph_ops.graph_conv(xt, wt, level, 4)
        assert out.grad_fn is not None
        ((out - torch.tensor(tgt, device=dev)) ** 2).sum().backward()
        grads.append((xt.grad.cpu(), wt.grad.cpu()))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-3)
    assert grads[0][0].abs().sum() > 0


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    g = _graph(cuda, seed=3)
    lvl = g.level(5)
    row_ptr, col, scale = lvl.csr()
    x = torch.zeros(lvl.g_cap, 8, device=cuda)
    w = torch.zeros(56, 8, device=cuda)
    with pytest.raises(TypeError):
        graph_conv_cuda.graph_conv(x.double(), w, row_ptr, col, scale)
    with pytest.raises(ValueError):
        graph_conv_cuda.graph_conv(x, w[:55], row_ptr, col, scale)
    with pytest.raises(ValueError):
        graph_conv_cuda.graph_conv(x.t(), w, row_ptr, col, scale)
