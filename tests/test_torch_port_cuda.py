"""Card-only tests of the port's CUDA kernels against their plain PyTorch
versions: the graph conv's K1 forward, K2 column buffer, K3 input
gradient and K5 packed forward (with its autograd guard), the
differentiable graph conv on the card, and the Chamfer kernel K4 with the
evaluation's tile loop.  They skip without a GPU; on
one, run them with

    python -m pytest tests/test_torch_port_cuda.py --noconftest -m cuda -q

(``--noconftest`` because the suite's conftest imports JAX, which the GPU
machine does not have).  This file imports no JAX."""

import numpy as np
import pytest
import torch

from octfusion_tpu_torch.octree.dual_graph import (build_dual_graph,
                                                   with_packed_levels)
from octfusion_tpu_torch.octree.octree import OctreeSpec
from octfusion_tpu_torch.octree.split_codec import split2octree_small
from octfusion_tpu_torch.metrics import distances
from octfusion_tpu_torch.ops import chamfer_cuda, graph_conv_cuda, graph_ops

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


@pytest.mark.cuda
@pytest.mark.parametrize("c,cout", [(6, 128), (131, 128), (259, 256),
                                    (515, 512), (38, 32), (128, 3)])
def test_packed_kernel_matches_plain_and_k1(cuda, c, cout):
    """K5 (3xTF32 tensor cores) against its plain version and K1 at levels
    4-6; ragged C (131, 259, 515) cross the 128-column packs."""
    g = _graph(cuda, seed=7)
    gen = torch.Generator(device=cuda).manual_seed(c + 1)
    for d in (4, 5, 6):
        lvl = g.level(d)
        x = torch.randn(lvl.g_cap, c, device=cuda, generator=gen)
        w = torch.randn(7 * c, cout, device=cuda, generator=gen) / (7 * c) ** 0.5
        csr = lvl.csr()
        n0 = dict(graph_conv_cuda.launches)
        got = graph_conv_cuda.graph_conv_packed(x, w, *csr)
        assert graph_conv_cuda.launches["graph_conv_fwd_packed"] == \
            n0["graph_conv_fwd_packed"] + 1
        assert graph_conv_cuda.launches["graph_conv_fwd"] == \
            n0["graph_conv_fwd"]
        ref = graph_conv_cuda.graph_conv_packed_plain(
            x, w, lvl.edge_row, lvl.edge_col, lvl.edge_dir, lvl.edge_scale)
        k1 = graph_conv_cuda.graph_conv(x, w, *csr)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=TOL, atol=TOL)
        torch.testing.assert_close(got, k1, rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_packed_level_dispatch_and_autograd_guard(cuda):
    """On a packed level graph_ops.graph_conv launches K5 (not K1) and
    equals the CPU plain path; under autograd it raises, launching
    nothing."""
    g = with_packed_levels(_graph(cuda, seed=8))
    lvl = g.level(6)
    rng = np.random.RandomState(9)
    x = torch.tensor(rng.normal(size=(lvl.g_cap, 16)).astype(np.float32))
    w = torch.tensor((rng.normal(size=(7 * (16 + 3), 24)) * 0.1).astype(
        np.float32))
    n0 = dict(graph_conv_cuda.launches)
    with torch.no_grad():
        got = graph_ops.graph_conv(x.to(cuda), w.to(cuda), lvl, 3)
    assert graph_conv_cuda.launches["graph_conv_fwd_packed"] == \
        n0["graph_conv_fwd_packed"] + 1
    assert graph_conv_cuda.launches["graph_conv_fwd"] == n0["graph_conv_fwd"]
    ref = graph_ops.graph_conv(x, w, lvl.to("cpu"), 3)
    torch.testing.assert_close(got.cpu(), ref, rtol=TOL, atol=TOL)
    wg = w.to(cuda).requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        graph_ops.graph_conv(x.to(cuda), wg, lvl, 3)
    with pytest.raises(RuntimeError, match="forward-only"):
        graph_conv_cuda.graph_conv_packed(x.to(cuda), wg, *lvl.csr())
    assert graph_conv_cuda.launches["graph_conv_fwd_packed"] == \
        n0["graph_conv_fwd_packed"] + 1


# K4: fp32 clouds in the unit cube, direct form against the plain
# version's expansion, whose cancellation is <= ~1e-7 |a|^2
TOL_CHAMFER = dict(rtol=1e-4, atol=1e-6)


def _clouds(device, case, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    if case == "ragged":   # N != M, neither a multiple of the 128-row tile
        return (torch.rand(2, 700, 3, device=device, generator=gen) - 0.5,
                torch.rand(2, 1100, 3, device=device, generator=gen) - 0.5)
    a = torch.rand(4, 2048, 3, device=device, generator=gen) - 0.5
    return a, a + 1e-3 * torch.randn(a.shape, device=device, generator=gen)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "near_duplicate"])
def test_chamfer_kernel_matches_plain(cuda, case):
    a, b = _clouds(cuda, case)
    n0 = chamfer_cuda.launches["chamfer"]
    got = chamfer_cuda.chamfer(a, b)
    assert chamfer_cuda.launches["chamfer"] == n0 + 1
    ref = chamfer_cuda.chamfer_plain(a, b)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **TOL_CHAMFER)
        assert not torch.signbit(g).any()   # +0.0, never -0.0
    if case == "near_duplicate":
        assert got[0].max() < 1e-4


@pytest.mark.cuda
def test_chamfer_dispatch(cuda, monkeypatch):
    """A CPU tensor never reaches the kernel and a CUDA tensor never
    reaches the plain version."""
    a, b = _clouds("cpu", "ragged")
    n0 = chamfer_cuda.launches["chamfer"]
    cpu = distances.chamfer(a, b)
    assert chamfer_cuda.launches["chamfer"] == n0
    with pytest.raises(ValueError, match="CUDA"):
        chamfer_cuda.chamfer(a, b)

    def no_plain(*args):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(chamfer_cuda, "chamfer_plain", no_plain)
    got = distances.chamfer(a.to(cuda), b.to(cuda))
    assert chamfer_cuda.launches["chamfer"] == n0 + 1
    for g, r in zip(got, cpu):
        torch.testing.assert_close(g.cpu(), r, **TOL_CHAMFER)


@pytest.mark.cuda
def test_chamfer_kernel_rejects_bad_inputs(cuda):
    a, b = _clouds(cuda, "ragged")
    with pytest.raises(TypeError):
        chamfer_cuda.chamfer(a.double(), b.double())
    with pytest.raises(ValueError):
        chamfer_cuda.chamfer(a[..., :2].contiguous(), b[..., :2].contiguous())
    with pytest.raises(ValueError):
        chamfer_cuda.chamfer(a.transpose(0, 1), b)
    with pytest.raises(ValueError):
        chamfer_cuda.chamfer(a, b[:1])
    with pytest.raises(ValueError):
        chamfer_cuda.chamfer(a, b.cpu())


@pytest.mark.cuda
def test_pairwise_on_the_card_matches_cpu(cuda):
    """The padded tile loop on the card: one K4 launch per tile, and the
    same matrices as the CPU path.  EMD at rtol 2e-3: at a few hundred
    points the auction carries float32 rounding (exp, reduction order) to
    ~1e-3 relative, as against the JAX package on the CPU."""
    gen = torch.Generator().manual_seed(3)
    s = torch.rand(5, 256, 3, generator=gen) - 0.5
    r = torch.rand(6, 300, 3, generator=gen) - 0.5
    n0 = chamfer_cuda.launches["chamfer"]
    got = distances.pairwise_cd_emd(s.to(cuda), r.to(cuda), batch=4,
                                    row_block=2)
    assert chamfer_cuda.launches["chamfer"] == n0 + 3 * 2
    ref = distances.pairwise_cd_emd(s, r, batch=4, row_block=2)
    np.testing.assert_allclose(got[0], ref[0], **TOL_CHAMFER)
    np.testing.assert_allclose(got[1], ref[1], rtol=2e-3)
