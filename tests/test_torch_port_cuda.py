"""Card-only tests of the port's CUDA kernels against their plain PyTorch
versions: the graph conv's K1 forward, K2 column buffer, K3 input
gradient and K5 packed forward (all four also on the edge-case level of
``test_torch_port_csr_cases`` and at ragged widths; K5 with its autograd
guard; K2 also on an x that is not 16-byte aligned), the
differentiable graph conv on the card, the per-sample broadcasts'
one-hot GEMM backward against ``index``'s, the MPU corner gathers'
segment-sum backward against ``index``'s at the snet VAE's shapes (and
the ``jvp`` VAE step against the analytic one), the Chamfer kernel K4 with the
evaluation's tile loop, and the solver's fp32 precision (the lr denoise
step, card against CPU); K1 / K2 / K3 at the VAE's odd input widths on
its depth-8 training graph; the VAE and lr train steps card against CPU
on ``configs/synthetic_tiny.yaml``, and the colour VAE's; the
training solvers' default device; data parallelism on the card (two gloo
ranks sharing it, one NCCL rank) and the sharded pairwise loop.  They skip without a GPU; on one, run them with

    python -m pytest tests/test_torch_port_cuda.py --noconftest -m cuda -q

(``--noconftest`` because the suite's conftest imports JAX, which the GPU
machine does not have).  This file imports no JAX."""

import os

import numpy as np
import pytest
import torch

import test_torch_port_csr_cases as csr_cases
from octfusion_tpu_torch.config import Config, load_config
from octfusion_tpu_torch.models.common import batch_to_graph, flatten_pos
from octfusion_tpu_torch.models.union_solver import UnionSolver
from octfusion_tpu_torch.models.vae_solver import VAESolver
from octfusion_tpu_torch.octree.dual_graph import (build_dual_graph,
                                                   with_packed_levels)
from octfusion_tpu_torch.octree.octree import OctreeSpec
from octfusion_tpu_torch.octree.split_codec import split2octree_small
from octfusion_tpu_torch.metrics import distances
from octfusion_tpu_torch.ops import (chamfer_cuda, graph_conv_cuda, graph_ops,
                                     mpu, mpu_gather_cuda)
from octfusion_tpu_torch.utils.shapes import (lumpy_sphere_batch,
                                              lumpy_sphere_sdf_samples)

# fp32 on both sides, different summation order: rtol = atol = 1e-4
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _graph(device, seed=0, depth=8, full_depth=4, batch=1):
    """Depth-6 graph at the default config's caps (G = 4096, 8192, 16384
    a sample) from a random split grid sparse enough to fit them."""
    rng = np.random.RandomState(seed)
    s = 2**full_depth
    split = torch.tensor(
        np.where(rng.rand(batch, s, s, s, 8) < 0.012, 1.0, -1.0).astype(
            np.float32), device=device)
    spec = OctreeSpec.create(depth, full_depth, batch,
                             finest_cap_per_sample=131072, decay=4.0)
    return build_dual_graph(split2octree_small(split, spec), 9,
                            up_to=full_depth + 2)


def _levels(graph, device):
    """Levels 4-6 of ``graph``, then ``csr_cases.synthetic_level``:
    slots of >= 2000 edges in the CSR and the transposed CSR (tile ranges
    walked in 3 staging pieces), row tiles without edges, a tile of light
    slots across two pieces, padding edges, G = 1000 (not a multiple of
    the 64-row tile)."""
    return [graph.level(d) for d in (4, 5, 6)] + [
        csr_cases.synthetic_level(device=device)]


# ragged C and C' (not multiples of 4 or 8: 16-byte copies of W only where
# its rows are aligned, zero-padded k8 tails), C' below the 128-column tile
# (32- and 64-column tiles), and C' = 3 (a 4-byte-copied W)
@pytest.mark.cuda
@pytest.mark.parametrize("c,cout", [(8, 128), (133, 128), (260, 256),
                                    (515, 512), (38, 32), (31, 24),
                                    (131, 128), (259, 256), (516, 512),
                                    (772, 512), (64, 48), (128, 3)])
def test_kernel_matches_plain(cuda, c, cout):
    g = _graph(cuda)
    gen = torch.Generator(device=cuda).manual_seed(c)
    for lvl in _levels(g, cuda):
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


def _unaligned(x):
    """``x``'s values in a contiguous tensor whose data starts 4 bytes past
    a 16-byte boundary."""
    buf = torch.empty(x.numel() + 4, device=x.device)
    off = 1 if buf.data_ptr() % 16 == 0 else 0
    out = buf[off:off + x.numel()].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("c,cout", [(8, 128), (133, 128), (260, 256),
                                    (772, 256), (31, 24), (515, 512),
                                    (131, 131), (516, 512), (48, 64),
                                    (3, 16), (4, 8), (6, 128)])
def test_backward_kernels_match_plain(cuda, c, cout):
    """K2 (column buffer) and K3 (dx over the transposed CSR) against
    their plain versions at levels 4-6 and on the synthetic edge-case
    level (K3's output width is C: 8, 31 and 48 take its 32- and
    64-column tiles; C' = 131 its 4-byte-copied W^T).  K2 at C = 3, 4, 6
    packs many slots into a warp, and at every C also runs on an x that
    is not 16-byte aligned (its 4-float loads, not float4)."""
    g = _graph(cuda, seed=4)
    gen = torch.Generator(device=cuda).manual_seed(c)
    for lvl in _levels(g, cuda):
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
        col_u = graph_conv_cuda.graph_conv_col(_unaligned(x), *lvl.csr())
        torch.cuda.synchronize()
        torch.testing.assert_close(col, col_ref, rtol=TOL, atol=TOL)
        torch.testing.assert_close(dx, dx_ref, rtol=TOL, atol=TOL)
        torch.testing.assert_close(col_u, col, rtol=0, atol=0)


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
                                    (515, 512), (38, 32), (128, 3),
                                    (31, 24), (64, 48), (6, 3)])
def test_packed_kernel_matches_plain_and_k1(cuda, c, cout):
    """K5 (the flat 7C walk, 3xTF32 tensor cores) against its plain
    version and K1 at levels 4-6 and on the synthetic edge-case level
    (slots of >= 2000 edges walked in staging pieces, empty row tiles,
    G = 1000); ragged C (131, 259, 515) put chunks across directions, C =
    6 up to six directions in one chunk; C' = 3, 24, 48 and >= 128 take
    every output-column tile."""
    g = _graph(cuda, seed=7)
    gen = torch.Generator(device=cuda).manual_seed(c + 1)
    for lvl in _levels(g, cuda):
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


def _broadcast_case(op, lvl, gen):
    """(f(*params), params) of one per-sample broadcast at C = 128."""
    b, c, cuda = lvl.spec.ospec.batch_size, 128, lvl.node_mask.device
    x = torch.randn(lvl.g_cap, c, device=cuda, generator=gen) * 3 + 1
    table = torch.randn(b, c, device=cuda, generator=gen)
    if op == "gather":
        idx = lvl.node_batch.clamp(0, b - 1)
        return (lambda t: torch.where(
            lvl.node_mask[:, None], graph_ops._batch_broadcast(t, idx, lvl),
            0.0)), [table]
    if op == "group_norm":
        return (lambda x, s, bias: graph_ops.dual_group_norm(
            x, lvl, s, bias, 32)), [x, 1 + 0.1 * table[0], table[1]]
    return (lambda x, e: graph_ops.add_batch_embedding(x, e, lvl)), [x, table]


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["gather", "group_norm", "embedding"])
def test_batch_broadcast_backward_matches_index(cuda, op, monkeypatch):
    """The per-sample broadcasts' one-hot GEMM backward at published widths
    (C = 128, B = 4, the depth-6 level of a seeded snet-size graph) against
    PyTorch's own ``index`` autograd of the same gather: equal within fp32
    rounding, and two runs equal bit for bit."""
    lvl = _graph(cuda, seed=11, batch=4).level(6)
    assert not bool(lvl.node_mask.all())
    gen = torch.Generator(device=cuda).manual_seed(12)
    f, params = _broadcast_case(op, lvl, gen)
    ct = torch.randn(lvl.g_cap, 128, device=cuda, generator=gen)

    def grads():
        ps = [p.detach().clone().requires_grad_() for p in params]
        (f(*ps) * ct).sum().backward()
        return [p.grad for p in ps]

    n0 = graph_ops._BatchBroadcast.backward_calls
    got, again = grads(), grads()
    assert graph_ops._BatchBroadcast.backward_calls - n0 == 2 * (
        2 if op == "group_norm" else 1)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    monkeypatch.setattr(graph_ops, "_batch_broadcast",
                        lambda t, idx, lvl: t[idx])
    ref = grads()
    assert graph_ops._BatchBroadcast.backward_calls - n0 == 2 * (
        2 if op == "group_norm" else 1)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=TOL,
                                   atol=TOL * r.abs().max().item())


# K4: fp32 clouds in the unit cube, the kernel's expansion (products on
# the tensor cores in split TF32) against the plain version's expansion:
# both carry its cancellation, <= ~1e-7 |a|^2
TOL_CHAMFER = dict(rtol=1e-4, atol=1e-6)
# (B, N, M) of each case; none of the ragged N or M is a multiple of the
# kernel's 128-row block (chamfer_cuda.ROWS_PER_BLOCK), 64-point tile or
# 512-point chunk
CHAMFER_SHAPES = {"ragged": (2, 700, 1100), "near_duplicate": (4, 2048, 2048),
                  "eval_launch": (32, 2048, 2048), "one_row": (3, 1, 517),
                  "one_column": (3, 517, 1), "one_point": (2, 1, 1),
                  "identical": (4, 2048, 2048), "nan": (3, 300, 37),
                  "non_finite": (3, 300, 601)}


def _clouds(device, case, seed=0):
    """Seeded clouds of ``CHAMFER_SHAPES[case]``.  ``near_duplicate``:
    b = a + 1e-3 noise; ``identical``: b = a; ``nan``: a NaN coordinate in
    a[0, 7] and in b[1, 36] (the last point of a partial tile), pair 2
    clean; ``non_finite``: +inf in a[0, 5], 1e20 in a[1, 299] (the last
    row of a partial block), -inf in b[2, 600] (the last point of a
    partial tile) and -1e20 in b[0, 17]."""
    bsz, n, m = CHAMFER_SHAPES[case]
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.rand(bsz, n, 3, device=device, generator=gen) - 0.5
    if case == "near_duplicate":
        return a, a + 1e-3 * torch.randn(a.shape, device=device, generator=gen)
    if case == "identical":
        return a, a.clone()
    b = torch.rand(bsz, m, 3, device=device, generator=gen) - 0.5
    if case == "nan":
        a[0, 7, 2] = float("nan")
        b[1, 36, 0] = float("nan")
    if case == "non_finite":
        a[0, 5, 1] = float("inf")
        a[1, 299, 2] = 1e20
        b[2, 600, 0] = -float("inf")
        b[0, 17, 1] = -1e20
    return a, b


def _check_chamfer(got, ref, case):
    """``got`` equals the plain version's ``ref`` within ``TOL_CHAMFER``,
    NaN and +inf exactly where it has them, and never -0.0 elsewhere (a
    NaN's sign is free)."""
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, equal_nan=True, **TOL_CHAMFER)
        assert not torch.signbit(g[~g.isnan()]).any()   # +0.0, never -0.0
    dl, dr = got
    if case == "near_duplicate":
        assert dl.max() < 1e-4
    if case == "identical":   # the expansion's cancellation, clamped at +0
        assert dl.max() <= 1e-6 and dr.max() <= 1e-6
    if case == "nan":
        # a NaN row makes its dl and all of the pair's dr NaN, a NaN point
        # of b its dr and all of the pair's dl; the padding makes none
        want_l = torch.zeros_like(dl, dtype=torch.bool)
        want_r = torch.zeros_like(dr, dtype=torch.bool)
        want_l[0, 7] = want_l[1] = want_r[0] = want_r[1, 36] = True
        assert torch.equal(dl.isnan(), want_l)
        assert torch.equal(dr.isnan(), want_r)
    if case == "non_finite":
        # an infinite coordinate: NaN or +inf by the products' signs; an
        # overflowing norm: +inf; never a finite value for either
        assert dl[0, 5].isnan() and dr[2, 600].isnan()
        assert dl[1, 299].isinf() and dr[0, 17].isinf()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CHAMFER_SHAPES))
def test_chamfer_kernel_matches_plain(cuda, case):
    a, b = _clouds(cuda, case)
    n0 = chamfer_cuda.launches["chamfer"]
    got = chamfer_cuda.chamfer(a, b)
    assert chamfer_cuda.launches["chamfer"] == n0 + 1
    ref = chamfer_cuda.chamfer_plain(a, b)
    torch.cuda.synchronize()
    _check_chamfer(got, ref, case)


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


@pytest.mark.cuda
def test_solver_computes_lr_step_in_fp32():
    """The repaired fault: ``UnionSolver`` left cuDNN free to run the lr
    U-Net's conv3d in TF32.  With both TF32 flags on before it is built
    (the test sets nothing off), the full-width lr denoise step on the card
    equals the CPU's within fp32 rounding: max error <= 1e-4 of the
    output's max |value|, a bound TF32 convolutions do not meet."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        cfg = Config()
        torch.manual_seed(0)
        cpu = UnionSolver(cfg, device="cpu")
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in cpu.df.unet_lr.parameters():    # no zero layer
                p.add_(0.02 * torch.randn(p.shape, generator=gen))
        card = UnionSolver(cfg, device="cuda")
        card.df.load_state_dict(cpu.df.state_dict())
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        s = 2**cfg.model.full_depth
        x = torch.randn(1, s, s, s, 8, generator=gen)
        t = cpu.log_snr(torch.tensor([0.5]))
        with torch.no_grad():
            ref = cpu.df("lr", x, t, x_self_cond=torch.zeros_like(x))
            got = card.df("lr", x.cuda(), t.cuda(),
                          x_self_cond=torch.zeros_like(x).cuda()).cpu()
        scale = ref.abs().max().item()
        assert scale > 0
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * scale)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ----------------------------------------------------------------------
# VAE and lr training
# ----------------------------------------------------------------------
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


@pytest.fixture(scope="module")
def vae_graph():
    """The VAE's batch-2 training graph on the card: two 65536-point lumpy
    spheres at the caps of ``configs/octfusion_snet_uncond.yaml`` (levels
    4-8; level 8 has ~3.6e5 vertices)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    cfg = load_config(os.path.join(CONFIGS, "octfusion_snet_uncond.yaml"))
    batch = lumpy_sphere_batch(2, 65536, 8, seed=0, device="cuda")
    spec = cfg.capacity.octree_spec(8, 4, 1)
    g = batch_to_graph(batch["points"], batch["normals"], spec,
                       cfg.capacity.edge_factor)[1]
    assert not g.any_overflow().item()
    return g


# the VAE's graph convs: C = channels + node types, none a multiple of 4
# (the colour VAE's conv1: 4 ND + 3 RGB + 7 node types = 14)
@pytest.mark.cuda
@pytest.mark.parametrize("d,c,cout", [(8, 11, 24), (8, 31, 24),
                                      (7, 38, 32), (6, 37, 32),
                                      (8, 14, 24)])
def test_kernels_match_plain_at_vae_shapes(cuda, vae_graph, d, c, cout):
    """K1, K2 and K3 against their plain versions at the VAE's (level, C,
    C'), and at the same widths on the synthetic edge-case level (G =
    1000, not a multiple of the 64-row tile; slots of >= 2000 edges)."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    for lvl in (vae_graph.level(d), csr_cases.synthetic_level(device=cuda)):
        edges = (lvl.edge_row, lvl.edge_col, lvl.edge_dir, lvl.edge_scale)
        x = torch.randn(lvl.g_cap, c, device=cuda, generator=gen)
        dout = torch.randn(lvl.g_cap, cout, device=cuda, generator=gen)
        w = torch.randn(7 * c, cout, device=cuda, generator=gen) / (7 * c) ** 0.5
        got = (graph_conv_cuda.graph_conv(x, w, *lvl.csr()),
               graph_conv_cuda.graph_conv_col(x, *lvl.csr()),
               graph_conv_cuda.graph_conv_bwd_dx(dout, w, *lvl.csr_t()))
        ref = (graph_conv_cuda.graph_conv_plain(x, w, *edges),
               graph_conv_cuda.graph_conv_col_plain(x, *edges),
               graph_conv_cuda.graph_conv_bwd_dx_plain(dout, w, *edges))
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert b.abs().max() > 0
            torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


def _tiny_config():
    return load_config(os.path.join(CONFIGS, "synthetic_tiny.yaml"))


def _perturbed(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return module


def _step_card_vs_cpu(solvers, net, loss_fn):
    """One step's loss terms and gradients on each solver -> compared:
    the terms and every gradient to 1e-3, each leaf's largest error within
    1e-4 of its largest |gradient| (fp32, another summation order).  A
    leaf whose exact gradient is zero (the tiny lr U-Net's conv biases and
    time shifts before a per-channel norm) holds rounding noise on both
    sides: below 1e-5 of the step's largest gradient, it must stay below
    that on both."""
    res = []
    for s in solvers:
        net(s).train()
        loss, terms = loss_fn(s)
        loss.backward()
        res.append(({k: float(v.detach()) for k, v in terms.items()},
                    {n: p.grad.cpu() for n, p in net(s).named_parameters()}))
    (t_card, g_card), (t_cpu, g_cpu) = res
    assert sorted(t_card) == sorted(t_cpu)
    for k in t_cpu:
        assert t_card[k] == pytest.approx(t_cpu[k], rel=1e-3, abs=1e-3), k
    floor = 1e-5 * max(g.abs().max().item() for g in g_cpu.values())
    for n, g in g_cpu.items():
        torch.testing.assert_close(g_card[n], g, rtol=1e-3, atol=1e-3,
                                   msg=n)
        scale = g.abs().max().item()
        if scale <= floor:
            assert g_card[n].abs().max().item() <= floor, n
            continue
        assert (g_card[n] - g).abs().max().item() <= 1e-4 * scale, n


@pytest.mark.cuda
def test_vae_train_step_card_matches_cpu(cuda):
    cfg = _tiny_config()
    cpu = VAESolver(cfg, device="cpu")
    _perturbed(cpu.vae, 1)
    card = VAESolver(cfg)
    card.vae.load_state_dict(cpu.vae.state_dict())
    batch = lumpy_sphere_batch(2, 2048, 256, seed=2)
    eps = torch.randn(cpu.code_shape(2),
                      generator=torch.Generator().manual_seed(3))
    n0 = dict(graph_conv_cuda.launches)
    _step_card_vs_cpu(
        (card, cpu), lambda s: s.vae,
        lambda s: s.loss_fn({k: v.to(s.device) for k, v in batch.items()},
                            eps=eps.to(s.device)))
    for name in ("graph_conv_fwd", "graph_conv_col", "graph_conv_bwd_dx"):
        assert graph_conv_cuda.launches[name] > n0[name], name


@pytest.mark.cuda
def test_lr_train_step_card_matches_cpu(cuda):
    import dataclasses

    cfg = _tiny_config()
    cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(
        cfg.diffusion, lr_pos_weight=1.75))
    cpu = UnionSolver(cfg, stage_flag="lr", device="cpu")
    _perturbed(cpu.df, 4)
    card = UnionSolver(cfg, stage_flag="lr")
    card.df.load_state_dict(cpu.df.state_dict())
    batch = lumpy_sphere_batch(2, 2048, 8, seed=5)
    gen = torch.Generator().manual_seed(6)
    s = 2**cfg.model.full_depth
    draws = {"times": torch.rand(2, generator=gen),
             "noise": torch.randn(2, s, s, s, 8, generator=gen)}
    _step_card_vs_cpu(
        (card, cpu), lambda s: s.df,
        lambda s: s.loss_fn({k: batch[k].to(s.device)
                             for k in ("points", "normals")},
                            **{k: v.to(s.device) for k, v in draws.items()}))


@pytest.mark.cuda
def test_training_solvers_default_to_the_card(cuda):
    cfg = _tiny_config()
    assert VAESolver(cfg).device.type == "cuda"
    assert next(VAESolver(cfg).vae.parameters()).is_cuda
    lr = UnionSolver(cfg, stage_flag="lr")
    assert lr.device.type == "cuda" and next(lr.df.parameters()).is_cuda


@pytest.mark.cuda
def test_color_vae_train_step_card_matches_cpu(cuda):
    import dataclasses

    cfg = _tiny_config()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, channel_in=7),
        loss=dataclasses.replace(cfg.loss, name="color"))
    cpu = VAESolver(cfg, device="cpu")
    _perturbed(cpu.vae, 7)
    card = VAESolver(cfg)
    card.vae.load_state_dict(cpu.vae.state_dict())
    batch = lumpy_sphere_batch(2, 2048, 256, seed=8, colors=True)
    eps = torch.randn(cpu.code_shape(2),
                      generator=torch.Generator().manual_seed(9))
    _step_card_vs_cpu(
        (card, cpu), lambda s: s.vae,
        lambda s: s.loss_fn({k: v.to(s.device) for k, v in batch.items()},
                            eps=eps.to(s.device)))


# ----------------------------------------------------------------------
# the MPU corner gathers' segment-sum backward
# ----------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 3])
def test_corner_gather_backward_matches_index(cuda, vae_graph, c):
    """``_CornerGather``'s segment-sum backward at the snet VAE's shapes:
    the batch-2 depth-8 octree of ``vae_graph``, 100000 queries (the
    shapes' 50000 SDF samples each, half of them uniform in the cube, so
    node 0 takes the misses: 52-81% of the slots at depths 5-8, and nodes
    that no query reaches), every depth 4-8, C = 4
    (planes) and C = 3 (``mpu_interp``'s colours), against PyTorch's own
    ``index`` autograd of the same gather: equal within fp32 rounding, two
    runs equal bit for bit, a NaN in a masked slot reaching its node (node
    0 for a missing corner) on both,
    one backward and one launch counted per call."""
    octree = vae_graph.octree
    pos, pb = flatten_pos(lumpy_sphere_sdf_samples(
        2, 50000, 0, points_per_shape=65536, device=cuda)["pos"])
    gen = torch.Generator(device=cuda).manual_seed(21)
    n0 = (mpu._CornerGather.backward_calls,
          mpu_gather_cuda.launches["corner_gather_bwd"])
    for dd in range(4, 9):
        corners = mpu.Corners(octree, dd, pos, pb)
        flat = corners.idx_c.reshape(-1)
        counts = torch.bincount(flat, minlength=corners.n_nodes)
        if dd > 4:      # depth 4 is full: every node is some query's corner
            assert int((counts == 0).sum()) > 0, dd
        if dd == 8:     # node 0 holds most slots
            assert int(counts.argmax()) == 0
            assert int(counts[0]) > flat.shape[0] // 2
        table = torch.randn(corners.n_nodes, c, device=cuda, generator=gen)
        ct = torch.randn(flat.shape[0], c, device=cuda, generator=gen)

        def grad(gather, ct=ct):
            t = table.clone().requires_grad_()
            (gather(t) * ct).sum().backward()
            return t.grad

        got, again = grad(corners.gather), grad(corners.gather)
        assert torch.equal(got, again), dd
        ref = grad(lambda t: t[flat])
        torch.testing.assert_close(got, ref, rtol=TOL,
                                   atol=TOL * ref.abs().max().item(),
                                   msg=f"depth {dd}")
        # a NaN in a masked slot: a missing corner's (clamped to node 0)
        # where depth 4, which is full, has only out-of-bounds ones
        masked = ~corners.valid.reshape(-1)
        miss = torch.nonzero(masked & (flat == 0))[:, 0]
        slot = int(miss[0] if dd > 4 else torch.nonzero(masked)[0, 0])
        node = int(flat[slot])
        ct_nan = ct.clone()
        ct_nan[slot, 1] = float("nan")
        for g in (grad(corners.gather, ct_nan), grad(lambda t: t[flat],
                                                     ct_nan)):
            assert torch.isnan(g[node, 1]), dd
            assert int(torch.isnan(g).sum()) == 1, dd
    assert (mpu._CornerGather.backward_calls - n0[0],
            mpu_gather_cuda.launches["corner_gather_bwd"] - n0[1]) == (15, 15)


@pytest.mark.cuda
def test_vae_train_step_jvp_matches_analytic_on_the_card(cuda):
    """One VAE step on the card with ``spatial_grad="jvp"`` (three
    ``torch.func.jvp`` passes, through ``_CornerGather``'s ``jvp`` rule)
    against ``"analytic"``: every loss term and gradient as the card and
    CPU steps agree; 5 corner-gather backwards an analytic step of the tiny
    configuration (target depths 3-4 over depths 2-4), 20 a jvp step."""
    import dataclasses

    cfg = _tiny_config()
    base = _perturbed(VAESolver(cfg, device="cpu").vae, 1)
    solvers = []
    for spatial_grad in ("analytic", "jvp"):
        s = VAESolver(dataclasses.replace(cfg, loss=dataclasses.replace(
            cfg.loss, spatial_grad=spatial_grad)))
        s.vae.load_state_dict(base.state_dict())
        solvers.append(s)
    batch = lumpy_sphere_batch(2, 2048, 256, seed=2)
    eps = torch.randn(solvers[0].code_shape(2),
                      generator=torch.Generator().manual_seed(3))
    n0 = mpu._CornerGather.backward_calls
    _step_card_vs_cpu(
        solvers, lambda s: s.vae,
        lambda s: s.loss_fn({k: v.to(s.device) for k, v in batch.items()},
                            eps=eps.to(s.device)))
    assert mpu._CornerGather.backward_calls - n0 == 25


@pytest.mark.cuda
def test_sharded_pairwise_on_the_card_is_bit_identical(cuda):
    gen = torch.Generator(device=cuda).manual_seed(10)
    a = torch.rand(13, 512, 3, device=cuda, generator=gen) - 0.5
    b = torch.rand(9, 512, 3, device=cuda, generator=gen) - 0.5
    cd1, em1 = distances.pairwise_cd_emd(a, b, batch=4, row_block=2)
    cd2, em2 = distances.pairwise_cd_emd(a, b, batch=4, row_block=2,
                                         shard_devices=["cuda:0", "cuda:0"])
    assert np.array_equal(cd1, cd2) and np.array_equal(em1, em2)


def _dp_rank_on_card(rank):
    """A tiny VAE DP step on two gloo ranks sharing cuda:0 -> (the
    averaged loss, bit digests of the updated parameters)."""
    from octfusion_tpu_torch.parallel import dist as pdist
    from octfusion_tpu_torch.parallel import train_step as pts
    from octfusion_tpu_torch.parallel.mesh import make_mesh

    dev = pdist.local_device("cuda")
    solver = VAESolver(_tiny_config(), device=dev)
    mesh = make_mesh()
    step = pts.make_vae_dp_train_step(solver, mesh, 10)
    batch = lumpy_sphere_batch(2, 2048, 256, seed=11, device=dev)
    out = step(pts.shard_batch(batch, mesh, vae=True))
    digest = [int(p.detach().view(torch.int32).long().sum())
              for p in solver.vae.parameters()]
    return float(out["loss"]), digest, str(dev)


def _nccl_rank(rank):
    import torch.distributed as tdist

    t = torch.full((3,), 2.0, device="cuda")
    tdist.all_reduce(t)
    return tdist.get_backend(), t.tolist()


@pytest.mark.cuda
def test_data_parallel_on_the_card(cuda):
    """Two gloo ranks on the one card take a VAE DP step and end with the
    same parameters; one NCCL rank (the default backend on a card)
    reduces a CUDA tensor."""
    from octfusion_tpu_torch.parallel import launch

    r0, r1 = launch.spawn(_dp_rank_on_card, 2, backend="gloo",
                          device="cuda", timeout=300)
    assert r0 == r1 and np.isfinite(r0[0]) and r0[2] == "cuda:0"
    (backend, vals), = launch.spawn(_nccl_rank, 1, backend=None,
                                    device="cuda", timeout=300)
    assert backend == "nccl" and vals == [2.0, 2.0, 2.0]


def _lumpy_mesh(seed, grid):
    """A lumpy sphere marched on a ``grid``³ field -> (verts, faces)."""
    from octfusion_tpu_torch.utils import mesh as mesh_utils
    from octfusion_tpu_torch.utils.shapes import lumpy_sphere_fields

    v, f = mesh_utils.marching_tetrahedra(lumpy_sphere_fields(1, grid,
                                                              seed)[0])
    return v.numpy(), f.numpy()


@pytest.mark.cuda
def test_raster_and_standin_features_card_match_cpu(cuda):
    """Two meshes x 20 views at 299² (phase 23's check): the card's images
    equal the CPU's within 1e-6 on >= 99.9% of the pixels (the same
    float64 operations), the stand-in features within rtol 1e-4 / atol
    1e-5."""
    from octfusion_tpu_torch.metrics import fid, render

    for seed in (1, 2):
        v, f = _lumpy_mesh(seed, 64)
        card = render.render_mesh_views_raster(v, f, device=cuda)
        cpu = render.render_mesh_views_raster(v, f, device="cpu")
        assert card.shape == (20, 299, 299) and (card > 0).mean() > 0.1
        assert (np.abs(card - cpu) <= 1e-6).mean() >= 0.999
        np.testing.assert_allclose(
            fid.standin_feature_extractor(device=cuda)(card),
            fid.standin_feature_extractor(device="cpu")(card),
            rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_prepare_dataset_card_matches_cpu(cuda, tmp_path):
    """One mesh, 4096 queries (phase 24's check): the nearest sample's
    distance within 1e-6 and the same index except at a tie (both
    indices' distances equal to 1e-12), winding numbers within 1e-4 and
    the same sign wherever |w - 0.5| > 1e-3; ``mesh_to_shards`` writes
    the same surface samples and queries from the card."""
    from octfusion_tpu_torch.tools import prepare_dataset as prep
    from octfusion_tpu_torch.utils import mesh as mesh_utils

    v, f = _lumpy_mesh(3, 64)
    path = str(tmp_path / "m.obj")
    mesh_utils.save_obj(path, v, f)
    for name, dev in (("card", cuda), ("cpu", "cpu")):
        prep.mesh_to_shards(path, str(tmp_path / name), n_surface=20000,
                            n_sdf=4096, device=dev)
    card, cpu = (np.load(tmp_path / d / "sdf.npz") for d in ("card", "cpu"))
    np.testing.assert_array_equal(card["points"], cpu["points"])
    np.testing.assert_array_equal(
        np.load(tmp_path / "card" / "pointcloud.npz")["points"],
        np.load(tmp_path / "cpu" / "pointcloud.npz")["points"])
    surf = np.load(tmp_path / "cpu" / "pointcloud.npz")["points"]
    q = cpu["points"]
    d_card, i_card = prep.nearest_surface(q, surf, device=cuda)
    d_cpu, i_cpu = prep.nearest_surface(q, surf, device="cpu")
    np.testing.assert_allclose(d_card, d_cpu, rtol=0, atol=1e-6)
    moved = i_card != i_cpu
    q64, s64 = q.astype(np.float64), surf.astype(np.float64)
    gap = np.abs(((q64[moved] - s64[i_card[moved]]) ** 2).sum(-1)
                 - ((q64[moved] - s64[i_cpu[moved]]) ** 2).sum(-1))
    assert (gap <= 1e-12).all()
    vv, ff = mesh_utils.load_obj(path)
    vv = prep.normalize_mesh(vv)
    w_card = prep.winding_number(vv, ff, q, device=cuda)
    w_cpu = prep.winding_number(vv, ff, q, device="cpu")
    np.testing.assert_allclose(w_card, w_cpu, rtol=0, atol=1e-4)
    clear = np.abs(w_cpu - 0.5) > 1e-3
    assert ((w_card > 0.5) == (w_cpu > 0.5))[clear].all()
    assert 0.05 < (w_cpu > 0.5).mean() < 0.95
    np.testing.assert_array_equal(np.sign(card["sdf"])[clear],
                                  np.sign(cpu["sdf"])[clear])
    np.testing.assert_allclose(card["sdf"][clear], cpu["sdf"][clear],
                               rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# the bf16 kernels (compute_dtype: bfloat16)
# ----------------------------------------------------------------------
# bf16 kernel against its plain version: each rounds its fp32 sums to bf16
# (the column buffer, the output) in another order, so an element may sit
# a bf16 ulp (2^-8) off on either side: rtol two ulps, atol two ulps of the
# reference's largest magnitude.  K3's plain version rounds dout W_d^T (the
# Pallas order) where the kernel rounds the gathered dout, C' products
# apart: atol four ulps of the largest magnitude
TOL_BF16 = 2.0**-7
TOL_K3_BF16 = 2.0**-6


def assert_close_bf16(got, ref, what="", atol_share=TOL_BF16):
    assert got.dtype == ref.dtype == torch.bfloat16, what
    scale = ref.float().abs().max().item()
    assert scale > 0, what
    torch.testing.assert_close(got.float(), ref.float(), rtol=TOL_BF16,
                               atol=atol_share * scale, msg=what)


# the snet hr U-Net's bf16 convs with their node-type columns ((3 + 5,
# 128), (128 + 5, 128), (128 + 4, 128), (128 + 4, 256), (256 + 4, 256)),
# a narrow C, ragged C and C' and a 3-column output
@pytest.mark.cuda
@pytest.mark.parametrize("c,cout", [(8, 128), (133, 128), (132, 128),
                                    (132, 256), (260, 256), (3, 16),
                                    (6, 3), (31, 24)])
def test_bf16_kernels_match_plain(cuda, c, cout):
    """K1, K5, K2 and K3 on bf16 operands (their ``_bf16`` entry points)
    against the plain versions' Pallas arithmetic at levels 4-6 and on the
    synthetic edge-case level (slots of >= 2000 edges in both CSRs, empty
    row tiles, G = 1000)."""
    g = _graph(cuda, seed=10)
    gen = torch.Generator(device=cuda).manual_seed(c + 2)
    bf = torch.bfloat16
    for lvl in _levels(g, cuda):
        edges = (lvl.edge_row, lvl.edge_col, lvl.edge_dir, lvl.edge_scale)
        csr, csr_t = lvl.csr(), lvl.csr_t()
        x = torch.randn(lvl.g_cap, c, device=cuda, generator=gen).to(bf)
        dout = torch.randn(lvl.g_cap, cout, device=cuda, generator=gen).to(bf)
        w = (torch.randn(7 * c, cout, device=cuda, generator=gen)
             / (7 * c) ** 0.5).to(bf)
        n0 = dict(graph_conv_cuda.launches)
        got = {"k1": graph_conv_cuda.graph_conv(x, w, *csr),
               "k5": graph_conv_cuda.graph_conv_packed(x, w, *csr),
               "k2": graph_conv_cuda.graph_conv_col(x, *csr),
               "k3": graph_conv_cuda.graph_conv_bwd_dx(dout, w, *csr_t)}
        for name in ("graph_conv_fwd", "graph_conv_fwd_packed",
                     "graph_conv_col", "graph_conv_bwd_dx"):
            assert graph_conv_cuda.launches[name + "_bf16"] == \
                n0[name + "_bf16"] + 1, name
            assert graph_conv_cuda.launches[name] == n0[name], name
        ref = {"k1": graph_conv_cuda.graph_conv_plain(x, w, *edges),
               "k5": graph_conv_cuda.graph_conv_packed_plain(x, w, *edges),
               "k2": graph_conv_cuda.graph_conv_col_plain(x, *edges),
               "k3": graph_conv_cuda.graph_conv_bwd_dx_plain(dout, w, *edges)}
        torch.cuda.synchronize()
        for k in got:
            assert_close_bf16(got[k], ref[k], f"{k} level "
                              f"{getattr(lvl, 'd', 'synthetic')} C={c} "
                              f"C'={cout}",
                              TOL_K3_BF16 if k == "k3" else TOL_BF16)


@pytest.mark.cuda
def test_bf16_kernels_refuse_mixed_dtypes(cuda):
    lvl = _graph(cuda, seed=3).level(5)
    x = torch.zeros(lvl.g_cap, 8, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(56, 8, device=cuda)
    with pytest.raises(TypeError):
        graph_conv_cuda.graph_conv(x, w, *lvl.csr())
    with pytest.raises(TypeError):
        graph_conv_cuda.graph_conv_bwd_dx(x, w, *lvl.csr_t())
    with pytest.raises(TypeError, match="w has dtype"):
        graph_ops.graph_conv(x, w, lvl)


@pytest.mark.cuda
def test_bf16_hr_unet_card_matches_cpu(cuda):
    """The tiny config's hr U-Net with ``compute_dtype: bfloat16``: the
    card (bf16 kernels, launched) against the CPU (plain versions) within
    twice the CPU's own bf16-vs-fp32 gap; its gradients too."""
    import dataclasses

    from octfusion_tpu_torch.nn.unet_union import UNetUnion
    from octfusion_tpu_torch.utils.shapes import lumpy_spheres

    cfg = _tiny_config()
    cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(
        cfg.diffusion, compute_dtype="bfloat16"))
    solver = UnionSolver(cfg, device="cpu")
    net = _perturbed(solver.df, 0)
    f32 = UNetUnion(dataclasses.replace(solver.union_cfg,
                                        compute_dtype="float32"), "hr")
    f32.load_state_dict(net.state_dict())
    pts, nrm = lumpy_spheres(1, 2048, seed=1)
    g = solver.batch_graph({"points": pts, "normals": nrm})
    lvl = g.level(solver.small_depth)
    x = torch.randn(lvl.g_cap, cfg.model.embed_dim,
                    generator=torch.Generator().manual_seed(2))
    t = torch.tensor([0.4])
    outs, grads = [], []
    for model, dev in ((net, "cpu"), (f32, "cpu"), (net, cuda)):
        model.to(dev).zero_grad()
        n0 = graph_conv_cuda.launches["graph_conv_fwd_bf16"]
        out = model("hr", x.to(dev), t.to(dev), g=g.to(dev))
        (out ** 2).sum().backward()
        if dev != "cpu":
            assert graph_conv_cuda.launches["graph_conv_fwd_bf16"] > n0
        outs.append(out.detach().cpu().clone())
        grads.append({n: p.grad.detach().cpu().clone()
                      for n, p in model.named_parameters()
                      if p.grad is not None})
    cpu, cpu32, card = outs
    gap = (cpu - cpu32).abs().max().item()
    assert card.dtype == torch.float32 and gap > 0
    assert (card - cpu).abs().max().item() <= 2 * gap
    for n, gr in grads[0].items():
        leaf_gap = (gr - grads[1][n]).abs().max().item()
        floor = 1e-6 * max(v.abs().max().item() for v in grads[0].values())
        assert (grads[2][n] - gr).abs().max().item() <= 2 * leaf_gap + floor, n
