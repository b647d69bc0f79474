"""Fused graph convolution on Hopper, forward and backward.

The forward computes ``out = col(x) @ W`` with

    col[r, d*C:(d+1)*C] = sum over edges (r, c, d) of scale_e * x[c]
    out = col @ W            x [G, C], W [7C, C'], out [G, C']

and ``scale_e = 1/|edges of (r, d)|``, i.e. a scatter-mean over
neighbours followed by the trailing GEMM.  Four hand-written CUDA kernels
(``csrc/graph_conv.cu``) replace the four Pallas kernels of
``octfusion_tpu/ops/pallas/graph_conv_kernel.py``:

* K1 ``graph_conv_fwd`` (replaces ``_fwd_kernel``): the forward, without
  ever writing the [G, 7C] column buffer to device memory;
* K2 ``graph_conv_col`` (replaces ``_col_kernel``): the column buffer
  alone, recomputed in the backward for ``dW = col(x)^T dout``;
* K3 ``graph_conv_bwd_dx`` (replaces ``_bwd_kernel``):
  ``dx = sum_d A_d^T (dout W_d^T)``, which it evaluates as
  ``sum_d (A_d^T dout) W_d^T`` over the transposed CSR
  (``GraphLevel.csr_t``), forming the product with ``W_d^T`` in its own
  body as the TPU kernel does;
* K5 ``graph_conv_fwd_packed`` (replaces ``_fwd_kernel_packed``): K1's
  function, forward only, for the levels that
  ``dual_graph.with_packed_levels`` marks (sampling graphs).  The TPU
  kernel merges 4 gathered blocks into one matrix-unit issue, a reason a
  GPU does not have; K5 is K1's template walking the flat 7C axis of the
  column buffer in chunks of 32 columns (a chunk may span directions), so
  a ragged or narrow C pads only the last chunk, not every direction's.
  Like the JAX ``graph_conv_packed`` it has no backward: where autograd
  would need one it raises (:func:`packed_forward`).

:class:`GraphConvFunction` ties them together as the JAX package's
``custom_vjp`` does (``graph_conv_kernel.py:259-287``); ``dW``'s product
itself is one ``torch.matmul``, as it is an XLA einsum outside Pallas
there.

The TPU kernels turn the gathers into one-hot matmuls over a descriptor
plan because the TPU has no fast per-row gather.  Hopper has one, so the
CUDA kernels read the CSR the sorted edge list already implies
(``GraphLevel.csr``) or its transpose.  K1, K3 and K5 share one
gather-GEMM template: a block stages its 64-row tile's CSR slice in
shared memory once (in pieces of 1024 edges where it is longer), gathers
[64, 32] chunks of the column buffer from it (the neighbour loads of the
next chunk and W's next chunk, by ``cp.async``, in flight under the math)
and multiplies each by up to 128 columns of W on the tensor cores in the
3xTF32 split, which keeps fp32 accuracy.  What bounds them on an H100:
the ``mma.sync`` TF32 rate with the split's extra instructions, and the
gather and W staging, which overlap the math only in part.  K2 is bound
by its bytes, most of them the G x 7C write: a block owns a stretch of
whole slots, stages its CSR slice once, and streams the stretch out in
16-byte stores, 4 channels a thread (several slots a warp at a narrow
C).  wgmma, TMA and bf16 are later work.

Beside each kernel sits its plain PyTorch version (gather, scale,
``index_add_``; for K1 and K3 a GEMM).  The wrappers take the plain
versions only for CPU tensors; a CUDA tensor launches the kernel or
raises.  The library is compiled with ``nvcc`` into ``build/`` on first use
and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import os

import torch
from torch.autograd.function import once_differentiable

from . import cuda_lib

N_EDGE_TYPE = 7
SOURCE = os.path.join(cuda_lib.CSRC, "graph_conv.cu")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argument types (pointers, ints, then the stream)
_SIGNATURES = {
    "graph_conv_fwd": [_P] * 6 + [_I] * 3 + [_P],
    "graph_conv_col": [_P] * 5 + [_I] * 2 + [_P],
    "graph_conv_bwd_dx": [_P] * 6 + [_I] * 3 + [_P],
    "graph_conv_fwd_packed": [_P] * 6 + [_I] * 3 + [_P],
}
# kernel launches since the last reset_launches(), per kernel; each is
# counted where its kernel is launched and nowhere else
launches = dict.fromkeys(_SIGNATURES, 0)
_lib = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def build() -> str:
    """Compile ``csrc/graph_conv.cu`` (if this exact source has not been
    built yet) and return the library path."""
    return cuda_lib.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        _lib = cuda_lib.load(SOURCE, _SIGNATURES)
    return _lib


def _check_inputs(name, feats, csr, g):
    """Checks shared by the wrappers: CUDA float32 ``feats``, and a
    CSR over g*7 slots."""
    if not feats[0][1].is_cuda:
        raise ValueError(f"graph_conv_cuda.{name} needs CUDA tensors; use "
                         f"{name}_plain on the CPU")
    dev = feats[0][1].device
    for fname, t in feats:
        cuda_lib.check(t, fname, torch.float32, 2, dev)
    ptr, idx, scale = csr
    cuda_lib.check(ptr, "row_ptr", torch.int32, 1, dev)
    cuda_lib.check(idx, "col", torch.int32, 1, dev)
    cuda_lib.check(scale, "scale", torch.float32, 1, dev)
    if ptr.shape[0] != g * N_EDGE_TYPE + 1:
        raise ValueError(f"row_ptr has {ptr.shape[0]} entries, expected "
                         f"G*7+1 = {g * N_EDGE_TYPE + 1}")
    if idx.shape != scale.shape:
        raise ValueError("col and scale differ in length")
    return dev


def _launch(name: str, dev, *args) -> None:
    cuda_lib.call(_load(), name, dev, *args)
    launches[name] += 1


def _forward(name, entry, x, w, row_ptr, col, scale) -> torch.Tensor:
    """K1 or K5 (``entry``): checks, output, launch."""
    g, c = x.shape
    dev = _check_inputs(name, [("x", x), ("w", w)], (row_ptr, col, scale), g)
    cout = w.shape[1]
    if w.shape[0] != N_EDGE_TYPE * c:
        raise ValueError(f"w has {w.shape[0]} rows, expected 7*C = {7 * c}")
    out = torch.empty((g, cout), dtype=torch.float32, device=dev)
    if g and cout:
        _launch(entry, dev, x.data_ptr(), w.data_ptr(), row_ptr.data_ptr(),
                col.data_ptr(), scale.data_ptr(), out.data_ptr(), g, c, cout)
    return out


def graph_conv(x: torch.Tensor, w: torch.Tensor, row_ptr: torch.Tensor,
               col: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K1: x [G, C] f32, w [7C, C'] f32, CSR ``row_ptr`` [G*7+1] int32,
    ``col`` [E] int32, ``scale`` [E] f32, all contiguous on one CUDA
    device.  Returns ``col(x) @ w``, [G, C'] f32."""
    return _forward("graph_conv", "graph_conv_fwd", x, w, row_ptr, col, scale)


def _forward_only(x: torch.Tensor, w: torch.Tensor) -> None:
    """K5 has no backward, as the JAX ``graph_conv_packed`` has none."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError(
            "the packed graph conv (K5) is forward-only: a packed level "
            "cannot be differentiated; run it under torch.no_grad() or use "
            "a level without the packed mark")


def graph_conv_packed(x: torch.Tensor, w: torch.Tensor,
                      row_ptr: torch.Tensor, col: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """K5: K1's function and arguments on the tensor cores (3xTF32).
    Forward only: raises where autograd would need a gradient."""
    _forward_only(x, w)
    return _forward("graph_conv_packed", "graph_conv_fwd_packed", x, w,
                    row_ptr, col, scale)


def graph_conv_col(x: torch.Tensor, row_ptr: torch.Tensor, col: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """K2: the column buffer ``col(x)``, [G, 7C] f32 (arguments as for
    :func:`graph_conv`)."""
    g, c = x.shape
    dev = _check_inputs("graph_conv_col", [("x", x)], (row_ptr, col, scale), g)
    out = torch.empty((g, N_EDGE_TYPE * c), dtype=torch.float32, device=dev)
    if g and c:
        _launch("graph_conv_col", dev, x.data_ptr(), row_ptr.data_ptr(),
                col.data_ptr(), scale.data_ptr(), out.data_ptr(), g, c)
    return out


def graph_conv_bwd_dx(dout: torch.Tensor, w: torch.Tensor,
                      trow_ptr: torch.Tensor, t_row: torch.Tensor,
                      t_scale: torch.Tensor) -> torch.Tensor:
    """K3: dout [G, C'] f32, w [7C, C'] f32 and the transposed CSR
    (``GraphLevel.csr_t``: ``trow_ptr`` [G*7+1] int32 over the (col, dir)
    slots, ``t_row`` [E] int32, ``t_scale`` [E] f32).  Returns the input
    gradient ``dx`` [G, C] f32."""
    g, cout = dout.shape
    dev = _check_inputs("graph_conv_bwd_dx", [("dout", dout), ("w", w)],
                        (trow_ptr, t_row, t_scale), g)
    if w.shape[1] != cout or w.shape[0] % N_EDGE_TYPE:
        raise ValueError(f"w has shape {tuple(w.shape)}, expected "
                         f"[7*C, {cout}]")
    c = w.shape[0] // N_EDGE_TYPE
    out = torch.empty((g, c), dtype=torch.float32, device=dev)
    if g and c:
        _launch("graph_conv_bwd_dx", dev, dout.data_ptr(), w.data_ptr(),
                trow_ptr.data_ptr(), t_row.data_ptr(), t_scale.data_ptr(),
                out.data_ptr(), g, c, cout)
    return out


# ----------------------------------------------------------------------
# plain PyTorch versions (CPU tensors; the kernels' oracles on the card)
# ----------------------------------------------------------------------
def graph_conv_col_plain(x: torch.Tensor, edge_row, edge_col, edge_dir,
                         edge_scale) -> torch.Tensor:
    """K2's plain version: gather, scale, ``index_add_`` into the [G*7, C]
    column buffer (invalid edges, ``row >= G``, land in a dropped slot)."""
    g, c = x.shape
    gathered = x[edge_col.clamp(0, g - 1)] * edge_scale[:, None].to(x.dtype)
    slots = torch.where(edge_row < g, edge_row * N_EDGE_TYPE + edge_dir,
                        g * N_EDGE_TYPE)
    col = torch.zeros((g * N_EDGE_TYPE + 1, c), dtype=x.dtype, device=x.device)
    col.index_add_(0, slots, gathered)
    return col[:-1].reshape(g, N_EDGE_TYPE * c)


def graph_conv_plain(x: torch.Tensor, w: torch.Tensor, edge_row, edge_col,
                     edge_dir, edge_scale) -> torch.Tensor:
    """K1's plain version: the column buffer, then one GEMM."""
    return graph_conv_col_plain(x, edge_row, edge_col, edge_dir,
                                edge_scale) @ w


def graph_conv_packed_plain(x: torch.Tensor, w: torch.Tensor, edge_row,
                            edge_col, edge_dir, edge_scale) -> torch.Tensor:
    """K5's plain version: K1's, since the function is the same."""
    return graph_conv_plain(x, w, edge_row, edge_col, edge_dir, edge_scale)


def packed_forward(x: torch.Tensor, w: torch.Tensor, lvl) -> torch.Tensor:
    """``col(x) @ w`` on a packed :class:`GraphLevel`: K5 on a CUDA tensor,
    its plain version on a CPU one.  Raises where autograd would need a
    gradient: it never falls back to :class:`GraphConvFunction`."""
    if x.is_cuda:
        return graph_conv_packed(x.contiguous(), w.contiguous(), *lvl.csr())
    _forward_only(x, w)
    return graph_conv_packed_plain(x, w, lvl.edge_row, lvl.edge_col,
                                   lvl.edge_dir, lvl.edge_scale)


def graph_conv_bwd_dx_plain(dout: torch.Tensor, w: torch.Tensor, edge_row,
                            edge_col, edge_dir, edge_scale) -> torch.Tensor:
    """K3's plain version: ``dcol = dout @ W^T`` as [G, 7, C], gathered by
    each edge's (row, dir), scaled, and ``index_add_``-ed into dx by its
    col (invalid edges land in a dropped row)."""
    g = dout.shape[0]
    c = w.shape[0] // N_EDGE_TYPE
    dcol = (dout @ w.t()).reshape(g * N_EDGE_TYPE, c)
    ok = edge_row < g
    src = torch.where(ok, edge_row * N_EDGE_TYPE + edge_dir, 0)
    dst = torch.where(ok, edge_col, g)
    dx = torch.zeros((g + 1, c), dtype=dout.dtype, device=dout.device)
    dx.index_add_(0, dst, dcol[src] * edge_scale[:, None].to(dout.dtype))
    return dx[:-1]


class GraphConvFunction(torch.autograd.Function):
    """``col(x) @ w`` on a :class:`GraphLevel` ``lvl``, differentiable in
    ``x`` and ``w``: K1 forward; K3 for ``dx`` and K2's column buffer for
    ``dW = col^T dout`` backward.  A CPU tensor takes the plain versions.
    Only ``x`` and ``w`` are saved; the level's edges, CSRs and scales are
    graph constants.  Like the JAX ``custom_vjp`` rule, every backward
    forms both gradients."""

    # backward calls since the last reset (cf. ``launches``)
    backward_calls = 0

    @staticmethod
    def forward(ctx, x, w, lvl):
        ctx.save_for_backward(x, w)
        ctx.lvl = lvl
        if x.is_cuda:
            return graph_conv(x.contiguous(), w.contiguous(), *lvl.csr())
        return graph_conv_plain(x, w, lvl.edge_row, lvl.edge_col,
                                lvl.edge_dir, lvl.edge_scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        x, w = ctx.saved_tensors
        lvl = ctx.lvl
        GraphConvFunction.backward_calls += 1
        dout = dout.contiguous()
        if dout.is_cuda:
            dx = graph_conv_bwd_dx(dout, w.contiguous(), *lvl.csr_t())
            col = graph_conv_col(x.contiguous(), *lvl.csr())
        else:
            edges = (lvl.edge_row, lvl.edge_col, lvl.edge_dir, lvl.edge_scale)
            dx = graph_conv_bwd_dx_plain(dout, w, *edges)
            col = graph_conv_col_plain(x, *edges)
        dw = col.t() @ dout
        return dx, dw, None
