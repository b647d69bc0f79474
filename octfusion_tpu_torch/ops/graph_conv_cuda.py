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
C).  wgmma and TMA are later work.

Each kernel also takes bf16 operands (the ``_bf16`` entry points), as the
Pallas kernels do under the JAX package's ``compute_dtype: bfloat16``:
x (dout) and W both bf16, the output bf16; mixed dtypes raise, since the
module casts W to x's dtype and the wrapper never casts.  The bf16 path
keeps the Pallas arithmetic: each edge's 1/deg scale rounded to bf16 (the
one-hot matrix holds it in the operand dtype), the gather's sums in fp32,
the gathered chunk rounded to bf16 and multiplied on the tensor cores by
``mma.sync`` m16n8k16 bf16 into fp32 accumulators (one product per
product: the 3xTF32 split exists only to keep fp32 accuracy), the output
rounded to bf16; K2 stores 8 bf16 channels in each 16-byte store.  K3
rounds the gathered dout where the Pallas kernel rounds ``dout W_d^T``
before its scatter: in bf16 the two orders round at other points, so K3
holds to its plain version (the Pallas order) within 2^-6 of its largest
magnitude, not exactly.  ``dW`` is one fp32 ``torch.matmul`` of the bf16 column buffer
and dout, rounded to W's dtype, as the JAX rule computes it.

Beside each kernel sits its plain PyTorch version (gather, scale,
``index_add_``; for K1 and K3 a GEMM), which rounds where the Pallas
kernel rounds in either dtype.  The wrappers take the plain
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
# C entry point -> argument types (pointers, ints, then the stream); each
# fp32 entry point has a bf16 twin, ``<name>_bf16``, with the same
# arguments
_FP32_SIGNATURES = {
    "graph_conv_fwd": [_P] * 6 + [_I] * 3 + [_P],
    "graph_conv_col": [_P] * 5 + [_I] * 2 + [_P],
    "graph_conv_bwd_dx": [_P] * 6 + [_I] * 3 + [_P],
    "graph_conv_fwd_packed": [_P] * 6 + [_I] * 3 + [_P],
}
_SIGNATURES = {**_FP32_SIGNATURES,
               **{f"{k}_bf16": v for k, v in _FP32_SIGNATURES.items()}}
# the operand dtypes the kernels take -> the suffix of their entry points
_ENTRY_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}
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
    """Checks shared by the wrappers: CUDA ``feats`` of one dtype, float32
    or bfloat16 (mixed dtypes raise: the caller casts, the wrapper never
    does), and a CSR over g*7 slots -> (device, the entry point's suffix
    for that dtype)."""
    if not feats[0][1].is_cuda:
        raise ValueError(f"graph_conv_cuda.{name} needs CUDA tensors; use "
                         f"{name}_plain on the CPU")
    dev = feats[0][1].device
    dtype = feats[0][1].dtype
    if dtype not in _ENTRY_SUFFIX:
        raise TypeError(f"graph_conv_cuda.{name} takes float32 or bfloat16 "
                        f"operands, not {dtype}")
    for fname, t in feats:
        cuda_lib.check(t, fname, dtype, 2, dev)
    ptr, idx, scale = csr
    cuda_lib.check(ptr, "row_ptr", torch.int32, 1, dev)
    cuda_lib.check(idx, "col", torch.int32, 1, dev)
    cuda_lib.check(scale, "scale", torch.float32, 1, dev)
    if ptr.shape[0] != g * N_EDGE_TYPE + 1:
        raise ValueError(f"row_ptr has {ptr.shape[0]} entries, expected "
                         f"G*7+1 = {g * N_EDGE_TYPE + 1}")
    if idx.shape != scale.shape:
        raise ValueError("col and scale differ in length")
    return dev, _ENTRY_SUFFIX[dtype]


def _launch(name: str, dev, *args) -> None:
    cuda_lib.call(_load(), name, dev, *args)
    launches[name] += 1


def _forward(name, entry, x, w, row_ptr, col, scale) -> torch.Tensor:
    """K1 or K5 (``entry``): checks, output, launch."""
    g, c = x.shape
    dev, suffix = _check_inputs(name, [("x", x), ("w", w)],
                                (row_ptr, col, scale), g)
    cout = w.shape[1]
    if w.shape[0] != N_EDGE_TYPE * c:
        raise ValueError(f"w has {w.shape[0]} rows, expected 7*C = {7 * c}")
    out = torch.empty((g, cout), dtype=x.dtype, device=dev)
    if g and cout:
        _launch(entry + suffix, dev, x.data_ptr(), w.data_ptr(),
                row_ptr.data_ptr(), col.data_ptr(), scale.data_ptr(),
                out.data_ptr(), g, c, cout)
    return out


def graph_conv(x: torch.Tensor, w: torch.Tensor, row_ptr: torch.Tensor,
               col: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K1: x [G, C], w [7C, C'] (both f32 or both bf16), CSR ``row_ptr``
    [G*7+1] int32, ``col`` [E] int32, ``scale`` [E] f32, all contiguous on
    one CUDA device.  Returns ``col(x) @ w``, [G, C'] in x's dtype."""
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
    """K5: K1's function and arguments on the tensor cores (3xTF32, or
    bf16).  Forward only: raises where autograd would need a gradient."""
    _forward_only(x, w)
    return _forward("graph_conv_packed", "graph_conv_fwd_packed", x, w,
                    row_ptr, col, scale)


def graph_conv_col(x: torch.Tensor, row_ptr: torch.Tensor, col: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """K2: the column buffer ``col(x)``, [G, 7C] in x's dtype (arguments
    as for :func:`graph_conv`)."""
    g, c = x.shape
    dev, suffix = _check_inputs("graph_conv_col", [("x", x)],
                                (row_ptr, col, scale), g)
    out = torch.empty((g, N_EDGE_TYPE * c), dtype=x.dtype, device=dev)
    if g and c:
        _launch("graph_conv_col" + suffix, dev, x.data_ptr(),
                row_ptr.data_ptr(),
                col.data_ptr(), scale.data_ptr(), out.data_ptr(), g, c)
    return out


def graph_conv_bwd_dx(dout: torch.Tensor, w: torch.Tensor,
                      trow_ptr: torch.Tensor, t_row: torch.Tensor,
                      t_scale: torch.Tensor) -> torch.Tensor:
    """K3: dout [G, C'], w [7C, C'] (both f32 or both bf16) and the
    transposed CSR (``GraphLevel.csr_t``: ``trow_ptr`` [G*7+1] int32 over
    the (col, dir) slots, ``t_row`` [E] int32, ``t_scale`` [E] f32).
    Returns the input gradient ``dx`` [G, C] in dout's dtype."""
    g, cout = dout.shape
    dev, suffix = _check_inputs("graph_conv_bwd_dx",
                                [("dout", dout), ("w", w)],
                                (trow_ptr, t_row, t_scale), g)
    if w.shape[1] != cout or w.shape[0] % N_EDGE_TYPE:
        raise ValueError(f"w has shape {tuple(w.shape)}, expected "
                         f"[7*C, {cout}]")
    c = w.shape[0] // N_EDGE_TYPE
    out = torch.empty((g, c), dtype=dout.dtype, device=dev)
    if g and c:
        _launch("graph_conv_bwd_dx" + suffix, dev, dout.data_ptr(),
                w.data_ptr(),
                trow_ptr.data_ptr(), t_row.data_ptr(), t_scale.data_ptr(),
                out.data_ptr(), g, c, cout)
    return out


# ----------------------------------------------------------------------
# plain PyTorch versions (CPU tensors; the kernels' oracles on the card)
#
# They follow the Pallas kernels' arithmetic in either dtype: the edge
# scale in the operand's dtype (``_onehot`` builds the one-hot matrix in
# it, so in bf16 each 1/deg is rounded to bf16), products and sums in fp32
# (``preferred_element_type``), and a rounding to the operand's dtype
# wherever the Pallas kernel rounds: the column buffer before the GEMM
# (K1, K5) or as K2's output, ``dcol = dout W_d^T`` before its scatter
# (K3), and each output.  In fp32 every rounding is exact, so the fp32
# versions compute what they always did; float64 (gradcheck) runs in
# float64.
# ----------------------------------------------------------------------
def _acc(dtype: torch.dtype) -> torch.dtype:
    """The dtype the Pallas kernels accumulate operands of ``dtype`` in."""
    return torch.promote_types(dtype, torch.float32)


def _check_same_dtype(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != b.dtype:
        raise TypeError(f"the graph conv's operands differ in dtype "
                        f"({a.dtype}, {b.dtype}): cast w to x's dtype")


def graph_conv_col_plain(x: torch.Tensor, edge_row, edge_col, edge_dir,
                         edge_scale) -> torch.Tensor:
    """K2's plain version: gather, scale, ``index_add_`` into the [G*7, C]
    column buffer (invalid edges, ``row >= G``, land in a dropped slot),
    summed in fp32 and rounded to x's dtype."""
    g, c = x.shape
    acc = _acc(x.dtype)
    s = edge_scale.to(x.dtype).to(acc)
    gathered = x[edge_col.clamp(0, g - 1)].to(acc) * s[:, None]
    slots = torch.where(edge_row < g, edge_row * N_EDGE_TYPE + edge_dir,
                        g * N_EDGE_TYPE)
    col = torch.zeros((g * N_EDGE_TYPE + 1, c), dtype=acc, device=x.device)
    col.index_add_(0, slots, gathered)
    return col[:-1].reshape(g, N_EDGE_TYPE * c).to(x.dtype)


def graph_conv_plain(x: torch.Tensor, w: torch.Tensor, edge_row, edge_col,
                     edge_dir, edge_scale) -> torch.Tensor:
    """K1's plain version: the column buffer (in x's dtype), then one GEMM
    accumulated in fp32, rounded to x's dtype."""
    _check_same_dtype(x, w)
    col = graph_conv_col_plain(x, edge_row, edge_col, edge_dir, edge_scale)
    acc = _acc(x.dtype)
    return (col.to(acc) @ w.to(acc)).to(x.dtype)


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
    """K3's plain version, in the Pallas kernel's order: ``dcol = dout @
    W^T`` as [G, 7, C], accumulated in fp32 and rounded to dout's dtype,
    gathered by each edge's (row, dir), scaled, and ``index_add_``-ed in
    fp32 into dx by its col (invalid edges land in a dropped row), rounded
    to dout's dtype."""
    _check_same_dtype(dout, w)
    g = dout.shape[0]
    c = w.shape[0] // N_EDGE_TYPE
    acc = _acc(dout.dtype)
    dcol = (dout.to(acc) @ w.to(acc).t()).to(dout.dtype)
    dcol = dcol.reshape(g * N_EDGE_TYPE, c).to(acc)
    ok = edge_row < g
    src = torch.where(ok, edge_row * N_EDGE_TYPE + edge_dir, 0)
    dst = torch.where(ok, edge_col, g)
    s = edge_scale.to(dout.dtype).to(acc)
    dx = torch.zeros((g + 1, c), dtype=acc, device=dout.device)
    dx.index_add_(0, dst, dcol[src] * s[:, None])
    return dx[:-1].to(dout.dtype)


def weight_grad(col: torch.Tensor, dout: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """``dW = col^T dout``: one ``torch.matmul`` in fp32 (an XLA einsum
    outside Pallas in the JAX package), rounded to w's dtype."""
    acc = _acc(w.dtype)
    return (col.to(acc).t() @ dout.to(acc)).to(w.dtype)


class GraphConvFunction(torch.autograd.Function):
    """``col(x) @ w`` on a :class:`GraphLevel` ``lvl``, differentiable in
    ``x`` and ``w``: K1 forward; K3 for ``dx`` and K2's column buffer for
    ``dW = col^T dout`` backward.  A CPU tensor takes the plain versions.
    Only ``x`` and ``w`` are saved; the level's edges, CSRs and scales are
    graph constants.  Like the JAX ``custom_vjp`` rule, every backward
    forms both gradients."""

    # backward calls since the last reset, and those of a bf16 conv (cf.
    # ``launches``)
    backward_calls = 0
    backward_calls_bf16 = 0

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
        GraphConvFunction.backward_calls_bf16 += dout.dtype == torch.bfloat16
        dout = dout.contiguous()
        if dout.is_cuda:
            dx = graph_conv_bwd_dx(dout, w.contiguous(), *lvl.csr_t())
            col = graph_conv_col(x.contiguous(), *lvl.csr())
        else:
            edges = (lvl.edge_row, lvl.edge_col, lvl.edge_dir, lvl.edge_scale)
            dx = graph_conv_bwd_dx_plain(dout, w, *edges)
            col = graph_conv_col_plain(x, *edges)
        return dx, weight_grad(col, dout, w), None
