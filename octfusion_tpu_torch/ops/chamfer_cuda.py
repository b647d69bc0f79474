"""Bidirectional nearest-neighbour squared distances on Hopper (K4).

    dl[p, i] = min_j |a[p, i] - b[p, j]|^2,   dr[p, j] = min_i |a[p, i] - b[p, j]|^2

for a [B, N, 3] and b [B, M, 3] float32: the Chamfer terms of every pair
of clouds.  One hand-written CUDA kernel (``csrc/chamfer.cu``) replaces the
Pallas kernel ``octfusion_tpu/ops/pallas/chamfer_kernel.py::_kernel``: a
block (one warpgroup) per (pair, 128 rows of a) computes the expansion
``|a|^2 - 2 a.b + |b|^2`` on the tensor cores (two TF32 ``wgmma`` per
64 x 128 pairs, the operands split into TF32 halves) and keeps both minima
with DPX three-way integer minima on the float's bit pattern; each block
finishes its rows' ``dl`` and merges the column minima with one
``atomicMin`` per column on ``dr``, which :func:`chamfer` fills with +inf
first.  It never forms the [N, M] matrix.  A point whose squared norm is
not finite or is 2^120 or more (a NaN or infinite coordinate, or a huge
one) is taken apart from the tensor cores, in the plain version's order
of operations, so it gives NaN and +inf where the plain version does (a
NaN point: its own minimum and every minimum of the other cloud of the
pair).

:func:`chamfer_plain` is its plain PyTorch version: the JAX package's
expansion ``max(|a|^2 - 2 a.b + |b|^2, 0)`` over the whole [B, N, M]
matrix, then both minima.  ``metrics.distances.chamfer`` takes it for CPU
tensors only; a CUDA tensor launches the kernel or raises.  The library is
compiled with ``nvcc`` into ``build/`` on first use and loaded with
``ctypes``.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import cuda_lib

SOURCE = os.path.join(cuda_lib.CSRC, "chamfer.cu")
ROWS_PER_BLOCK = 128   # kHeld in the source: a block per (pair, row block)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"chamfer_fwd": [_P] * 4 + [_I] * 3 + [_P]}
# kernel launches since the last reset_launches(); counted where the
# kernel is launched and nowhere else
launches = {"chamfer": 0}
_lib = None


def reset_launches() -> None:
    launches["chamfer"] = 0


def build() -> str:
    """Compile ``csrc/chamfer.cu`` (if this exact source has not been
    built yet) and return the library path."""
    return cuda_lib.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        _lib = cuda_lib.load(SOURCE, _SIGNATURES)
    return _lib


def chamfer(a: torch.Tensor, b: torch.Tensor):
    """K4: a [B, N, 3], b [B, M, 3] float32, contiguous, on one CUDA
    device, N and M at least 1 -> (dl [B, N], dr [B, M]) float32.
    Outputs are +0.0 or more (+inf included), or NaN where the plain
    version has NaN."""
    if not a.is_cuda:
        raise ValueError("chamfer_cuda.chamfer needs CUDA tensors; use "
                         "chamfer_plain on the CPU")
    for name, t in (("a", a), ("b", b)):
        cuda_lib.check(t, name, torch.float32, 3, a.device)
        if t.shape[2] != 3:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             "[B, n, 3]")
    bsz, n, m = a.shape[0], a.shape[1], b.shape[1]
    if b.shape[0] != bsz:
        raise ValueError(f"a holds {bsz} clouds and b {b.shape[0]}")
    if n == 0 or m == 0:
        raise ValueError("chamfer needs at least one point per cloud")
    if bsz * -(-n // ROWS_PER_BLOCK) >= 2**31:
        raise ValueError(f"B = {bsz}, N = {n} exceeds the kernel's grid")
    dl = torch.empty((bsz, n), dtype=torch.float32, device=a.device)
    dr = torch.full((bsz, m), float("inf"), dtype=torch.float32,
                    device=a.device)
    if bsz:
        cuda_lib.call(_load(), "chamfer_fwd", a.device, a.data_ptr(),
                      b.data_ptr(), dl.data_ptr(), dr.data_ptr(), bsz, n, m)
        launches["chamfer"] += 1
    return dl, dr


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] x [B, M, 3] -> [B, N, M] float32 squared distances by the
    expansion ``max(|a|^2 - 2 a.b + |b|^2, 0)``, as the JAX package's
    ``metrics/distances._pairwise_sqdist``."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    aa = (a * a).sum(-1, keepdim=True)
    bb = (b * b).sum(-1)[:, None, :]
    return (aa - 2.0 * torch.bmm(a, b.transpose(1, 2)) + bb).clamp_min(0.0)


def chamfer_plain(a: torch.Tensor, b: torch.Tensor):
    """K4's plain version, on any device: the row and column minima of
    :func:`pairwise_sqdist`."""
    d = pairwise_sqdist(a, b)
    return d.amin(2), d.amin(1)
