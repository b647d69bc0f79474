"""The MPU corner gathers' backward on Hopper: a deterministic segment sum

    out[n] = sum of grad[s] over the slots s whose corner node is n

of gradient rows grad [M, C] (N queries x 8 corners) into a depth's node
table [n_nodes, C], fp32.  ``ops/mpu._CornerGather`` calls it in place of
``index``'s backward, which sorts the M indices at every call and adds each
run of equal ones serially: the MPU's runs are long (a few thousand nodes
take every query at the coarse depths, and each missing or out-of-bounds
corner is clamped to node 0).

:func:`plan` groups the slots by node once per depth (a stable sort, so
a node's slots stay ascending, and the chunk table of the kernel's
split); every backward through that depth reuses it.  The kernel
(``csrc/mpu_gather.cu``) sums fixed chunks of a node's run in parallel,
then each node's chunks in chunk order, with no atomics, so two calls
give the same bits.  :func:`segment_sum` launches it on a CUDA tensor
and raises on any other; :func:`segment_sum_plain` is its plain PyTorch
version (gather in plan order, ``index_add_``), the reference of the
tests and ``chip_smoke.py``.  The library is compiled with ``nvcc`` into
``build/`` on first use and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from . import cuda_lib

SOURCE = os.path.join(cuda_lib.CSRC, "mpu_gather.cu")
CHUNK = 256            # kChunk in the source: slots a warp sums

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"corner_gather_bwd": [_P] * 6 + [_I] * 4 + [_P]}
# kernel launches; counted where the kernel is launched and nowhere else
launches = {"corner_gather_bwd": 0}
_lib = None


def build() -> str:
    """Compile ``csrc/mpu_gather.cu`` (if this exact source has not been
    built yet) and return the library path."""
    return cuda_lib.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        _lib = cuda_lib.load(SOURCE, _SIGNATURES)
    return _lib


class Plan(NamedTuple):
    """The slots of one depth grouped by node: ``perm`` [M] int32, the
    slots in node order; ``offsets`` [n_nodes + 1] int32, node n's slots
    are ``perm[offsets[n]:offsets[n + 1]]``, ascending; ``chunk_ptr``
    [n_nodes + 1] int32, the prefix sum of each node's ``CHUNK``-slot
    chunks."""
    perm: torch.Tensor
    offsets: torch.Tensor
    chunk_ptr: torch.Tensor


def plan(idx: torch.Tensor, n_nodes: int) -> Plan:
    """The :class:`Plan` of the flat node indices ``idx`` [M] (each in
    [0, n_nodes)).  Built from the indices alone, with autograd off."""
    if idx.dim() != 1 or idx.shape[0] >= 2**31 or n_nodes < 1:
        raise ValueError(f"plan of {tuple(idx.shape)} indices over "
                         f"{n_nodes} nodes")
    with torch.no_grad():
        keys, perm = torch.sort(idx, stable=True)
        offsets = torch.searchsorted(
            keys, torch.arange(n_nodes + 1, device=idx.device))
        chunks = (offsets.diff() + CHUNK - 1) // CHUNK
        chunk_ptr = torch.cat([chunks.new_zeros(1), chunks.cumsum(0)])
        return Plan(perm.to(torch.int32), offsets.to(torch.int32),
                    chunk_ptr.to(torch.int32))


def segment_sum_plain(grad: torch.Tensor, p: Plan,
                      n_nodes: int) -> torch.Tensor:
    """The kernel's plain version, on any device: grad [M, C] -> [n_nodes,
    C] fp32, each node's rows added in slot order."""
    node = torch.repeat_interleave(
        torch.arange(n_nodes, device=grad.device), p.offsets.diff().long())
    out = grad.new_zeros((n_nodes, grad.shape[1]), dtype=torch.float32)
    return out.index_add_(0, node, grad[p.perm.long()].to(torch.float32))


def segment_sum(grad: torch.Tensor, p: Plan, n_nodes: int) -> torch.Tensor:
    """grad [M, C] float32, contiguous, on the card, and the :class:`Plan`
    of its slots -> [n_nodes, C] float32, by the kernel."""
    if not grad.is_cuda:
        raise ValueError(f"segment_sum runs on a CUDA tensor, not on "
                         f"{grad.device}")
    dev = grad.device
    cuda_lib.check(grad, "grad", torch.float32, 2, dev)
    m, c = grad.shape
    for name, t, n in (("perm", p.perm, m), ("offsets", p.offsets,
                       n_nodes + 1), ("chunk_ptr", p.chunk_ptr, n_nodes + 1)):
        cuda_lib.check(t, name, torch.int32, 1, dev)
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} entries, expected {n}")
    # every run adds at most one partial chunk to M / CHUNK full ones
    max_chunks = -(-m // CHUNK) + min(n_nodes, m)
    if n_nodes < 1 or c < 1 or max_chunks >= 2**31:
        raise ValueError(f"segment sum of {m} rows into [{n_nodes}, {c}]")
    out = torch.empty((n_nodes, c), dtype=torch.float32, device=dev)
    partial = torch.empty((max_chunks, c), dtype=torch.float32, device=dev)
    vec4 = c % 4 == 0 and grad.data_ptr() % 16 == 0
    cuda_lib.call(_load(), "corner_gather_bwd", dev, grad.data_ptr(),
                  p.perm.data_ptr(), p.offsets.data_ptr(),
                  p.chunk_ptr.data_ptr(), partial.data_ptr(),
                  out.data_ptr(), n_nodes, max_chunks, c, int(vec4))
    launches["corner_gather_bwd"] += 1
    return out
