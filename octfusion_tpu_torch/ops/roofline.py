"""The least time an NVIDIA H100 SXM could take for each kernel's work:
the larger of its operations over the peak rate of the units it runs on
(``FLOPS_RATE``) and its bytes over the HBM rate.

Rates from NVIDIA's data sheet, at the 700 W power limit: 495 TFLOP/s of
dense TF32 on the tensor cores (K1, K3 and K5, whose 3xTF32 split issues
three tensor-core products per product: their bounds count the
function's operations once at this rate, so no share can pass 100%),
989 TFLOP/s of dense bf16 on the tensor cores (the bf16 entry points of
K1, K3 and K5, ``*_bf16``: one bf16 product per product), 67 TFLOP/s in
fp32 outside the tensor cores (K2, whose sums stay fp32 in either
dtype, and K6's adds), and 3.35 TB/s of HBM.  The bf16 entry points move 2-byte
operands (``elem`` = :data:`BF16`); the CSR stays 4-byte.
K4 computes its distances on the tensor cores and keeps its minima on the
integer units, so its operations' time (:func:`bound_times`) is the
larger of its 8 FLOP per pair at the TF32 rate and its two minima per
pair at ``MINIMA_RATE``, the part no tensor core can do; :func:`chamfer_cost`
keeps the 8 FLOP per pair of the direct form, whose bound at the fp32
rate ``chip_smoke.py`` prints beside it.  Bytes count each input read
once and each output written once; operations count what the function
needs on these inputs (the edges present, not the capacity)."""

from __future__ import annotations

FP32_FLOPS = 67e12        # FLOP/s, fp32 outside the tensor cores
TF32_FLOPS = 495e12       # FLOP/s, dense TF32 on the tensor cores
BF16_FLOPS = 989e12       # FLOP/s, dense bf16 on the tensor cores
HBM_BYTES = 3.35e12       # bytes/s
# two-input minima/s: the DPX three-way minimum (VIMNMX3) issues at 64
# per SM and clock (the CUDA C++ Programming Guide's throughput for 32-bit
# integer minima, which scripts/k4_shapes.py measures) and does two
# minima, on 132 SMs at the 1.98 GHz of the 67 TFLOP/s fp32 rate
MINIMA_RATE = 132 * 64 * 2 * 1.98e9
N_EDGE_TYPE = 7
F32 = 4
BF16 = 2
I32 = 4
# the peak rate of the units each kernel's operations run on, by entry
# point: the graph conv's GEMMs and K4's distances on the tensor cores
# (TF32, or bf16 for the ``_bf16`` entry points), K2's sums on the fp32
# units
FLOPS_RATE = {"graph_conv_fwd": TF32_FLOPS, "graph_conv_bwd_dx": TF32_FLOPS,
              "graph_conv_fwd_packed": TF32_FLOPS,
              "graph_conv_col": FP32_FLOPS, "chamfer": TF32_FLOPS,
              "graph_conv_fwd_bf16": BF16_FLOPS,
              "graph_conv_bwd_dx_bf16": BF16_FLOPS,
              "graph_conv_fwd_packed_bf16": BF16_FLOPS,
              "graph_conv_col_bf16": FP32_FLOPS,
              "corner_gather_bwd": FP32_FLOPS}


def times_ms(flops: float, nbytes: float, flops_rate: float = FP32_FLOPS):
    """-> (ms the operations take at ``flops_rate``, the fp32 peak unless
    given, ms the bytes take at the HBM rate); the bound is the larger."""
    return flops / flops_rate * 1e3, nbytes / HBM_BYTES * 1e3


def bound_times(name: str, flops: float, nbytes: float):
    """The bound terms of the kernel behind entry point ``name`` on its
    cost (``*_cost``) -> (ms of its operations at ``FLOPS_RATE[name]``,
    ms of its bytes); for K4 (``chamfer``) the operations' time is the
    larger of its products at the TF32 rate and its two minima per pair
    (``flops / 4``) at ``MINIMA_RATE``."""
    ops_ms, bytes_ms = times_ms(flops, nbytes, FLOPS_RATE[name])
    if name == "chamfer":
        ops_ms = max(ops_ms, flops / 4 / MINIMA_RATE * 1e3)
    return ops_ms, bytes_ms


def _csr_bytes(g: int, e: int) -> int:
    """row_ptr over the G * 7 slots, and a column index and a scale per
    edge."""
    return (N_EDGE_TYPE * g + 1) * I32 + e * (I32 + F32)


def graph_conv_fwd_cost(g: int, c: int, cout: int, e: int, elem: int = F32):
    """K1 and K5, ``out [G, C'] = col(x) @ W``: the GEMM's 2 * G * 7C * C'
    and the gather's 2 * E * C FLOP; x and W read, the CSR read, out
    written, operands of ``elem`` bytes -> (flops, bytes)."""
    flops = 2 * g * N_EDGE_TYPE * c * cout + 2 * e * c
    nbytes = ((g * c + N_EDGE_TYPE * c * cout + g * cout) * elem
              + _csr_bytes(g, e))
    return flops, nbytes


def graph_conv_bwd_dx_cost(g: int, c: int, cout: int, e: int,
                           elem: int = F32):
    """K3, ``dx [G, C] = A^T (dout W^T)``: K1's cost with C and C'
    exchanged -> (flops, bytes)."""
    return graph_conv_fwd_cost(g, cout, c, e, elem)


def graph_conv_col_cost(g: int, c: int, e: int, elem: int = F32):
    """K2, the column buffer ``col(x)`` [G, 7C]: 2 * E * C FLOP; x and the
    CSR read, col written, of ``elem`` bytes -> (flops, bytes)."""
    flops = 2 * e * c
    nbytes = (g * c + g * N_EDGE_TYPE * c) * elem + _csr_bytes(g, e)
    return flops, nbytes


def chamfer_cost(b: int, n: int, m: int):
    """K4, (dl [B, N], dr [B, M]) from a [B, N, 3] and b [B, M, 3]: 8 FLOP
    per (i, j) distance (3 subtractions and 3 multiply-adds; the minima
    get no credit); the clouds read, both minima written -> (flops,
    bytes).  At the fp32 rate, the bound of the direct form on the fp32
    units."""
    flops = 8 * b * n * m
    nbytes = b * (n + m) * 3 * F32 + b * (n + m) * F32
    return flops, nbytes


def corner_gather_bwd_cost(m: int, c: int, n_nodes: int):
    """K6, the MPU corner gathers' segment sum ``out [n_nodes, C]`` of
    ``grad [M, C]`` over the plan of M slots: one add per element of
    grad; grad and ``perm`` read, the plan's ``offsets`` and
    ``chunk_ptr`` read, out written (the per-chunk partials, a few bytes
    a node, are the kernel's own) -> (flops, bytes)."""
    flops = m * c
    nbytes = m * c * F32 + m * I32 + 2 * (n_nodes + 1) * I32 \
        + n_nodes * c * F32
    return flops, nbytes
