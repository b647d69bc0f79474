"""The least time an NVIDIA H100 SXM could take for each kernel's work:
the larger of its operations over the peak rate of the units it runs on
(``FLOPS_RATE``) and its bytes over the HBM rate.

Rates from NVIDIA's data sheet, at the 700 W power limit: 495 TFLOP/s of
dense TF32 on the tensor cores (K1, K3 and K5, whose 3xTF32 split issues
three tensor-core products per product: their bounds count the
function's operations once at this rate, so no share can pass 100%),
67 TFLOP/s in fp32 outside the tensor cores (K2 and K4), and 3.35 TB/s
of HBM.  Bytes count each input read once and each output written once;
operations count what the function needs on these inputs (the edges
present, not the capacity)."""

from __future__ import annotations

FP32_FLOPS = 67e12        # FLOP/s, fp32 outside the tensor cores
TF32_FLOPS = 495e12       # FLOP/s, dense TF32 on the tensor cores
HBM_BYTES = 3.35e12       # bytes/s
N_EDGE_TYPE = 7
F32 = 4
I32 = 4
# the peak rate of the units each kernel's operations run on, by entry
# point: the graph conv's GEMMs on the tensor cores, K2's sums and K4's
# distances on the fp32 units
FLOPS_RATE = {"graph_conv_fwd": TF32_FLOPS, "graph_conv_bwd_dx": TF32_FLOPS,
              "graph_conv_fwd_packed": TF32_FLOPS,
              "graph_conv_col": FP32_FLOPS, "chamfer": FP32_FLOPS}


def times_ms(flops: float, nbytes: float, flops_rate: float = FP32_FLOPS):
    """-> (ms the operations take at ``flops_rate``, the fp32 peak unless
    given, ms the bytes take at the HBM rate); the bound is the larger."""
    return flops / flops_rate * 1e3, nbytes / HBM_BYTES * 1e3


def _csr_bytes(g: int, e: int) -> int:
    """row_ptr over the G * 7 slots, and a column index and a scale per
    edge."""
    return (N_EDGE_TYPE * g + 1) * I32 + e * (I32 + F32)


def graph_conv_fwd_cost(g: int, c: int, cout: int, e: int):
    """K1 and K5, ``out [G, C'] = col(x) @ W``: the GEMM's 2 * G * 7C * C'
    and the gather's 2 * E * C FLOP; x and W read, the CSR read, out
    written -> (flops, bytes)."""
    flops = 2 * g * N_EDGE_TYPE * c * cout + 2 * e * c
    nbytes = (g * c + N_EDGE_TYPE * c * cout + g * cout) * F32 + _csr_bytes(g, e)
    return flops, nbytes


def graph_conv_bwd_dx_cost(g: int, c: int, cout: int, e: int):
    """K3, ``dx [G, C] = A^T (dout W^T)``: K1's cost with C and C'
    exchanged -> (flops, bytes)."""
    return graph_conv_fwd_cost(g, cout, c, e)


def graph_conv_col_cost(g: int, c: int, e: int):
    """K2, the column buffer ``col(x)`` [G, 7C]: 2 * E * C FLOP; x and the
    CSR read, col written -> (flops, bytes)."""
    flops = 2 * e * c
    nbytes = (g * c + g * N_EDGE_TYPE * c) * F32 + _csr_bytes(g, e)
    return flops, nbytes


def chamfer_cost(b: int, n: int, m: int):
    """K4, (dl [B, N], dr [B, M]) from a [B, N, 3] and b [B, M, 3]: 8 FLOP
    per (i, j) distance (3 subtractions and 3 multiply-adds; the minima
    get no credit); the clouds read, both minima written -> (flops,
    bytes)."""
    flops = 8 * b * n * m
    nbytes = b * (n + m) * 3 * F32 + b * (n + m) * F32
    return flops, nbytes
