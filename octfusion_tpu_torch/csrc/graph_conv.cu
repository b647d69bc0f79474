// Dual-graph convolution kernels for Hopper (sm_90a): the forward (K1), the
// column buffer alone (K2) and the input gradient (K3) of
//
//   col[r, d*C + k] = sum_{e in CSR slot r*7+d} scale[e] * x[col_idx[e], k]
//   out[r, n]       = sum_{d, k} col[r, d*C + k] * w[d*C + k, n]
//
// x [G, C], w [7C, Cout], out [G, Cout], fp32, row-major and contiguous;
// row_ptr [G*7 + 1] int32 over the (row, dir) slots of the edge list sorted
// by row*7+dir; col_idx / scale [E].  Slots without edges give zero rows.
//
// K1 graph_conv_fwd     out = col(x) @ w
// K2 graph_conv_col     col(x) itself, [G, 7C] (recomputed for dW = col^T dout)
// K3 graph_conv_bwd_dx  dx = sum_d A_d^T (dout @ W_d^T)
//                          = sum_d (A_d^T dout) @ W_d^T
//    over the transposed CSR (slots col*7+dir, holding each edge's row and
//    scale): the gathered operand is dout and the GEMM reads W_d transposed
//    in place.
//
// K1 and K3 share one kernel body.  A block owns a BM x BN output tile.
// For every direction and every K-chunk of BK channels of the gathered
// operand it gathers the matching [BM, BK] tile of the column buffer from
// the CSR into shared memory (a warp per row, a lane per channel, so each
// neighbour read is one coalesced line), stages the [BK, BN] chunk of W_d
// (K1) or W_d^T (K3) beside it, and accumulates the output tile in fp32
// registers (a TM x TN micro-tile per thread).  The [G, 7C] column buffer
// never reaches device memory, and K3 forms its dout @ W_d^T product in its
// own body.  Shared memory: (BK * (BM + 1) + BK * (BN + pad)) * 4 bytes =
// 16.5 KB (K1) or 17.0 KB (K3).
//
// K2 writes the column buffer: a warp per (row, dir) slot, lanes on
// consecutive channels, so every neighbour read is a coalesced line and
// every slot's row of `col` is written once (zeros where it has no edges).
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDirs = 7;
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kWarps = kThreads / 32;
constexpr int kColWarps = 8;                      // K2: slots per block

static_assert(BK == 32, "one lane per channel of a K-chunk");

// out[G, N] = sum_d gather_d(src)[G, K] @ B_d[K, N], where
// gather_d(src)[r, k] = sum_{e in slot r*7+d} scale[e] * src[idx[e], k] and
// B_d = w[d*K:(d+1)*K, :] ([7K, N]; K1) or w[d*N:(d+1)*N, :]^T ([7N, K]; K3)
template <bool kTransposedW>
__global__ void __launch_bounds__(kThreads)
gather_gemm_kernel(const float* __restrict__ src,
                   const float* __restrict__ w,
                   const int* __restrict__ ptr,
                   const int* __restrict__ idx,
                   const float* __restrict__ scale,
                   float* __restrict__ out,
                   int G, int K, int N) {
  // k-major tiles.  As has a padded row, so the gather's per-lane writes
  // hit distinct banks.  Bs keeps 16-byte aligned rows for the vector
  // loads of the inner loop; K3 pads them by 4 floats, which cuts its
  // k-major stores of W^T from a 32-way to a 4-way bank conflict
  constexpr int kBPad = kTransposedW ? 4 : 0;
  __shared__ float As[BK][BM + 1];
  __shared__ __align__(16) float Bs[BK][BN + kBPad];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int d = 0; d < kDirs; ++d) {
    for (int k0 = 0; k0 < K; k0 += BK) {
      const int kc = k0 + lane;
      // gather the [BM, BK] tile of the column buffer for direction d
      for (int r = warp; r < BM; r += kWarps) {
        const int row = m0 + r;
        float s = 0.f;
        if (row < G && kc < K) {
          const int slot = row * kDirs + d;
          const int e_end = ptr[slot + 1];
          for (int e = ptr[slot]; e < e_end; ++e) {
            s += scale[e] * src[(int64_t)idx[e] * K + kc];
          }
        }
        As[lane][r] = s;
      }
      // stage rows k0 .. +BK, columns n0 .. +BN of B_d; consecutive threads
      // read consecutive addresses of w in both layouts
      for (int i = tid; i < BK * BN; i += kThreads) {
        const int k = kTransposedW ? i % BK : i / BN;
        const int n = kTransposedW ? i / BK : i % BN;
        const int kk = k0 + k;
        const int nn = n0 + n;
        float v = 0.f;
        if (kk < K && nn < N) {
          v = kTransposedW ? w[((int64_t)d * N + nn) * K + kk]
                           : w[((int64_t)d * K + kk) * N + nn];
        }
        Bs[k][n] = v;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[TM];
        float b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[k][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= G) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int nn = n0 + tx * TN + j;
      if (nn < N) out[(int64_t)row * N + nn] = acc[i][j];
    }
  }
}

// col[slot, k] = sum_{e in slot} scale[e] * x[col_idx[e], k] over the
// slots * C buffer ([G, 7C] viewed as [G*7, C])
__global__ void __launch_bounds__(kColWarps * 32)
graph_conv_col_kernel(const float* __restrict__ x,
                      const int* __restrict__ row_ptr,
                      const int* __restrict__ col_idx,
                      const float* __restrict__ scale,
                      float* __restrict__ col,
                      int slots, int C) {
  const int lane = threadIdx.x % 32;
  const int slot = blockIdx.x * kColWarps + threadIdx.x / 32;
  if (slot >= slots) return;
  const int e_begin = row_ptr[slot];
  const int e_end = row_ptr[slot + 1];
  float* dst = col + (int64_t)slot * C;
  for (int k = lane; k < C; k += 32) {
    float s = 0.f;
    for (int e = e_begin; e < e_end; ++e) {
      s += scale[e] * x[(int64_t)col_idx[e] * C + k];
    }
    dst[k] = s;
  }
}

}  // namespace

extern "C" int graph_conv_fwd(const float* x, const float* w,
                              const int* row_ptr, const int* col_idx,
                              const float* scale, float* out, int G, int C,
                              int Cout, void* stream) {
  const dim3 grid((G + BM - 1) / BM, (Cout + BN - 1) / BN);
  gather_gemm_kernel<false><<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, w, row_ptr, col_idx, scale, out, G, C, Cout);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int graph_conv_col(const float* x, const int* row_ptr,
                              const int* col_idx, const float* scale,
                              float* col, int G, int C, void* stream) {
  const int slots = G * kDirs;
  const int blocks = (slots + kColWarps - 1) / kColWarps;
  graph_conv_col_kernel<<<blocks, kColWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, row_ptr, col_idx, scale, col, slots, C);
  return static_cast<int>(cudaGetLastError());
}

// dout [G, Cout], w [7C, Cout], dx [G, C]; trow_ptr [G*7 + 1] over the
// (col, dir) slots of the edges sorted by col*7+dir, t_row / t_scale [E]
extern "C" int graph_conv_bwd_dx(const float* dout, const float* w,
                                 const int* trow_ptr, const int* t_row,
                                 const float* t_scale, float* dx, int G,
                                 int C, int Cout, void* stream) {
  const dim3 grid((G + BM - 1) / BM, (C + BN - 1) / BN);
  gather_gemm_kernel<true><<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      dout, w, trow_ptr, t_row, t_scale, dx, G, Cout, C);
  return static_cast<int>(cudaGetLastError());
}
