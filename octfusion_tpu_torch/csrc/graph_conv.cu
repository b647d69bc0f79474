// Dual-graph convolution kernels for Hopper (sm_90a): the forward (K1), the
// column buffer alone (K2), the input gradient (K3) and the forward on the
// tensor cores (K5) of
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
// K5 graph_conv_fwd_packed  out = col(x) @ w, over packs of the flat 7C axis
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
// K5 graph_conv_fwd_packed  K1's function on the tensor cores; replaces
//    the k-packed forward `_fwd_kernel_packed` of
//    octfusion_tpu/ops/pallas/graph_conv_kernel.py, whose one matrix-unit
//    issue consumes K_PACK = 4 gathered blocks.  Here the 7C axis of the
//    column buffer is one flat K axis cut into packs of 4 x 32 = 128
//    columns; a pack may cross direction boundaries, so a ragged C (131,
//    515) pads only the last pack, not every direction.  A block owns a
//    64 x 64 output tile.  Per pack it gathers the [64, 128] tile of the
//    column buffer from the CSR into shared memory (a lane per column,
//    each looking up its own direction's slot, a warp over 4 rows at a
//    time so that 16 chains of dependent loads per lane overlap), stages
//    W's matching [128, 64] rows beside it, and multiplies them with WMMA
//    m16n16k8 TF32 fragments in the error-compensated 3xTF32 split
//    (a_hi b_hi + a_hi b_lo + a_lo b_hi), each 8-deep step's products
//    added to fp32 register accumulators with IEEE adds, which keeps
//    fp32 accuracy.  8 warps, each a 16 x 32 slice of the tile.  What
//    bounds it: by count, the GEMM (3 TF32 tensor-core products per
//    product, against K1's fp32 FMAs); in practice the latency of the
//    gather's dependent loads, which nothing overlaps with the tensor-core
//    work yet (no pipelining).  Shared memory: (64 * 132 + 128 * 68) * 4
//    = 67 KB, dynamic.  Forward only.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <mma.h>
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

// ---- K5 -------------------------------------------------------------
constexpr int PM = 64;              // output rows per block
constexpr int PN = 64;              // output columns per block
constexpr int KP = 128;             // one pack of the flat 7C axis
constexpr int kPackThreads = 256;
constexpr int kPackWarps = kPackThreads / 32;
constexpr int kAStride = KP + 4;    // floats per row of the gathered tile
constexpr int kBStride = PN + 4;    // floats per row of W's pack
constexpr int kPackSmem = (PM * kAStride + KP * kBStride) * 4;
constexpr int kQ = KP / 32;         // gather: columns per lane
constexpr int kRows = 4;            // gather: rows per pass of a warp

static_assert(KP % 32 == 0 && PM == 4 * 16 && PN == 2 * 32,
              "8 warps of 16 x 32 cover the 64 x 64 tile");
static_assert(PM % (kRows * kPackWarps) == 0, "whole gather passes");
static_assert(PM * kBStride <= PM * kAStride, "epilogue fits in As");

using FragA = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 8,
                                     nvcuda::wmma::precision::tf32,
                                     nvcuda::wmma::row_major>;
using FragB = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 8,
                                     nvcuda::wmma::precision::tf32,
                                     nvcuda::wmma::row_major>;
using FragC = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 8,
                                     float>;

// v = hi + lo with both halves TF32 (hi rounded, lo the rounded residual)
template <typename Frag>
__device__ __forceinline__ void split_tf32(const Frag& v, Frag& hi,
                                           Frag& lo) {
#pragma unroll
  for (int i = 0; i < v.num_elements; ++i) {
    const float h = nvcuda::wmma::__float_to_tf32(v.x[i]);
    hi.x[i] = h;
    lo.x[i] = nvcuda::wmma::__float_to_tf32(v.x[i] - h);
  }
}

// out[G, N] = col(x)[G, 7C] @ w[7C, N], over packs of KP flat columns
__global__ void __launch_bounds__(kPackThreads)
graph_conv_packed_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const int* __restrict__ ptr,
                         const int* __restrict__ idx,
                         const float* __restrict__ scale,
                         float* __restrict__ out,
                         int G, int C, int N) {
  extern __shared__ __align__(128) float smem[];
  float* As = smem;                    // [PM][kAStride]
  float* Bs = smem + PM * kAStride;    // [KP][kBStride]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m0 = blockIdx.x * PM;
  const int n0 = blockIdx.y * PN;
  const int wm = (warp % 4) * 16;      // the warp's rows of the tile
  const int wn = (warp / 4) * 32;      // and its columns
  const int K = kDirs * C;

  FragC acc[2];
  nvcuda::wmma::fill_fragment(acc[0], 0.f);
  nvcuda::wmma::fill_fragment(acc[1], 0.f);

  for (int k0 = 0; k0 < K; k0 += KP) {
    // gather the [PM, KP] pack of the column buffer: lane j of a warp
    // takes flat columns k0 + j + 32q (q < kQ), each in its own direction,
    // of kRows rows at once, so its kRows * kQ chains of dependent loads
    // (slot bounds, then edge, then neighbour) are in flight together
    for (int r0 = warp; r0 < PM; r0 += kRows * kPackWarps) {
      int eb[kRows][kQ], ee[kRows][kQ], ch[kQ];
      int n = 0;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int kk = k0 + q * 32 + lane;
        const int d = kk < K ? kk / C : 0;
        ch[q] = kk - d * C;
#pragma unroll
        for (int h = 0; h < kRows; ++h) {
          const int row = m0 + r0 + h * kPackWarps;
          eb[h][q] = 0;
          ee[h][q] = 0;
          if (row < G && kk < K) {
            const int slot = row * kDirs + d;
            eb[h][q] = ptr[slot];
            ee[h][q] = ptr[slot + 1];
          }
          n = max(n, ee[h][q] - eb[h][q]);
        }
      }
      float s[kRows][kQ];
#pragma unroll
      for (int h = 0; h < kRows; ++h)
#pragma unroll
        for (int q = 0; q < kQ; ++q) s[h][q] = 0.f;
      for (int t = 0; t < n; ++t) {
#pragma unroll
        for (int h = 0; h < kRows; ++h)
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const int e = eb[h][q] + t;
            if (e < ee[h][q]) {
              s[h][q] += scale[e] * x[(int64_t)idx[e] * C + ch[q]];
            }
          }
      }
#pragma unroll
      for (int h = 0; h < kRows; ++h)
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          As[(r0 + h * kPackWarps) * kAStride + q * 32 + lane] = s[h][q];
        }
    }
    // W's rows k0 .. +KP, columns n0 .. +PN (zeros past the edges)
    for (int i = tid; i < KP * PN; i += kPackThreads) {
      const int k = i / PN;
      const int n = i % PN;
      const int kk = k0 + k;
      const int nn = n0 + n;
      Bs[k * kBStride + n] =
          (kk < K && nn < N) ? w[(int64_t)kk * N + nn] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KP; k += 8) {
      FragA a, a_hi, a_lo;
      nvcuda::wmma::load_matrix_sync(a, As + wm * kAStride + k, kAStride);
      split_tf32(a, a_hi, a_lo);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB b, b_hi, b_lo;
        nvcuda::wmma::load_matrix_sync(b, Bs + k * kBStride + wn + 16 * j,
                                       kBStride);
        split_tf32(b, b_hi, b_lo);
        // the tensor cores' own fp32 accumulation truncates: summed over
        // the whole 7C axis its bias reaches ~1e-4 at C = 515, so each
        // 8-deep step starts from zero and is added in IEEE fp32
        FragC part;
        nvcuda::wmma::fill_fragment(part, 0.f);
        nvcuda::wmma::mma_sync(part, a_lo, b_hi, part);
        nvcuda::wmma::mma_sync(part, a_hi, b_lo, part);
        nvcuda::wmma::mma_sync(part, a_hi, b_hi, part);
#pragma unroll
        for (int i = 0; i < part.num_elements; ++i) acc[j].x[i] += part.x[i];
      }
    }
    __syncthreads();
  }

  // stage the tile through shared memory and store its valid part
  float* Cs = smem;                    // [PM][kBStride]
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    nvcuda::wmma::store_matrix_sync(Cs + wm * kBStride + wn + 16 * j, acc[j],
                                    kBStride, nvcuda::wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = tid; i < PM * PN; i += kPackThreads) {
    const int row = m0 + i / PN;
    const int nn = n0 + i % PN;
    if (row < G && nn < N) {
      out[(int64_t)row * N + nn] = Cs[(i / PN) * kBStride + i % PN];
    }
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

// K5: arguments as for graph_conv_fwd
extern "C" int graph_conv_fwd_packed(const float* x, const float* w,
                                     const int* row_ptr, const int* col_idx,
                                     const float* scale, float* out, int G,
                                     int C, int Cout, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      graph_conv_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kPackSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((G + PM - 1) / PM, (Cout + PN - 1) / PN);
  graph_conv_packed_kernel<<<grid, kPackThreads, kPackSmem,
                             static_cast<cudaStream_t>(stream)>>>(
      x, w, row_ptr, col_idx, scale, out, G, C, Cout);
  return static_cast<int>(cudaGetLastError());
}
