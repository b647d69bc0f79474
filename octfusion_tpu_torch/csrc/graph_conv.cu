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
// K1 and K3 share one template, gather_gemm_kernel, which replaces the
// forward `_fwd_kernel` and the input gradient `_bwd_kernel` of
// octfusion_tpu/ops/pallas/graph_conv_kernel.py.  A block owns GM = 64
// output rows and BN = 32, 64 or 128 output columns (the whole C' up to
// 128).  The [G, 7C] column buffer never reaches device memory, and K3
// forms its dout @ W_d^T product in its own body.  What bounds it: by
// count, the GEMM's 2 * G * 7C * C' operations, which run on the tensor
// cores; and the latency of the CSR gather's loads, which a walk of the
// CSR per chunk turns into chains of dependent loads (slot bounds -> edge
// -> neighbour, one row at a time, repeated for every K-chunk and every
// tile of output columns).  The design:
// - The CSR slice is staged once per block.  Edges are sorted by
//   row*7+dir (K3: col*7+dir), so a row tile's edges are one contiguous
//   range [ptr[m0*7], ptr[(m0+64)*7]).  The block copies its 7*64+1 slot
//   pointers and the range's (idx, scale) into shared memory with
//   cp.async, and turns the pointers into one word per slot, (first edge,
//   count); a range longer than kEdgeStage edges (a coarse node's face
//   can border 4^k finer nodes) is walked in pieces, each a full pass
//   over (direction, K-chunk) whose products add into the same
//   accumulators.  A gather then issues only the neighbour rows' loads,
//   all addresses known: a warp keeps the first edge of each of its 8
//   rows in flight together, then any deeper edges kDeep a row at a
//   time (one lane per channel, so each is one coalesced line).  A tile without edges writes zeros; a direction
//   without edges in the piece is skipped.
// - One gathered [64, 32] chunk serves BN output columns, so the column
//   buffer is gathered ceil(C'/128) times instead of C'/64.
// - Two stages in dynamic shared memory: while the tensor cores multiply
//   chunk i, W's chunk i+1 arrives by cp.async and the loads of chunk
//   i+1's gather are in flight; one block barrier per chunk.
// - Math: mma.sync m16n8k8 TF32 in the 3xTF32 split (a_lo b_hi + a_hi b_lo
//   + a_hi b_hi), each 8-deep step from a zero fragment, added to the fp32
//   accumulators with IEEE adds (K5's rule; the tensor cores' own fp32
//   accumulation truncates): fp32 accuracy.  8 warps, each a 32 x 32
//   (BN = 128) or 16 x 32 / 16 x 16 slice of the tile, which skips its
//   8-column tiles past N.  A split into TF32 halves rounds with two
//   integer operations (cvt.rna.tf32.f32 compiles to several).  K1's B is
//   W_d, staged k-major; K3's is W_d^T read in place
//   (w[(d*N + n)*K + k] is k-contiguous), staged n-major.  A fragment's
//   k slots t and t + 4 take the adjacent k = 2t, 2t + 1, so A (and K3's
//   B) fragments load as 8-byte pairs; the strides keep every fragment
//   read free of bank conflicts.
// - Ragged widths: W's chunks load in 16-byte copies only where its rows
//   are 16-byte aligned (else 4-byte), zero-filled past K and N; the
//   gathered chunk's channels past K are zeros in shared memory, and only
//   the chunk's 8-deep steps that hold data run.
// Shared memory: 2 stages of (64 * 40 + 32 * 132) floats (K3: 64 * 40 +
// 128 * 40) and the CSR slice, 452 + 448 + 2 * 1024 words: 66.1 KB (K1,
// BN = 128) or 73.2 KB (K3), dynamic; registers allow two blocks an SM.
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
//    product); in practice the latency of the
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
constexpr int kColWarps = 8;                      // K2: slots per block

// ---- K1 / K3 --------------------------------------------------------
constexpr int GM = 64;                  // output rows per block
constexpr int GK = 32;                  // gathered channels per chunk
constexpr int kGemmThreads = 256;
constexpr int kGemmWarps = kGemmThreads / 32;
constexpr int kRowsPerWarp = GM / kGemmWarps;    // gather: 8 rows a warp
constexpr int kEarly = 1;               // edges per row issued before the math
constexpr int kDeep = 4;                // deeper edges per row per pass
constexpr int kEdgeStage = 1024;        // edges of the CSR slice per piece
                                        // (< 2^16: see the slot table)
constexpr int kPtrWords = (kDirs * GM + 1 + 3) / 4 * 4;  // slot pointers
constexpr int kSlotWords = kDirs * GM;  // a piece's (first edge, count) per slot
constexpr int kGStride = GK + 8;        // floats per row of a gathered chunk

static_assert(GK == 32, "one lane per channel of a gathered chunk");

// the shapes behind a BN-column tile.  A stage holds the gathered chunk,
// [GM][GK + 8], and B_d's chunk, [GK][BN + 4] (K1, k-major) or
// [BN][GK + 8] (K3, n-major): strides that make every fragment read below
// free of bank conflicts
template <int BN, bool kT>
struct GemmTile {
  static constexpr int kWarpsN = BN == 128 ? 4 : 2;
  static constexpr int kWarpsM = kGemmWarps / kWarpsN;
  static constexpr int kMT = GM / (16 * kWarpsM);   // m16 tiles per warp
  static constexpr int kNT = BN / (8 * kWarpsN);    // n8 tiles per warp
  static constexpr int kBStride = kT ? GK + 8 : BN + 4;
  static constexpr int kAFloats = GM * kGStride;
  static constexpr int kBFloats = kT ? BN * kBStride : GK * kBStride;
  static constexpr int kStageFloats = kAFloats + kBFloats;
  static constexpr int kSmem =
      (2 * kStageFloats + kPtrWords + kSlotWords + 2 * kEdgeStage) * 4;
  static_assert(kMT >= 1 && kNT >= 1 && kWarpsM * 16 * kMT == GM,
                "the warps cover the tile");
  static_assert(kAFloats % 4 == 0 && kBFloats % 4 == 0,
                "16-byte aligned stages");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (0..size) bytes from global `src`, zero-filling the
// rest of `size`; bytes = 0 reads nothing
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x rounded to TF32 (10 mantissa bits, half away from zero), as bits: two
// integer operations where cvt.rna.tf32.f32 compiles to several
__device__ __forceinline__ unsigned round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32 (hi rounded, lo the rounded residual)
__device__ __forceinline__ void split_tf32_bits(float x, unsigned& hi,
                                                unsigned& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

// d += a @ b on a 16 x 8 x 8 TF32 tile (fp32 accumulate)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a @ b from a zero accumulator (one zero register, no zeroed tile)
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const unsigned (&a)[4],
                                              const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// out[G, N] = sum_d gather_d(src)[G, K] @ B_d[K, N], where
// gather_d(src)[r, k] = sum_{e in slot r*7+d} scale[e] * src[idx[e], k] and
// B_d = w[d*K:(d+1)*K, :] ([7K, N]; K1) or w[d*N:(d+1)*N, :]^T ([7N, K]; K3).
// vec_w: W's rows are 16-byte aligned (w aligned and N (K1) or K (K3) a
// multiple of 4).
template <int BN, bool kT>
__global__ void __launch_bounds__(kGemmThreads, 2)
gather_gemm_kernel(const float* __restrict__ src,
                   const float* __restrict__ w,
                   const int* __restrict__ ptr,
                   const int* __restrict__ idx,
                   const float* __restrict__ scale,
                   float* __restrict__ out,
                   int G, int K, int N, int vec_w) {
  using T = GemmTile<BN, kT>;
  extern __shared__ __align__(16) float gemm_smem[];  // 2 stages of [A | B_d]
  float* smem = gemm_smem;
  int* sptr = reinterpret_cast<int*>(smem + 2 * T::kStageFloats);
  int* sslot = sptr + kPtrWords;
  int* sidx = sslot + kSlotWords;
  float* sscale = reinterpret_cast<float*>(sidx + kEdgeStage);
  __shared__ unsigned dir_mask;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int fg = lane / 4;              // fragment row / column group
  const int ft = lane % 4;              // and thread in the group
  const int m0 = blockIdx.x * GM;
  const int n0 = blockIdx.y * BN;
  const int rows = min(GM, G - m0);
  const int wm = (warp / T::kWarpsN) * 16 * T::kMT;
  const int wn = (warp % T::kWarpsN) * 8 * T::kNT;
  const int nk = (K + GK - 1) / GK;
  const int e_begin = ptr[m0 * kDirs];
  const int e_end = ptr[(m0 + rows) * kDirs];

  float acc[T::kMT][T::kNT][4];
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < T::kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // the tile's slot pointers, once (rows past G have none)
  if (e_begin < e_end) {
    for (int i = tid; i <= rows * kDirs; i += kGemmThreads) {
      cp_async4(sptr + i, ptr + m0 * kDirs + i, 4);
    }
  }
  for (int pe = e_begin; pe < e_end; pe += kEdgeStage) {
    // one piece of the tile's edge range
    const int np = min(kEdgeStage, e_end - pe);
    for (int i = tid; i < np; i += kGemmThreads) {
      cp_async4(sidx + i, idx + pe + i, 4);
      cp_async4(sscale + i, scale + pe + i, 4);
    }
    cp_async_commit();
    if (tid == 0) dir_mask = 0u;
    cp_async_wait_all();
    __syncthreads();

    // slot s's edges within the piece, as (offset into sidx / sscale) << 16
    // | count, and the directions that have any
    for (int s = tid; s < rows * kDirs; s += kGemmThreads) {
      const int b = min(max(sptr[s] - pe, 0), np);
      const int e = min(max(sptr[s + 1] - pe, 0), np);
      sslot[s] = b << 16 | (e - b);
      if (e > b) atomicOr(&dir_mask, 1u << (s % kDirs));
    }
    __syncthreads();
    auto slot_range = [&](int s, int& b, int& e) {
      const int v = sslot[s];
      b = v >> 16;
      e = b + (v & 0xffff);
    };
    const unsigned mask = dir_mask;
    const int steps = __popc(mask) * nk;

    // step i -> (direction d, first channel k0) over the piece's
    // directions with edges
    auto step_at = [&](int i, int& d, int& k0) {
      int j = i / nk;
      k0 = (i - j * nk) * GK;
      unsigned m = mask;
      for (; j > 0; --j) m &= m - 1;
      d = __ffs(m) - 1;
    };

    // W's [GK, BN] chunk of direction d into stage `st` by cp.async
    auto load_w = [&](int st, int d, int k0) {
      float* bs = smem + st * T::kStageFloats + T::kAFloats;
      if (!kT) {            // B_d[k][n] = w[(d*K + k)*N + n], k-major
        if (vec_w) {
          for (int i = tid; i < GK * BN / 4; i += kGemmThreads) {
            const int k = i / (BN / 4);
            const int n = (i % (BN / 4)) * 4;
            const int kk = k0 + k;
            const int nn = n0 + n;
            const int bytes = kk < K ? min(max(N - nn, 0), 4) * 4 : 0;
            cp_async16(bs + k * T::kBStride + n,
                       bytes ? w + ((int64_t)d * K + kk) * N + nn : w, bytes);
          }
        } else {
          for (int i = tid; i < GK * BN; i += kGemmThreads) {
            const int k = i / BN;
            const int n = i % BN;
            const bool ok = k0 + k < K && n0 + n < N;
            cp_async4(bs + k * T::kBStride + n,
                      ok ? w + ((int64_t)d * K + k0 + k) * N + n0 + n : w,
                      ok ? 4 : 0);
          }
        }
      } else {              // B_d[k][n] = w[(d*N + n)*K + k], n-major
        if (vec_w) {
          for (int i = tid; i < BN * GK / 4; i += kGemmThreads) {
            const int n = i / (GK / 4);
            const int k = (i % (GK / 4)) * 4;
            const int kk = k0 + k;
            const int nn = n0 + n;
            const int bytes = nn < N ? min(max(K - kk, 0), 4) * 4 : 0;
            cp_async16(bs + n * T::kBStride + k,
                       bytes ? w + ((int64_t)d * N + nn) * K + kk : w, bytes);
          }
        } else {
          for (int i = tid; i < BN * GK; i += kGemmThreads) {
            const int n = i / GK;
            const int k = i % GK;
            const bool ok = k0 + k < K && n0 + n < N;
            cp_async4(bs + n * T::kBStride + k,
                      ok ? w + ((int64_t)d * N + n0 + n) * K + k0 + k : w,
                      ok ? 4 : 0);
          }
        }
      }
    };

    // the gather of chunk (d, k0): warp w takes rows w + 8h, lane its
    // channel k0 + lane.  gather_issue loads the first kEarly edges of all
    // 8 rows at once; gather_finish (after the math) scales and sums them,
    // walks any deeper edges with the 8 rows in step, and stores the chunk
    float raw[kRowsPerWarp][kEarly];
    auto gather_issue = [&](int d, int k0) {
      const int kc = k0 + lane;
#pragma unroll
      for (int h = 0; h < kRowsPerWarp; ++h) {
        const int r = warp + h * kGemmWarps;
        int b = 0, e = 0;
        if (r < rows && kc < K) slot_range(r * kDirs + d, b, e);
#pragma unroll
        for (int u = 0; u < kEarly; ++u) {
          raw[h][u] = b + u < e
                          ? __ldg(src + (int64_t)sidx[b + u] * K + kc) : 0.f;
        }
      }
    };
    auto gather_finish = [&](int st, int d, int k0) {
      float* as = smem + st * T::kStageFloats;
      const int kc = k0 + lane;
      float sum[kRowsPerWarp];
      int bs[kRowsPerWarp], es[kRowsPerWarp];
      int deepest = 0;
#pragma unroll
      for (int h = 0; h < kRowsPerWarp; ++h) {
        const int r = warp + h * kGemmWarps;
        int b = 0, e = 0;
        if (r < rows && kc < K) slot_range(r * kDirs + d, b, e);
        bs[h] = b;
        es[h] = e;
        deepest = max(deepest, e - b);
        sum[h] = 0.f;
#pragma unroll
        for (int u = 0; u < kEarly; ++u) {
          if (b + u < e) sum[h] = fmaf(sscale[b + u], raw[h][u], sum[h]);
        }
      }
      deepest = __reduce_max_sync(0xffffffffu, deepest);
      // kDeep edges a row per pass, all their loads issued before the sums
      for (int u = kEarly; u < deepest; u += kDeep) {
        float v[kRowsPerWarp][kDeep];
#pragma unroll
        for (int h = 0; h < kRowsPerWarp; ++h)
#pragma unroll
          for (int q = 0; q < kDeep; ++q) {
            const int e = bs[h] + u + q;
            v[h][q] = e < es[h] ? __ldg(src + (int64_t)sidx[e] * K + kc) : 0.f;
          }
#pragma unroll
        for (int h = 0; h < kRowsPerWarp; ++h)
#pragma unroll
          for (int q = 0; q < kDeep; ++q) {
            const int e = bs[h] + u + q;
            if (e < es[h]) sum[h] = fmaf(sscale[e], v[h][q], sum[h]);
          }
      }
#pragma unroll
      for (int h = 0; h < kRowsPerWarp; ++h) {
        as[(warp + h * kGemmWarps) * kGStride + lane] = sum[h];
      }
    };

    // acc += chunk (A of stage st) @ B_d's chunk, over its 8-deep steps
    // that hold data.  The sum over an 8-deep step does not depend on
    // which k meets which fragment slot, so slots t and t + 4 take the
    // adjacent k = 2t and 2t + 1: one 8-byte read gives both
    auto multiply = [&](int st, int k0) {
      const float* as = smem + st * T::kStageFloats;
      const float* bsm = as + T::kAFloats;
      const int ksteps = (min(GK, K - k0) + 7) / 8;
#pragma unroll
      for (int ks = 0; ks < GK / 8; ++ks) {
        if (ks >= ksteps) break;
        const int kb = ks * 8 + 2 * ft;
        unsigned a_hi[T::kMT][4], a_lo[T::kMT][4];
#pragma unroll
        for (int i = 0; i < T::kMT; ++i) {
          const float* p = as + (wm + 16 * i + fg) * kGStride + kb;
          const float2 r0 = *reinterpret_cast<const float2*>(p);
          const float2 r8 = *reinterpret_cast<const float2*>(p + 8 * kGStride);
          split_tf32_bits(r0.x, a_hi[i][0], a_lo[i][0]);  // (row g, k 2t)
          split_tf32_bits(r8.x, a_hi[i][1], a_lo[i][1]);  // (row g + 8, k 2t)
          split_tf32_bits(r0.y, a_hi[i][2], a_lo[i][2]);  // (row g, k 2t + 1)
          split_tf32_bits(r8.y, a_hi[i][3], a_lo[i][3]);  // (g + 8, 2t + 1)
        }
#pragma unroll
        for (int j = 0; j < T::kNT; ++j) {
          if (n0 + wn + 8 * j >= N) break;    // columns past N: zeros
          const int n = wn + 8 * j + fg;
          float b0, b1;               // (k 2t, col g) and (k 2t + 1, col g)
          if (kT) {
            const float2 v = *reinterpret_cast<const float2*>(
                bsm + n * T::kBStride + kb);
            b0 = v.x;
            b1 = v.y;
          } else {
            b0 = bsm[kb * T::kBStride + n];
            b1 = bsm[(kb + 1) * T::kBStride + n];
          }
          unsigned b_hi[2], b_lo[2];
          split_tf32_bits(b0, b_hi[0], b_lo[0]);
          split_tf32_bits(b1, b_hi[1], b_lo[1]);
#pragma unroll
          for (int i = 0; i < T::kMT; ++i) {
            float part[4];
            mma_tf32_zero(part, a_lo[i], b_hi);
            mma_tf32(part, a_hi[i], b_lo);
            mma_tf32(part, a_hi[i], b_hi);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] += part[q];
          }
        }
      }
    };

    if (steps > 0) {
      int d, k0;
      step_at(0, d, k0);
      load_w(0, d, k0);
      cp_async_commit();
      gather_issue(d, k0);
      gather_finish(0, d, k0);
      cp_async_wait_all();
      __syncthreads();
      for (int i = 0; i < steps; ++i) {
        const int st = i & 1;
        const int k_cur = k0;
        const bool more = i + 1 < steps;
        if (more) {
          step_at(i + 1, d, k0);
          load_w(st ^ 1, d, k0);
          cp_async_commit();
          gather_issue(d, k0);
        }
        multiply(st, k_cur);
        if (more) gather_finish(st ^ 1, d, k0);
        cp_async_wait_all();
        __syncthreads();
      }
    }
    __syncthreads();    // the piece's staging and mask are free again
  }

  // the fragments' (row, col) pairs: (fg, 2ft + q) and (fg + 8, 2ft + q)
#pragma unroll
  for (int i = 0; i < T::kMT; ++i) {
#pragma unroll
    for (int j = 0; j < T::kNT; ++j) {
      const int c = n0 + wn + 8 * j + 2 * ft;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm + 16 * i + fg + 8 * half;
        if (r >= G) continue;
        float* o = out + (int64_t)r * N + c;
        if (c < N) o[0] = acc[i][j][2 * half];
        if (c + 1 < N) o[1] = acc[i][j][2 * half + 1];
      }
    }
  }
}

template <int BN, bool kT>
int launch_gather_gemm(const float* src, const float* w, const int* ptr,
                       const int* idx, const float* scale, float* out, int G,
                       int K, int N, cudaStream_t stream) {
  using T = GemmTile<BN, kT>;
  const cudaError_t err = cudaFuncSetAttribute(
      gather_gemm_kernel<BN, kT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_w = (kT ? K : N) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((G + GM - 1) / GM, (N + BN - 1) / BN);
  gather_gemm_kernel<BN, kT><<<grid, kGemmThreads, T::kSmem, stream>>>(
      src, w, ptr, idx, scale, out, G, K, N, vec_w);
  return static_cast<int>(cudaGetLastError());
}

// the tile's width: the whole N up to 128 columns
template <bool kT>
int gather_gemm(const float* src, const float* w, const int* ptr,
                const int* idx, const float* scale, float* out, int G, int K,
                int N, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 32) {
    return launch_gather_gemm<32, kT>(src, w, ptr, idx, scale, out, G, K, N, s);
  }
  if (N <= 64) {
    return launch_gather_gemm<64, kT>(src, w, ptr, idx, scale, out, G, K, N, s);
  }
  return launch_gather_gemm<128, kT>(src, w, ptr, idx, scale, out, G, K, N, s);
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
  return gather_gemm<false>(x, w, row_ptr, col_idx, scale, out, G, C, Cout,
                            stream);
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
  return gather_gemm<true>(dout, w, trow_ptr, t_row, t_scale, dx, G, Cout, C,
                           stream);
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
