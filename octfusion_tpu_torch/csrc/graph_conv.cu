// Dual-graph convolution kernels for Hopper (sm_90a): the forward (K1), the
// column buffer alone (K2), the input gradient (K3) and the forward over
// the flat 7C axis (K5) of
//
//   col[r, d*C + k] = sum_{e in CSR slot r*7+d} scale[e] * x[col_idx[e], k]
//   out[r, n]       = sum_{d, k} col[r, d*C + k] * w[d*C + k, n]
//
// x [G, C], w [7C, Cout], out [G, Cout], fp32, row-major and contiguous;
// row_ptr [G*7 + 1] int32 over the (row, dir) slots of the edge list sorted
// by row*7+dir; col_idx / scale [E].  Slots without edges give zero rows.
// Each entry point has a bf16 twin (`<name>_bf16`, the JAX package's
// compute_dtype bfloat16, which feeds the Pallas kernels bf16 operands):
// x, w and out bf16, the CSR and its scales as for fp32.  It keeps the
// Pallas kernels' arithmetic: each scale rounded to bf16, the gather's sums
// in fp32, the column buffer rounded to bf16 before the GEMM, the GEMM's
// sums in fp32, the output rounded to bf16 (K3 rounds the gathered dout,
// where the Pallas kernel rounds dout @ W_d^T: see K3 below).
//
// K1 graph_conv_fwd     out = col(x) @ w
// K2 graph_conv_col     col(x) itself, [G, 7C] (recomputed for dW = col^T dout)
// K3 graph_conv_bwd_dx  dx = sum_d A_d^T (dout @ W_d^T)
//                          = sum_d (A_d^T dout) @ W_d^T
//    over the transposed CSR (slots col*7+dir, holding each edge's row and
//    scale): the gathered operand is dout and the GEMM reads W_d transposed
//    in place.  In bf16 the two orders round at other points (this one the
//    gathered dout, the Pallas kernel dout @ W_d^T), so K3's bf16 output
//    holds to the Pallas order within 2^-6 of its largest magnitude, not
//    bit for bit.
// K5 graph_conv_fwd_packed  out = col(x) @ w, in chunks of the flat 7C axis
//
// K1, K3 and K5 are one template, gather_gemm_kernel<BN, kT, kFlat>, which
// replaces the forward `_fwd_kernel`, the input gradient `_bwd_kernel` and
// the k-packed forward `_fwd_kernel_packed` of
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
//   over the K-chunks whose products add into the same accumulators.  A
//   gather then issues only the neighbour rows' loads, all addresses
//   known: a warp keeps the first edge of each of its 8 rows in flight
//   together, then any deeper edges kDeep a row at a time (one lane per
//   column of the chunk, so each is one coalesced line, or two where a K5
//   chunk crosses a direction).  A tile without edges writes zeros.
// - The K-chunks.  K1 and K3 walk (direction, 32 channels) over the
//   directions with edges in the piece: ceil(C/32) chunks a direction, so
//   a ragged or narrow C pads every direction's last chunk.  K5 (kFlat)
//   walks the flat 7C axis in chunks of 32 columns, ceil(7C/32) in all
//   (C = 515: 113 against 119; C = 6: 2 against 7), skipping the chunks
//   whose directions have no edges in the piece.  A K5 chunk may span
//   several directions (two at C >= 32, up to six at C = 6): each lane
//   finds its own direction d = (k0 + lane) / C and channel, reads its
//   own (row, d) slot from the slot table, and walks deeper edges to the
//   warp's largest count with a predicate.  Its W chunk is the 32
//   contiguous rows k0 .. k0 + 32 of w.
// - One gathered [64, 32] chunk serves BN output columns, so the column
//   buffer is gathered ceil(C'/128) times instead of C'/64.
// - Two stages in dynamic shared memory: while the tensor cores multiply
//   chunk i, W's chunk i+1 arrives by cp.async and the loads of chunk
//   i+1's gather are in flight; one block barrier per chunk.
// - Math: mma.sync m16n8k8 TF32 in the 3xTF32 split (a_lo b_hi + a_hi b_lo
//   + a_hi b_hi), each 8-deep step from a zero fragment, added to the fp32
//   accumulators with IEEE adds (the tensor cores' own fp32 accumulation
//   truncates: over the whole 7C axis its bias reaches ~1e-4 at C = 515):
//   fp32 accuracy.  bf16: the gathered chunk is stored rounded to bf16 and
//   each 16-deep step is one mma.sync m16n8k16 bf16 straight into the fp32
//   accumulators (the truncation's ~1e-4 is far below a bf16 ulp, 2^-8; no
//   split); W's chunk is staged k-major with stride BN + 8, and a B register
//   pairs two k-adjacent bf16 of one column.  8 warps, each a 32 x 32
//   (BN = 128) or 16 x 32 / 16 x 16 slice of the tile, which skips its
//   8-column tiles past N.  A split into TF32 halves rounds with two
//   integer operations (cvt.rna.tf32.f32 compiles to several).  K1's and
//   K5's B is W's chunk, staged k-major; K3's is W_d^T read in place
//   (w[(d*N + n)*K + k] is k-contiguous), staged n-major.  A fragment's
//   k slots t and t + 4 take the adjacent k = 2t, 2t + 1, so A (and K3's
//   B) fragments load as 8-byte pairs; the strides keep every fragment
//   read free of bank conflicts.
// - Ragged widths: W's chunks load in 16-byte copies only where its rows
//   are 16-byte aligned (else 4-byte), zero-filled past K and N; the
//   gathered chunk's columns past K are zeros in shared memory, and only
//   the chunk's 8-deep steps that hold data run.
// Shared memory: 2 stages of (64 * 40 + 32 * 132) floats (K3: 64 * 40 +
// 128 * 40) and the CSR slice, 452 + 448 + 2 * 1024 words: 66.1 KB (K1 and
// K5, BN = 128) or 73.2 KB (K3), dynamic; bf16 stages of half the bytes
// (64 * 40 + 32 * 136 bf16; K3 64 * 40 + 128 * 40): 38.5 KB or 41.8 KB;
// registers allow two blocks an SM.
//
// K2 graph_conv_col replaces `_col_kernel`.  By count it is bound by its
// bytes, 7/8 of them the [G, 7C] write; in practice also by the latency
// of its dependent loads (slot bounds -> edge -> neighbour row), since
// most slots hold one edge or none.  The column buffer is written as one
// stream: a block of 512 threads owns a stretch of whole slots, about
// kColFloats floats of col (fewer where the level is small, so that every
// SM gets two stretches) and at most a tile's 448 slots, a multiple of 4
// slots so that every stretch starts 16-byte aligned.
// - A stretch without edges (the padding rows past a level's nodes) is
//   written as zeros, nothing read.
// - Otherwise the block stages the stretch's slot pointers and edge range
//   (idx, scale) once by cp.async.  A thread's unit is 4 consecutive
//   floats of the stretch, stored in one 16-byte store whatever C: a
//   narrow C packs several slots into a warp (C = 8: 16 slots a warp),
//   and a unit that crosses a slot (C not a multiple of 4) sums each
//   float over its own slot.  x's rows load as float4 where C % 4 == 0 and
//   x is 16-byte aligned, else as 4 floats; the edge loop is unrolled 4
//   deep, so up to 4 neighbour loads are in flight.
// - A stretch whose edge range overflows the stage (kEdgeStage edges)
//   holds a heavy slot (a coarse node's face can border 4^k finer
//   nodes): there the warps share out (slot, 32-channel) pieces, a lane a
//   channel, reading the edges in place.
// Each (slot, channel) sum runs in edge order from zero, one fma per edge
// on the fp32 units, on every path.  bf16: a unit is 8 channels (16 bytes),
// x's rows load as 16-byte vectors where C % 8 == 0 and x is 16-byte
// aligned (else 8 scalar loads), each scale is rounded to bf16 and each
// sum rounded once to bf16 as it is stored.

// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDirs = 7;

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
constexpr int kGStride = GK + 8;        // elements a row of a gathered chunk

static_assert(GK == 32, "one lane per column of a gathered chunk");

// ---- K2 -------------------------------------------------------------
constexpr int kColThreads = 512;
constexpr int kColWarps = kColThreads / 32;
constexpr int kColFloats = 8192;        // col floats a stretch aims at
constexpr int kColSlots = kDirs * GM;   // at most a tile's 448 slots a stretch

// the shapes behind a BN-column tile of element type T (float or bf16).  A
// stage holds the gathered chunk, [GM][GK + 8], and B_d's chunk, [GK][BN +
// 4] floats or [GK][BN + 8] bf16 (K1, k-major) or [BN][GK + 8] (K3,
// n-major): strides that make every fragment read below free of bank
// conflicts.  Sizes in bytes.
template <typename T, int BN, bool kT>
struct GemmTile {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kWarpsN = BN == 128 ? 4 : 2;
  static constexpr int kWarpsM = kGemmWarps / kWarpsN;
  static constexpr int kMT = GM / (16 * kWarpsM);   // m16 tiles per warp
  static constexpr int kNT = BN / (8 * kWarpsN);    // n8 tiles per warp
  static constexpr int kBStride = kT ? GK + 8 : BN + (kBf16 ? 8 : 4);
  static constexpr int kABytes = GM * kGStride * (int)sizeof(T);
  static constexpr int kBBytes =
      (kT ? BN * kBStride : GK * kBStride) * (int)sizeof(T);
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem =
      2 * kStageBytes + (kPtrWords + kSlotWords + 2 * kEdgeStage) * 4;
  static_assert(kMT >= 1 && kNT >= 1 && kWarpsM * 16 * kMT == GM,
                "the warps cover the tile");
  static_assert(kABytes % 16 == 0 && kBBytes % 16 == 0,
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

// bf16 <-> fp32.  A bf16 is the upper half of an fp32, so widening is
// exact; narrowing rounds to nearest even (__float2bfloat16_rn)
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// d += a @ b on a 16 x 8 x 16 bf16 tile (fp32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 as one mma operand register, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16;
}

// out[G, N] = sum_d gather_d(src)[G, K] @ B_d[K, N], where
// gather_d(src)[r, k] = sum_{e in slot r*7+d} scale[e] * src[idx[e], k] and
// B_d = w[d*K:(d+1)*K, :] ([7K, N]; K1 and K5) or w[d*N:(d+1)*N, :]^T
// ([7N, K]; K3).  kFlat (K5): the same sum as K1's, in chunks of the flat
// [G, 7K] column buffer and W's matching rows.  vec_w: W's rows are
// 16-byte aligned (w aligned and N (K1, K5) or K (K3) a multiple of 4
// floats or 8 bf16).  T = float: fp32 operands, the 3xTF32 split.  T =
// bf16 (the JAX package's bfloat16 compute mode): src and w bf16, each
// edge's scale rounded to bf16 (the Pallas kernel's one-hot matrix holds
// it in the operand dtype), the gather's sums in fp32, the gathered chunk
// rounded to bf16 in shared memory and multiplied by one bf16 mma.sync
// m16n8k16 a 16-deep step into the fp32 accumulators, out rounded to bf16.
template <typename T, int BN, bool kT, bool kFlat>
__global__ void __launch_bounds__(kGemmThreads, 2)
gather_gemm_kernel(const T* __restrict__ src,
                   const T* __restrict__ w,
                   const int* __restrict__ ptr,
                   const int* __restrict__ idx,
                   const float* __restrict__ scale,
                   T* __restrict__ out,
                   int G, int K, int N, int vec_w) {
  static_assert(!(kT && kFlat), "the flat walk is a forward");
  using Tile = GemmTile<T, BN, kT>;
  constexpr bool kBf16 = Tile::kBf16;
  extern __shared__ __align__(16) unsigned char gemm_smem[];  // 2 x [A | B_d]
  unsigned char* smem = gemm_smem;
  int* sptr = reinterpret_cast<int*>(smem + 2 * Tile::kStageBytes);
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
  const int wm = (warp / Tile::kWarpsN) * 16 * Tile::kMT;
  const int wn = (warp % Tile::kWarpsN) * 8 * Tile::kNT;
  const int KW = kFlat ? kDirs * K : K;    // the K axis the chunks walk
  const int nk = (KW + GK - 1) / GK;
  const int e_begin = ptr[m0 * kDirs];
  const int e_end = ptr[(m0 + rows) * kDirs];

  float acc[Tile::kMT][Tile::kNT][4];
#pragma unroll
  for (int i = 0; i < Tile::kMT; ++i)
#pragma unroll
    for (int j = 0; j < Tile::kNT; ++j)
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
    // | count, and the directions that have any; bf16: the scales rounded
    // to bf16, as the Pallas kernel's one-hot matrix carries them
    for (int s = tid; s < rows * kDirs; s += kGemmThreads) {
      const int b = min(max(sptr[s] - pe, 0), np);
      const int e = min(max(sptr[s + 1] - pe, 0), np);
      sslot[s] = b << 16 | (e - b);
      if (e > b) atomicOr(&dir_mask, 1u << (s % kDirs));
    }
    if constexpr (kBf16) {
      for (int i = tid; i < np; i += kGemmThreads) {
        sscale[i] = to_f32(from_f32<T>(sscale[i]));
      }
    }
    __syncthreads();
    auto slot_range = [&](int s, int& b, int& e) {
      const int v = sslot[s];
      b = v >> 16;
      e = b + (v & 0xffff);
    };
    const unsigned mask = dir_mask;
    constexpr unsigned kAllDirs = (1u << kDirs) - 1u;

    // K5: does flat chunk c span a direction with edges in the piece?
    auto chunk_live = [&](int c) {
      const int d0 = c * GK / K;
      const int d1 = (min(c * GK + GK, KW) - 1) / K;
      return ((mask >> d0) & ((2u << (d1 - d0)) - 1u)) != 0u;
    };
    int steps = __popc(mask) * nk;
    if constexpr (kFlat) {
      steps = nk;
      if (mask != kAllDirs) {
        steps = 0;
        for (int c = 0; c < nk; ++c) steps += chunk_live(c);
      }
    }

    // step i -> (direction d, first channel k0) over the piece's
    // directions with edges; K5: (0, first flat column) of the i-th live
    // chunk, the steps taken in order
    int cursor = -1;
    auto step_at = [&](int i, int& d, int& k0) {
      if constexpr (kFlat) {
        do {
          ++cursor;
        } while (mask != kAllDirs && !chunk_live(cursor));
        d = 0;
        k0 = cursor * GK;
        return;
      }
      int j = i / nk;
      k0 = (i - j * nk) * GK;
      unsigned m = mask;
      for (; j > 0; --j) m &= m - 1;
      d = __ffs(m) - 1;
    };

    // W's [GK, BN] chunk of direction d (K5: rows k0 .. k0 + GK of w) into
    // stage `st`: 16-byte cp.async copies where vec_w (4 floats or 8
    // bf16), else fp32 4-byte cp.async copies and bf16 2-byte loads
    constexpr int kVec = 16 / sizeof(T);
    auto load_w = [&](int st, int d, int k0) {
      T* bs = reinterpret_cast<T*>(smem + st * Tile::kStageBytes +
                                   Tile::kABytes);
      if (!kT) {            // B_d[k][n] = w[(d*K + k)*N + n], k-major
        if (vec_w) {
          for (int i = tid; i < GK * BN / kVec; i += kGemmThreads) {
            const int k = i / (BN / kVec);
            const int n = (i % (BN / kVec)) * kVec;
            const int kk = k0 + k;
            const int nn = n0 + n;
            const int bytes =
                kk < KW ? min(max(N - nn, 0), kVec) * (int)sizeof(T) : 0;
            cp_async16(bs + k * Tile::kBStride + n,
                       bytes ? w + ((int64_t)d * K + kk) * N + nn : w, bytes);
          }
        } else {
          for (int i = tid; i < GK * BN; i += kGemmThreads) {
            const int k = i / BN;
            const int n = i % BN;
            const bool ok = k0 + k < KW && n0 + n < N;
            const T* p = ok ? w + ((int64_t)d * K + k0 + k) * N + n0 + n : w;
            if constexpr (kBf16) {
              bs[k * Tile::kBStride + n] = ok ? p[0] : from_f32<T>(0.f);
            } else {
              cp_async4(bs + k * Tile::kBStride + n, p, ok ? 4 : 0);
            }
          }
        }
      } else {              // B_d[k][n] = w[(d*N + n)*K + k], n-major
        if (vec_w) {
          for (int i = tid; i < BN * GK / kVec; i += kGemmThreads) {
            const int n = i / (GK / kVec);
            const int k = (i % (GK / kVec)) * kVec;
            const int kk = k0 + k;
            const int nn = n0 + n;
            const int bytes =
                nn < N ? min(max(K - kk, 0), kVec) * (int)sizeof(T) : 0;
            cp_async16(bs + n * Tile::kBStride + k,
                       bytes ? w + ((int64_t)d * N + nn) * K + kk : w, bytes);
          }
        } else {
          for (int i = tid; i < BN * GK; i += kGemmThreads) {
            const int n = i / GK;
            const int k = i % GK;
            const bool ok = k0 + k < K && n0 + n < N;
            const T* p = ok ? w + ((int64_t)d * N + n0 + n) * K + k0 + k : w;
            if constexpr (kBf16) {
              bs[n * Tile::kBStride + k] = ok ? p[0] : from_f32<T>(0.f);
            } else {
              cp_async4(bs + n * Tile::kBStride + k, p, ok ? 4 : 0);
            }
          }
        }
      }
    };

    // the lane's column of chunk (d, k0): its direction and its channel of
    // src, false past the K axis.  K5: flat column k0 + lane, in direction
    // (k0 + lane) / K
    auto lane_column = [&](int d, int k0, int& dl, int& kc) {
      kc = k0 + lane;
      dl = d;
      if constexpr (kFlat) {
        dl = kc / K;
        kc -= dl * K;
        return dl < kDirs;
      }
      return kc < K;
    };

    // the gather of chunk (d, k0): warp w takes rows w + 8h, lane its
    // column k0 + lane.  gather_issue loads the first kEarly edges of all
    // 8 rows at once; gather_finish (after the math) scales and sums them,
    // walks any deeper edges with the 8 rows in step, and stores the chunk
    // (bf16: rounded to bf16)
    float raw[kRowsPerWarp][kEarly];
    auto gather_issue = [&](int d, int k0) {
      int dl, kc;
      const bool live = lane_column(d, k0, dl, kc);
#pragma unroll
      for (int h = 0; h < kRowsPerWarp; ++h) {
        const int r = warp + h * kGemmWarps;
        int b = 0, e = 0;
        if (r < rows && live) slot_range(r * kDirs + dl, b, e);
#pragma unroll
        for (int u = 0; u < kEarly; ++u) {
          raw[h][u] = b + u < e
                          ? ldg_f32(src + (int64_t)sidx[b + u] * K + kc) : 0.f;
        }
      }
    };
    auto gather_finish = [&](int st, int d, int k0) {
      T* as = reinterpret_cast<T*>(smem + st * Tile::kStageBytes);
      int dl, kc;
      const bool live = lane_column(d, k0, dl, kc);
      float sum[kRowsPerWarp];
      int bs[kRowsPerWarp], es[kRowsPerWarp];
      int deepest = 0;
#pragma unroll
      for (int h = 0; h < kRowsPerWarp; ++h) {
        const int r = warp + h * kGemmWarps;
        int b = 0, e = 0;
        if (r < rows && live) slot_range(r * kDirs + dl, b, e);
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
            v[h][q] = e < es[h] ? ldg_f32(src + (int64_t)sidx[e] * K + kc)
                                : 0.f;
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
        as[(warp + h * kGemmWarps) * kGStride + lane] = from_f32<T>(sum[h]);
      }
    };

    // acc += chunk (A of stage st) @ B_d's chunk, over its 8-deep (fp32)
    // or 16-deep (bf16) steps that hold data.  The sum over a step does
    // not depend on which k meets which fragment slot, so an fp32
    // fragment's slots t and t + 4 take the adjacent k = 2t and 2t + 1: one
    // 8-byte read gives both.  A bf16 fragment register holds the adjacent
    // k = 2t, 2t + 1 (and 2t + 8, 2t + 9) by the instruction's layout
    auto multiply = [&](int st, int k0) {
      if constexpr (kBf16) {
        const T* as =
            reinterpret_cast<const T*>(smem + st * Tile::kStageBytes);
        const T* bsm = reinterpret_cast<const T*>(
            smem + st * Tile::kStageBytes + Tile::kABytes);
        const int ksteps = (min(GK, KW - k0) + 15) / 16;
#pragma unroll
        for (int ks = 0; ks < GK / 16; ++ks) {
          if (ks >= ksteps) break;
          const int kb = ks * 16 + 2 * ft;
          unsigned a[Tile::kMT][4];
#pragma unroll
          for (int i = 0; i < Tile::kMT; ++i) {
            const T* p = as + (wm + 16 * i + fg) * kGStride + kb;
            a[i][0] = *reinterpret_cast<const unsigned*>(p);
            a[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * kGStride);
            a[i][2] = *reinterpret_cast<const unsigned*>(p + 8);
            a[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * kGStride + 8);
          }
#pragma unroll
          for (int j = 0; j < Tile::kNT; ++j) {
            if (n0 + wn + 8 * j >= N) break;    // columns past N: zeros
            const int n = wn + 8 * j + fg;
            unsigned b[2];
            if (kT) {
              const T* q = bsm + n * Tile::kBStride + kb;
              b[0] = *reinterpret_cast<const unsigned*>(q);
              b[1] = *reinterpret_cast<const unsigned*>(q + 8);
            } else {
              const T* q = bsm + kb * Tile::kBStride + n;
              b[0] = pack_bf16(q[0], q[Tile::kBStride]);
              b[1] = pack_bf16(q[8 * Tile::kBStride], q[9 * Tile::kBStride]);
            }
#pragma unroll
            for (int i = 0; i < Tile::kMT; ++i) mma_bf16(acc[i][j], a[i], b);
          }
        }
      } else {
        const float* as =
            reinterpret_cast<const float*>(smem + st * Tile::kStageBytes);
        const float* bsm = reinterpret_cast<const float*>(
            smem + st * Tile::kStageBytes + Tile::kABytes);
        const int ksteps = (min(GK, KW - k0) + 7) / 8;
#pragma unroll
        for (int ks = 0; ks < GK / 8; ++ks) {
          if (ks >= ksteps) break;
          const int kb = ks * 8 + 2 * ft;
          unsigned a_hi[Tile::kMT][4], a_lo[Tile::kMT][4];
#pragma unroll
          for (int i = 0; i < Tile::kMT; ++i) {
            const float* p = as + (wm + 16 * i + fg) * kGStride + kb;
            const float2 r0 = *reinterpret_cast<const float2*>(p);
            const float2 r8 =
                *reinterpret_cast<const float2*>(p + 8 * kGStride);
            split_tf32_bits(r0.x, a_hi[i][0], a_lo[i][0]);  // (row g, k 2t)
            split_tf32_bits(r8.x, a_hi[i][1], a_lo[i][1]);  // (g + 8, 2t)
            split_tf32_bits(r0.y, a_hi[i][2], a_lo[i][2]);  // (g, 2t + 1)
            split_tf32_bits(r8.y, a_hi[i][3], a_lo[i][3]);  // (g + 8, 2t + 1)
          }
#pragma unroll
          for (int j = 0; j < Tile::kNT; ++j) {
            if (n0 + wn + 8 * j >= N) break;    // columns past N: zeros
            const int n = wn + 8 * j + fg;
            float b0, b1;             // (k 2t, col g) and (k 2t + 1, col g)
            if (kT) {
              const float2 v = *reinterpret_cast<const float2*>(
                  bsm + n * Tile::kBStride + kb);
              b0 = v.x;
              b1 = v.y;
            } else {
              b0 = bsm[kb * Tile::kBStride + n];
              b1 = bsm[(kb + 1) * Tile::kBStride + n];
            }
            unsigned b_hi[2], b_lo[2];
            split_tf32_bits(b0, b_hi[0], b_lo[0]);
            split_tf32_bits(b1, b_hi[1], b_lo[1]);
#pragma unroll
            for (int i = 0; i < Tile::kMT; ++i) {
              float part[4];
              mma_tf32_zero(part, a_lo[i], b_hi);
              mma_tf32(part, a_hi[i], b_lo);
              mma_tf32(part, a_hi[i], b_hi);
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[i][j][q] += part[q];
            }
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
  for (int i = 0; i < Tile::kMT; ++i) {
#pragma unroll
    for (int j = 0; j < Tile::kNT; ++j) {
      const int c = n0 + wn + 8 * j + 2 * ft;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm + 16 * i + fg + 8 * half;
        if (r >= G) continue;
        T* o = out + (int64_t)r * N + c;
        if (c < N) o[0] = from_f32<T>(acc[i][j][2 * half]);
        if (c + 1 < N) o[1] = from_f32<T>(acc[i][j][2 * half + 1]);
      }
    }
  }
}

template <typename T, int BN, bool kT, bool kFlat>
int launch_gather_gemm(const T* src, const T* w, const int* ptr,
                       const int* idx, const float* scale, T* out, int G,
                       int K, int N, cudaStream_t stream) {
  using Tile = GemmTile<T, BN, kT>;
  // the opt-in to more than 48 KB of dynamic shared memory, once per
  // instantiation: a launch makes no other runtime call
  static const cudaError_t attr = cudaFuncSetAttribute(
      gather_gemm_kernel<T, BN, kT, kFlat>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int vec_w = (kT ? K : N) % (16 / (int)sizeof(T)) == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((G + GM - 1) / GM, (N + BN - 1) / BN);
  gather_gemm_kernel<T, BN, kT, kFlat>
      <<<grid, kGemmThreads, Tile::kSmem, stream>>>(src, w, ptr, idx, scale,
                                                    out, G, K, N, vec_w);
  return static_cast<int>(cudaGetLastError());
}

// the tile's width: the whole N up to 128 columns
template <typename T, bool kT, bool kFlat>
int gather_gemm(const T* src, const T* w, const int* ptr, const int* idx,
                const float* scale, T* out, int G, int K, int N,
                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 32) {
    return launch_gather_gemm<T, 32, kT, kFlat>(src, w, ptr, idx, scale, out,
                                                G, K, N, s);
  }
  if (N <= 64) {
    return launch_gather_gemm<T, 64, kT, kFlat>(src, w, ptr, idx, scale, out,
                                                G, K, N, s);
  }
  return launch_gather_gemm<T, 128, kT, kFlat>(src, w, ptr, idx, scale, out,
                                               G, K, N, s);
}

// K2 writes col in units of U = 16 / sizeof(T) consecutive elements (4
// floats or 8 bf16), one 16-byte store each
template <typename T>
constexpr int kUnit = 16 / (int)sizeof(T);

// an edge's scale in the operand's dtype, as the Pallas kernel's one-hot
// matrix carries it: rounded to bf16 where T is bf16
template <typename T>
__device__ __forceinline__ float edge_scale(float s) {
  return to_f32(from_f32<T>(s));
}

// K2: U consecutive elements of x's row from p as floats, as one 16-byte
// load (kVecX: p 16-byte aligned) or as U loads
template <typename T, bool kVecX>
__device__ __forceinline__ void load_unit(const T* p, float (&r)[kUnit<T>]) {
  if constexpr (kVecX && sizeof(T) == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  } else if constexpr (kVecX) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {      // a bf16 is an fp32's upper half
      r[2 * j] = __uint_as_float(u[j] << 16);
      r[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kUnit<T>; ++j) r[j] = ldg_f32(p + j);
  }
}

// K2: a unit of U floats into col at dst (16-byte aligned), in one 16-byte
// streaming store (bf16: each rounded to nearest even)
template <typename T>
__device__ __forceinline__ void store_unit(T* dst,
                                           const float (&a)[kUnit<T>]) {
  if constexpr (sizeof(T) == 4) {
    __stcs(reinterpret_cast<float4*>(dst),
           make_float4(a[0], a[1], a[2], a[3]));
  } else {
    unsigned u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      u[j] = pack_bf16(__float2bfloat16_rn(a[2 * j]),
                       __float2bfloat16_rn(a[2 * j + 1]));
    }
    __stcs(reinterpret_cast<uint4*>(dst), make_uint4(u[0], u[1], u[2], u[3]));
  }
}

// A (slot, channel) sum of K2, sum_e scale[e] * x[idx[e], k] over the
// slot's edges in edge order from 0 (one fma per edge), is the same
// float on every path below (bf16: then rounded once).

// K2, a unit of U elements that crosses a slot boundary (or ends the
// stretch): each element over its own slot, the next edge's index read
// before this edge's sum
template <typename T>
__device__ __forceinline__ void col_crossing(
    const T* __restrict__ x, const int* eidx, const float* escale,
    const int* sptr, int e_begin, T* dst, int f, int nflat, int C) {
  constexpr int U = kUnit<T>;
  int b[U], e[U], c[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    b[j] = e[j] = c[j] = 0;
    if (f + j < nflat) {
      const int sl = (f + j) / C;
      c[j] = f + j - sl * C;
      b[j] = sptr[sl] - e_begin;
      e[j] = sptr[sl + 1] - e_begin;
    }
  }
  float a[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    a[j] = 0.f;
    int nx = b[j] < e[j] ? eidx[b[j]] : 0;
    for (int u = b[j]; u < e[j]; ++u) {
      const float r = ldg_f32(x + (int64_t)nx * C + c[j]);
      nx = u + 1 < e[j] ? eidx[u + 1] : 0;
      a[j] = fmaf(edge_scale<T>(escale[u]), r, a[j]);
    }
  }
  if (f + U <= nflat) {
    store_unit<T>(dst + f, a);
  } else {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (f + j < nflat) dst[f + j] = from_f32<T>(a[j]);
    }
  }
}

// K2 over a staged stretch: thread t's units start at f = U * (t + i *
// kColThreads), each stored in one 16-byte store; eidx / escale and the
// slot pointers in shared memory
template <typename T, bool kVecX>
__device__ __forceinline__ void col_stream(
    const T* __restrict__ x, const int* eidx, const float* escale,
    const int* sptr, int e_begin, T* dst, int nflat, int C) {
  constexpr int U = kUnit<T>;
  for (int f = U * threadIdx.x; f < nflat; f += U * kColThreads) {
    const int ls = f / C;
    const int ch = f - ls * C;
    const bool one_slot = ch + U <= C;
    int b = 0, e = 0;
    if (one_slot) {
      b = sptr[ls] - e_begin;
      e = sptr[ls + 1] - e_begin;
    }
    float v[U];
#pragma unroll
    for (int j = 0; j < U; ++j) v[j] = 0.f;
#pragma unroll 4
    for (int u = b; u < e; ++u) {
      float r[U];
      load_unit<T, kVecX>(x + (int64_t)eidx[u] * C + ch, r);
      const float s = edge_scale<T>(escale[u]);
#pragma unroll
      for (int j = 0; j < U; ++j) v[j] = fmaf(s, r[j], v[j]);
    }
    if (one_slot) {
      store_unit<T>(dst + f, v);
    } else {
      col_crossing<T>(x, eidx, escale, sptr, e_begin, dst, f, nflat, C);
    }
  }
}

// col[slot, k] = sum_{e in slot} scale[e] * x[col_idx[e], k] over the
// [slots, C] buffer ([G, 7C] viewed as [G*7, C]).  Block b writes the
// stretch of slots [b * nslot, (b + 1) * nslot): nslot * C elements that
// start 16-byte aligned (nslot % U == 0, col aligned).  A stretch
// without edges is a stream of zeros; one whose edges overflow the stage
// holds a heavy slot, and there the warps share out (slot, 32 channels)
// pieces, a lane per channel walking the slot's edges in place, so that
// a heavy slot's channels are walked by many warps at once.  kVecX: C %
// U == 0 and x 16-byte aligned.  T = bf16: x and col bf16, the scales
// rounded to bf16, the sums in fp32, each rounded once to bf16.
template <typename T, bool kVecX>
__global__ void __launch_bounds__(kColThreads)
graph_conv_col_kernel(const T* __restrict__ x,
                      const int* __restrict__ ptr,
                      const int* __restrict__ idx,
                      const float* __restrict__ scale,
                      T* __restrict__ col,
                      int slots, int C, int nslot) {
  constexpr int U = kUnit<T>;
  __shared__ int sptr[kColSlots + 1];
  __shared__ int sidx[kEdgeStage];
  __shared__ float sscale[kEdgeStage];

  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * nslot;
  const int ns = min(nslot, slots - s0);
  T* dst = col + (int64_t)s0 * C;
  const int nflat = ns * C;
  const int e_begin = ptr[s0];
  const int ne = ptr[s0 + ns] - e_begin;

  if (ne == 0) {
    int f = U * tid;
    for (; f + U <= nflat; f += U * kColThreads) {
      __stcs(reinterpret_cast<uint4*>(dst + f), make_uint4(0u, 0u, 0u, 0u));
    }
    for (int j = 0; j < U && f + j < nflat; ++j) dst[f + j] = from_f32<T>(0.f);
    return;
  }
  if (ne > kEdgeStage) {
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int pieces = (C + 31) / 32;
    for (int it = warp; it < ns * pieces; it += kColWarps) {
      const int sl = it / pieces;
      const int k = (it - sl * pieces) * 32 + lane;
      if (k >= C) continue;
      const int e = __ldg(ptr + s0 + sl + 1);
      float a = 0.f;
#pragma unroll 4
      for (int u = __ldg(ptr + s0 + sl); u < e; ++u) {
        a = fmaf(edge_scale<T>(__ldg(scale + u)),
                 ldg_f32(x + (int64_t)__ldg(idx + u) * C + k), a);
      }
      dst[(int64_t)sl * C + k] = from_f32<T>(a);
    }
    return;
  }
  // the stretch's slot pointers and edge range, once
  for (int i = tid; i <= ns; i += kColThreads) {
    cp_async4(sptr + i, ptr + s0 + i, 4);
  }
  for (int i = tid; i < ne; i += kColThreads) {
    cp_async4(sidx + i, idx + e_begin + i, 4);
    cp_async4(sscale + i, scale + e_begin + i, 4);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  col_stream<T, kVecX>(x, sidx, sscale, sptr, e_begin, dst, nflat, C);
}

// K2's stretch for channel width C over `slots` slots on `sms` SMs: about
// kColFloats elements of col, few enough slots that every SM gets two
// stretches, at most a tile's slots, a multiple of the unit's `u` slots
// (so that every stretch starts 16-byte aligned)
int col_stretch_slots(int C, int slots, int sms, int u) {
  const int s = min(kColFloats / C, slots / (2 * sms)) / u * u;
  return s < u ? u : (s > kColSlots ? kColSlots : s);
}

// K2 on the stream: col [G, 7C] must be 16-byte aligned (a fresh
// allocation is)
template <typename T>
int graph_conv_col_launch(const T* x, const int* row_ptr, const int* col_idx,
                          const float* scale, T* col, int G, int C,
                          void* stream) {
  if (reinterpret_cast<uintptr_t>(col) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  const int slots = G * kDirs;
  const int nslot = col_stretch_slots(C, slots, sms, kUnit<T>);
  const int blocks = (slots + nslot - 1) / nslot;
  if (C % kUnit<T> == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    graph_conv_col_kernel<T, true><<<blocks, kColThreads, 0, s>>>(
        x, row_ptr, col_idx, scale, col, slots, C, nslot);
  } else {
    graph_conv_col_kernel<T, false><<<blocks, kColThreads, 0, s>>>(
        x, row_ptr, col_idx, scale, col, slots, C, nslot);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fp32 entry points (T = float) and their bf16 twins (`_bf16`: x / dout,
// w and the output bf16; the CSR and its scales as for fp32)
using bf16 = __nv_bfloat16;

extern "C" int graph_conv_fwd(const float* x, const float* w,
                              const int* row_ptr, const int* col_idx,
                              const float* scale, float* out, int G, int C,
                              int Cout, void* stream) {
  return gather_gemm<float, false, false>(x, w, row_ptr, col_idx, scale, out,
                                          G, C, Cout, stream);
}

extern "C" int graph_conv_fwd_bf16(const bf16* x, const bf16* w,
                                   const int* row_ptr, const int* col_idx,
                                   const float* scale, bf16* out, int G,
                                   int C, int Cout, void* stream) {
  return gather_gemm<bf16, false, false>(x, w, row_ptr, col_idx, scale, out,
                                         G, C, Cout, stream);
}

// col [G, 7C] must be 16-byte aligned (a fresh allocation is)
extern "C" int graph_conv_col(const float* x, const int* row_ptr,
                              const int* col_idx, const float* scale,
                              float* col, int G, int C, void* stream) {
  return graph_conv_col_launch<float>(x, row_ptr, col_idx, scale, col, G, C,
                                      stream);
}

extern "C" int graph_conv_col_bf16(const bf16* x, const int* row_ptr,
                                   const int* col_idx, const float* scale,
                                   bf16* col, int G, int C, void* stream) {
  return graph_conv_col_launch<bf16>(x, row_ptr, col_idx, scale, col, G, C,
                                     stream);
}

// dout [G, Cout], w [7C, Cout], dx [G, C]; trow_ptr [G*7 + 1] over the
// (col, dir) slots of the edges sorted by col*7+dir, t_row / t_scale [E]
extern "C" int graph_conv_bwd_dx(const float* dout, const float* w,
                                 const int* trow_ptr, const int* t_row,
                                 const float* t_scale, float* dx, int G,
                                 int C, int Cout, void* stream) {
  return gather_gemm<float, true, false>(dout, w, trow_ptr, t_row, t_scale,
                                         dx, G, Cout, C, stream);
}

extern "C" int graph_conv_bwd_dx_bf16(const bf16* dout, const bf16* w,
                                      const int* trow_ptr, const int* t_row,
                                      const float* t_scale, bf16* dx, int G,
                                      int C, int Cout, void* stream) {
  return gather_gemm<bf16, true, false>(dout, w, trow_ptr, t_row, t_scale,
                                        dx, G, Cout, C, stream);
}

// K5: arguments as for graph_conv_fwd
extern "C" int graph_conv_fwd_packed(const float* x, const float* w,
                                     const int* row_ptr, const int* col_idx,
                                     const float* scale, float* out, int G,
                                     int C, int Cout, void* stream) {
  return gather_gemm<float, false, true>(x, w, row_ptr, col_idx, scale, out,
                                         G, C, Cout, stream);
}

extern "C" int graph_conv_fwd_packed_bf16(const bf16* x, const bf16* w,
                                          const int* row_ptr,
                                          const int* col_idx,
                                          const float* scale, bf16* out,
                                          int G, int C, int Cout,
                                          void* stream) {
  return gather_gemm<bf16, false, true>(x, w, row_ptr, col_idx, scale, out,
                                        G, C, Cout, stream);
}
