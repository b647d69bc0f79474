// Bidirectional nearest-neighbour squared distances (K4) for Hopper (sm_90a)
//
//   dl[p, i] = min_j |a[p, i] - b[p, j]|^2      a [B, N, 3], dl [B, N]
//   dr[p, j] = min_i |a[p, i] - b[p, j]|^2      b [B, M, 3], dr [B, M]
//
// fp32, row-major and contiguous.  Replaces the Pallas kernel
// octfusion_tpu/ops/pallas/chamfer_kernel.py::_kernel, which walks a
// sequential (B, N/1024, M/1024) grid, revisits dl over j and dr over i,
// and pads both clouds to 1024 with far points.  Here blocks run in
// parallel and in no order: a block holds some rows of a, streams all of
// b, and so finishes its rows' dl itself; dr's column minima are merged
// across the blocks of a pair with one atomicMin per column per block on
// dr's int bit pattern, which the wrapper fills with +inf first.
//
// Arithmetic: the expansion of the plain version and of the Pallas kernel,
// d = |a|^2 - 2 a.b + |b|^2, clamped at +0 after the minima (max and min
// commute), so near-duplicate clouds carry its cancellation (~1e-7 |a|^2)
// and identical points give ~1e-8, not exactly 0, as the plain version.
//
// What bounds it.  Per pair the work is the distance (8 FLOP as a direct
// or expanded form) and two minima.  The direct form on the fp32 units
// issues 8 instructions per pair, so it can reach at most half of the
// 67 TFLOP/s fp32 bound; the expansion with b' = -2b and |b|^2 staged
// issues 5 (3 FMAs, the add of |a|^2, one three-way minimum).
// chamfer_tc_kernel moves the distances to the tensor cores and leaves
// the CUDA cores the minima:
//
// * With b' = -2b, m = |b|^2 and n = |a|^2 split into TF32 halves
//   (x = x_h + x_l; the split's a_l b'_l, ~2^-22 relative, is dropped),
//       d = [b'_h, 1, m_h, 0 0 0] . [a_h, n_h, 1, 0 0 0]          (k = 8)
//         + [b'_l, b'_h, 1, m_l] . [a_h, a_l, n_l, 1]              (k = 8)
//   two wgmma m64n128k8 TF32 per 64 points of b x 128 rows of a, the small
//   one from zero and the large one added on top, as K1's 3xTF32 step.
// * A block is one warpgroup holding 128 rows of a as B in shared memory
//   (K-major, no swizzle), staged once; b streams through in chunks of
//   512 points whose A fragments (slot pairs t, t + 4, so a lane loads
//   them with two 8-byte reads a product) are built once per block and
//   read into registers for each 64-point tile.  The next chunk's
//   coordinates are loaded under the current chunk's products.
// * The minima run on the float's int bit pattern with the DPX three-way
//   minimum __vimin3_s32 (one VIMNMX3, 64 per SM and clock): one per
//   pair, 4 per 4 pairs of a thread's accumulator quad.  A tile's minima
//   over b's points need 2 shuffles (the 4 lanes of a row) and go to dr
//   by atomicMin; the minima over a's rows stay in registers until the
//   end, then go over 8 lanes and the 4 warps.
// * Its bound (ops/roofline.py) is the minima at that rate, 2x the tensor
//   cores' time for the products; scripts/k4_shapes.py prints its share
//   and the share of the 8-FLOP fp32 bound.  What holds it under the bound
//   is the tensor cores at k = 8: the products alone (no minima) take
//   most of the kernel's time, the wgmma pair and its wait are not
//   overlapped with the minima inside a block (a two-accumulator pipeline
//   made ptxas serialise the wgmmas), only across the 4 blocks an SM holds
//   (127 registers).
//
// Minima on bit patterns: for values >= +0 the int order is the float's; a
// negative value (cancellation, or -0.0) wins and is clamped to +0.0 at the
// store, which is what the plain version's clamp gives.  Padding points
// are never in memory: a row past N or a column past M has coordinates 0
// and a squared norm of 2^125, so every distance that involves one is
// 2^125 or more, finite, and is stored as +inf (no entry) if nothing else
// reached that output.
//
// Special points.  A row of a or point of b whose squared norm is NaN,
// infinite or 2^120 or more (a NaN or infinite coordinate, or one of
// ~1e18 or more) goes to the tensor cores as padding, and its distances
// are computed apart, in the plain version's order of operations
// (exact_bits), after the pair loop and only in a block that met one
// (special_pairs): if it streamed a special point, it walks b again and
// takes its rows against each; then each special row it holds against
// all of b.  So a
// NaN or an infinity gives what the plain version and the JAX package
// give: dl[p, i] is NaN when a[p, i] holds a NaN or any point of b[p]
// does (and dr likewise), an infinite coordinate gives NaN or +inf by the
// signs of the products, an overflowing norm gives +inf.  Below 2^120 the
// tensor cores' sums cannot overflow nor a padding distance win.  The
// exact distances are merged as bit patterns too, NaN as kNaNBits, a NaN
// whose signed pattern is below every value >= +0, so that it wins every
// minimum.  special_pairs is a call of its own (noinline): inlined, it
// kept 132 registers live over the pair loop, 3 blocks an SM, not 4.
// Outputs are +0.0 or more, never -0.0, or NaN (of either sign).
//
// The entry points return cudaGetLastError() after their launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFarBits = 0x7e000000;           // 2^125, exact in TF32
constexpr float kSpecial = 0x1p120f;           // |x|^2 of a special point
constexpr float kNone = 0x1p124f;              // above every real distance
constexpr int kInfBits = 0x7f800000;           // +inf
constexpr int kNaNBits = (int)0xffc00000u;     // NaN, negative as an int
constexpr unsigned kOneBits = 0x3f800000u;     // 1.0f

__device__ __forceinline__ float far_norm() { return __int_as_float(kFarBits); }

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return fmaf(z, z, fmaf(y, y, x * x));
}

__device__ __forceinline__ int min3(int a, int b, int c) {
  return __vimin3_s32(a, b, c);
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

// the store of a tensor-core minimum held as a bit pattern: +0.0 for a
// negative value or -0.0, +inf for one that only padding gave, else the
// value
__device__ __forceinline__ int finish_bits(int bits) {
  const float v = __int_as_float(bits);
  return !(v < kNone) ? kInfBits : __float_as_int(v > 0.f ? v : 0.f);
}

// a special pair's distance as the plain version forms it, unfused,
// (|a|^2 - 2 a.b) + |b|^2 clamped at +0, as a bit pattern: kNaNBits for
// a NaN, else +0.0 or more (+inf included)
__device__ __forceinline__ int exact_bits(const float* p, const float* q) {
  const float ax = p[0], ay = p[1], az = p[2];
  const float bx = q[0], by = q[1], bz = q[2];
  const float n = __fadd_rn(__fadd_rn(__fmul_rn(ax, ax), __fmul_rn(ay, ay)),
                            __fmul_rn(az, az));
  const float m = __fadd_rn(__fadd_rn(__fmul_rn(bx, bx), __fmul_rn(by, by)),
                            __fmul_rn(bz, bz));
  const float ab = __fadd_rn(
      __fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
  const float d = __fadd_rn(__fsub_rn(n, __fmul_rn(2.f, ab)), m);
  return isnan(d) ? kNaNBits : __float_as_int(d > 0.f ? d : 0.f);
}

// x rounded to TF32 (10 mantissa bits, half away from zero), as bits
__device__ __forceinline__ unsigned round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32 (hi rounded, lo the rounded residual)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

// ---- the tensor-core design ---------------------------------------------

constexpr int kWgThreads = 128;                // one warpgroup
constexpr int kHeld = 128;                     // rows of a per block: N
constexpr int kTile = 64;                      // points of b per product: M
constexpr int kChunk = 512;                    // points of b per stage
constexpr int kPer = kChunk / kWgThreads;      // points a thread stages
constexpr int kD = kHeld / 2;                  // accumulators per thread
// the staged A slots' row stride, 4 mod 16 points: a fragment's 8-byte
// reads by a half-warp (4 slot pairs x 4 points) hit distinct banks
constexpr int kSlotStride = kChunk + 4;
static_assert(kChunk % kTile == 0 && kChunk % kWgThreads == 0 &&
              kHeld == kWgThreads && kSlotStride % 16 == 4,
              "whole tiles; a thread per held row; conflict-free reads");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// B: 8 TF32 slots per held row, K-major without swizzle: 8-row groups of
// two 8 x 16-byte core matrices (slots 0-3, then 4-7), so row i's slots
// 4q .. 4q + 3 are the 16 bytes at float b_at(i) + 32 q
__device__ __forceinline__ int b_at(int i) {
  return (i / 8) * 64 + (i % 8) * 4;
}

// its wgmma descriptor: start address, K-direction core matrices 128 B
// apart (LBO), 8-row groups 256 B apart (SBO), no swizzle
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  return (uint64_t)((smem_addr(p) & 0x3ffff) >> 4) |
         (uint64_t)(128 >> 4) << 16 | (uint64_t)(256 >> 4) << 32;
}

__device__ __forceinline__ void put_b(float* op, int i, unsigned s0,
                                      unsigned s1, unsigned s2, unsigned s3,
                                      unsigned s4, unsigned s5, unsigned s6,
                                      unsigned s7) {
  float4* q = reinterpret_cast<float4*>(op + b_at(i));
  q[0] = make_float4(__uint_as_float(s0), __uint_as_float(s1),
                     __uint_as_float(s2), __uint_as_float(s3));
  q[8] = make_float4(__uint_as_float(s4), __uint_as_float(s5),
                     __uint_as_float(s6), __uint_as_float(s7));
}

__device__ __forceinline__ float2 pack(unsigned x, unsigned y) {
  return make_float2(__uint_as_float(x), __uint_as_float(y));
}

// d (+)= A[64 x 8] B[8 x 128]^T, A from registers (the warp's 16 rows as
// mma.sync's m16n8k8 fragment), B from shared memory; d keeps the sum
// when `accumulate`, else starts from zero
__device__ __forceinline__ void wgmma_tf32(float (&d)[kD],
                                           const unsigned (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d = A2 B2^T + A1 B1^T, then wait for it; every accumulator is tied to
// the wait so that no read of d moves above it
__device__ __forceinline__ void wgmma_distances(float (&d)[kD],
                                                const unsigned (&a1)[4],
                                                const unsigned (&a2)[4],
                                                uint64_t db1, uint64_t db2) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma_tf32(d, a2, db2, 0);
  wgmma_tf32(d, a1, db1, 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < kD; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The exact path of a block of chamfer_tc_kernel that met a special row
// or point (rare), a call of its own so that the pair loop keeps no
// register for it: the block's rows against each special point of b
// (if it streamed one), then each of its special rows against all of b.
// Thread tid holds row i0 + tid; srow, rspecial and bspecial are the
// block's shared arrays.
__device__ __noinline__ void special_pairs(
    const float* __restrict__ a, const float* __restrict__ b,
    int* __restrict__ dr_bits, int* srow, const unsigned char* rspecial,
    unsigned char* bspecial, int N, int M, int pair, int i0,
    bool saw_special) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int i = i0 + tid;
  const float* ap = a + (int64_t)pair * N * 3;
  const float* bp = b + (int64_t)pair * M * 3;
  int* drp = dr_bits + (int64_t)pair * M;
  if (__syncthreads_or(saw_special)) {
    for (int j0 = 0; j0 < M; j0 += kChunk) {
      for (int p = tid; p < kChunk; p += kWgThreads) {
        const float* bj = bp + (int64_t)(j0 + p) * 3;
        bspecial[p] = j0 + p < M && !(sq_norm(bj[0], bj[1], bj[2]) < kSpecial);
      }
      __syncthreads();
      for (int p = 0; p < kChunk; ++p) {
        if (!bspecial[p]) continue;
        int e = INT_MAX;
        if (i < N) {
          e = exact_bits(ap + (int64_t)i * 3, bp + (int64_t)(j0 + p) * 3);
          srow[tid] = min(srow[tid], e);
        }
        e = warp_min(e);
        if (lane == 0) atomicMin(drp + j0 + p, e);
      }
      __syncthreads();
    }
  }
  for (int r = 0; r < kHeld; ++r) {
    if (!rspecial[r]) continue;
    const float* ar = ap + (int64_t)(i0 + r) * 3;
    int v = INT_MAX;
    for (int j = tid; j < M; j += kWgThreads) {
      const int e = exact_bits(ar, bp + (int64_t)j * 3);
      v = min(v, e);
      atomicMin(drp + j, e);
    }
    v = warp_min(v);
    if (lane == 0) atomicMin(srow + r, v);
  }
}

// Slots (k = 0..7) of the two products; a row of A is a point of b, a row
// of B (a column of the product) a row of a:
//   A1 = [b'x_h b'y_h b'z_h 1 | m_h 0 0 0]    B1 = [x_h y_h z_h n_h | 1 0 0 0]
//   A2 = [b'x_l b'y_l b'z_l b'x_h | b'y_h b'z_h 1 m_l]
//   B2 = [x_h y_h z_h x_l | y_l z_l n_l 1]
// A is staged as slot pairs (t, t + 4) of each point, [product][t][point],
// and loaded as fragments: thread (warp w, g, t) takes points 16w + g and
// 16w + g + 8 of the tile at slots t and t + 4.  It then holds D's rows
// 16w + g and 16w + g + 8 (points of b) at columns 8j + 2t and
// 8j + 2t + 1 (rows of a), j = 0..15.
__global__ void __launch_bounds__(kWgThreads)
chamfer_tc_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ dl, int* __restrict__ dr_bits, int N,
                  int M, int row_blocks) {
  __shared__ float2 sa[2][4][kSlotStride];              // A1, A2 of a chunk
  __shared__ __align__(128) float sb[2][kHeld * 8];    // B1, B2
  __shared__ int hred[kWgThreads / 32][kHeld];
  __shared__ int srow[kHeld];                  // rows' exact minima
  __shared__ unsigned char rspecial[kHeld];
  __shared__ unsigned char bspecial[kChunk];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int pair = blockIdx.x / row_blocks;
  const int i0 = (blockIdx.x % row_blocks) * kHeld;
  const float* ap = a + (int64_t)pair * N * 3;
  const float* bp = b + (int64_t)pair * M * 3;

  // thread tid builds row i0 + tid of a as B's slots (a special row as
  // padding), and stores its dl
  {
    bool special = false;
    const int i = i0 + tid;
    float x = 0.f, y = 0.f, z = 0.f, n = far_norm();
    if (i < N) {
      x = ap[(int64_t)i * 3 + 0];
      y = ap[(int64_t)i * 3 + 1];
      z = ap[(int64_t)i * 3 + 2];
      n = sq_norm(x, y, z);
      special = !(n < kSpecial);
      if (special) x = y = z = 0.f, n = far_norm();
    }
    rspecial[tid] = special;
    srow[tid] = INT_MAX;
    unsigned xh, xl, yh, yl, zh, zl, nh, nl;
    split_tf32(x, xh, xl);
    split_tf32(y, yh, yl);
    split_tf32(z, zh, zl);
    split_tf32(n, nh, nl);
    put_b(sb[0], tid, xh, yh, zh, nh, kOneBits, 0u, 0u, 0u);
    put_b(sb[1], tid, xh, yh, zh, xl, yl, zl, nl, kOneBits);
  }
  // the generic-proxy stores of B, before wgmma reads it
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t db1 = b_desc(sb[0]), db2 = b_desc(sb[1]);

  int hmin[kD / 2];                    // column 8j + 2t + q at 2j + q
#pragma unroll
  for (int c = 0; c < kD / 2; ++c) hmin[c] = INT_MAX;

  // thread tid stages points tid + 128 q of each chunk, their coordinates
  // loaded a chunk ahead, under the previous chunk's products
  float px[kPer], py[kPer], pz[kPer];
  auto fetch = [&](int j0) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int j = j0 + tid + kWgThreads * q;
      px[q] = py[q] = pz[q] = 0.f;
      if (j < M) {
        px[q] = bp[(int64_t)j * 3 + 0];
        py[q] = bp[(int64_t)j * 3 + 1];
        pz[q] = bp[(int64_t)j * 3 + 2];
      }
    }
  };
  fetch(0);
  bool saw_special = false;
  float d[kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) d[i] = 0.f;
  for (int j0 = 0; j0 < M; j0 += kChunk) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int p = tid + kWgThreads * q;
      float x = px[q], y = py[q], z = pz[q];
      float m = sq_norm(x, y, z);
      const bool special = j0 + p < M && !(m < kSpecial);
      if (j0 + p >= M || special) x = y = z = 0.f, m = far_norm();
      saw_special |= special;
      unsigned xh, xl, yh, yl, zh, zl, mh, ml;
      split_tf32(-2.f * x, xh, xl);
      split_tf32(-2.f * y, yh, yl);
      split_tf32(-2.f * z, zh, zl);
      split_tf32(m, mh, ml);
      sa[0][0][p] = pack(xh, mh);
      sa[0][1][p] = pack(yh, 0u);
      sa[0][2][p] = pack(zh, 0u);
      sa[0][3][p] = pack(kOneBits, 0u);
      sa[1][0][p] = pack(xl, yh);
      sa[1][1][p] = pack(yl, zh);
      sa[1][2][p] = pack(zl, kOneBits);
      sa[1][3][p] = pack(xh, ml);
    }
    __syncthreads();
    if (j0 + kChunk < M) fetch(j0 + kChunk);

    const int tiles = (min(kChunk, M - j0) + kTile - 1) / kTile;
    for (int tile = 0; tile < tiles; ++tile) {
      const int p0 = tile * kTile + 16 * warp + g;
      unsigned af[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float2 v0 = sa[q][t][p0];
        const float2 v8 = sa[q][t][p0 + 8];
        af[q][0] = __float_as_uint(v0.x);
        af[q][1] = __float_as_uint(v8.x);
        af[q][2] = __float_as_uint(v0.y);
        af[q][3] = __float_as_uint(v8.y);
      }
      wgmma_distances(d, af[0], af[1], db1, db2);
      int s0 = INT_MAX, s1 = INT_MAX;          // points g and g + 8
#pragma unroll
      for (int j = 0; j < kD / 4; ++j) {
        const int d0 = __float_as_int(d[4 * j + 0]);
        const int d1 = __float_as_int(d[4 * j + 1]);
        const int d2 = __float_as_int(d[4 * j + 2]);
        const int d3 = __float_as_int(d[4 * j + 3]);
        hmin[2 * j] = min3(hmin[2 * j], d0, d2);
        hmin[2 * j + 1] = min3(hmin[2 * j + 1], d1, d3);
        s0 = min3(s0, d0, d1);
        s1 = min3(s1, d2, d3);
      }
      s0 = min(s0, __shfl_xor_sync(kFull, s0, 1));
      s1 = min(s1, __shfl_xor_sync(kFull, s1, 1));
      s0 = min(s0, __shfl_xor_sync(kFull, s0, 2));
      s1 = min(s1, __shfl_xor_sync(kFull, s1, 2));
      const int p = p0 + 8 * t;
      if (t < 2 && j0 + p < M)
        atomicMin(dr_bits + (int64_t)pair * M + j0 + p,
                  finish_bits(t ? s1 : s0));
    }
    __syncthreads();
  }

  // row minima of a: over the 8 lanes that share a column (g), then over
  // the 4 warps in shared memory; thread tid stores row i0 + tid
#pragma unroll
  for (int c = 0; c < kD / 2; ++c) {
    int v = hmin[c];
    v = min(v, __shfl_xor_sync(kFull, v, 4));
    v = min(v, __shfl_xor_sync(kFull, v, 8));
    v = min(v, __shfl_xor_sync(kFull, v, 16));
    if (g == 0) hred[warp][8 * (c / 2) + 2 * t + c % 2] = v;
  }

  // the exact path, in a block that met a special row or point
  if (__syncthreads_or(saw_special || rspecial[tid]))
    special_pairs(a, b, dr_bits, srow, rspecial, bspecial, N, M,
                  blockIdx.x / row_blocks, i0, saw_special);
  __syncthreads();
  const int i = i0 + tid;
  if (i < N) {
    const int v = min(min(hred[0][tid], hred[1][tid]),
                      min(hred[2][tid], hred[3][tid]));
    dl[(int64_t)pair * N + i] =
        __int_as_float(min(finish_bits(v), srow[tid]));
  }
}

}  // namespace

// a [B, N, 3], b [B, M, 3] -> dl [B, N]; dr [B, M] must hold +inf on entry
extern "C" int chamfer_fwd(const float* a, const float* b, float* dl,
                           float* dr, int B, int N, int M, void* stream) {
  const int row_blocks = (N + kHeld - 1) / kHeld;
  chamfer_tc_kernel<<<B * row_blocks, kWgThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      a, b, dl, reinterpret_cast<int*>(dr), N, M, row_blocks);
  return static_cast<int>(cudaGetLastError());
}
