// Bidirectional nearest-neighbour squared distances (K4) for Hopper (sm_90a)
//
//   dl[p, i] = min_j |a[p, i] - b[p, j]|^2      a [B, N, 3], dl [B, N]
//   dr[p, j] = min_i |a[p, i] - b[p, j]|^2      b [B, M, 3], dr [B, M]
//
// fp32, row-major and contiguous.  Replaces the Pallas kernel
// octfusion_tpu/ops/pallas/chamfer_kernel.py::_kernel, which walks a
// sequential (B, N/1024, M/1024) grid, revisits dl over j and dr over i,
// and pads both clouds to 1024 with far points.  Here blocks run in
// parallel and in no order, so the design is a different one:
//
// * One CTA per (pair p, tile of 128 rows of a).  Its 256 threads form a
//   16 x 16 grid; a thread keeps 8 rows of a (rows ty + 16 r) and their
//   running row minima in registers for the whole kernel.
// * The CTA loops over all of b in tiles of 128 points, staged in shared
//   memory as SoA x / y / z.  A thread takes 8 columns of each tile
//   (tx + 16 c): the 16 lanes of a half-warp read 16 consecutive words and
//   the two halves the same ones, so the loads are conflict-free.
// * The row minima are final after the loop: a shuffle over the 16
//   threads that share a row, then one plain store per row, no atomics.
// * Column minima: per tile, each thread's 8 columns over its 8 rows, then
//   a shuffle over the two row groups of a warp, then the 8 warps through
//   shared memory, then ONE atomicMin per column per CTA on dr's int bit
//   pattern.  That pattern orders like the float only for values >= +0,
//   so the wrapper fills dr with +inf (0x7f800000) before the launch and
//   the kernel stores only +0.0 or more, never -0.0 (the clamp
//   `d > 0.f ? d : 0.f`; fmaxf may return -0.0, whose signed pattern is
//   negative and would win every atomicMin).
// * Ragged edges are masked in registers, with no padding points in
//   memory: rows past N sit at +inf and columns past M at -inf, so every
//   distance that involves one is +inf (inf - (-inf) is inf, never NaN)
//   and never wins a minimum; rows past N and columns past M are never
//   stored.
//
// Arithmetic: the direct form dx^2 + dy^2 + dz^2 (3 subtractions, 1
// multiply, 2 FMAs): the same 8 FLOP per pair as the expansion
// |a|^2 - 2 a.b + |b|^2, with no cancellation, so near-duplicate clouds
// keep their tiny distances and the result is >= +0 by construction.
//
// What bounds it on an H100: fp32 arithmetic.  Tensor cores do not serve a
// K = 3 product, and the bytes are O(B (N + M)) against O(B N M) work
// (at N = M = 2048, 33.6 MFLOP per pair against 98 KB).  Each pair issues
// 8 instructions (the 6 above and two minima, which the 8-FLOP count does
// not credit) where the 67 TFLOP/s fp32 peak counts 4 FMAs, so this kernel
// can reach at most about half of its FLOP bound.  The design keeps the
// FP32 pipes fed: 64 independent pairs per thread between shared-memory
// loads (3 loads per 8 pairs), and the column reduction costs ~30
// instructions per tile against 512.  More rows per thread, larger tiles,
// b staged by TMA, or the expansion with a folded |b|^2 (6 instructions
// per pair) are later work.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTx = 16;              // threads along the columns
constexpr int kTy = 16;              // threads along the rows
constexpr int kR = 8;                // rows per thread
constexpr int kC = 8;                // columns per thread and tile
constexpr int kRows = kTy * kR;      // 128 rows of a per CTA
constexpr int kCols = kTx * kC;      // 128 points of b per tile
constexpr int kThreads = kTx * kTy;  // 256
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kTx == 16 && kThreads % 32 == 0,
              "a warp holds two row groups of 16 column threads");
static_assert(kR <= kTx, "thread tx == r stores row r");

__device__ __forceinline__ float non_negative(float d) {
  return d > 0.f ? d : 0.f;  // +0.0 for 0 and -0.0, never -0.0
}

__global__ void __launch_bounds__(kThreads)
chamfer_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ dl, int* __restrict__ dr_bits, int N,
               int M, int row_tiles) {
  __shared__ float sb[3][kCols];
  __shared__ float red[kWarps][kCols];

  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int pair = blockIdx.x / row_tiles;
  const int i0 = (blockIdx.x % row_tiles) * kRows;
  const float* ap = a + (int64_t)pair * N * 3;
  const float* bp = b + (int64_t)pair * M * 3;

  float ax[kR], ay[kR], az[kR], rmin[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = i0 + ty + kTy * r;
    const bool ok = i < N;
    ax[r] = ok ? ap[(int64_t)i * 3 + 0] : INFINITY;
    ay[r] = ok ? ap[(int64_t)i * 3 + 1] : INFINITY;
    az[r] = ok ? ap[(int64_t)i * 3 + 2] : INFINITY;
    rmin[r] = INFINITY;
  }

  for (int j0 = 0; j0 < M; j0 += kCols) {
    // b[j0 : j0 + 128] as SoA; consecutive threads read consecutive floats
    for (int t = tid; t < 3 * kCols; t += kThreads) {
      const int p = t / 3;
      const int k = t % 3;
      const int j = j0 + p;
      sb[k][p] = j < M ? bp[(int64_t)j * 3 + k] : -INFINITY;
    }
    __syncthreads();

    float cmin[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float bx = sb[0][tx + kTx * c];
      const float by = sb[1][tx + kTx * c];
      const float bz = sb[2][tx + kTx * c];
      cmin[c] = INFINITY;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float dx = ax[r] - bx;
        const float dy = ay[r] - by;
        const float dz = az[r] - bz;
        const float d = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
        rmin[r] = fminf(rmin[r], d);
        cmin[c] = fminf(cmin[c], d);
      }
    }

    // the tile's column minima over the CTA's 128 rows: the two row groups
    // of a warp (lanes l and l ^ 16), then the 8 warps in shared memory
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float v = fminf(cmin[c], __shfl_xor_sync(kFull, cmin[c], 16));
      if (lane < 16) red[warp][tx + kTx * c] = v;
    }
    __syncthreads();
    // the next tile's staging writes sb only after every thread has left
    // the loop above, and red only after the next barrier, which these
    // reads precede
    if (tid < kCols && j0 + tid < M) {
      float v = red[0][tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v = fminf(v, red[w][tid]);
      atomicMin(dr_bits + (int64_t)pair * M + j0 + tid,
                __float_as_int(non_negative(v)));
    }
  }

  // row minima over the 16 column threads of a row group
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float v = rmin[r];
#pragma unroll
    for (int s = 8; s > 0; s >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, s));
    const int i = i0 + ty + kTy * r;
    if (tx == r && i < N) dl[(int64_t)pair * N + i] = non_negative(v);
  }
}

}  // namespace

// a [B, N, 3], b [B, M, 3] -> dl [B, N]; dr [B, M] must hold +inf on entry
extern "C" int chamfer_fwd(const float* a, const float* b, float* dl,
                           float* dr, int B, int N, int M, void* stream) {
  const int row_tiles = (N + kRows - 1) / kRows;
  chamfer_kernel<<<B * row_tiles, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      a, b, dl, reinterpret_cast<int*>(dr), N, M, row_tiles);
  return static_cast<int>(cudaGetLastError());
}
