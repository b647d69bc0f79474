// The MPU corner gathers' backward for Hopper (sm_90a): a deterministic
// segment sum of gradient rows by node,
//
//   out[n, :] = sum of grad[s, :] over the slots s whose corner node is n
//
//   grad [M, C] fp32 (M = N queries x 8 corners), out [n_nodes, C] fp32.
//
// Replaces no TPU kernel: the JAX package leaves the gather's transpose to
// XLA's scatter-add.  It was added because PyTorch's `index` backward sorts
// the M indices and then adds each run of equal indices serially
// (`indexing_backward_kernel`), and the MPU's runs are long: at the coarse
// depths a few thousand nodes take every query, and every corner that is
// out of bounds or missing is clamped to node 0, so node 0 takes one run
// of a large share of the M slots.
//
// The plan (ops/mpu_gather_cuda.plan, built once per depth and shared by
// every target depth's backward) is a node-sorted CSR of the slots:
// `perm` [M] the slots in node order (a stable sort: a node's slots
// ascending), `offsets` [n_nodes + 1] each node's run in `perm`, and
// `chunk_ptr` [n_nodes + 1] the exclusive prefix sum of each run's chunk
// count, ceil(run / kChunk).  Two passes:
//
// 1. segment_chunk_sums: one warp per chunk of at most kChunk slots of
//    one node; a lane adds every 32nd slot's row in slot order, then the
//    warp adds its lanes by a fixed butterfly.  A chunk finds its node by
//    a binary search over chunk_ptr.  Short runs are one chunk, a warp
//    each; a long run is split over as many warps as it has chunks.
// 2. segment_node_sums: one warp per node adds its chunks' partial sums,
//    a lane every 32nd chunk in chunk order, then the same butterfly;
//    a node that no slot reaches gets zeros.
//
// No atomics: every sum is taken in an order fixed by the plan, so two
// calls on the same inputs give the same bits.  Every slot is summed,
// masked ones included, so a NaN in any row reaches its node as it does
// through `index`'s backward.
//
// What bounds it: bytes.  Each slot's row is read once (16 bytes at C = 4,
// one float4 load where C % 4 == 0 and the rows are 16-byte aligned) with
// its 4-byte `perm` entry; the partials and the output are a few bytes a
// node.  The rows are gathered in node order, so a warp's loads scatter
// over 32-byte sectors, and the binary search adds ~log2(n_nodes)
// dependent reads a chunk, which L2 serves.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 256;   // slots a warp sums in pass 1
constexpr int kWarps = 8;     // warps a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 warp_sum(float4 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(kFull, v.x, o);
    v.y += __shfl_xor_sync(kFull, v.y, o);
    v.z += __shfl_xor_sync(kFull, v.z, o);
    v.w += __shfl_xor_sync(kFull, v.w, o);
  }
  return v;
}

// acc += row[c0 : c0 + 4] (channels past c read as nothing)
template <bool kVec4>
__device__ __forceinline__ void add_row(float4& acc, const float* row, int c0,
                                        int c) {
  if (kVec4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + c0));
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  } else {
    acc.x += __ldg(row + c0);
    if (c0 + 1 < c) acc.y += __ldg(row + c0 + 1);
    if (c0 + 2 < c) acc.z += __ldg(row + c0 + 2);
    if (c0 + 3 < c) acc.w += __ldg(row + c0 + 3);
  }
}

__device__ __forceinline__ void store_group(float* row, float4 v, int c0,
                                            int c) {
  row[c0] = v.x;
  if (c0 + 1 < c) row[c0 + 1] = v.y;
  if (c0 + 2 < c) row[c0 + 2] = v.z;
  if (c0 + 3 < c) row[c0 + 3] = v.w;
}

template <bool kVec4>
__global__ void __launch_bounds__(kWarps * 32) segment_chunk_sums(
    const float* __restrict__ grad, const int* __restrict__ perm,
    const int* __restrict__ offsets, const int* __restrict__ chunk_ptr,
    int n_nodes, int c, float* __restrict__ partial) {
  const int chunk = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (chunk >= __ldg(chunk_ptr + n_nodes)) return;   // the whole warp
  // the node whose chunks hold this one: chunk_ptr[lo] <= chunk <
  // chunk_ptr[lo + 1]
  int lo = 0, hi = n_nodes;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(chunk_ptr + mid) <= chunk) lo = mid; else hi = mid;
  }
  const int begin = __ldg(offsets + lo) + (chunk - __ldg(chunk_ptr + lo)) *
                    kChunk;
  const int end = min(__ldg(offsets + lo + 1), begin + kChunk);
  for (int c0 = 0; c0 < c; c0 += 4) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = begin + lane; j < end; j += 32)
      add_row<kVec4>(acc, grad + static_cast<size_t>(__ldg(perm + j)) * c,
                     c0, c);
    acc = warp_sum(acc);
    if (lane == 0)
      store_group(partial + static_cast<size_t>(chunk) * c, acc, c0, c);
  }
}

template <bool kVec4>
__global__ void __launch_bounds__(kWarps * 32) segment_node_sums(
    const float* __restrict__ partial, const int* __restrict__ chunk_ptr,
    int n_nodes, int c, float* __restrict__ out) {
  const int node = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (node >= n_nodes) return;                          // the whole warp
  const int begin = __ldg(chunk_ptr + node);
  const int end = __ldg(chunk_ptr + node + 1);
  for (int c0 = 0; c0 < c; c0 += 4) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = begin + lane; k < end; k += 32)
      add_row<kVec4>(acc, partial + static_cast<size_t>(k) * c, c0, c);
    acc = warp_sum(acc);
    if (lane == 0)
      store_group(out + static_cast<size_t>(node) * c, acc, c0, c);
  }
}

}  // namespace

// grad [M, C], perm [M], offsets and chunk_ptr [n_nodes + 1] (the plan);
// partial [max_chunks, C] scratch, max_chunks >= chunk_ptr[n_nodes];
// out [n_nodes, C].  vec4: C % 4 == 0 and grad 16-byte aligned.
extern "C" int corner_gather_bwd(const float* grad, const int* perm,
                                 const int* offsets, const int* chunk_ptr,
                                 float* partial, float* out, int n_nodes,
                                 int max_chunks, int c, int vec4,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = kWarps * 32;
  if (max_chunks > 0) {
    const int blocks = (max_chunks + kWarps - 1) / kWarps;
    if (vec4)
      segment_chunk_sums<true><<<blocks, threads, 0, s>>>(
          grad, perm, offsets, chunk_ptr, n_nodes, c, partial);
    else
      segment_chunk_sums<false><<<blocks, threads, 0, s>>>(
          grad, perm, offsets, chunk_ptr, n_nodes, c, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n_nodes + kWarps - 1) / kWarps;
  if (vec4)
    segment_node_sums<true><<<blocks, threads, 0, s>>>(partial, chunk_ptr,
                                                       n_nodes, c, out);
  else
    segment_node_sums<false><<<blocks, threads, 0, s>>>(partial, chunk_ptr,
                                                        n_nodes, c, out);
  return static_cast<int>(cudaGetLastError());
}
