// Pieces shared by the f32 pair-force kernels (accel_f32.cu, kernels 5 and
// 7, and accel_mixed.cu, kernel 6): the f32 weight chain and the warp-tiled
// loop's constants and launch, whose launch adds its per-warp partial sums
// in split order itself.

#pragma once

#include <cuda_runtime.h>

#include "twofloat.cuh"

namespace eet {

// mu / r^3 in f32 (pallas_nbody.py:890-894) of R pairs with one source's
// mu: the rsqrt seed, one Newton step u (1.5 - 0.5 r2 u u), then mu (u u u),
// each product rounded as written; each step taken for every pair before the
// next, so that the R chains interleave in the instruction stream (the same
// operations on each pair: the same bits).
template <int R>
__device__ __forceinline__ void f32_weights(const float r2[R], float mu, float w[R]) {
  float u[R], t[R];
#pragma unroll
  for (int r = 0; r < R; ++r) u[r] = rsqrtf(r2[r]);
#pragma unroll
  for (int r = 0; r < R; ++r) t[r] = fmul(0.5f, r2[r]);
#pragma unroll
  for (int r = 0; r < R; ++r) t[r] = fmul(t[r], u[r]);
#pragma unroll
  for (int r = 0; r < R; ++r) t[r] = fmul(t[r], u[r]);
#pragma unroll
  for (int r = 0; r < R; ++r) u[r] = fmul(u[r], fsub(1.5f, t[r]));
#pragma unroll
  for (int r = 0; r < R; ++r) t[r] = fmul(u[r], u[r]);
#pragma unroll
  for (int r = 0; r < R; ++r) w[r] = fmul(mu, fmul(t[r], u[r]));
}

// r^2 of R differences, summed left to right as pallas_nbody.py:888 writes
// it, step by step across the pairs.
template <int R>
__device__ __forceinline__ void f32_r2s(const float d[R][3], float r2[R]) {
  float t[R];
#pragma unroll
  for (int r = 0; r < R; ++r) t[r] = fmul(d[r][0], d[r][0]);
#pragma unroll
  for (int r = 0; r < R; ++r) t[r] = fadd(t[r], fmul(d[r][1], d[r][1]));
#pragma unroll
  for (int r = 0; r < R; ++r) r2[r] = fadd(t[r], fmul(d[r][2], d[r][2]));
}

// ---------------------------------------------------------------------------
// The warp-tiled pair loop of kernels 5, 6 and 7.
//
// A warp holds a receiver group of kGroup receivers, kRecv a lane: lane l
// holds receivers g0 + 32 r + l, r < kRecv.  It walks one split of the
// source tiles (kSrcTile sources each), staging each tile in its own slice
// of shared memory, so the warps of a block never wait for each other.  The
// block's warps and a grid row's blocks are the splits of one receiver
// group: split s = blockIdx.x * warps + warp of S takes the tiles s, s + S,
// s + 2 S, ... of the T = ceil(N / kSrcTile), in that order.  The partition
// depends on N and S alone, and S on N alone (the wrapper's
// `_f32_pair_geometry`), so a receiver is summed in the same order
// whichever receivers share its launch.

constexpr int kLanes = 32;
constexpr int kRecv = 4;                  // receivers a lane
constexpr int kGroup = kLanes * kRecv;    // receivers a warp
constexpr int kSrcTile = 32;              // sources a tile
constexpr int kMaxWarps = 8;              // warps a block

// The block's dynamic shared memory: one slice a warp, of the kernel's own
// layout (a multiple of 16 bytes).
extern __shared__ __align__(16) unsigned char pair_smem[];

// The number of source tiles of n sources; split s of S takes the tiles
// s, s + S, s + 2 S, ... below it, so the warps that run side by side read
// neighbouring tiles.
__device__ __forceinline__ int source_tiles(int n) { return (n + kSrcTile - 1) / kSrcTile; }

// Whether tile j0 holds one of the group's receivers (g0 .. g0 + kGroup - 1).
__device__ __forceinline__ bool tile_meets_group(int j0, int g0) {
  return j0 < g0 + kGroup && j0 + kSrcTile > g0;
}

// After the source loops, in every thread of the block: warp w's partial
// sums sit in shared memory at part_s + w * stride, as [3][kGroup]
// (component-major, lane order).  The block adds them in warp order into its
// row blockIdx.x of the (blocks, NL, 3) scratch `part`; the block of the
// receiver group that arrives last (its group's counter, zero between
// launches) adds the rows in block order, writes the group's rows g0 .. of
// out (NL, 3), those below nl, and rearms the counter.  So one launch sums
// every receiver over its splits in split order, whatever the blocks' timing.
__device__ __forceinline__ void sum_splits(const float* part_s, int stride,
                                           float* __restrict__ part,
                                           unsigned* __restrict__ counters,
                                           float* __restrict__ out, int g0, int nl) {
  __shared__ bool s_last;
  const int warps = static_cast<int>(blockDim.x) / kLanes;
  const int blocks = static_cast<int>(gridDim.x);
  __syncthreads();  // every warp's partials are in shared memory
  for (int e = threadIdx.x; e < 3 * kGroup; e += blockDim.x) {
    const int q = e % kGroup, c = e / kGroup;
    float acc = 0.0f;  // a partial is never -0, so 0 + p0 == p0
    for (int w = 0; w < warps; ++w) acc = fadd(acc, part_s[w * stride + e]);
    if (g0 + q < nl) part[(static_cast<size_t>(blockIdx.x) * nl + g0 + q) * 3 + c] = acc;
  }
  __threadfence();  // the row is visible before the ticket is taken
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&counters[blockIdx.y], 1u) == blocks - 1u;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int e = threadIdx.x; e < 3 * kGroup; e += blockDim.x) {
    const int q = e % kGroup, c = e / kGroup;
    if (g0 + q >= nl) continue;
    const size_t at = static_cast<size_t>(g0 + q) * 3 + c;
    float acc = 0.0f;
#pragma unroll 8
    for (int b = 0; b < blocks; ++b) acc = fadd(acc, __ldcg(part + b * static_cast<size_t>(nl) * 3 + at));
    out[at] = acc;
  }
  if (threadIdx.x == 0) counters[blockIdx.y] = 0u;
}

// Launch `kernel` on a (blocks, groups) grid of warps * 32 threads, the
// blocks of a row the source splits of one receiver group, with `warp_smem`
// bytes of dynamic shared memory a warp.  Returns the launch's cudaError_t
// (0 = launched).
template <typename... KArgs, typename... Args>
inline int launch_pair_kernel(void (*kernel)(KArgs...), size_t warp_smem, int groups, int warps,
                              int blocks, cudaStream_t stream, Args... args) {
  if (warps < 1 || warps > kMaxWarps || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(blocks, groups), warps * kLanes, warps * warp_smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace eet
