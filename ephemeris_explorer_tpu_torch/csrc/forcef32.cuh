// Pieces shared by the f32 pair-force kernels (accel_f32.cu, kernels 5 and
// 7, and accel_mixed.cu, kernel 6): the tile width, the f32 weight chain and
// the pass that adds the per-split partial sums in split order.

#pragma once

#include <cuda_runtime.h>

#include "twofloat.cuh"

namespace eet {

// receivers per block, and sources per shared-memory tile
constexpr int kF32Tile = 128;

// r^2 of a difference, summed left to right as pallas_nbody.py:888 writes it.
__device__ __forceinline__ float f32_r2(const float d[3]) {
  return fadd(fadd(fmul(d[0], d[0]), fmul(d[1], d[1])), fmul(d[2], d[2]));
}

// mu / r^3 in f32 (pallas_nbody.py:890-894): the rsqrt seed, one Newton step
// u (1.5 - 0.5 r2 u u), then mu (u u u), each product rounded as written.
__device__ __forceinline__ float f32_weight(float r2, float mu) {
  float u = rsqrtf(r2);
  u = fmul(u, fsub(1.5f, fmul(fmul(fmul(0.5f, r2), u), u)));
  return fmul(mu, fmul(fmul(u, u), u));
}

namespace {

// out[e] = sum over the S splits of part[s, e], f32 adds in split order.
__global__ void f32_partials_reduce(const float* __restrict__ part, float* __restrict__ out,
                                    int m, int splits) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  float acc = part[e];
  for (int s = 1; s < splits; ++s) acc = fadd(acc, part[static_cast<size_t>(s) * m + e]);
  out[e] = acc;
}

// Launch the reduction over m = 3 NL outputs; returns cudaGetLastError().
inline int launch_f32_reduce(const float* part, float* out, int m, int splits,
                             cudaStream_t stream) {
  f32_partials_reduce<<<(m + 255) / 256, 256, 0, stream>>>(part, out, m, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace eet
