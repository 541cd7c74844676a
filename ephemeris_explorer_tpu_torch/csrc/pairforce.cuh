// Pieces shared by the two-float pair-force kernels (accel_df64.cu, kernel
// 1, accel_limbs3.cu, kernel 3, strong_corr.cu, kernels 8-9, accel_sym.cu,
// kernel 10, gen_scan.cu, kernel 11): the tile width, the squaring and rsqrt
// steps of the per-pair chain, the leaf order of the reference's tree sum,
// and the pass that adds the per-split partial sums in split order.

#pragma once

#include <cuda_runtime.h>

#include "twofloat.cuh"

namespace eet {

// receivers per block, and sources per shared-memory tile
constexpr int kPairTile = 128;

// The reference's `_dd_tree_sum` (pallas_nbody.py:47) halves as a[k] =
// add_sloppy(a[k], a[k + m]), so leaf j meets leaf j XOR m first: walking
// the leaves in bit-reversed order t -> rev(t) turns it into the
// adjacent-pairs tree, which a stack of partial sums reduces as the leaves
// arrive (a binary counter: pop_count(t) partials are on the stack before
// leaf t; after it, merge ctz(t + 1) times, the earlier partial first).
__host__ __device__ constexpr int bit_reverse(int t, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((t >> b) & 1) << (bits - 1 - b);
  return r;
}

__host__ __device__ constexpr int pop_count(int t) {
  int c = 0;
  for (; t; t &= t - 1) ++c;
  return c;
}

// x * x with the split of x.hi supplied (pallas_nbody._sqr_presplit).
__device__ __forceinline__ TF sqr_presplit(TF x, TF xs) {
  float p = fmul(x.hi, x.hi);
  float e = fadd(fadd(fsub(fmul(xs.hi, xs.hi), p), fmul(2.0f, fmul(xs.hi, xs.lo))),
                 fmul(xs.lo, xs.lo));
  e = fadd(e, fmul(2.0f, fmul(x.hi, x.lo)));
  return quick_two_sum(p, e);
}

// Two-float 1/sqrt(x) (pallas_nbody._rsqrt_df with one refinement).
__device__ __forceinline__ TF rsqrt_df(TF x) {
  float y0 = rsqrtf(x.hi);
  TF xy2 = mul(x, two_sqr(y0));
  float t = fadd(fsub(xy2.hi, 1.0f), xy2.lo);
  TF corr = add_float(mul_float(xy2, -0.5f), 1.5f);
  corr.lo = fadd(corr.lo, fmul(fmul(0.375f, t), t));
  TF y = two_prod(y0, corr.hi);
  return quick_two_sum(y.hi, fadd(y.lo, fmul(y0, corr.lo)));
}

namespace {

// out[e] = sum over the S splits of part[s, e], accurate adds in split order.
__global__ void pair_partials_reduce(const float* __restrict__ part_hi,
                                     const float* __restrict__ part_lo,
                                     float* __restrict__ out_hi, float* __restrict__ out_lo,
                                     int m, int splits) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  TF acc{part_hi[e], part_lo[e]};
  for (int s = 1; s < splits; ++s) {
    acc = add(acc, TF{part_hi[static_cast<size_t>(s) * m + e],
                      part_lo[static_cast<size_t>(s) * m + e]});
  }
  out_hi[e] = acc.hi;
  out_lo[e] = acc.lo;
}

// Launch the reduction over m = 3N outputs; returns cudaGetLastError().
inline int launch_pair_reduce(const float* part_hi, const float* part_lo, float* out_hi,
                              float* out_lo, int m, int splits, cudaStream_t stream) {
  pair_partials_reduce<<<(m + 255) / 256, 256, 0, stream>>>(part_hi, part_lo, out_hi, out_lo,
                                                            m, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace eet
