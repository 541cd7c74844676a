// Kernel 4: the ELM2 position update on the 4-limb expansion state.
//
// Replaces the TPU kernel ephemeris_explorer_tpu/ops/pallas_elm2.py
// `_update_kernel` (reached through `elm2q_update`), in both of its modes.
// For each element of the flattened state (M = 3N) it computes
//
//     y_{n+1} = sum_j c_y[j] y_{n-j}  +  h^2/beta_d * sum_j c_dy[j] dd_{n-j}
//
// with y a 4-limb f32 expansion (ring ys0..ys3) and dd a (hi, lo) f32 pair
// (rings ddh, ddl), newest first, in the JAX kernel's exact order:
//
// * plain: the beta sum in two-float arithmetic (accurate adds over the
//   nonzero c_dy rows, split (hi, lo) coefficients), times the split
//   h^2/beta_d, lifted to an expansion as (hi, lo, 0, 0);
// * precise: each nonzero row j forms p, pe = two_prod(hi_j, b0), q, qe =
//   two_prod(lo_j, b0), r, re = two_prod(hi_j, b1) against the 3-limb
//   pre-scaled weight w_j = b0 + b1 + b2, then s = qe + re + lo_j b1 + hi_j
//   b2 left to right, renormalises (p, pe, q, r, s) to 4 limbs and
//   accumulates the terms with expansion adds;
//
// then the alpha combination (exact scalings by +-1, +-2; expansion adds)
// and the final expansion add.  An expansion add interleaves the 8 limbs
// and runs three two_sum distillation sweeps (expansion.renorm).  The same
// ops in the same order as the plain PyTorch version, with no contraction,
// make the two bitwise equal.
//
// What bounds it on an H100: launch latency and memory traffic.  One thread
// per element reads 6 rings x ORDER x 4 bytes (288 bytes at ORDER = 12) and
// writes 16; at N = 4096 that is 3.7 MB, about a microsecond at 3.35 TB/s.
// The arithmetic is long (seven expansion adds of ~130 operations each in
// the alpha sum; in precise mode ~180 more per beta row) but stays in
// registers: the limbs live in fully unrolled local arrays.  The
// coefficient table travels by value as a kernel argument (constant bank),
// read uniformly by every thread.

#include <cuda_runtime.h>

#include "twofloat.cuh"

namespace {

using eet::TF;

constexpr int kMaxOrder = 16;
constexpr int kK = 4;  // limbs

struct Elm2qCoef {
  float w[kMaxOrder + 1][3];  // plain: c_dy rows then h^2/beta_d as (hi, lo);
                              // precise: pre-scaled weights as 3 limbs
  float cy[kMaxOrder];
  int order;
  unsigned nonzero;  // bit j set where c_dy[j] != 0
};

// expansion.renorm of N >= 4 limbs, in place, into out[0..3].
template <int N>
__device__ __forceinline__ void renorm(float (&x)[N], float (&out)[kK]) {
  static_assert(N >= kK, "renorm folds at least K limbs");
#pragma unroll
  for (int sweep = 0; sweep < 3; ++sweep) {
#pragma unroll
    for (int i = N - 2; i >= 0; --i) {
      TF s = eet::two_sum(x[i], x[i + 1]);
      x[i] = s.hi;
      x[i + 1] = s.lo;
    }
  }
  float tail = x[kK - 1];
#pragma unroll
  for (int i = kK; i < N; ++i) tail = eet::fadd(tail, x[i]);
  out[0] = x[0];
  out[1] = x[1];
  out[2] = x[2];
  out[3] = tail;
}

// expansion.add: a + b with the limbs interleaved (a0 b0 a1 b1 ...).
__device__ __forceinline__ void ex_add(const float (&a)[kK], const float (&b)[kK],
                                       float (&out)[kK]) {
  float m[2 * kK];
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    m[2 * i] = a[i];
    m[2 * i + 1] = b[i];
  }
  renorm<2 * kK>(m, out);
}

__device__ __forceinline__ void copy4(const float (&a)[kK], float (&out)[kK]) {
#pragma unroll
  for (int i = 0; i < kK; ++i) out[i] = a[i];
}

template <bool kPrecise>
__global__ void elm2q_update_kernel(Elm2qCoef cf, const float* __restrict__ ys0,
                                    const float* __restrict__ ys1,
                                    const float* __restrict__ ys2,
                                    const float* __restrict__ ys3,
                                    const float* __restrict__ ddh,
                                    const float* __restrict__ ddl, float* __restrict__ o0,
                                    float* __restrict__ o1, float* __restrict__ o2,
                                    float* __restrict__ o3, int m) {
  using namespace eet;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;

  float inc[kK];
  if (kPrecise) {
    bool first = true;
    for (int j = 0; j < cf.order; ++j) {
      if (!((cf.nonzero >> j) & 1u)) continue;
      const size_t at = static_cast<size_t>(j) * m + e;
      const float hi = ddh[at], lo = ddl[at];
      const float b0 = cf.w[j][0], b1 = cf.w[j][1], b2 = cf.w[j][2];
      TF p = two_prod(hi, b0);
      TF q = two_prod(lo, b0);
      TF r = two_prod(hi, b1);
      float s = fadd(fadd(fadd(q.lo, r.lo), fmul(lo, b1)), fmul(hi, b2));
      float five[5] = {p.hi, p.lo, q.hi, r.hi, s};
      float term[kK];
      renorm<5>(five, term);
      if (first) {
        copy4(term, inc);
      } else {
        float sum[kK];
        ex_add(inc, term, sum);
        copy4(sum, inc);
      }
      first = false;
    }
  } else {
    TF acc{0.0f, 0.0f};
    bool first = true;
    for (int j = 0; j < cf.order; ++j) {
      if (!((cf.nonzero >> j) & 1u)) continue;
      const size_t at = static_cast<size_t>(j) * m + e;
      TF term = mul(TF{ddh[at], ddl[at]}, TF{cf.w[j][0], cf.w[j][1]});
      acc = first ? term : add(acc, term);
      first = false;
    }
    TF i2 = mul(acc, TF{cf.w[cf.order][0], cf.w[cf.order][1]});
    inc[0] = i2.hi;
    inc[1] = i2.lo;
    inc[2] = 0.0f;
    inc[3] = 0.0f;
  }

  float sum[kK];
  bool first = true;
  for (int j = 0; j < cf.order; ++j) {
    const float c = cf.cy[j];
    if (c == 0.0f) continue;
    const size_t at = static_cast<size_t>(j) * m + e;
    float term[kK] = {fmul(ys0[at], c), fmul(ys1[at], c), fmul(ys2[at], c), fmul(ys3[at], c)};
    if (first) {
      copy4(term, sum);
    } else {
      float next[kK];
      ex_add(sum, term, next);
      copy4(next, sum);
    }
    first = false;
  }
  float y[kK];
  ex_add(sum, inc, y);
  o0[e] = y[0];
  o1[e] = y[1];
  o2[e] = y[2];
  o3[e] = y[3];
}

}  // namespace

extern "C" {

// coef: host (rows, cols) f32 table, cols = 2 (plain: order + 1 rows) or 3
// (precise: order rows); c_y: host (order,) f32; nonzero: bit j set where
// c_dy[j] != 0; rings: (order, M) f32 device; out: 4 x (M,).  Launches on
// `stream` and returns cudaGetLastError() (0 = launched); -1 on bad sizes.
int eet_elm2q_update(const float* coef, int precise, const float* c_y, int order,
                     unsigned nonzero, const float* ys0, const float* ys1, const float* ys2,
                     const float* ys3, const float* ddh, const float* ddl, float* o0,
                     float* o1, float* o2, float* o3, int m, cudaStream_t stream) {
  if (order < 1 || order > kMaxOrder) return -1;
  Elm2qCoef cf{};
  cf.order = order;
  cf.nonzero = nonzero;
  const int cols = precise ? 3 : 2;
  const int rows = precise ? order : order + 1;
  for (int j = 0; j < rows; ++j)
    for (int k = 0; k < cols; ++k) cf.w[j][k] = coef[j * cols + k];
  for (int j = 0; j < order; ++j) cf.cy[j] = c_y[j];
  constexpr int kBlock = 256;
  const int blocks = (m + kBlock - 1) / kBlock;
  if (precise) {
    elm2q_update_kernel<true><<<blocks, kBlock, 0, stream>>>(cf, ys0, ys1, ys2, ys3, ddh, ddl,
                                                              o0, o1, o2, o3, m);
  } else {
    elm2q_update_kernel<false><<<blocks, kBlock, 0, stream>>>(cf, ys0, ys1, ys2, ys3, ddh, ddl,
                                                               o0, o1, o2, o3, m);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
