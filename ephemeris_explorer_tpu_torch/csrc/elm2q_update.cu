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
// What bounds it on an H100: latency.  Its bytes (6 rings x ORDER x 4 bytes
// in, 16 out an element: 3.7 MB at N = 4096) take about a microsecond, its
// ~3,500 operations an element (QT12, precise) 1.3 us over the whole card;
// but both sums must stay left to right, so each element carries two serial
// chains of expansion adds of ~130 operations each (10 for QT12's beta sum,
// 6 for its alpha sum) and the final add after both, and the first design
// (one thread an element) ran those chains and its terms in series on 48
// of 132 SMs.  Design: a block is one tile of 32 elements, one a lane, on
// four warps.
//
// 1. every warp forms terms: task r is beta row r's term (precise: the
//    two_prods and renorm<5>; plain: the two-float product) or an alpha
//    row's scaled limbs, for the tile's 32 elements, read as one coalesced
//    run of the ring row; the terms go to shared memory;
// 2. warp 0 folds the beta terms and warp 2 the alpha terms, each left to
//    right in the plain version's order, side by side; warp 2 hands its
//    sum over through shared memory (a named barrier) and warp 0 adds the
//    final expansion add and writes.  (Picking the two fold warps per block
//    from its hardware warp slot, to spread the folds of the blocks an SM
//    holds over its schedulers, measured slower on an H100.)
//
// Lanes past M read element M - 1 and write nothing.  The coefficient
// table, with the lists of nonzero rows, travels by value as a kernel
// argument (constant bank), read uniformly.

#include <cuda_runtime.h>

#include "twofloat.cuh"

namespace {

using eet::TF;

constexpr int kMaxOrder = 16;
constexpr int kK = 4;  // limbs

constexpr int kTile = 32;  // elements a block, one a lane
constexpr int kWarps = 4;  // warps a block

struct Elm2qCoef {
  float w[kMaxOrder + 1][3];  // plain: c_dy rows then h^2/beta_d as (hi, lo);
                              // precise: pre-scaled weights as 3 limbs
  float cy[kMaxOrder];
  int order;
  int n_beta, n_alpha;
  int beta_row[kMaxOrder];   // the rows with c_dy != 0, in order
  int alpha_row[kMaxOrder];  // the rows with c_y != 0, in order
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

// A beta row's term from its pair (hi, lo) and its row w = (b0, b1, b2) of
// the table: precise, the renormalised 4-limb product with the 3-limb
// weight; plain, the two-float product with the split coefficient (b0, b1)
// in limbs 0 and 1.
template <bool kPrecise>
__device__ __forceinline__ void beta_term(float b0, float b1, float b2, float hi, float lo,
                                          float (&out)[kK]) {
  using namespace eet;
  if (kPrecise) {
    TF p = two_prod(hi, b0);
    TF q = two_prod(lo, b0);
    TF r = two_prod(hi, b1);
    float s = fadd(fadd(fadd(q.lo, r.lo), fmul(lo, b1)), fmul(hi, b2));
    float five[5] = {p.hi, p.lo, q.hi, r.hi, s};
    renorm<5>(five, out);
  } else {
    TF t = mul(TF{hi, lo}, TF{b0, b1});
    out[0] = t.hi;
    out[1] = t.lo;
    out[2] = 0.0f;
    out[3] = 0.0f;
  }
}

// Term r of a tile in shared memory: kK limbs of 32 lanes.
__device__ __forceinline__ void load_term(const float (*terms)[kK][kTile], int r, int lane,
                                          float (&out)[kK]) {
#pragma unroll
  for (int l = 0; l < kK; ++l) out[l] = terms[r][l][lane];
}

// ex_add fold of terms[0..n) left to right (zeros for n = 0), each term
// read one add ahead.
__device__ __forceinline__ void fold_expansions(const float (*terms)[kK][kTile], int n, int lane,
                                                float (&acc)[kK]) {
  if (n == 0) {
#pragma unroll
    for (int l = 0; l < kK; ++l) acc[l] = 0.0f;
    return;
  }
  load_term(terms, 0, lane, acc);
  float t[kK];
  load_term(terms, n > 1 ? 1 : 0, lane, t);
  for (int r = 1; r < n; ++r) {
    float ahead[kK];
    load_term(terms, r + 1 < n ? r + 1 : r, lane, ahead);
    float sum[kK];
    ex_add(acc, t, sum);
    copy4(sum, acc);
    copy4(ahead, t);
  }
}

template <bool kPrecise>
__global__ void __launch_bounds__(kWarps * 32)
elm2q_update_kernel(Elm2qCoef cf, const float* __restrict__ ys0, const float* __restrict__ ys1,
                    const float* __restrict__ ys2, const float* __restrict__ ys3,
                    const float* __restrict__ ddh, const float* __restrict__ ddl,
                    float* __restrict__ o0, float* __restrict__ o1, float* __restrict__ o2,
                    float* __restrict__ o3, int m) {
  using namespace eet;
  __shared__ float beta[kMaxOrder][kK][kTile];   // the beta terms
  __shared__ float alpha[kMaxOrder][kK][kTile];  // the scaled alpha rows
  __shared__ float alpha_sum[kK][kTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e_out = blockIdx.x * kTile + lane;
  const int e = min(e_out, m - 1);

  // 1. the terms: task r below n_beta is beta row r, the rest the alpha rows
  for (int r = warp; r < cf.n_beta + cf.n_alpha; r += kWarps) {
    float v[kK];
    if (r < cf.n_beta) {
      const int j = cf.beta_row[r];
      const size_t at = static_cast<size_t>(j) * m + e;
      beta_term<kPrecise>(cf.w[j][0], cf.w[j][1], cf.w[j][2], ddh[at], ddl[at], v);
#pragma unroll
      for (int l = 0; l < kK; ++l) beta[r][l][lane] = v[l];
    } else {
      const int a = r - cf.n_beta, j = cf.alpha_row[a];
      const size_t at = static_cast<size_t>(j) * m + e;
      const float c = cf.cy[j];
      alpha[a][0][lane] = fmul(ys0[at], c);
      alpha[a][1][lane] = fmul(ys1[at], c);
      alpha[a][2][lane] = fmul(ys2[at], c);
      alpha[a][3][lane] = fmul(ys3[at], c);
    }
  }
  __syncthreads();

  // 2. the folds: warp 0 the beta sum, warp 2 the alpha sum
  if (warp == 2) {
    float sum[kK];
    fold_expansions(alpha, cf.n_alpha, lane, sum);
#pragma unroll
    for (int l = 0; l < kK; ++l) alpha_sum[l][lane] = sum[l];
    asm volatile("bar.sync 1, 64;" ::: "memory");  // with warp 0
    return;
  }
  if (warp != 0) return;
  float inc[kK];
  if (kPrecise) {
    fold_expansions(beta, cf.n_beta, lane, inc);
  } else {
    TF acc{0.0f, 0.0f};
    for (int r = 0; r < cf.n_beta; ++r) {
      const TF term{beta[r][0][lane], beta[r][1][lane]};
      acc = r == 0 ? term : add(acc, term);
    }
    TF i2 = mul(acc, TF{cf.w[cf.order][0], cf.w[cf.order][1]});
    inc[0] = i2.hi;
    inc[1] = i2.lo;
    inc[2] = 0.0f;
    inc[3] = 0.0f;
  }
  asm volatile("bar.sync 1, 64;" ::: "memory");  // with warp 2
  float sum[kK];
  load_term(&alpha_sum, 0, lane, sum);
  float y[kK];
  ex_add(sum, inc, y);
  if (e_out >= m) return;
  o0[e_out] = y[0];
  o1[e_out] = y[1];
  o2[e_out] = y[2];
  o3[e_out] = y[3];
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
  if (order < 1 || order > kMaxOrder || m < 1) return -1;
  Elm2qCoef cf{};
  cf.order = order;
  const int cols = precise ? 3 : 2;
  const int rows = precise ? order : order + 1;
  for (int j = 0; j < rows; ++j)
    for (int k = 0; k < cols; ++k) cf.w[j][k] = coef[j * cols + k];
  for (int j = 0; j < order; ++j) {
    cf.cy[j] = c_y[j];
    if ((nonzero >> j) & 1u) cf.beta_row[cf.n_beta++] = j;
    if (c_y[j] != 0.0f) cf.alpha_row[cf.n_alpha++] = j;
  }
  const int blocks = (m + kTile - 1) / kTile;
  if (precise) {
    elm2q_update_kernel<true><<<blocks, kWarps * 32, 0, stream>>>(cf, ys0, ys1, ys2, ys3, ddh,
                                                                   ddl, o0, o1, o2, o3, m);
  } else {
    elm2q_update_kernel<false><<<blocks, kWarps * 32, 0, stream>>>(cf, ys0, ys1, ys2, ys3, ddh,
                                                                    ddl, o0, o1, o2, o3, m);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
