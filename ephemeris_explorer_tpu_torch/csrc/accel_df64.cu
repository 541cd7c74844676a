// Kernel 1: pairwise Newtonian gravity in two-float ("df64") arithmetic.
//
// Replaces the TPU kernel ephemeris_explorer_tpu/ops/pallas_nbody.py
// `_accel_kernel` (square form, reached through `pairwise_accel_df64` and
// `pairwise_accel`).  It computes
//
//     a_i = sum_{j != i} mu_j (p_j - p_i) / |p_j - p_i|^3
//
// with positions and mu as (hi, lo) f32 pairs and the same per-pair chain as
// pallas_nbody.py:144-180: two-float differences; r^2 from squares that share
// each difference's Dekker split; the two-float rsqrt (f32 seed, one Newton
// step, plus the exact (3/8)(s-1)^2 bias term of `_rsqrt_df`); the weight
// formed as (u^2 mu) u, which keeps the distant-pair terms out of f32
// subnormals; and products that share the weight's split.
//
// What bounds it on an H100: arithmetic.  The chain is about 400 f32
// add/multiply operations per pair (a split alone is 4, an accurate
// two-float add 20), so N = 4096 is 16.8M pairs and ~7 GFLOP per call,
// against 16 bytes read per source per block.  Tensor cores do not apply:
// every step is an error-free transform whose rounding must be exact f32,
// and none of it is a matrix product.
//
// Design: one thread per receiver row and a block of 128 receivers; the
// block stages each tile of 128 sources' (hi, lo) positions and (hi, lo) mu
// in shared memory, and every thread reads the same source at once (a
// broadcast).  N = 4096 gives only 32 row blocks, far too few for 132 SMs,
// so the source range is also split across gridDim.y: each split sums its
// share in registers with accurate two-float adds into a partial (S, N, 3)
// scratch, and a second small kernel adds the S partials in order.  The
// self pair is skipped by global index, and the ragged edge is masked for
// any N >= 1.  The order of the sum differs from the TPU kernel's tile tree,
// so the result is held to a tolerance, not to bitwise equality; so is the
// f32 rsqrt seed, which differs from other platforms' by an ulp before the
// Newton step absorbs it.

#include <cuda_runtime.h>

#include "twofloat.cuh"

namespace {

using eet::TF;

constexpr int kTile = 128;

// x * x with the split of x.hi supplied (pallas_nbody._sqr_presplit).
__device__ __forceinline__ TF sqr_presplit(TF x, TF xs) {
  using namespace eet;
  float p = fmul(x.hi, x.hi);
  float e = fadd(fadd(fsub(fmul(xs.hi, xs.hi), p), fmul(2.0f, fmul(xs.hi, xs.lo))),
                 fmul(xs.lo, xs.lo));
  e = fadd(e, fmul(2.0f, fmul(x.hi, x.lo)));
  return quick_two_sum(p, e);
}

// Two-float 1/sqrt(x) (pallas_nbody._rsqrt_df with one refinement).
__device__ __forceinline__ TF rsqrt_df(TF x) {
  using namespace eet;
  float y0 = rsqrtf(x.hi);
  TF xy2 = mul(x, two_sqr(y0));
  float t = fadd(fsub(xy2.hi, 1.0f), xy2.lo);
  TF corr = add_float(mul_float(xy2, -0.5f), 1.5f);
  corr.lo = fadd(corr.lo, fmul(fmul(0.375f, t), t));
  TF y = two_prod(y0, corr.hi);
  return quick_two_sum(y.hi, fadd(y.lo, fmul(y0, corr.lo)));
}

__global__ void __launch_bounds__(kTile)
accel_df64_partial(const float* __restrict__ pos_hi, const float* __restrict__ pos_lo,
                   const float* __restrict__ mu_hi, const float* __restrict__ mu_lo,
                   float* __restrict__ part_hi, float* __restrict__ part_lo,
                   int n, int tiles_per_split) {
  using namespace eet;
  __shared__ float s_ph[3][kTile], s_pl[3][kTile], s_mh[kTile], s_ml[kTile];

  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool active = i < n;
  const int ii = active ? i : 0;
  TF pi[3];
  for (int c = 0; c < 3; ++c) pi[c] = TF{pos_hi[c * n + ii], pos_lo[c * n + ii]};
  TF acc[3] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};

  const int tile0 = blockIdx.y * tiles_per_split;
  for (int tile = tile0; tile < tile0 + tiles_per_split; ++tile) {
    const int j0 = tile * kTile;
    if (j0 >= n) break;  // uniform across the block
    const int jj = j0 + threadIdx.x;
    if (jj < n) {
      for (int c = 0; c < 3; ++c) {
        s_ph[c][threadIdx.x] = pos_hi[c * n + jj];
        s_pl[c][threadIdx.x] = pos_lo[c * n + jj];
      }
      s_mh[threadIdx.x] = mu_hi[jj];
      s_ml[threadIdx.x] = mu_lo[jj];
    }
    __syncthreads();
    const int cnt = min(kTile, n - j0);
    if (active) {
      for (int k = 0; k < cnt; ++k) {
        if (j0 + k == i) continue;  // self pair
        TF d[3], ds[3];
        for (int c = 0; c < 3; ++c) {
          d[c] = sub(TF{s_ph[c][k], s_pl[c][k]}, pi[c]);
          ds[c] = split(d[c].hi);
        }
        TF r2 = add(add(sqr_presplit(d[0], ds[0]), sqr_presplit(d[1], ds[1])),
                    sqr_presplit(d[2], ds[2]));
        TF u = rsqrt_df(r2);
        TF w = mul(mul(sqr(u), TF{s_mh[k], s_ml[k]}), u);
        TF ws = split(w.hi);
        for (int c = 0; c < 3; ++c) acc[c] = add(acc[c], mul_presplit(w, ws, d[c], ds[c]));
      }
    }
    __syncthreads();
  }
  if (active) {
    const size_t base = (static_cast<size_t>(blockIdx.y) * n + i) * 3;
    for (int c = 0; c < 3; ++c) {
      part_hi[base + c] = acc[c].hi;
      part_lo[base + c] = acc[c].lo;
    }
  }
}

// out[e] = sum over the S splits of part[s, e], accurate adds in split order.
__global__ void accel_df64_reduce(const float* __restrict__ part_hi,
                                  const float* __restrict__ part_lo,
                                  float* __restrict__ out_hi, float* __restrict__ out_lo,
                                  int m, int splits) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  TF acc{part_hi[e], part_lo[e]};
  for (int s = 1; s < splits; ++s) {
    acc = eet::add(acc, TF{part_hi[static_cast<size_t>(s) * m + e],
                           part_lo[static_cast<size_t>(s) * m + e]});
  }
  out_hi[e] = acc.hi;
  out_lo[e] = acc.lo;
}

}  // namespace

extern "C" {

int eet_accel_df64_tile() { return kTile; }

// pos_*: (3, N) f32 component-major; mu_*: (N,) f32; part_*: (splits, N, 3)
// scratch; out_*: (N, 3).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int eet_accel_df64(const float* pos_hi, const float* pos_lo, const float* mu_hi,
                   const float* mu_lo, float* part_hi, float* part_lo, float* out_hi,
                   float* out_lo, int n, int splits, cudaStream_t stream) {
  const int n_tiles = (n + kTile - 1) / kTile;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  dim3 grid(n_tiles, splits);
  accel_df64_partial<<<grid, kTile, 0, stream>>>(pos_hi, pos_lo, mu_hi, mu_lo, part_hi,
                                                 part_lo, n, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m = 3 * n;
  accel_df64_reduce<<<(m + 255) / 256, 256, 0, stream>>>(part_hi, part_lo, out_hi, out_lo,
                                                         m, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
