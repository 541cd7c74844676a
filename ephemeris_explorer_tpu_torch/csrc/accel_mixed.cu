// Kernel 6: pairwise Newtonian gravity from error-free differences of split
// positions, with the weight chain in plain f32.
//
// Replaces the TPU kernel ephemeris_explorer_tpu/ops/pallas_nbody.py
// `_accel_kernel_mixed` (reached through `pairwise_accel_mixed`, the middle
// rung of the force-mode ladder).  Positions arrive as (hi, lo) f32 pairs;
// each component of d = p_j - p_i is formed as pallas_nbody.py:800-803 does,
//
//     s, e = two_sum(pj_hi, -pi_hi);   d = s + (e + (pj_lo - pi_lo)),
//
// i.e. the f32 rounding of the exact (hi + lo) difference, so a close pair
// keeps ~2^-24 of |d| however far it lies from the origin.  From there on
// the chain is kernel 5's (forcef32.cuh): r^2, the rsqrt seed and one Newton
// step, w = mu (u u u), f32 sums.  The two_sum survives because every step
// is a round-to-nearest intrinsic and the library is built with
// --fmad=false and without fast math (twofloat.cuh).
//
// What bounds it on an H100: arithmetic, ~45 f32 operations and one rsqrt
// per pair (16.8M pairs at N = 4096), against 28 bytes read per source per
// block.  Design: kernel 1's (accel_df64.cu): one thread per receiver, 128
// receivers per block, tiles of 128 sources' (hi, lo) positions and mu in
// shared memory read as broadcasts, the source range split across gridDim.y
// into partial sums that a second pass adds in split order.  The self pair
// is skipped by index, the ragged edge masked for any N >= 1.  The f32 sums
// run in another order than the TPU kernel's, so the result is held to a
// tolerance, not bitwise.

#include "forcef32.cuh"

namespace {

constexpr int kTile = eet::kF32Tile;

__global__ void __launch_bounds__(kTile)
accel_mixed_partial(const float* __restrict__ pos_hi, const float* __restrict__ pos_lo,
                    const float* __restrict__ mu, float* __restrict__ part, int n,
                    int tiles_per_split) {
  using namespace eet;
  __shared__ float s_ph[3][kTile], s_pl[3][kTile], s_mu[kTile];

  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool active = i < n;
  const int ii = active ? i : 0;
  float pi_hi[3], pi_lo[3];
  for (int c = 0; c < 3; ++c) {
    pi_hi[c] = pos_hi[c * n + ii];
    pi_lo[c] = pos_lo[c * n + ii];
  }
  float acc[3] = {0.0f, 0.0f, 0.0f};

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
      s_mu[threadIdx.x] = mu[jj];
    }
    __syncthreads();
    const int cnt = min(kTile, n - j0);
    if (active) {
      for (int k = 0; k < cnt; ++k) {
        if (j0 + k == i) continue;  // self pair
        float d[3];
        for (int c = 0; c < 3; ++c) {
          const TF se = two_sum(s_ph[c][k], -pi_hi[c]);
          d[c] = fadd(se.hi, fadd(se.lo, fsub(s_pl[c][k], pi_lo[c])));
        }
        const float w = f32_weight(f32_r2(d), s_mu[k]);
        for (int c = 0; c < 3; ++c) acc[c] = fadd(acc[c], fmul(w, d[c]));
      }
    }
    __syncthreads();
  }
  if (active) {
    const size_t base = (static_cast<size_t>(blockIdx.y) * n + i) * 3;
    for (int c = 0; c < 3; ++c) part[base + c] = acc[c];
  }
}

}  // namespace

extern "C" {

int eet_accel_mixed_tile() { return kTile; }

// pos_hi/pos_lo: (3, N) f32 component-major split positions; mu: (N,) f32;
// part: (splits, N, 3) scratch; out: (N, 3).  Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
int eet_accel_mixed(const float* pos_hi, const float* pos_lo, const float* mu, float* part,
                    float* out, int n, int splits, cudaStream_t stream) {
  const int n_tiles = (n + kTile - 1) / kTile;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  dim3 grid(n_tiles, splits);
  accel_mixed_partial<<<grid, kTile, 0, stream>>>(pos_hi, pos_lo, mu, part, n, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return eet::launch_f32_reduce(part, out, 3 * n, splits, stream);
}

}  // extern "C"
