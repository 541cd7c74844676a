// Kernel 1: pairwise Newtonian gravity in two-float ("df64") arithmetic.
//
// Replaces the TPU kernel ephemeris_explorer_tpu/ops/pallas_nbody.py
// `_accel_kernel` in all three of its entry forms: the square form
// (`pairwise_accel_df64`, `pairwise_accel`), the ensemble grid
// (`pairwise_accel_df64_ensemble`, `pairwise_accel_ensemble`) and the rows
// form (`pairwise_accel_df64_rows`, through `_pallas_accel_rect`).  It
// computes
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
//
// One kernel holds the three forms.  Receivers are read through strides,
// from the (3, N) sources themselves (square and ensemble forms) or from
// separate (NL, 3) rows (rows form); the rows form's receivers sit at the
// global offset `row0`, which the self-pair test adds.  The ensemble form
// runs member e on blockIdx.z, the members' positions 3N floats apart and
// mu shared.  Every form takes the split count from the SOURCE count N
// alone, so each receiver of every form is summed in exactly the square
// form's order: an ensemble member equals the square form on that member
// bitwise, and a rows call equals the square form's row slice bitwise (the
// row decomposition of parallel/sharding.py rests on that).  At E = 16,
// N = 4096 the members alone would fill the card (32 row tiles x 16
// members), but they keep the square form's 16 splits all the same: 8192
// blocks, and a (16, 16, 4096, 3) hi/lo partial scratch of 25 MB that the
// reduction reads once.

#include "pairforce.cuh"

namespace {

using eet::TF;

constexpr int kTile = eet::kPairTile;

// Sources: (3, N) hi/lo, member e at pos_* + e * pos_se.  Receivers:
// element (i, c) of member e at rows_*[e * rows_se + i * rows_si + c * rows_sc],
// global index row0 + i.  part_*: (splits, E, NL, 3).
__global__ void __launch_bounds__(kTile)
accel_df64_partial(const float* __restrict__ pos_hi, const float* __restrict__ pos_lo,
                   const float* __restrict__ mu_hi, const float* __restrict__ mu_lo,
                   const float* __restrict__ rows_hi, const float* __restrict__ rows_lo,
                   int rows_si, int rows_sc, size_t pos_se, size_t rows_se,
                   float* __restrict__ part_hi, float* __restrict__ part_lo,
                   int n, int nl, int row0, int tiles_per_split) {
  using namespace eet;
  __shared__ float s_ph[3][kTile], s_pl[3][kTile], s_mh[kTile], s_ml[kTile];

  const int member = blockIdx.z;
  pos_hi += member * pos_se;
  pos_lo += member * pos_se;
  rows_hi += member * rows_se;
  rows_lo += member * rows_se;
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool active = i < nl;
  const int ii = active ? i : 0;
  const int gi = row0 + i;  // the receiver's global index
  TF pi[3];
  for (int c = 0; c < 3; ++c) {
    const int at = ii * rows_si + c * rows_sc;
    pi[c] = TF{rows_hi[at], rows_lo[at]};
  }
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
        if (j0 + k == gi) continue;  // self pair
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
    const size_t base =
        ((static_cast<size_t>(blockIdx.y) * gridDim.z + member) * nl + i) * 3;
    for (int c = 0; c < 3; ++c) {
      part_hi[base + c] = acc[c].hi;
      part_lo[base + c] = acc[c].lo;
    }
  }
}

int launch(const float* pos_hi, const float* pos_lo, const float* mu_hi, const float* mu_lo,
           const float* rows_hi, const float* rows_lo, int rows_si, int rows_sc, size_t pos_se,
           size_t rows_se, float* part_hi, float* part_lo, float* out_hi, float* out_lo, int n,
           int nl, int members, int row0, int splits, cudaStream_t stream) {
  const int n_tiles = (n + kTile - 1) / kTile;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  dim3 grid((nl + kTile - 1) / kTile, splits, members);
  accel_df64_partial<<<grid, kTile, 0, stream>>>(pos_hi, pos_lo, mu_hi, mu_lo, rows_hi, rows_lo,
                                                 rows_si, rows_sc, pos_se, rows_se, part_hi,
                                                 part_lo, n, nl, row0, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return eet::launch_pair_reduce(part_hi, part_lo, out_hi, out_lo, 3 * nl * members, splits,
                                 stream);
}

}  // namespace

extern "C" {

int eet_accel_df64_tile() { return kTile; }

// Square form.  pos_*: (3, N) f32 component-major; mu_*: (N,) f32; part_*:
// (splits, N, 3) scratch; out_*: (N, 3).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int eet_accel_df64(const float* pos_hi, const float* pos_lo, const float* mu_hi,
                   const float* mu_lo, float* part_hi, float* part_lo, float* out_hi,
                   float* out_lo, int n, int splits, cudaStream_t stream) {
  return launch(pos_hi, pos_lo, mu_hi, mu_lo, pos_hi, pos_lo, 1, n, 0, 0, part_hi, part_lo,
                out_hi, out_lo, n, n, 1, 0, splits, stream);
}

// Ensemble form.  pos_*: (E, 3, N) f32; mu_*: (N,) f32 shared; part_*:
// (splits, E, N, 3) scratch; out_*: (E, N, 3).
int eet_accel_df64_ensemble(const float* pos_hi, const float* pos_lo, const float* mu_hi,
                            const float* mu_lo, float* part_hi, float* part_lo, float* out_hi,
                            float* out_lo, int n, int members, int splits, cudaStream_t stream) {
  const size_t se = static_cast<size_t>(3) * n;
  return launch(pos_hi, pos_lo, mu_hi, mu_lo, pos_hi, pos_lo, 1, n, se, se, part_hi, part_lo,
                out_hi, out_lo, n, n, members, 0, splits, stream);
}

// Rows form.  pos_*: (3, N) f32 sources; rows_*: (NL, 3) f32 receivers at
// global indices row0 .. row0 + NL - 1; part_*: (splits, NL, 3) scratch with
// splits chosen from N; out_*: (NL, 3).
int eet_accel_df64_rows(const float* pos_hi, const float* pos_lo, const float* mu_hi,
                        const float* mu_lo, const float* rows_hi, const float* rows_lo,
                        float* part_hi, float* part_lo, float* out_hi, float* out_lo, int n,
                        int nl, int row0, int splits, cudaStream_t stream) {
  return launch(pos_hi, pos_lo, mu_hi, mu_lo, rows_hi, rows_lo, 3, 1, 0, 0, part_hi, part_lo,
                out_hi, out_lo, n, nl, 1, row0, splits, stream);
}

}  // extern "C"
