// Kernel 3: pairwise Newtonian gravity from 3-limb f32 positions.
//
// Replaces the TPU kernel ephemeris_explorer_tpu/ops/pallas_nbody.py
// `_accel_kernel3` in both of its entry forms: the square form
// (`pairwise_accel_limbs_pair`, `pairwise_accel_limbs`) and the rows form
// (`pairwise_accel_limbs_pair_rows`, through `_pallas_accel3_rect`).  It
// computes
//
//     a_i = sum_{j != i} mu_j (p_j - p_i) / |p_j - p_i|^3
//
// where each position is the unevaluated sum of three f32 limbs (the
// leading limbs of the 4-limb expansion state) and mu a (hi, lo) pair.  It
// differs from kernel 1 (accel_df64.cu) in its first stage only, as
// pallas_nbody.py:410-433 does: the difference is taken error-free,
// two_sum(pj0, -pi0) and two_sum(pj1, -pi1), their sloppy two-float sum,
// then the third limbs' plain difference added as a float, so d is accurate
// to ~2^-48 of |d| itself rather than of |p| (a close moon pair at 1e8 km
// gains ~5 digits).  The three squares of r^2 are non-negative and are
// summed with sloppy adds.  From there on the chain is kernel 1's: the
// two-float rsqrt, w = (u^2 mu) u, products sharing the splits.
//
// What bounds it on an H100: arithmetic, as kernel 1 (about 400 f32 add and
// multiply operations per pair, ~7 GFLOP per call at N = 4096; the
// error-free difference adds a few dozen).  The design is kernel 1's: one
// thread per receiver, 128 receivers per block, each tile of 128 sources
// staged in shared memory and read as a broadcast, the source range split
// across gridDim.y into per-split partial sums (accurate two-float adds in
// source order) that the shared reduction adds in split order.  The limbs
// arrive as the (N, 3) tensors of the expansion ring, so a tile is one
// contiguous run of 3 x 128 floats per limb, loaded coalesced; no transpose
// is launched.  The self pair is skipped by index, the ragged edge masked
// for any N >= 1.  The sum runs in another order than the TPU kernel's
// per-tile tree, so the result is held to a tolerance, not bitwise.
//
// The rows form takes the sources as the reference does, (3, N) per limb,
// and the receivers as separate (NL, 3) limbs at the global offset `row0`;
// the kernel reads sources through strides, so the square form's (N, 3)
// ring limbs and the rows form's (3, N) sources share one body.  As in
// kernel 1 (accel_df64.cu), the split count follows from the source count
// N alone, so a rows call equals the square form's row slice bitwise.

#include "pairforce.cuh"

namespace {

using eet::TF;

constexpr int kTile = eet::kPairTile;

// Sources: limb l, element (j, c) at l[j * src_sj + c * src_sc].  Receivers:
// (NL, 3) limbs r0/r1/r2 at global indices row0 + i.  part_*: (splits, NL, 3).
__global__ void __launch_bounds__(kTile)
accel_limbs3_partial(const float* __restrict__ l0, const float* __restrict__ l1,
                     const float* __restrict__ l2, int src_sj, int src_sc,
                     const float* __restrict__ mu_hi, const float* __restrict__ mu_lo,
                     const float* __restrict__ r0, const float* __restrict__ r1,
                     const float* __restrict__ r2l, float* __restrict__ part_hi,
                     float* __restrict__ part_lo, int n, int nl, int row0, int tiles_per_split) {
  using namespace eet;
  __shared__ float s_p[3][3 * kTile];  // [limb][k * 3 + c]
  __shared__ float s_mh[kTile], s_ml[kTile];

  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool active = i < nl;
  const int ii = active ? i : 0;
  const int gi = row0 + i;  // the receiver's global index
  float pi[3][3];  // [limb][c]
  for (int c = 0; c < 3; ++c) {
    pi[0][c] = r0[ii * 3 + c];
    pi[1][c] = r1[ii * 3 + c];
    pi[2][c] = r2l[ii * 3 + c];
  }
  TF acc[3] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};

  const int tile0 = blockIdx.y * tiles_per_split;
  for (int tile = tile0; tile < tile0 + tiles_per_split; ++tile) {
    const int j0 = tile * kTile;
    if (j0 >= n) break;  // uniform across the block
    const int cnt = min(kTile, n - j0);
    for (int idx = threadIdx.x; idx < 3 * cnt; idx += kTile) {
      const int k = idx / 3;
      const size_t at = static_cast<size_t>(j0 + k) * src_sj + static_cast<size_t>(idx - 3 * k) * src_sc;
      s_p[0][idx] = l0[at];
      s_p[1][idx] = l1[at];
      s_p[2][idx] = l2[at];
    }
    if (threadIdx.x < cnt) {
      s_mh[threadIdx.x] = mu_hi[j0 + threadIdx.x];
      s_ml[threadIdx.x] = mu_lo[j0 + threadIdx.x];
    }
    __syncthreads();
    if (active) {
      for (int k = 0; k < cnt; ++k) {
        if (j0 + k == gi) continue;  // self pair
        TF d[3], ds[3];
        for (int c = 0; c < 3; ++c) {
          TF a = two_sum(s_p[0][3 * k + c], -pi[0][c]);
          TF b = two_sum(s_p[1][3 * k + c], -pi[1][c]);
          float s2 = fsub(s_p[2][3 * k + c], pi[2][c]);
          d[c] = add_float(add_sloppy(a, b), s2);
          ds[c] = split(d[c].hi);
        }
        TF r2 = add_sloppy(add_sloppy(sqr_presplit(d[0], ds[0]), sqr_presplit(d[1], ds[1])),
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
    const size_t base = (static_cast<size_t>(blockIdx.y) * nl + i) * 3;
    for (int c = 0; c < 3; ++c) {
      part_hi[base + c] = acc[c].hi;
      part_lo[base + c] = acc[c].lo;
    }
  }
}

int launch(const float* l0, const float* l1, const float* l2, int src_sj, int src_sc,
           const float* mu_hi, const float* mu_lo, const float* r0, const float* r1,
           const float* r2, float* part_hi, float* part_lo, float* out_hi, float* out_lo, int n,
           int nl, int row0, int splits, cudaStream_t stream) {
  const int n_tiles = (n + kTile - 1) / kTile;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  dim3 grid((nl + kTile - 1) / kTile, splits);
  accel_limbs3_partial<<<grid, kTile, 0, stream>>>(l0, l1, l2, src_sj, src_sc, mu_hi, mu_lo, r0,
                                                   r1, r2, part_hi, part_lo, n, nl, row0,
                                                   tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return eet::launch_pair_reduce(part_hi, part_lo, out_hi, out_lo, 3 * nl, splits, stream);
}

}  // namespace

extern "C" {

int eet_accel_limbs3_tile() { return kTile; }

// Square form.  l0/l1/l2: (N, 3) f32 position limbs; mu_*: (N,) f32;
// part_*: (splits, N, 3) scratch; out_*: (N, 3).  Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
int eet_accel_limbs3(const float* l0, const float* l1, const float* l2, const float* mu_hi,
                     const float* mu_lo, float* part_hi, float* part_lo, float* out_hi,
                     float* out_lo, int n, int splits, cudaStream_t stream) {
  return launch(l0, l1, l2, 3, 1, mu_hi, mu_lo, l0, l1, l2, part_hi, part_lo, out_hi, out_lo, n,
                n, 0, splits, stream);
}

// Rows form.  p0/p1/p2: (3, N) f32 source limbs; r0/r1/r2: (NL, 3) f32
// receiver limbs at global indices row0 .. row0 + NL - 1; part_*:
// (splits, NL, 3) scratch with splits chosen from N; out_*: (NL, 3).
int eet_accel_limbs3_rows(const float* p0, const float* p1, const float* p2, const float* mu_hi,
                          const float* mu_lo, const float* r0, const float* r1, const float* r2,
                          float* part_hi, float* part_lo, float* out_hi, float* out_lo, int n,
                          int nl, int row0, int splits, cudaStream_t stream) {
  return launch(p0, p1, p2, 1, n, mu_hi, mu_lo, r0, r1, r2, part_hi, part_lo, out_hi, out_lo, n,
                nl, row0, splits, stream);
}

}  // extern "C"
