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
// What bounds it on an H100: arithmetic, ~47 f32 operations and one rsqrt
// per pair (16.8M pairs at N = 4096), each add and multiply issued alone;
// any other instruction in the pair loop (a load, an index compare, a
// branch) takes an issue slot from them.  The loop below issues 53 a pair:
// the 46 adds and multiplies, the rsqrt and the four instructions of its
// guard for subnormal inputs, and about two loads, selects or loop
// instructions.
//
// Design (forcef32.cuh's warp-tiled loop): each lane holds kRecv = 4
// receivers, so a source read once from shared memory, as two 16-byte
// vectors {hi.x, hi.y, hi.z, mu} and {lo.x, lo.y, lo.z, 0}, feeds four
// independent chains (0.5 loads a pair, against 7 in a one-receiver loop),
// written step by step across the four so that they interleave.  Each warp
// walks its own split of 32-source tiles through its own slice of shared
// memory: the next tile's global loads are issued into registers before
// the current tile is computed, and only __syncwarp orders them.  The self
// pair is taken by a select (w := 0, as the plain version's masked_fill),
// and only in a tile that holds the warp's own receivers or the ragged last
// tile (padded with zeros, also selected away): a branch uniform across the
// warp, so the common tile runs branch-free, unrolled by four.  The block's
// warps and a grid row's blocks are the source splits of one receiver
// group, 64 of them at N = 4096 (16 warps on each SM); the last block of a
// group to finish adds the splits' partial sums in split order
// (sum_splits), so one launch gives the result, deterministic.  The f32 sums
// run in another order than the TPU kernel's, so the result is held to a
// tolerance, not bitwise.

#include "forcef32.cuh"

namespace eet {
namespace {

// One source {h, l} against the lane's receivers: acc[r] += w d.  nhi holds
// -pi_hi; skip_k[r] is the source index (in the tile) a receiver skips
// (its self pair, or -1), and k >= cnt marks the padding.  Each step is
// taken for all receivers before the next, so the kRecv chains interleave.
template <bool kChecked>
__device__ __forceinline__ void mixed_pairs(float4 h, float4 l, const float nhi[kRecv][3],
                                            const float plo[kRecv][3], float acc[kRecv][3], int k,
                                            const int skip_k[kRecv], int cnt) {
  const float sh[3] = {h.x, h.y, h.z}, sl[3] = {l.x, l.y, l.z};
  float d[kRecv][3], r2[kRecv], w[kRecv];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    TF se[kRecv];
#pragma unroll
    for (int r = 0; r < kRecv; ++r) se[r] = two_sum(sh[c], nhi[r][c]);
#pragma unroll
    for (int r = 0; r < kRecv; ++r) d[r][c] = fadd(se[r].hi, fadd(se[r].lo, fsub(sl[c], plo[r][c])));
  }
  f32_r2s<kRecv>(d, r2);
  f32_weights<kRecv>(r2, h.w, w);
  if (kChecked) {
#pragma unroll
    for (int r = 0; r < kRecv; ++r) w[r] = (k == skip_k[r] || k >= cnt) ? 0.0f : w[r];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int r = 0; r < kRecv; ++r) acc[r][c] = fadd(acc[r][c], fmul(w[r], d[r][c]));
  }
}

// Shared memory of one warp: its tile's sources, and after the loop its
// partial sums.
struct MixedWarpSmem {
  union {
    float4 src[2][kSrcTile];  // {hi.x, hi.y, hi.z, mu}, {lo.x, lo.y, lo.z, 0}
    float part[3 * kGroup];
  };
};

template <bool kChecked>
__device__ __forceinline__ void mixed_tile(const float4 (*src)[kSrcTile], const float nhi[kRecv][3],
                                           const float plo[kRecv][3], float acc[kRecv][3],
                                           const int skip_k[kRecv], int cnt) {
  // the next source read while this one is computed
  float4 h = src[0][0], l = src[1][0];
#pragma unroll 4
  for (int k = 0; k < kSrcTile; ++k) {
    const int kn = (k + 1) % kSrcTile;
    const float4 hn = src[0][kn], ln = src[1][kn];
    mixed_pairs<kChecked>(h, l, nhi, plo, acc, k, skip_k, cnt);
    h = hn;
    l = ln;
  }
}

__global__ void __launch_bounds__(kMaxWarps * kLanes, 2)
accel_mixed_kernel(const float* __restrict__ pos_hi, const float* __restrict__ pos_lo,
                   const float* __restrict__ mu, float* __restrict__ part,
                   unsigned* __restrict__ counters, float* __restrict__ out, int n) {
  MixedWarpSmem* smem = reinterpret_cast<MixedWarpSmem*>(pair_smem);
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int warps = blockDim.x / kLanes;
  const int g0 = blockIdx.y * kGroup;
  const int split = blockIdx.x * warps + warp, splits = warps * gridDim.x;
  const int tiles = source_tiles(n);
  MixedWarpSmem& sm = smem[warp];

  // the next tile's source, one a lane, in registers
  float next_hi[3], next_lo[3], next_mu;
  auto fetch = [&](int t) {
    const int j = t * kSrcTile + lane;
    const bool in = j < n;
    const int jj = in ? j : 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      next_hi[c] = in ? pos_hi[c * n + jj] : 0.0f;
      next_lo[c] = in ? pos_lo[c * n + jj] : 0.0f;
    }
    next_mu = in ? mu[jj] : 0.0f;
  };
  if (split < tiles) fetch(split);

  float nhi[kRecv][3], plo[kRecv][3], acc[kRecv][3];
#pragma unroll
  for (int r = 0; r < kRecv; ++r) {
    const int i = min(g0 + r * kLanes + lane, n - 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      nhi[r][c] = -pos_hi[c * n + i];
      plo[r][c] = pos_lo[c * n + i];
      acc[r][c] = 0.0f;
    }
  }

  for (int t = split; t < tiles; t += splits) {
    sm.src[0][lane] = make_float4(next_hi[0], next_hi[1], next_hi[2], next_mu);
    sm.src[1][lane] = make_float4(next_lo[0], next_lo[1], next_lo[2], 0.0f);
    __syncwarp();
    if (t + splits < tiles) fetch(t + splits);
    const int j0 = t * kSrcTile;
    const int cnt = min(kSrcTile, n - j0);
    if (cnt < kSrcTile || tile_meets_group(j0, g0)) {
      int skip_k[kRecv];
#pragma unroll
      for (int r = 0; r < kRecv; ++r) skip_k[r] = g0 + r * kLanes + lane - j0;
      mixed_tile<true>(sm.src, nhi, plo, acc, skip_k, cnt);
    } else {
      const int none[kRecv] = {-1, -1, -1, -1};
      mixed_tile<false>(sm.src, nhi, plo, acc, none, kSrcTile);
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRecv; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) sm.part[c * kGroup + r * kLanes + lane] = acc[r][c];
  }
  sum_splits(smem[0].part, static_cast<int>(sizeof(MixedWarpSmem) / sizeof(float)), part,
             counters, out, g0, n);
}

}  // namespace
}  // namespace eet

extern "C" {

// pos_hi/pos_lo: (3, N) f32 component-major split positions; mu: (N,) f32;
// part: (blocks, N, 3) scratch; counters: one unsigned a group of 128
// receivers, zero (and left zero); out: (N, 3).  `warps` warps a block times
// `blocks` blocks are the source splits of each group (ops/cuda_nbody.py
// `_f32_pair_geometry`).  Launches on `stream` and returns the cudaError_t
// of the launch (0 = launched).
int eet_accel_mixed(const float* pos_hi, const float* pos_lo, const float* mu, float* part,
                    unsigned* counters, float* out, int n, int warps, int blocks,
                    cudaStream_t stream) {
  using namespace eet;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_pair_kernel(accel_mixed_kernel, sizeof(MixedWarpSmem), (n + kGroup - 1) / kGroup,
                            warps, blocks, stream, pos_hi, pos_lo, mu, part, counters, out, n);
}

// The warp-tiled loop's tile and receiver group (kernels 5-7), which
// `_f32_pair_geometry` assumes.
int eet_f32_pair_tile() { return eet::kSrcTile; }
int eet_f32_pair_group() { return eet::kGroup; }

}  // extern "C"
