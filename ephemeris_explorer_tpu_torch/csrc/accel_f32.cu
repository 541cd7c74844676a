// Kernels 5 and 7: pairwise Newtonian gravity in plain f32, without and with
// a per-pair exclusion mask.
//
// Replaces the TPU kernels ephemeris_explorer_tpu/ops/pallas_nbody.py
// `_accel_kernel_f32` (kernel 5, reached through `pairwise_accel_f32`, the
// f32 rung of the force-mode ladder) and `_accel_kernel_f32_masked` (kernel
// 7, reached through `pairwise_accel_f32_masked` and
// `pairwise_accel_f32_masked_rows`, the weak tail of the magnitude-split
// force mode).  It computes
//
//     a_i = sum_{j != i, not skipped} mu_j (p_j - p_i) / |p_j - p_i|^3
//
// in f32 with the chain of pallas_nbody.py:884-897, in the order written: the
// difference, r^2 summed left to right, the rsqrt seed and one Newton step,
// w = mu (u u u).  Kernel 5 skips the self pair; kernel 7 skips every pair
// whose int8 mask entry is nonzero and, unless the mask is promised to carry
// the self diagonal (`diag_in_mask`), the self pair as well.
//
// What bounds them on an H100: arithmetic, ~23 f32 operations and one rsqrt
// per pair (16.8M pairs at N = 4096), each add and multiply issued alone.
// Kernel 7 also reads the (NL, N) int8 mask once, 16.8 MB at N = 4096 (5.0
// us of HBM, under the 11.5 us of arithmetic), and every pair pays for its
// mask byte: a load, a test and a select.  Kernel 7's loop issues 30
// instructions a pair: the 22 adds and multiplies, the rsqrt and the four
// instructions of its guard for subnormal inputs, the mask test and select,
// and a share of the loads and the loop; kernel 5's the same less the mask's
// test and select.
//
// Both run one body, forcef32.cuh's warp-tiled loop, with the mask compiled
// in (kernel 7) or out (kernel 5) by a template flag.  Each lane holds kRecv
// = 4 receivers, so one 16-byte {x, y, z, mu} read from shared memory feeds
// four independent chains, written step by step across the four.  Each warp
// walks its own split of 32-source tiles, the next tile prefetched into
// registers while the tile before is computed.  With a tile's sources kernel
// 7 stages its 128 receivers' 32 mask bytes each, loaded from device memory
// as 16-byte runs and stored word-major (word q of all 128 rows side by
// side), so each lane reads a 4-byte word, four sources' mask bytes, of each
// of its rows without a bank conflict.  The splits take the tiles in a
// stride, so the warps that run side by side read each mask row's
// neighbouring 32-byte runs.  A masked pair is taken by a select, as in the
// plain version (w := 0: it adds +-0, the sum of a skipped pair), so the
// loop has no per-pair branch; the self compare (kernel 5, and kernel 7
// without `diag_in_mask`) and the ragged last tile's padding are selected
// only in the tiles that need them, a branch uniform across the warp.  The
// block's warps and a grid row's blocks are the source splits of one
// receiver group; the last block of a group to finish adds their partial
// sums in split order (sum_splits): one launch, deterministic.  The splits
// follow from N (the sources) alone, so kernel 7's rows form (receivers at a
// global offset) sums every receiver in the same order as the square form
// and equals its row slices bitwise.
//
// The f32 sums run in another order than the TPU kernels' per-tile sums, so
// the results are held to a tolerance, not bitwise; CUDA's rsqrtf seed may
// also differ from other platforms' by an ulp before the Newton step.

#include <cstdint>

#include "forcef32.cuh"

namespace eet {
namespace {

constexpr int kWords = kSrcTile / 4;  // mask words (4 sources each) a row of a tile
constexpr int kRuns = kSrcTile / 16;  // 16-byte mask runs a row of a tile

// Shared memory of one warp: its tile's sources, with the mask its 128 rows'
// mask words of the tile, word-major; after the loop the partial sums take
// the place of the mask words (of the sources without a mask).
template <bool kMasked>
struct F32WarpSmem;

template <>
struct F32WarpSmem<true> {
  float4 src[kSrcTile];
  union {
    uint32_t mask[kWords][kGroup];
    float part[3 * kGroup];
  };
};

template <>
struct F32WarpSmem<false> {
  union {
    float4 src[kSrcTile];
    float part[3 * kGroup];
  };
};

// 16 mask bytes of row `row` (< nl) from column `col`: one 16-byte load when
// the run lies inside the row and `vec` (rows and pointer 16-byte aligned),
// else byte by byte, zero past column n.
__device__ __forceinline__ uint4 mask_run(const int8_t* __restrict__ mask, int n, int row, int col,
                                          bool vec) {
  const int8_t* p = mask + static_cast<size_t>(row) * n + col;
  if (vec && col + 16 <= n) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if (col + b < n) w[b / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(p[b])) << (8 * (b % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One source s against the lane's receivers p[r]: acc[r] += w d, w := 0
// where the mask byte `byte` of mw[r] is nonzero (kMasked), and in checked
// tiles where k is the receiver's skip_k (its self pair, or -1) or past cnt
// (the padding).  Each step is taken for all receivers before the next, so
// the kRecv chains interleave.
template <bool kMasked, bool kChecked>
__device__ __forceinline__ void f32_pairs(float4 s, const float p[kRecv][3], float acc[kRecv][3],
                                          const uint32_t mw[kRecv], int byte, int k,
                                          const int skip_k[kRecv], int cnt) {
  float d[kRecv][3], r2[kRecv], w[kRecv];
#pragma unroll
  for (int r = 0; r < kRecv; ++r) {
    d[r][0] = fsub(s.x, p[r][0]);
    d[r][1] = fsub(s.y, p[r][1]);
    d[r][2] = fsub(s.z, p[r][2]);
  }
  f32_r2s<kRecv>(d, r2);
  f32_weights<kRecv>(r2, s.w, w);
  if (kMasked || kChecked) {
#pragma unroll
    for (int r = 0; r < kRecv; ++r) {
      bool skip = kMasked && (mw[r] & (0xffu << (8 * byte))) != 0u;
      if (kChecked) skip = skip || k == skip_k[r] || k >= cnt;
      w[r] = skip ? 0.0f : w[r];
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int r = 0; r < kRecv; ++r) acc[r][c] = fadd(acc[r][c], fmul(w[r], d[r][c]));
  }
}

// The lane's receivers against a staged tile, four sources at a time (with
// the mask, word q of each receiver's mask row first).
template <bool kMasked, bool kChecked>
__device__ __forceinline__ void f32_tile(const F32WarpSmem<kMasked>& sm, int lane,
                                         const float p[kRecv][3], float acc[kRecv][3],
                                         const int skip_k[kRecv], int cnt) {
#pragma unroll 1
  for (int q = 0; q < kWords; ++q) {
    uint32_t mw[kRecv] = {0u, 0u, 0u, 0u};
    if constexpr (kMasked) {
#pragma unroll
      for (int r = 0; r < kRecv; ++r) mw[r] = sm.mask[q][r * kLanes + lane];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      f32_pairs<kMasked, kChecked>(sm.src[4 * q + b], p, acc, mw, b, 4 * q + b, skip_k, cnt);
    }
  }
}

// kMasked: kernel 7 (kDiagInMask: the mask carries the self diagonal);
// else kernel 5 (rows == pos, nl == n, mask unused, the self pair skipped
// by index).
template <bool kMasked, bool kDiagInMask>
__global__ void __launch_bounds__(kMaxWarps * kLanes, 2)
accel_f32_kernel(const float* __restrict__ pos, const float* __restrict__ mu,
                 const float* __restrict__ rows, const int8_t* __restrict__ mask,
                 float* __restrict__ part, unsigned* __restrict__ counters,
                 float* __restrict__ out, int n, int nl) {
  using Smem = F32WarpSmem<kMasked>;
  Smem* smem = reinterpret_cast<Smem*>(pair_smem);
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int warps = blockDim.x / kLanes;
  const int g0 = blockIdx.y * kGroup;
  const int split = blockIdx.x * warps + warp, splits = warps * gridDim.x;
  const int tiles = source_tiles(n);
  Smem& sm = smem[warp];

  // the next tile in registers: a source a lane, and (kMasked) the tile's
  // mask bytes of rows g0 + 32 r + lane, kRuns runs of 16
  float4 next_src;
  uint4 next_mask[kRecv][kMasked ? kRuns : 1];
  auto fetch = [&](int t) {
    const int j0 = t * kSrcTile;
    const int j = j0 + lane;
    next_src = j < n ? make_float4(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2], mu[j])
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (kMasked) {
      const bool vec = n % 16 == 0 && (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
#pragma unroll
      for (int r = 0; r < kRecv; ++r) {
        const int row = g0 + r * kLanes + lane;
#pragma unroll
        for (int h = 0; h < kRuns; ++h) {
          next_mask[r][h] = row < nl ? mask_run(mask, n, row, j0 + 16 * h, vec)
                                     : make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  };
  if (split < tiles) fetch(split);

  float p[kRecv][3], acc[kRecv][3];
#pragma unroll
  for (int r = 0; r < kRecv; ++r) {
    const int i = min(g0 + r * kLanes + lane, nl - 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p[r][c] = rows[3 * i + c];
      acc[r][c] = 0.0f;
    }
  }

  for (int t = split; t < tiles; t += splits) {
    sm.src[lane] = next_src;
    if constexpr (kMasked) {
#pragma unroll
      for (int r = 0; r < kRecv; ++r) {
        const int row = r * kLanes + lane;
#pragma unroll
        for (int h = 0; h < kRuns; ++h) {
          sm.mask[4 * h][row] = next_mask[r][h].x;
          sm.mask[4 * h + 1][row] = next_mask[r][h].y;
          sm.mask[4 * h + 2][row] = next_mask[r][h].z;
          sm.mask[4 * h + 3][row] = next_mask[r][h].w;
        }
      }
    }
    __syncwarp();
    if (t + splits < tiles) fetch(t + splits);
    const int j0 = t * kSrcTile;
    const int cnt = min(kSrcTile, n - j0);
    if (cnt < kSrcTile || (!kDiagInMask && tile_meets_group(j0, g0))) {
      int skip_k[kRecv];
#pragma unroll
      for (int r = 0; r < kRecv; ++r) skip_k[r] = kDiagInMask ? -1 : g0 + r * kLanes + lane - j0;
      f32_tile<kMasked, true>(sm, lane, p, acc, skip_k, cnt);
    } else {
      const int none[kRecv] = {-1, -1, -1, -1};
      f32_tile<kMasked, false>(sm, lane, p, acc, none, kSrcTile);
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRecv; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) sm.part[c * kGroup + r * kLanes + lane] = acc[r][c];
  }
  sum_splits(smem[0].part, static_cast<int>(sizeof(Smem) / sizeof(float)), part, counters, out,
             g0, nl);
}

}  // namespace
}  // namespace eet

extern "C" {

// Kernel 5.  pos: (N, 3) f32 sources and receivers; mu: (N,) f32; part:
// (blocks, N, 3) scratch; counters: one unsigned a group of 128 receivers,
// zero (and left zero); out: (N, 3).  `warps` warps a block times `blocks`
// blocks are the source splits of each group (ops/cuda_nbody.py
// `_f32_pair_geometry`).  Launches on `stream` and returns the cudaError_t of
// the launch (0 = launched).
int eet_accel_f32(const float* pos, const float* mu, float* part, unsigned* counters, float* out,
                  int n, int warps, int blocks, cudaStream_t stream) {
  using namespace eet;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_pair_kernel(accel_f32_kernel<false, false>, sizeof(F32WarpSmem<false>),
                            (n + kGroup - 1) / kGroup, warps, blocks, stream, pos, mu, pos,
                            static_cast<const int8_t*>(nullptr), part, counters, out, n, n);
}

// Kernel 7.  pos: (N, 3) f32 sources; mu: (N,) f32; rows: (NL, 3) f32
// receivers; mask: (NL, N) int8; part: (blocks, NL, 3) scratch; counters:
// one unsigned a group of 128 receivers, zero (and left zero); out: (NL,
// 3).  Without diag_in_mask the receivers must be the sources (NL == N) and
// the self pair is skipped by index.  `warps` and `blocks` as kernel 5's,
// from N alone.  Launches on `stream` and returns the cudaError_t of the
// launch (0 = launched).
int eet_accel_f32_masked(const float* pos, const float* mu, const float* rows, const int8_t* mask,
                         float* part, unsigned* counters, float* out, int n, int nl, int warps,
                         int blocks, int diag_in_mask, cudaStream_t stream) {
  using namespace eet;
  if (n < 1 || nl < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_pair_kernel(diag_in_mask ? accel_f32_kernel<true, true>
                                         : accel_f32_kernel<true, false>,
                            sizeof(F32WarpSmem<true>), (nl + kGroup - 1) / kGroup, warps, blocks,
                            stream, pos, mu, rows, mask, part, counters, out, n, nl);
}

}  // extern "C"
