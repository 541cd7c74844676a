// Kernels 5 and 7: pairwise Newtonian gravity in plain f32, without and with
// a per-pair exclusion mask.
//
// Replaces the TPU kernels ephemeris_explorer_tpu/ops/pallas_nbody.py
// `_accel_kernel_f32` (kernel 5, reached through `pairwise_accel_f32`) and
// `_accel_kernel_f32_masked` (kernel 7, reached through
// `pairwise_accel_f32_masked` and `pairwise_accel_f32_masked_rows`, the weak
// tail of the magnitude-split force mode).  It computes
//
//     a_i = sum_{j != i, not skipped} mu_j (p_j - p_i) / |p_j - p_i|^3
//
// in f32 with the chain of pallas_nbody.py:884-897, in the order written: the
// difference, r^2 summed left to right, the rsqrt seed and one Newton step,
// w = mu (u u u).  Kernel 5 skips the self pair; kernel 7 skips every pair
// whose int8 mask entry is nonzero and, unless the mask is promised to carry
// the self diagonal (`diag_in_mask`), the self pair as well.  One template,
// `accel_f32_partial<masked, diag_in_mask>`, holds both.
//
// What bounds it on an H100: arithmetic and the special-function unit.  The
// chain is ~25 f32 operations and one rsqrt per pair, so N = 4096 is 16.8M
// pairs, ~0.4 GFLOP and 16.8M rsqrts per call: a few microseconds of the
// card, comparable to a launch.  Kernel 7 also reads the (NL, N) int8 mask,
// 16.8 MB at N = 4096, once.
//
// Design: kernel 1's (accel_df64.cu).  One thread per receiver, 128
// receivers per block; each tile of 128 sources is staged in shared memory,
// read as the (N, 3) rows it arrives in (one contiguous run of 384 floats),
// and every thread reads the same source at once (a broadcast).  The source
// range is split across gridDim.y into per-split partial sums (f32 adds in
// source order) that a second pass adds in split order.  The number of
// splits follows from N (the sources) alone, so the rows form (receivers at
// a global offset) sums every receiver in the same order as the square form
// and equals its row slices bitwise.
//
// The mask is row-major (NL, N): thread i reading mask[i, j] directly would
// stride every warp load by N bytes.  Each (128 receivers x 128 sources)
// block of it is staged through shared memory instead, by coalesced loads
// (16 bytes a thread where N and the pointer allow, bytes otherwise), into
// rows padded to 132 bytes so that a warp's 32 receivers reading one source
// column fall in 32 different banks.
//
// The f32 sums run in another order than the TPU kernel's per-tile sums, so
// the result is held to a tolerance, not bitwise; CUDA's rsqrtf seed may also
// differ from other platforms' by an ulp before the Newton step.

#include <cstdint>

#include "forcef32.cuh"

namespace {

constexpr int kTile = eet::kF32Tile;
constexpr int kMaskStride = kTile + 4;  // bytes per staged mask row (33 words)

// Stage mask[row0 : row0 + rows, j0 : j0 + cnt] into s_mask (row stride
// kMaskStride), coalesced.
__device__ __forceinline__ void stage_mask(const int8_t* __restrict__ mask, unsigned char* s_mask,
                                           int n, int row0, int rows, int j0, int cnt) {
  const bool vec = cnt == kTile && n % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  if (vec) {
    for (int v = threadIdx.x; v < rows * (kTile / 16); v += kTile) {
      const int r = v / (kTile / 16), q = v % (kTile / 16);
      const uint4 x = *reinterpret_cast<const uint4*>(
          mask + static_cast<size_t>(row0 + r) * n + j0 + q * 16);
      unsigned* dst = reinterpret_cast<unsigned*>(s_mask + r * kMaskStride + q * 16);
      dst[0] = x.x;
      dst[1] = x.y;
      dst[2] = x.z;
      dst[3] = x.w;
    }
  } else {
    for (int e = threadIdx.x; e < rows * cnt; e += kTile) {
      const int r = e / cnt, c = e - r * cnt;
      s_mask[r * kMaskStride + c] =
          static_cast<unsigned char>(mask[static_cast<size_t>(row0 + r) * n + j0 + c]);
    }
  }
}

template <bool kMasked, bool kDiagInMask>
__global__ void __launch_bounds__(kTile)
accel_f32_partial(const float* __restrict__ pos, const float* __restrict__ mu,
                  const float* __restrict__ rows, const int8_t* __restrict__ mask,
                  float* __restrict__ part, int n, int nl, int tiles_per_split) {
  using namespace eet;
  __shared__ float s_p[3 * kTile];
  __shared__ float s_mu[kTile];
  __shared__ __align__(16) unsigned char s_mask[kMasked ? kTile * kMaskStride : 4];

  const int row0 = blockIdx.x * kTile;
  const int rows_here = min(kTile, nl - row0);
  const int i = row0 + threadIdx.x;  // receiver; its global index in the square form
  const bool active = i < nl;
  const int ii = active ? i : 0;
  const float pi[3] = {rows[ii * 3], rows[ii * 3 + 1], rows[ii * 3 + 2]};
  float acc[3] = {0.0f, 0.0f, 0.0f};

  const int tile0 = blockIdx.y * tiles_per_split;
  for (int tile = tile0; tile < tile0 + tiles_per_split; ++tile) {
    const int j0 = tile * kTile;
    if (j0 >= n) break;  // uniform across the block
    const int cnt = min(kTile, n - j0);
    for (int e = threadIdx.x; e < 3 * cnt; e += kTile) s_p[e] = pos[static_cast<size_t>(j0) * 3 + e];
    if (threadIdx.x < cnt) s_mu[threadIdx.x] = mu[j0 + threadIdx.x];
    if (kMasked) stage_mask(mask, s_mask, n, row0, rows_here, j0, cnt);
    __syncthreads();
    if (active) {
      for (int k = 0; k < cnt; ++k) {
        bool skip = false;
        if (kMasked) skip = s_mask[threadIdx.x * kMaskStride + k] != 0;
        if (!kDiagInMask) skip = skip || j0 + k == i;
        if (skip) continue;  // the reference's w = 0 adds +-0: the same sum
        const float d[3] = {fsub(s_p[3 * k], pi[0]), fsub(s_p[3 * k + 1], pi[1]),
                            fsub(s_p[3 * k + 2], pi[2])};
        const float w = f32_weight(f32_r2(d), s_mu[k]);
        for (int c = 0; c < 3; ++c) acc[c] = fadd(acc[c], fmul(w, d[c]));
      }
    }
    __syncthreads();
  }
  if (active) {
    const size_t base = (static_cast<size_t>(blockIdx.y) * nl + i) * 3;
    for (int c = 0; c < 3; ++c) part[base + c] = acc[c];
  }
}

template <bool kMasked, bool kDiagInMask>
int launch(const float* pos, const float* mu, const float* rows, const int8_t* mask, float* part,
           float* out, int n, int nl, int splits, cudaStream_t stream) {
  const int n_tiles = (n + kTile - 1) / kTile;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  dim3 grid((nl + kTile - 1) / kTile, splits);
  accel_f32_partial<kMasked, kDiagInMask>
      <<<grid, kTile, 0, stream>>>(pos, mu, rows, mask, part, n, nl, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return eet::launch_f32_reduce(part, out, 3 * nl, splits, stream);
}

}  // namespace

extern "C" {

int eet_accel_f32_tile() { return kTile; }

// Kernel 5.  pos: (N, 3) f32 sources and receivers; mu: (N,) f32; part:
// (splits, N, 3) scratch; out: (N, 3).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int eet_accel_f32(const float* pos, const float* mu, float* part, float* out, int n, int splits,
                  cudaStream_t stream) {
  return launch<false, false>(pos, mu, pos, nullptr, part, out, n, n, splits, stream);
}

// Kernel 7.  pos: (N, 3) f32 sources; mu: (N,) f32; rows: (NL, 3) f32
// receivers; mask: (NL, N) int8; part: (splits, NL, 3) scratch; out: (NL, 3).
// Without diag_in_mask the receivers must be the sources (NL == N) and the
// self pair is skipped by index.
int eet_accel_f32_masked(const float* pos, const float* mu, const float* rows,
                         const int8_t* mask, float* part, float* out, int n, int nl, int splits,
                         int diag_in_mask, cudaStream_t stream) {
  if (diag_in_mask) {
    return launch<true, true>(pos, mu, rows, mask, part, out, n, nl, splits, stream);
  }
  return launch<true, false>(pos, mu, rows, mask, part, out, n, nl, splits, stream);
}

}  // extern "C"
