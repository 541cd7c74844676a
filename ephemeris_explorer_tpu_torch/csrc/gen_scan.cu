// Kernel 11: a whole generation chunk in one thread block.
//
// Replaces the TPU kernel ephemeris_explorer_tpu/ops/pallas_gen.py
// `_gen_kernel` (reached through `_gen_scan_flat` and `elm2_gen_scan`).  For
// n_steps steps it runs, on two-float (hi, lo) f32 state:
//
//   1. the ELM2 position update of every element (kernel 2's arithmetic,
//      elm2f.cuh);
//   2. the N x N two-float pair force on the new positions
//      (pallas_gen.py:47-85 `_pair_force`);
//   3. the ring shift;
//   4. the emission of the new positions, one (3N,) row per step.
//
// Layout: the reference's component-major flat rows, M = 3N elements
// [x_0 .. x_{N-1}, y_0 .., z_0 ..], with N padded by the wrapper to a power
// of two (massless ghost bodies far away), because the force's sum is the
// halving tree of `_dd_tree_sum` over all N sources.
//
// The force's chain is `_pair_force`'s: d = p_j - p_i in two-float; r^2 from
// squares sharing each difference's split; the self pair's r^2 set to 1; the
// two-float rsqrt of pairforce.cuh; the weight w = (u^2 u) mu_j, in that
// order, as pallas_gen.py:72 writes it (the row kernels fold mu in before
// the last multiply by u, because on the TPU u^3's low word flushes
// subnormal for the most distant pairs; this library is built without
// flush-to-zero, so subnormals survive here and the reference's order is
// kept as written); the self pair's w set to 0; products with d sharing w's
// split; then the tree over the N sources.  The plain version
// (ops/cuda_gen.py) runs the same ops in the same order, so the two agree
// bitwise.
//
// What bounds it on an H100: latency.  At N = 32 a step is 1024 pairs of
// ~420 f32 operations, about 0.4 M operations, a few microseconds of one SM;
// the TPU's whole-chunk program saved dispatches, and here it saves the ~10
// launches and host work of each step (the full_solar_system year runs
// host-bound with the device ~93% idle on the per-step path).  One block
// uses one of the 132 SMs: the design trades the card's width for a chunk
// with no launch, no host round trip and no device-memory traffic but the
// emission.
//
// Design: one block, 32 x min(N, 16) threads.  The four rings (positions and
// forces, hi and lo; ORDER x 3N floats each) stay in shared memory for all
// n_steps (18.4 KB at N = 32 for ORDER = 12; 147 KB at N = 256, the largest
// padded N the wrapper takes).  The ring shift is a rotating head index:
// the new row overwrites the oldest slot, so no data moves and no sum
// changes order.  Each step: every thread updates its elements (reading its
// own element of each ring row and writing the new row in place of the
// oldest), writes the emission, and a barrier; then warp w computes the
// forces on receivers w, w + warps, ..., lane l holding sources l, l + 32,
// ... (l < N when N < 32): the first levels of the halving tree (sources j
// and j + N/2, ...) run inside the lane, the last five across lanes as
// shuffles, lane l + off added to lane l with the lower index first, as
// `_dd_tree_sum` adds; lane 0 writes the force into the new ring row, and a
// barrier.  At the end the rings go back to device memory newest first.

#include "elm2f.cuh"
#include "pairforce.cuh"

namespace {

using eet::Elm2Coef;
using eet::TF;

constexpr int kMaxPaddedN = 256;
constexpr int kMaxWarps = 16;

// Source j's term on receiver i: mul(w, d) per component (zero for i == j).
__device__ __forceinline__ void gen_pair(const float* y_hi, const float* y_lo,
                                         const float* mu_hi, const float* mu_lo, const TF pi[3],
                                         int n, int i, int j, TF term[3]) {
  using namespace eet;
  TF d[3], ds[3];
  for (int c = 0; c < 3; ++c) {
    d[c] = sub(TF{y_hi[c * n + j], y_lo[c * n + j]}, pi[c]);
    ds[c] = split(d[c].hi);
  }
  TF r2 = add(add(sqr_presplit(d[0], ds[0]), sqr_presplit(d[1], ds[1])),
              sqr_presplit(d[2], ds[2]));
  if (i == j) r2 = TF{1.0f, 0.0f};
  const TF u = rsqrt_df(r2);
  TF w = mul(mul(sqr(u), u), TF{mu_hi[j], mu_lo[j]});
  if (i == j) w = TF{0.0f, 0.0f};
  const TF ws = split(w.hi);
  for (int c = 0; c < 3; ++c) term[c] = mul_presplit(w, ws, d[c], ds[c]);
}

// kCols sources per lane: N = 32 kCols for kCols > 1, N <= 32 for kCols = 1.
template <int kCols>
__global__ void __launch_bounds__(kMaxWarps * 32)
gen_scan(Elm2Coef cf, const float* __restrict__ mu_hi, const float* __restrict__ mu_lo,
         const float* __restrict__ ys_hi, const float* __restrict__ ys_lo,
         const float* __restrict__ dd_hi, const float* __restrict__ dd_lo,
         float* __restrict__ emit_hi, float* __restrict__ emit_lo, float* __restrict__ oys_hi,
         float* __restrict__ oys_lo, float* __restrict__ odd_hi, float* __restrict__ odd_lo,
         int n, int n_steps) {
  using namespace eet;
  extern __shared__ float smem[];
  const int order = cf.order, m = 3 * n, ring = order * m;
  float* s_yh = smem;
  float* s_yl = s_yh + ring;
  float* s_dh = s_yl + ring;
  float* s_dl = s_dh + ring;
  float* s_mh = s_dl + ring;
  float* s_ml = s_mh + n;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, warps = nthreads / 32;
  const int lanes = n < 32 ? n : 32;  // lanes holding sources

  for (int e = tid; e < ring; e += nthreads) {
    s_yh[e] = ys_hi[e];
    s_yl[e] = ys_lo[e];
    s_dh[e] = dd_hi[e];
    s_dl[e] = dd_lo[e];
  }
  for (int e = tid; e < n; e += nthreads) {
    s_mh[e] = mu_hi[e];
    s_ml[e] = mu_lo[e];
  }
  __syncthreads();

  int head = 0;  // the slot of ring row 0 (newest); row j is at slot (head + j) % order
  for (int k = 0; k < n_steps; ++k) {
    const int slot = head == 0 ? order - 1 : head - 1;  // the oldest row's slot
    for (int e = tid; e < m; e += nthreads) {
      const TF y = elm2f_point(cf, s_yh, s_yl, s_dh, s_dl, [&](int j) {
        const int s = head + j;
        return static_cast<size_t>(s < order ? s : s - order) * m + e;
      });
      s_yh[slot * m + e] = y.hi;
      s_yl[slot * m + e] = y.lo;
      emit_hi[static_cast<size_t>(k) * m + e] = y.hi;
      emit_lo[static_cast<size_t>(k) * m + e] = y.lo;
    }
    __syncthreads();

    const float* y_hi = s_yh + slot * m;
    const float* y_lo = s_yl + slot * m;
    for (int i = warp; i < n; i += warps) {
      TF pi[3];
      for (int c = 0; c < 3; ++c) pi[c] = TF{y_hi[c * n + i], y_lo[c * n + i]};
      TF v[kCols][3];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        if (lane < lanes) {
          gen_pair(y_hi, y_lo, s_mh, s_ml, pi, n, i, lane + 32 * q, v[q]);
        } else {
          for (int c = 0; c < 3; ++c) v[q][c] = TF{0.0f, 0.0f};
        }
      }
      // the halving tree: sources j and j + N/2 first, inside the lane ...
#pragma unroll
      for (int half = kCols / 2; half >= 1; half /= 2) {
#pragma unroll
        for (int q = 0; q < half; ++q) {
          for (int c = 0; c < 3; ++c) v[q][c] = add_sloppy(v[q][c], v[q + half][c]);
        }
      }
      // ... then across the lanes
      for (int off = lanes / 2; off >= 1; off /= 2) {
        for (int c = 0; c < 3; ++c) {
          const TF other{__shfl_down_sync(0xffffffffu, v[0][c].hi, off),
                         __shfl_down_sync(0xffffffffu, v[0][c].lo, off)};
          v[0][c] = add_sloppy(v[0][c], other);
        }
      }
      if (lane == 0) {
        for (int c = 0; c < 3; ++c) {
          s_dh[slot * m + c * n + i] = v[0][c].hi;
          s_dl[slot * m + c * n + i] = v[0][c].lo;
        }
      }
    }
    __syncthreads();
    head = slot;
  }

  for (int e = tid; e < ring; e += nthreads) {
    const int j = e / m, x = e - j * m;
    const int s = head + j < order ? head + j : head + j - order;
    oys_hi[e] = s_yh[s * m + x];
    oys_lo[e] = s_yl[s * m + x];
    odd_hi[e] = s_dh[s * m + x];
    odd_lo[e] = s_dl[s * m + x];
  }
}

template <int kCols>
int launch(const Elm2Coef& cf, const float* mu_hi, const float* mu_lo, const float* ys_hi,
           const float* ys_lo, const float* dd_hi, const float* dd_lo, float* emit_hi,
           float* emit_lo, float* oys_hi, float* oys_lo, float* odd_hi, float* odd_lo, int n,
           int n_steps, cudaStream_t stream) {
  const size_t smem = (4 * static_cast<size_t>(cf.order) * 3 * n + 2 * static_cast<size_t>(n)) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gen_scan<kCols>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 32 * (n < kMaxWarps ? n : kMaxWarps);
  gen_scan<kCols><<<1, threads, smem, stream>>>(cf, mu_hi, mu_lo, ys_hi, ys_lo, dd_hi, dd_lo,
                                                emit_hi, emit_lo, oys_hi, oys_lo, odd_hi,
                                                odd_lo, n, n_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// coef: host (order + 1, 2) f32 (hi, lo) rows; c_y: host (order,) f32;
// mu_*: (N,) f32; rings ys_*, dd_*: (order, 3N) f32, newest first,
// component-major; emit_*: (n_steps, 3N); o*: the rings after the chunk.  N a
// power of two <= 256 (else -1).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int eet_gen_scan(const float* coef, const float* c_y, int order, const float* mu_hi,
                 const float* mu_lo, const float* ys_hi, const float* ys_lo, const float* dd_hi,
                 const float* dd_lo, float* emit_hi, float* emit_lo, float* oys_hi,
                 float* oys_lo, float* odd_hi, float* odd_lo, int n, int n_steps,
                 cudaStream_t stream) {
  Elm2Coef cf;
  if (!eet::elm2_coef(coef, c_y, order, &cf)) return -1;
  if (n < 1 || n > kMaxPaddedN || (n & (n - 1)) != 0 || n_steps < 0) return -1;
  switch (n) {
    case 64:
      return launch<2>(cf, mu_hi, mu_lo, ys_hi, ys_lo, dd_hi, dd_lo, emit_hi, emit_lo, oys_hi,
                       oys_lo, odd_hi, odd_lo, n, n_steps, stream);
    case 128:
      return launch<4>(cf, mu_hi, mu_lo, ys_hi, ys_lo, dd_hi, dd_lo, emit_hi, emit_lo, oys_hi,
                       oys_lo, odd_hi, odd_lo, n, n_steps, stream);
    case 256:
      return launch<8>(cf, mu_hi, mu_lo, ys_hi, ys_lo, dd_hi, dd_lo, emit_hi, emit_lo, oys_hi,
                       oys_lo, odd_hi, odd_lo, n, n_steps, stream);
    default:
      return launch<1>(cf, mu_hi, mu_lo, ys_hi, ys_lo, dd_hi, dd_lo, emit_hi, emit_lo, oys_hi,
                       oys_lo, odd_hi, odd_lo, n, n_steps, stream);
  }
}

}  // extern "C"
