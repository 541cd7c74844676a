// Kernel 2: the two-float ELM2 position update.
//
// Replaces the TPU kernel ephemeris_explorer_tpu/ops/pallas_elm2.py
// `_update_kernel2` (reached through `elm2f_update`).  For each element of
// the flattened state (M = 3N) it computes
//
//     y_{n+1} = sum_j c_y[j] y_{n-j}  +  (sum_j c_dy[j] dd_{n-j}) * h^2/beta_d
//
// on (hi, lo) f32 rings, newest first, in the JAX kernel's exact order: the
// beta sum over the nonzero c_dy with accurate two-float adds (c_dy
// alternates in sign and cancels about 6x, so the sloppy add's precondition
// fails), then the product with the split h^2/beta_d, then the alpha sum over
// the nonzero c_y (exact scalings by +-1 and +-2) with accurate adds, and
// the final accurate add.  The same ops in the same order as the plain
// PyTorch version, with no contraction, make the two bitwise equal.
//
// What bounds it on an H100: memory traffic and launch latency.  One thread
// per element reads 4 rings x ORDER x 4 bytes (192 bytes at ORDER = 12) and
// writes 8, about 200 M bytes a step: 2.4 MB at N = 4096, under a
// microsecond at 3.35 TB/s, so the launch itself dominates.  The split
// coefficients travel by value as a kernel argument (constant bank), read
// uniformly by every thread.
//
// Triton would serve this pure elementwise pass as well.  CUDA C++ keeps the
// port on one build route, and one --fmad=false build (with the _rn
// intrinsics of twofloat.cuh) is simpler to guarantee than
// enable_fp_fusion=False on every Triton launch.

#include <cuda_runtime.h>

#include "twofloat.cuh"

namespace {

using eet::TF;

constexpr int kMaxOrder = 16;

struct Elm2Coef {
  float dy_hi[kMaxOrder + 1];  // split c_dy rows, then h^2/beta_d at [order]
  float dy_lo[kMaxOrder + 1];
  float cy[kMaxOrder];
  int order;
};

__global__ void elm2f_update_kernel(Elm2Coef cf, const float* __restrict__ ys_hi,
                                    const float* __restrict__ ys_lo,
                                    const float* __restrict__ dd_hi,
                                    const float* __restrict__ dd_lo,
                                    float* __restrict__ out_hi, float* __restrict__ out_lo,
                                    int m) {
  using namespace eet;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;

  TF acc{0.0f, 0.0f};
  bool first = true;
  for (int j = 0; j < cf.order; ++j) {
    if (cf.dy_hi[j] == 0.0f) continue;
    const size_t at = static_cast<size_t>(j) * m + e;
    TF term = mul(TF{dd_hi[at], dd_lo[at]}, TF{cf.dy_hi[j], cf.dy_lo[j]});
    acc = first ? term : add(acc, term);
    first = false;
  }
  TF inc = mul(acc, TF{cf.dy_hi[cf.order], cf.dy_lo[cf.order]});

  TF sum{0.0f, 0.0f};
  first = true;
  for (int j = 0; j < cf.order; ++j) {
    const float c = cf.cy[j];
    if (c == 0.0f) continue;
    const size_t at = static_cast<size_t>(j) * m + e;
    TF term{fmul(ys_hi[at], c), fmul(ys_lo[at], c)};
    sum = first ? term : add(sum, term);
    first = false;
  }
  TF y = add(sum, inc);
  out_hi[e] = y.hi;
  out_lo[e] = y.lo;
}

}  // namespace

extern "C" {

// coef: host (order + 1, 2) f32 (hi, lo) rows; c_y: host (order,) f32;
// rings: (order, M) f32 device; out: (M,).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched); -1 if order is out of range.
int eet_elm2f_update(const float* coef, const float* c_y, int order, const float* ys_hi,
                     const float* ys_lo, const float* dd_hi, const float* dd_lo,
                     float* out_hi, float* out_lo, int m, cudaStream_t stream) {
  if (order < 1 || order > kMaxOrder) return -1;
  Elm2Coef cf{};
  cf.order = order;
  for (int j = 0; j <= order; ++j) {
    cf.dy_hi[j] = coef[2 * j];
    cf.dy_lo[j] = coef[2 * j + 1];
  }
  for (int j = 0; j < order; ++j) cf.cy[j] = c_y[j];
  constexpr int kBlock = 256;
  elm2f_update_kernel<<<(m + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      cf, ys_hi, ys_lo, dd_hi, dd_lo, out_hi, out_lo, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
