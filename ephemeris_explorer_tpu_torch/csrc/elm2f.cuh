// The two-float ELM2 position update of one element, shared by kernel 2
// (elm2f_update.cu, rings in device memory) and kernel 11 (gen_scan.cu,
// rings in shared memory).  See elm2f_update.cu for the arithmetic.

#pragma once

#include "twofloat.cuh"

namespace eet {

constexpr int kMaxOrder = 16;

struct Elm2Coef {
  float dy_hi[kMaxOrder + 1];  // split c_dy rows, then h^2/beta_d at [order]
  float dy_lo[kMaxOrder + 1];
  float cy[kMaxOrder];
  int order;
};

// The coefficients from the host tables: coef (order + 1, 2) f32 (hi, lo)
// rows, c_y (order,) f32.  False if the order is out of range.
inline bool elm2_coef(const float* coef, const float* c_y, int order, Elm2Coef* cf) {
  if (order < 1 || order > kMaxOrder) return false;
  *cf = Elm2Coef{};
  cf->order = order;
  for (int j = 0; j <= order; ++j) {
    cf->dy_hi[j] = coef[2 * j];
    cf->dy_lo[j] = coef[2 * j + 1];
  }
  for (int j = 0; j < order; ++j) cf->cy[j] = c_y[j];
  return true;
}

// y_{n+1} at one element; ring row j (newest first) of that element is at
// offset at(j) of each ring.
template <class At>
__device__ __forceinline__ TF elm2f_point(const Elm2Coef& cf, const float* ys_hi,
                                          const float* ys_lo, const float* dd_hi,
                                          const float* dd_lo, At at) {
  TF acc{0.0f, 0.0f};
  bool first = true;
  for (int j = 0; j < cf.order; ++j) {
    if (cf.dy_hi[j] == 0.0f) continue;
    const size_t o = at(j);
    TF term = mul(TF{dd_hi[o], dd_lo[o]}, TF{cf.dy_hi[j], cf.dy_lo[j]});
    acc = first ? term : add(acc, term);
    first = false;
  }
  TF inc = mul(acc, TF{cf.dy_hi[cf.order], cf.dy_lo[cf.order]});

  TF sum{0.0f, 0.0f};
  first = true;
  for (int j = 0; j < cf.order; ++j) {
    const float c = cf.cy[j];
    if (c == 0.0f) continue;
    const size_t o = at(j);
    TF term{fmul(ys_hi[o], c), fmul(ys_lo[o], c)};
    sum = first ? term : add(sum, term);
    first = false;
  }
  return add(sum, inc);
}

}  // namespace eet
