// Two-float ("df64") device arithmetic shared by the port's CUDA kernels.
//
// Device twins of ephemeris_explorer_tpu_torch/ops/eft.py, op for op and in
// the same order, so a kernel and its plain PyTorch version round the same
// way.  Every step is written with the round-to-nearest intrinsics
// (__fadd_rn, __fsub_rn, __fmul_rn), which the compiler never contracts into
// a fused multiply-add; the library is also built with --fmad=false and
// without fast math or flush-to-zero, because a single contraction or a
// flushed subnormal destroys the error-free transforms.

#pragma once

namespace eet {

struct TF {
  float hi, lo;
};

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }

// s + e == a + b exactly (Knuth).
__device__ __forceinline__ TF two_sum(float a, float b) {
  float s = fadd(a, b);
  float bb = fsub(s, a);
  float e = fadd(fsub(a, fsub(s, bb)), fsub(b, bb));
  return {s, e};
}

// s + e == a + b exactly, requires |a| >= |b|.
__device__ __forceinline__ TF quick_two_sum(float a, float b) {
  float s = fadd(a, b);
  float e = fsub(b, fsub(s, a));
  return {s, e};
}

// Dekker split: hi + lo == a, each half with <= 12 significant bits.
__device__ __forceinline__ TF split(float a) {
  float c = fmul(4097.0f, a);
  float hi = fsub(c, fsub(c, a));
  return {hi, fsub(a, hi)};
}

// p + e == a * b exactly, from both operands' splits.
__device__ __forceinline__ TF two_prod_presplit(float a, TF as, float b, TF bs) {
  float p = fmul(a, b);
  float e = fadd(fadd(fadd(fsub(fmul(as.hi, bs.hi), p), fmul(as.hi, bs.lo)),
                      fmul(as.lo, bs.hi)),
                 fmul(as.lo, bs.lo));
  return {p, e};
}

__device__ __forceinline__ TF two_prod(float a, float b) {
  return two_prod_presplit(a, split(a), b, split(b));
}

// p + e == a * a exactly.
__device__ __forceinline__ TF two_sqr(float a) {
  float p = fmul(a, a);
  TF s = split(a);
  float e = fadd(fadd(fsub(fmul(s.hi, s.hi), p), fmul(2.0f, fmul(s.hi, s.lo))),
                 fmul(s.lo, s.lo));
  return {p, e};
}

// Accurate two-float add (eft.add).
__device__ __forceinline__ TF add(TF x, TF y) {
  TF s = two_sum(x.hi, y.hi);
  TF t = two_sum(x.lo, y.lo);
  float e = fadd(s.lo, t.hi);
  TF u = quick_two_sum(s.hi, e);
  e = fadd(u.lo, t.lo);
  return quick_two_sum(u.hi, e);
}

__device__ __forceinline__ TF sub(TF x, TF y) { return add(x, TF{-y.hi, -y.lo}); }

// Cheaper two-float add (eft.add_sloppy): no cancellation allowed.
__device__ __forceinline__ TF add_sloppy(TF x, TF y) {
  TF s = two_sum(x.hi, y.hi);
  return quick_two_sum(s.hi, fadd(s.lo, fadd(x.lo, y.lo)));
}

__device__ __forceinline__ TF add_float(TF x, float b) {
  TF s = two_sum(x.hi, b);
  return quick_two_sum(s.hi, fadd(s.lo, x.lo));
}

__device__ __forceinline__ TF mul(TF x, TF y) {
  TF p = two_prod(x.hi, y.hi);
  float e = fadd(p.lo, fadd(fmul(x.hi, y.lo), fmul(x.lo, y.hi)));
  return quick_two_sum(p.hi, e);
}

__device__ __forceinline__ TF mul_float(TF x, float b) {
  TF p = two_prod(x.hi, b);
  return quick_two_sum(p.hi, fadd(p.lo, fmul(x.lo, b)));
}

__device__ __forceinline__ TF sqr(TF x) {
  TF p = two_sqr(x.hi);
  float e = fadd(p.lo, fmul(2.0f, fmul(x.hi, x.lo)));
  return quick_two_sum(p.hi, e);
}

// x * y with the splits of x.hi and y.hi supplied.
__device__ __forceinline__ TF mul_presplit(TF x, TF xs, TF y, TF ys) {
  TF p = two_prod_presplit(x.hi, xs, y.hi, ys);
  float e = fadd(p.lo, fadd(fmul(x.hi, y.lo), fmul(x.lo, y.hi)));
  return quick_two_sum(p.hi, e);
}

}  // namespace eet
