// Kernel 14: the spacecraft fleet loop, one warp a ship.
//
// Corresponds to no Pallas kernel.  It replaces the JAX package's
// ephemeris_explorer_tpu/spacecraft.py:253 `propagate`, whose nested
// lax.while_loops (segments :324, attempts :364) run one ship as one XLA
// program, vmapped over a fleet at :715 (`_jitted_propagate_batch`).  The
// port's eager loop (spacecraft.py `propagate_batch_plain`, this kernel's
// plain version) launches ~1,000 small torch operations an iteration; here
// a launch advances every live ship by up to `budget` iterations of that
// loop, each ship on its own.  Ships are independent: the eager loop's
// lockstep is only its batching, so every ship sees the sequence of
// operations the eager loop gives it, and the two agree bitwise.
//
// One iteration of a ship that is not done (spacecraft.py
// `propagate_batch_plain`, `iteration`):
//
//   * its segment (clamped to the last), the bound min(segment end, end_t),
//     the burn, its frame and whether it burns;
//   * an advance's pre-checks (at the bound, t + next_h == t, n > n_max);
//   * otherwise one attempt of the tableau at h = min(h_try, bound - t):
//     the stages' states y + sum_j (h a_sj) k_j, skipping zero
//     coefficients, the RHS at t + h c_s (an FSAL tableau's stage 0 is the
//     cache, or a fresh evaluation at the ship's state where the cache is
//     stale), the new state and the embedded error, the AbsTol norm (each
//     error times the host's 1/tol) and the controller
//     (integrators/adaptive.py `control`: fac err^(-1/k) with the exponent
//     formed on the host, torch's NaN-propagating clamps);
//   * the commit, the knot append straight to device memory, the end
//     reasons, the segment change with its reset.
//
// The RHS at stage time ts and ship state (p, v): each body's segment
// (ephemeris.py `_segments`: ceil(local / interval) - 1 as int64, clamped)
// and tau, Horner on its (9, 3) coefficients (ops/polyfit.py `horner`, or
// `horner_and_deriv` with the velocity where the batch has body-relative
// burns: then the positions come from that form too), the point-mass
// gravity d = b - p, r^2 = (dx dx + dy dy) + dz dz, inv_r = rsqrt(r^2)
// (CUDA's f64 rsqrt, the function torch's CUDA rsqrt calls), w = mu
// (inv_r inv_r) inv_r, a = sum d w; then, where the batch burns, the burn:
// TNB about the frame body where the segment is body-relative (each norm
// the square root of a left-to-right sum, the cross products and the
// matrix product written out), else as given, added where the ship burns.
//
// Sum over bodies: lane l adds bodies l, l + 32, ... to 0.0 in turn (a lane
// past N adds nothing, so it holds an exact 0.0), then a halving tree adds
// lane l + off's partial to lane l's for off = 16, 8, 4, 2, 1, and lane 0's
// sum is broadcast: kernel 11-f64's order.  The plain version's
// `_lane_sum` repeats it.  Every add, subtract, multiply, divide and square
// root is a round-to-nearest intrinsic, which the compiler never contracts
// (the library is also built with --fmad=false); torch's eager CUDA
// kernels run one operation each, so they never contract either.
//
// What bounds it on an H100: latency.  A ship is one warp, and its attempt
// a serial chain of 6-16 stages, each a segment lookup, a 9-deep Horner
// chain, the gravity's rsqrt and divide-free chain, a 5-level shuffle tree
// and, with relative burns, three square roots and three divisions.  At 32
// bodies (full_solar_system) each lane holds one body; a fleet of B ships
// is B blocks on min(B, 132) SMs.  chip_smoke.py phase 43 measures ~2 us a
// stage on an H100 80GB HBM3 at 700 W (24-29 us an iteration at 13-16
// stages), 1-1.4% of the operations bound of the SMs it runs on.
//
// Design: one block of 32 threads a ship.  The tableau (stage times and
// coefficient tables, 592 doubles) is read into shared memory once a
// launch; the stage derivatives k_s (up to 16 x 6 doubles) live in shared
// memory, written by lane 0 and read by every lane after a __syncwarp;
// every other value of the ship's state is held in registers, the same on
// every lane (the scalar logic runs redundantly on all 32).  The stage loop
// is not unrolled, so the RHS is inlined once; its count is a template
// parameter (the stage counts of the port's adaptive tableaux: 6, 7, 9, 13,
// 16 for ERK, 7 for ERKNG).  The state and counters go back to device
// memory at the end of the launch (cuda_fleet.py's row layout), with the
// iterations the ship ran in it.  __launch_bounds__(32, 1) lets ptxas take
// the registers the attempt needs (178-184 for sm_90a, no spills; with the
// block size alone it kept 128 and spilled 16-28 bytes at 7 to 16 stages).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 32;
constexpr int kMaxStages = 16;
constexpr int kCoefs = 9;                  // ops/polyfit.py MAX_COEFFS
constexpr int kSegDoubles = kCoefs * 3;
// the tableau table (cuda_fleet.py `_table`): c, a (ERKNG: ap), av, b (bp),
// bv, e (ep), ev; the (16, 16) matrices row-major
constexpr int kTabC = 0;
constexpr int kTabA = kTabC + kMaxStages;
constexpr int kTabAV = kTabA + kMaxStages * kMaxStages;
constexpr int kTabB = kTabAV + kMaxStages * kMaxStages;
constexpr int kTabBV = kTabB + kMaxStages;
constexpr int kTabE = kTabBV + kMaxStages;
constexpr int kTabEV = kTabE + kMaxStages;
constexpr int kTabLen = kTabEV + kMaxStages;
// state rows (cuda_fleet.py F_*, I_*), each of n_ships values
constexpr int kFT = 0, kFY = 1, kFNextH = 7, kFHTry = 8, kFCache = 9;
constexpr int kISeg = 0, kICount = 1, kIReason = 2, kIN = 3, kIInAdv = 4, kIStale = 5,
              kIDone = 6, kIIters = 7;
// spacecraft.py DONE_*, FRAME_RELATIVE
constexpr long long kDoneEnd = 0, kDoneFull = 1, kDoneError = 2;
constexpr long long kRelative = 1;

struct Params {
  double h_init, h_max, fac, fac_min, fac_max, inv_tol_pos, inv_tol_vel, expo;
  long long n_max;
  int fsal, burns, frames;
};

struct Eph {
  const double* mus;
  const double* starts;
  const double* intervals;
  const long long* offsets;
  const long long* nsegs;
  const double* coeffs;
  int n;
};

struct Fleet {
  const double* ends;      // (B, S)
  const double* accels;    // (B, S, 3)
  const long long* kind;   // (B, S)
  const long long* body;   // (B, S)
  const double* end_t;     // (B,)
  int n_seg;
};

__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double ddiv(double a, double b) { return __ddiv_rn(a, b); }

// torch.minimum / torch.maximum: a NaN operand is the result
__device__ __forceinline__ double tmin(double a, double b) {
  return a != a ? a : (b != b ? b : fmin(a, b));
}
__device__ __forceinline__ double tmax(double a, double b) {
  return a != a ? a : (b != b ? b : fmax(a, b));
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = kLanes / 2; off >= 1; off /= 2) v = dadd(v, __shfl_xor_sync(0xffffffffu, v, off));
  return __shfl_sync(0xffffffffu, v, 0);
}

// v / |v|, |v| the square root of a left-to-right sum (spacecraft.py `_unit`)
__device__ __forceinline__ void unit3(double (&v)[3]) {
  const double n = __dsqrt_rn(dadd(dadd(dmul(v[0], v[0]), dmul(v[1], v[1])), dmul(v[2], v[2])));
  v[0] = ddiv(v[0], n);
  v[1] = ddiv(v[1], n);
  v[2] = ddiv(v[2], n);
}

// a x b (spacecraft.py `_cross`)
__device__ __forceinline__ void cross3(const double (&a)[3], const double (&b)[3],
                                       double (&c)[3]) {
  c[0] = dsub(dmul(a[1], b[2]), dmul(a[2], b[1]));
  c[1] = dsub(dmul(a[2], b[0]), dmul(a[0], b[2]));
  c[2] = dsub(dmul(a[0], b[1]), dmul(a[1], b[0]));
}

// The ship's acceleration at stage time ts and state (p, v), on every lane
// (spacecraft.py `_make_rhs`'s `total`).
__device__ __forceinline__ void rhs(const Eph& e, const Params& prm, double ts,
                                    const double (&p)[3], const double (&v)[3],
                                    const double (&burn)[3], bool relative, bool burning,
                                    long long fb, int lane, double (&acc)[3]) {
  double ax = 0.0, ay = 0.0, az = 0.0;
  double fp[3] = {0.0, 0.0, 0.0}, fv[3] = {0.0, 0.0, 0.0};
  for (int i = lane; i < e.n; i += kLanes) {
    const double iv = e.intervals[i];
    const double local = dsub(ts, e.starts[i]);
    long long idx = static_cast<long long>(ceil(ddiv(local, iv))) - 1;
    idx = idx < 0 ? 0 : idx;
    const long long last = e.nsegs[i] - 1;
    idx = idx < last ? idx : last;
    const double tau = ddiv(dsub(local, dmul(iv, static_cast<double>(idx))), iv);
    const double* c = e.coeffs + (e.offsets[i] + idx) * kSegDoubles;
    double b[3];
    if (prm.frames) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        double val = c[(kCoefs - 1) * 3 + k];
        double der = val;
#pragma unroll
        for (int d = kCoefs - 2; d >= 1; --d) {
          val = dadd(dmul(val, tau), c[d * 3 + k]);
          der = dadd(dmul(der, tau), val);
        }
        val = dadd(dmul(val, tau), c[k]);
        b[k] = val;
        if (i == fb) {
          fp[k] = val;
          fv[k] = ddiv(der, iv);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        double out = dmul(c[(kCoefs - 1) * 3 + k], 0.0);
#pragma unroll
        for (int d = kCoefs - 1; d >= 0; --d) out = dadd(dmul(out, tau), c[d * 3 + k]);
        b[k] = out;
      }
    }
    const double dx = dsub(b[0], p[0]), dy = dsub(b[1], p[1]), dz = dsub(b[2], p[2]);
    const double inv_r = rsqrt(dadd(dadd(dmul(dx, dx), dmul(dy, dy)), dmul(dz, dz)));
    const double w = dmul(e.mus[i], dmul(dmul(inv_r, inv_r), inv_r));
    ax = dadd(ax, dmul(dx, w));
    ay = dadd(ay, dmul(dy, w));
    az = dadd(az, dmul(dz, w));
  }
  acc[0] = warp_sum(ax);
  acc[1] = warp_sum(ay);
  acc[2] = warp_sum(az);
  if (!prm.burns) return;
  double man[3] = {burn[0], burn[1], burn[2]};
  if (prm.frames) {
    const int src = static_cast<int>(fb & (kLanes - 1));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      fp[k] = __shfl_sync(0xffffffffu, fp[k], src);
      fv[k] = __shfl_sync(0xffffffffu, fv[k], src);
    }
    if (relative) {
      double rp[3], x[3], y[3], z[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        rp[k] = dsub(p[k], fp[k]);
        x[k] = dsub(v[k], fv[k]);
      }
      cross3(rp, x, y);
      unit3(x);
      unit3(y);
      cross3(x, y, z);
      unit3(z);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        man[k] = dadd(dadd(dmul(x[k], burn[0]), dmul(z[k], burn[1])), dmul(y[k], burn[2]));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) acc[k] = dadd(acc[k], burning ? man[k] : 0.0);
}

template <int S, bool kNystrom>
__global__ void __launch_bounds__(kLanes, 1)
fleet_scan_kernel(Params prm, const double* __restrict__ tab, Eph e, Fleet fl,
                  double* __restrict__ fstate, long long* __restrict__ istate,
                  double* __restrict__ knots, int n_ships, int max_knots, int budget) {
  __shared__ double s_tab[kTabLen];
  __shared__ double ks[S][6];
  const int lane = threadIdx.x;
  const int ship = blockIdx.x;
  for (int i = lane; i < kTabLen; i += kLanes) s_tab[i] = tab[i];
  __syncwarp();
  const double* tc = s_tab + kTabC;
  const double* ta = s_tab + kTabA;
  const double* tav = s_tab + kTabAV;
  const double* tb = s_tab + kTabB;
  const double* tbv = s_tab + kTabBV;
  const double* te = s_tab + kTabE;
  const double* tev = s_tab + kTabEV;

  const size_t B = static_cast<size_t>(n_ships);
  double t = fstate[kFT * B + ship];
  double y[6], cache[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    y[c] = fstate[(kFY + c) * B + ship];
    cache[c] = fstate[(kFCache + c) * B + ship];
  }
  double next_h = fstate[kFNextH * B + ship];
  double h_try = fstate[kFHTry * B + ship];
  long long seg = istate[kISeg * B + ship];
  long long count = istate[kICount * B + ship];
  long long reason = istate[kIReason * B + ship];
  long long n = istate[kIN * B + ship];
  bool in_adv = istate[kIInAdv * B + ship] != 0;
  bool stale = istate[kIStale * B + ship] != 0;
  bool done = istate[kIDone * B + ship] != 0;
  const double end_t = fl.end_t[ship];
  double* kn = knots + static_cast<size_t>(ship) * (max_knots + 1) * 7;

  int it = 0;
  for (; it < budget && !done; ++it) {
    const long long sc = seg < fl.n_seg - 1 ? seg : fl.n_seg - 1;
    const size_t row = static_cast<size_t>(ship) * fl.n_seg + sc;
    const double bound = tmin(fl.ends[row], end_t);
    const double burn[3] = {fl.accels[row * 3], fl.accels[row * 3 + 1], fl.accels[row * 3 + 2]};
    const bool relative = fl.kind[row] == kRelative;
    const bool burning = burn[0] != 0.0 || burn[1] != 0.0 || burn[2] != 0.0;
    const long long fb = fl.body[row];

    const bool start = !in_adv;
    const bool pre_bound = start && t >= bound;
    const bool pre_under = start && !pre_bound && dadd(t, next_h) == t;
    const bool pre_stop = pre_bound || pre_under || (start && n > prm.n_max);
    if (start) h_try = next_h;
    bool ok = false, adv_end = pre_stop;
    double h = 0.0, y_new[6];
    if (!pre_stop) {
      h = tmin(h_try, dsub(bound, t));
      const double hh = dmul(h, h);
      __syncwarp();
      // the stages (integrators/fixed.py erk_step, erkng_step)
#pragma unroll 1
      for (int s = 0; s < S; ++s) {
        double pi[3], vi[3];
        if (s == 0 && prm.fsal) {
          if (!stale) {
            if (lane == 0) {
#pragma unroll
              for (int c = 0; c < 6; ++c) ks[0][c] = cache[c];
            }
            __syncwarp();
            continue;
          }
          // the fresh evaluation at the ship's state (stage 0's bodies)
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            pi[k] = y[k];
            vi[k] = y[3 + k];
          }
        } else if (!kNystrom) {
          double yi[6];
#pragma unroll
          for (int c = 0; c < 6; ++c) yi[c] = y[c];
          for (int j = 0; j < s; ++j) {
            const double a = ta[s * kMaxStages + j];
            if (a != 0.0) {
              const double cf = dmul(h, a);
#pragma unroll
              for (int c = 0; c < 6; ++c) yi[c] = dadd(yi[c], dmul(cf, ks[j][c]));
            }
          }
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            pi[k] = yi[k];
            vi[k] = yi[3 + k];
          }
        } else {
          const double cc = dmul(h, tc[s]);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            pi[k] = dadd(y[k], dmul(cc, y[3 + k]));
            vi[k] = y[3 + k];
          }
          for (int j = 0; j < s; ++j) {
            const double ap = ta[s * kMaxStages + j], av = tav[s * kMaxStages + j];
            if (ap != 0.0) {
              const double cf = dmul(hh, ap);
#pragma unroll
              for (int k = 0; k < 3; ++k) pi[k] = dadd(pi[k], dmul(cf, ks[j][k]));
            }
            if (av != 0.0) {
              const double cf = dmul(h, av);
#pragma unroll
              for (int k = 0; k < 3; ++k) vi[k] = dadd(vi[k], dmul(cf, ks[j][k]));
            }
          }
        }
        double acc[3];
        rhs(e, prm, dadd(t, dmul(h, tc[s])), pi, vi, burn, relative, burning, fb, lane, acc);
        double k6[6];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          k6[k] = kNystrom ? acc[k] : vi[k];
          k6[3 + k] = kNystrom ? 0.0 : acc[k];
        }
        if (s == 0 && prm.fsal) {
#pragma unroll
          for (int c = 0; c < 6; ++c) cache[c] = k6[c];
          stale = false;
        }
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < 6; ++c) ks[s][c] = k6[c];
        }
        __syncwarp();
      }

      // the new state and the embedded error
      double err[6];
      if (!kNystrom) {
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          double yn = y[c], ec = 0.0;
          bool first = true;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if (tb[s] != 0.0) yn = dadd(yn, dmul(dmul(h, tb[s]), ks[s][c]));
            if (te[s] != 0.0) {
              const double term = dmul(dmul(h, te[s]), ks[s][c]);
              ec = first ? term : dadd(ec, term);
              first = false;
            }
          }
          y_new[c] = yn;
          err[c] = ec;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          double yn = dadd(y[k], dmul(h, y[3 + k])), dyn = y[3 + k], ey = 0.0, edy = 0.0;
          bool first_y = true, first_dy = true;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if (tb[s] != 0.0) yn = dadd(yn, dmul(dmul(hh, tb[s]), ks[s][k]));
            if (tbv[s] != 0.0) dyn = dadd(dyn, dmul(dmul(h, tbv[s]), ks[s][k]));
            if (te[s] != 0.0) {
              const double term = dmul(dmul(hh, te[s]), ks[s][k]);
              ey = first_y ? term : dadd(ey, term);
              first_y = false;
            }
            if (tev[s] != 0.0) {
              const double term = dmul(dmul(h, tev[s]), ks[s][k]);
              edy = first_dy ? term : dadd(edy, term);
              first_dy = false;
            }
          }
          y_new[k] = yn;
          y_new[3 + k] = dyn;
          err[k] = ey;
          err[3 + k] = edy;
        }
      }

      // the AbsTol norm and the controller (integrators/adaptive.py control)
      double e_pos = fabs(dmul(err[0], prm.inv_tol_pos));
      double e_vel = fabs(dmul(err[3], prm.inv_tol_vel));
#pragma unroll
      for (int k = 1; k < 3; ++k) {
        e_pos = tmax(e_pos, fabs(dmul(err[k], prm.inv_tol_pos)));
        e_vel = tmax(e_vel, fabs(dmul(err[3 + k], prm.inv_tol_vel)));
      }
      const double en = tmax(e_pos, e_vel);
      bool finite = true;
#pragma unroll
      for (int c = 0; c < 6; ++c) finite = finite && isfinite(y_new[c]);
      const bool fail = !finite || isnan(en);
      const double m = dmul(prm.fac, pow(en, prm.expo));
      const double cl = isnan(m) ? m : fmin(fmax(m, prm.fac_min), prm.fac_max);
      double nh = dmul(h, cl);
      nh = isnan(nh) ? nh : fmin(nh, prm.h_max);
      const bool accepted = en <= 1.0;
      n += 1;
      h_try = nh;
      ok = accepted && !fail;
      adv_end = accepted || fail || n > prm.n_max;
    }
    in_adv = !pre_stop && !adv_end;

    // commit and append
    if (ok) {
      t = dadd(t, h);
#pragma unroll
      for (int c = 0; c < 6; ++c) y[c] = y_new[c];
      next_h = h_try;
      if (prm.fsal) {
#pragma unroll
        for (int c = 0; c < 6; ++c) cache[c] = ks[S - 1][c];
      }
      if (lane < 7 && count <= max_knots) kn[count * 7 + lane] = lane == 0 ? t : y[lane - 1];
      count += 1;
    }

    // end of the accepted-step loop, then of the segment loop
    const bool full = count >= max_knots;
    const bool stop = adv_end && (!ok || full || t >= bound);
    const long long seg_reason = full ? kDoneFull : ((ok || pre_bound) ? kDoneEnd : kDoneError);
    const bool finished = stop && (t >= end_t || seg_reason != kDoneEnd || full);
    if (finished) {
      reason = full ? kDoneFull : seg_reason;
      done = true;
    } else if (stop) {
      seg += 1;
      next_h = prm.h_init;
      n = 0;
      stale = true;
    }
  }

  if (lane == 0) {
    fstate[kFT * B + ship] = t;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      fstate[(kFY + c) * B + ship] = y[c];
      fstate[(kFCache + c) * B + ship] = cache[c];
    }
    fstate[kFNextH * B + ship] = next_h;
    fstate[kFHTry * B + ship] = h_try;
    istate[kISeg * B + ship] = seg;
    istate[kICount * B + ship] = count;
    istate[kIReason * B + ship] = reason;
    istate[kIN * B + ship] = n;
    istate[kIInAdv * B + ship] = in_adv;
    istate[kIStale * B + ship] = stale;
    istate[kIDone * B + ship] = done;
    istate[kIIters * B + ship] = it;
  }
}

template <int S, bool kNystrom>
int launch(const Params& prm, const double* tab, const Eph& e, const Fleet& fl, double* fstate,
           long long* istate, double* knots, int n_ships, int max_knots, int budget,
           cudaStream_t stream) {
  fleet_scan_kernel<S, kNystrom><<<n_ships, kLanes, 0, stream>>>(
      prm, tab, e, fl, fstate, istate, knots, n_ships, max_knots, budget);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// stages, nystrom: the tableau's (ERK: 6, 7, 9, 13, 16; ERKNG: 7; else -1);
// tab: device (kTabLen,) f64 table; prm: host (8,) f64 h_init, h_max, fac,
// fac_min, fac_max, 1/tol_pos, 1/tol_vel, -1/lower_order; the ephemeris
// (N bodies), the stacked timelines (B, S) and end_t (B,) on the device;
// fstate (15, B) f64, istate (8, B) int64 and knots (B, max_knots + 1, 7)
// f64 are read and advanced in place.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int eet_fleet_scan(int stages, int nystrom, const double* tab, const double* prm,
                   long long n_max, int fsal, int burns, int frames, const double* mus,
                   const double* starts, const double* intervals, const long long* offsets,
                   const long long* nsegs, const double* coeffs, int n_bodies,
                   const double* ends, const double* accels, const long long* kind,
                   const long long* body, int n_seg, const double* end_t, double* fstate,
                   long long* istate, double* knots, int n_ships, int max_knots, int budget,
                   cudaStream_t stream) {
  if (n_ships < 1 || n_seg < 1 || max_knots < 1 || budget < 1 || n_bodies < 0) return -1;
  Params p{prm[0], prm[1], prm[2], prm[3], prm[4], prm[5], prm[6], prm[7], n_max, fsal, burns,
           frames};
  const Eph e{mus, starts, intervals, offsets, nsegs, coeffs, n_bodies};
  const Fleet fl{ends, accels, kind, body, end_t, n_seg};
  if (nystrom) {
    if (stages == 7) return launch<7, true>(p, tab, e, fl, fstate, istate, knots, n_ships,
                                            max_knots, budget, stream);
    return -1;
  }
  switch (stages) {
    case 6:
      return launch<6, false>(p, tab, e, fl, fstate, istate, knots, n_ships, max_knots, budget,
                              stream);
    case 7:
      return launch<7, false>(p, tab, e, fl, fstate, istate, knots, n_ships, max_knots, budget,
                              stream);
    case 9:
      return launch<9, false>(p, tab, e, fl, fstate, istate, knots, n_ships, max_knots, budget,
                              stream);
    case 13:
      return launch<13, false>(p, tab, e, fl, fstate, istate, knots, n_ships, max_knots, budget,
                               stream);
    case 16:
      return launch<16, false>(p, tab, e, fl, fstate, istate, knots, n_ships, max_knots, budget,
                               stream);
    default:
      return -1;
  }
}

}  // extern "C"
