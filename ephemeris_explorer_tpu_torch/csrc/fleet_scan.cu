// Kernel 14: the spacecraft fleet loop, one block a ship.
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
//     the bodies at every stage time t + h c_s (spacecraft.py
//     `_stage_bodies`), the stages' states y + sum_j (h a_sj) k_j, skipping
//     zero coefficients, the RHS (an FSAL tableau's stage 0 is the cache, or
//     a fresh evaluation at the ship's state, on stage 0's bodies, where the
//     cache is stale), the new state and the embedded error, the AbsTol norm
//     (each error times the host's 1/tol) and the controller
//     (integrators/adaptive.py `control`: fac err^(-1/k) with the exponent
//     formed on the host, torch's NaN-propagating clamps);
//   * the commit, the knot append straight to device memory, the end
//     reasons, the segment change with its reset.
//
// The bodies at stage time ts: each body's segment (ephemeris.py
// `_segments`: ceil(local / interval) - 1 as int64, clamped) and tau, Horner
// on its (9, 3) coefficients (ops/polyfit.py `horner`, or `horner_and_deriv`
// with the velocity where the batch has body-relative burns: then the
// positions come from that form too).  The RHS at (p, v): the point-mass
// gravity d = b - p, r^2 = (dx dx + dy dy) + dz dz, inv_r = rsqrt(r^2)
// (CUDA's f64 rsqrt, the function torch's CUDA rsqrt calls), w = mu (inv_r
// inv_r) inv_r, a = sum d w; then, where the batch burns, the burn: TNB about
// the frame body where the segment is body-relative (each norm the square
// root of a left-to-right sum, the cross products and the matrix product
// written out), else as given, added where the ship burns.
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
// What bounds it on an H100: latency.  An attempt is a serial chain of 6-16
// stages, each waiting on the one before; a ship's chain runs on one warp,
// and a fleet of B ships on min(B, 132) SMs.  The first design (one warp a
// ship) ran each stage's ephemeris evaluation (two divisions, a dependent
// load, a 9-deep Horner chain) inside the chain and took ~2 us a stage
// (chip_smoke.py phase 43, H100 80GB HBM3 at 700 W).
//
// Design: one block of W = 8 warps a ship, so that fleet64 is one block an
// SM.  A fleet past the card's 132 SMs runs in waves; no path flies one (the
// largest is fleet64).  1, 2 and 4 warps measured slower at B = 1 and 64
// on the same card (PERF.md, kernel 14).
//
//   * The bodies leave the chain.  As soon as an attempt's h is known, warp
//     0 (the lead) posts (t, h) and the block evaluates the bodies at all
//     its stage times at once, S x N independent chains spread over the W x
//     32 threads (two rounds, ~2.6 us, at 13 stages and 32 bodies), into
//     shared memory: positions [3][S][N], the frame body's state [S][6].
//     Two barriers an attempt (named barrier 1: post, then done).  Where
//     [3][S][N] does not fit the 227 KB a block may opt into (S N > ~9,400
//     positions: ~590 bodies at 16 stages), the same protocol evaluates the
//     stages in windows of G stages, and past one stage a window, in chunks
//     of bodies (multiples of 32, so every lane keeps its bodies' order).
//   * Each thread keeps its body's tables (start, interval, nsegs - 1,
//     offset; the lead lane's mu) in registers for the launch, and the
//     ship's timeline row until its segment changes; the ephemeris pointers
//     are read through the read-only path (__ldg).
//   * The lead warp runs the chain, every lane the scalar logic, but a
//     stage's state sum, the attempt's new state and its error run one
//     component a lane (lanes 0-5), then a shuffle gives every lane the six;
//     the TNB frame normalises x on lanes 0-2 and y on 3-5 at once, then z,
//     and is issued between the levels of the lane-sum trees so that its
//     square roots and divisions overlap the shuffles.
//   * The tableau is a template parameter: one instance for each adaptive
//     tableau of fleet_tableaux.cuh, its coefficients and zero pattern
//     compile-time constants.  Each lane keeps its own component of every
//     k_s in registers (ERK: component lane % 6; ERKNG: lane % 3, the
//     stage's acceleration), so a stage's state, the new state and the
//     error are straight-line chains of the nonzero coefficients' terms
//     over registers: no coefficient is loaded, no zero tested, and no k_s
//     goes through shared memory.  Stage s + 1's state is formed as stage s
//     ends: once the lane sums' broadcast is issued, a balanced tree of
//     (warp-uniform) branches on s + 1 leads to that stage's row, which sums
//     the terms of k_0..k_{s-1} while the shuffles are in flight; once k_s
//     is known, its own multiply and add remain.  The stage loop stays
//     rolled, with the RHS inlined once.  There is no kernel for a tableau
//     that no instance matches (ops/cuda_fleet.py `plan` refuses it).
//
// Other designs measured slower on the same card by
// tools/fleet_scan_timeline.py, which stamps clock64 at the parts of an
// iteration (tools/fleet_scan_clocks.patch, applied to a copy of this file;
// an edit here that the patch's context no longer matches needs the patch
// made again; Verner87 with TNB burns on full_solar_system, H100 80GB
// HBM3 at 700 W): helpers that evaluate stage
// by stage while the lead runs, each stage's readiness a shared-memory
// count behind a block fence; the stages' states, the new state and the
// error summed term by term as each stage ends; the evaluation out of line
// (__noinline__).  With the tableau compiled in: each stage's whole state
// summed at its start (26,843 cycles an iteration against 26,085), the
// branch tree a switch (27,157 against 26,843), and the stage loop unrolled
// (DormandPrince54 16,177 against 14,338: the RHS and the windows'
// evaluation copied into every stage).
//
// The state and counters go back to device memory at the end of the launch
// (cuda_fleet.py's row layout), with the iterations the ship ran in it.
// __launch_bounds__(256, 1) leaves ptxas up to 255 registers a thread
// (phase 43 checks that it spills none).

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <type_traits>

#include "fleet_tableaux.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kLanes * kWarps;
constexpr int kCoefs = 9;                  // ops/polyfit.py MAX_COEFFS
constexpr int kSegDoubles = kCoefs * 3;
// state rows (cuda_fleet.py F_*, I_*), each of n_ships values
constexpr int kFT = 0, kFY = 1, kFNextH = 7, kFHTry = 8, kFCache = 9;
constexpr int kISeg = 0, kICount = 1, kIReason = 2, kIN = 3, kIInAdv = 4, kIStale = 5,
              kIDone = 6, kIIters = 7;
// spacecraft.py DONE_*, FRAME_RELATIVE
constexpr long long kDoneEnd = 0, kDoneFull = 1, kDoneError = 2;
constexpr long long kRelative = 1;
// shared memory a body position takes in a window
constexpr int kSlotBytes = 3 * sizeof(double);
// devices whose window size is kept (window_slots)
constexpr int kMaxDevices = 64;

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

// a window of the bodies' evaluation: stages [s0, s1) and bodies [c0, c1)
// at (t, h), or the end of the launch
struct Window {
  double t, h;
  long long fb;
  int s0, s1, c0, c1, stop;
};

// a thread's body tables, read once a launch
struct Tables {
  double start, interval;
  long long last, offset;
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

__device__ __forceinline__ double shfl(double v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}

// one level of the three halving trees
__device__ __forceinline__ void tree_level(double& ax, double& ay, double& az, int off) {
  ax = dadd(ax, __shfl_xor_sync(0xffffffffu, ax, off));
  ay = dadd(ay, __shfl_xor_sync(0xffffffffu, ay, off));
  az = dadd(az, __shfl_xor_sync(0xffffffffu, az, off));
}

// v[k] with k a runtime index, without local memory
__device__ __forceinline__ double pick(const double (&v)[6], int k) {
  double r = v[0];
#pragma unroll
  for (int c = 1; c < 6; ++c) r = k == c ? v[c] : r;
  return r;
}

// a x b (spacecraft.py `_cross`)
__device__ __forceinline__ void cross3(const double (&a)[3], const double (&b)[3],
                                       double (&c)[3]) {
  c[0] = dsub(dmul(a[1], b[2]), dmul(a[2], b[1]));
  c[1] = dsub(dmul(a[2], b[0]), dmul(a[0], b[2]));
  c[2] = dsub(dmul(a[0], b[1]), dmul(a[1], b[0]));
}

// the square root of a left-to-right sum of squares (spacecraft.py `_unit`)
__device__ __forceinline__ double norm3(double a, double b, double c) {
  return __dsqrt_rn(dadd(dadd(dmul(a, a), dmul(b, b)), dmul(c, c)));
}

// A compile-time tableau's coefficients, read in constant expressions alone
// (the elements of a host constexpr array reach device code only through a
// constexpr function): c, a (ERKNG: ap), av, b (bp), bv, e (ep), ev.
template <class T>
__host__ __device__ constexpr double c_of(int s) { return T::kC[s]; }
template <class T, bool kV>
__host__ __device__ constexpr double a_of(int s, int j) {
  if constexpr (kV) return T::kAV[s][j]; else return T::kA[s][j];
}
template <class T, bool kV>
__host__ __device__ constexpr double b_of(int s) {
  if constexpr (kV) return T::kBV[s]; else return T::kB[s];
}
template <class T, bool kV>
__host__ __device__ constexpr double e_of(int s) {
  if constexpr (kV) return T::kEV[s]; else return T::kE[s];
}
// the first stage with a nonzero error coefficient (kStages if none)
template <class T, bool kV>
__host__ __device__ constexpr int first_e() {
  for (int s = 0; s < T::kStages; ++s)
    if (e_of<T, kV>(s) != 0.0) return s;
  return T::kStages;
}

// f(std::integral_constant<int, I>{}) for I = I0, ..., N - 1 in turn
template <int I0, int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I0 < N) {
    f(std::integral_constant<int, I0>{});
    static_for<I0 + 1, N>(f);
  }
}

// acc + sum_j (m x_Rj) k_j over the nonzero x_Rj, j < J, in order (x the
// tableau's a, or av where kV): the first J terms of stage R's state
template <class T, bool kV, int R, int J>
__device__ __forceinline__ double row_sum(double acc, double m, const double (&kr)[T::kStages]) {
  static_for<0, J>([&](auto jc) {
    constexpr double x = a_of<T, kV>(R, decltype(jc)::value);
    if constexpr (x != 0.0) acc = dadd(acc, dmul(dmul(m, x), kr[decltype(jc)::value]));
  });
  return acc;
}

// Stage 0's state, this lane's component: ERK y_c; ERKNG positions y_c +
// (h c_0) v_c, velocities v_c (an FSAL tableau's fresh stage 0 is y_c)
template <class T>
__device__ __forceinline__ double state0(double yc, double yv, double h, bool pos_lane) {
  if constexpr (!T::kNystrom) {
    return yc;
  } else {
    constexpr double c = c_of<T>(0);
    return pos_lane ? dadd(yc, dmul(dmul(h, c), yv)) : yv;
  }
}

// Stage R's state but for its last term, while k_{R-1} is still being
// formed: `acc` the sum of the nonzero terms of k_0..k_{R-2} onto the row's
// start (ERK y_c; ERKNG positions y_c + (h c_R) v_c with h^2 ap, velocities
// v_c with h av), `m` the last term's multiplier (h a_{R,R-1}; ERKNG h^2
// ap or h av) and `last` whether that coefficient is nonzero.
struct Partial {
  double acc, m;
  bool last;
};

// k_{R-2} (kc) goes into kr[R - 2], then stage R's Partial for a
// compile-time tableau; R = kStages only stores.
template <class T, int R>
__device__ __forceinline__ Partial partial_state(double (&kr)[T::kStages], double kc, double yc,
                                                 double yv, double h, double hh, bool pos_lane) {
  if constexpr (R >= 2) kr[R - 2] = kc;
  if constexpr (R == T::kStages) {
    return {0.0, 0.0, false};
  } else if constexpr (!T::kNystrom) {
    constexpr double a = a_of<T, false>(R, R - 1);
    return {row_sum<T, false, R, R - 1>(yc, h, kr), dmul(h, a), a != 0.0};
  } else {
    constexpr double c = c_of<T>(R), ap = a_of<T, false>(R, R - 1), av = a_of<T, true>(R, R - 1);
    const double p = row_sum<T, false, R, R - 1>(dadd(yc, dmul(dmul(h, c), yv)), hh, kr);
    const double v = row_sum<T, true, R, R - 1>(yv, h, kr);
    return {pos_lane ? p : v, pos_lane ? dmul(hh, ap) : dmul(h, av),
            pos_lane ? ap != 0.0 : av != 0.0};
  }
}

// partial_state for the stage r in [R0, R1) that r names: a balanced tree
// of (warp-uniform) branches
template <class T, int R0, int R1>
__device__ __forceinline__ Partial partial_state_at(int r, double (&kr)[T::kStages], double kc,
                                                    double yc, double yv, double h, double hh,
                                                    bool pos_lane) {
  if constexpr (R1 - R0 == 1) {
    return partial_state<T, R0>(kr, kc, yc, yv, h, hh, pos_lane);
  } else {
    constexpr int mid = (R0 + R1) / 2;
    if (r < mid) return partial_state_at<T, R0, mid>(r, kr, kc, yc, yv, h, hh, pos_lane);
    return partial_state_at<T, mid, R1>(r, kr, kc, yc, yv, h, hh, pos_lane);
  }
}

// the state that a Partial leaves once k_{R-1} (kc) is known
__device__ __forceinline__ double finish_state(const Partial& p, double kc) {
  return p.last ? dadd(p.acc, dmul(p.m, kc)) : p.acc;
}

// The new state and the embedded error, this lane's component, for a
// compile-time tableau: y + sum_s (m b_s) k_s over the nonzero b_s, and the
// sum of the nonzero (m e_s) k_s from the first (0.0 where none); b, e the
// tableau's (bv, ev where kV).
template <class T, bool kV>
__device__ __forceinline__ void new_state(double& yn, double& ec, double m,
                                          const double (&kr)[T::kStages]) {
  constexpr int first = first_e<T, kV>();
  ec = 0.0;
  static_for<0, T::kStages>([&](auto sc) {
    constexpr int s = decltype(sc)::value;
    constexpr double b = b_of<T, kV>(s), e = e_of<T, kV>(s);
    if constexpr (b != 0.0) yn = dadd(yn, dmul(dmul(m, b), kr[s]));
    if constexpr (e != 0.0) {
      const double term = dmul(dmul(m, e), kr[s]);
      if constexpr (s == first) ec = term; else ec = dadd(ec, term);
    }
  });
}

__device__ __forceinline__ void bar_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// One body at stage time ts: its position into out[0], out[stride],
// out[2 stride], and where it is the frame body its (position, velocity)
// into fs.
__device__ __forceinline__ void eval_body(const double* __restrict__ coeffs, double ts,
                                          const Tables& tb, bool frames, bool is_fb,
                                          double* out, int stride, double* fs) {
  const double iv = tb.interval;
  const double local = dsub(ts, tb.start);
  long long idx = static_cast<long long>(ceil(ddiv(local, iv))) - 1;
  idx = idx < 0 ? 0 : idx;
  idx = idx < tb.last ? idx : tb.last;
  const double tau = ddiv(dsub(local, dmul(iv, static_cast<double>(idx))), iv);
  const double* c = coeffs + (tb.offset + idx) * kSegDoubles;
  if (frames) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      double val = __ldg(c + (kCoefs - 1) * 3 + k);
      double der = val;
#pragma unroll
      for (int d = kCoefs - 2; d >= 1; --d) {
        val = dadd(dmul(val, tau), __ldg(c + d * 3 + k));
        der = dadd(dmul(der, tau), val);
      }
      val = dadd(dmul(val, tau), __ldg(c + k));
      out[k * stride] = val;
      if (is_fb) {
        fs[k] = val;
        fs[3 + k] = ddiv(der, iv);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      double val = dmul(__ldg(c + (kCoefs - 1) * 3 + k), 0.0);
#pragma unroll
      for (int d = kCoefs - 1; d >= 0; --d) val = dadd(dmul(val, tau), __ldg(c + d * 3 + k));
      out[k * stride] = val;
    }
  }
}

__device__ __forceinline__ Tables tables_of(const Eph& e, int i) {
  return Tables{__ldg(e.starts + i), __ldg(e.intervals + i), __ldg(e.nsegs + i) - 1,
                __ldg(e.offsets + i)};
}

// A window's evaluation, every thread of the block its share: for N <= 32,
// lane l takes body l % N (32 / N copies of each body a warp, each its own
// stages); above, lane l takes bodies l, l + 32, ... of the window.  Slot
// (k, s, i) is sb[(k G + s - s0) C + i - c0].
__device__ void eval_window(const Eph& e, const double* tc, const Window& w, bool frames,
                            const Tables& mine, double* sb, int G, int C, double (*fs)[6],
                            int warp, int lane) {
  const int n = e.n;
  const int stride = G * C;
  if (n <= kLanes) {
    const int copies = kLanes / n;
    if (lane >= copies * n) return;
    const int i = lane % n;
    for (int s = w.s0 + warp * copies + lane / n; s < w.s1; s += kWarps * copies) {
      const double ts = dadd(w.t, dmul(w.h, tc[s]));
      eval_body(e.coeffs, ts, mine, frames, i == w.fb, sb + (s - w.s0) * C + i, stride, fs[s]);
    }
    return;
  }
  for (int s = w.s0 + warp; s < w.s1; s += kWarps) {
    const double ts = dadd(w.t, dmul(w.h, tc[s]));
    for (int i = w.c0 + lane; i < w.c1; i += kLanes) {
      eval_body(e.coeffs, ts, i == lane ? mine : tables_of(e, i), frames, i == w.fb,
                sb + (s - w.s0) * C + (i - w.c0), stride, fs[s]);
    }
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads, 1)
fleet_scan_kernel(Params prm, Eph e, Fleet fl, double* __restrict__ fstate,
                  long long* __restrict__ istate, double* __restrict__ knots, int n_ships,
                  int max_knots, int budget, int G, int C) {
  constexpr bool kNystrom = T::kNystrom;
  constexpr int kS = T::kStages;
  extern __shared__ double sb[];           // [3][G][C] body positions
  __shared__ double tc[kS];                // the tableau's c (the stage times)
  __shared__ double fs[kS][6];             // the frame body's (position, velocity)
  __shared__ Window cmd;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int ship = blockIdx.x;
  const int n = e.n;
  if (threadIdx.x == 0) {
    static_for<0, kS>([&](auto sc) {
      constexpr double c = c_of<T>(decltype(sc)::value);
      tc[decltype(sc)::value] = c;
    });
  }
  // this thread's body in the evaluation (and the lead lane's in the sums)
  const int body = n <= kLanes ? (n > 0 ? lane % n : 0) : lane;
  const Tables mine = n > 0 ? tables_of(e, body) : Tables{0.0, 1.0, 0, 0};
  const double mu_lane = lane < n ? __ldg(e.mus + lane) : 0.0;
  __syncthreads();
  const bool frames = prm.frames != 0;

  if (warp != 0) {  // the helpers: evaluate each window the lead posts
    for (;;) {
      bar_sync(kThreads);
      const Window w = cmd;
      if (w.stop) return;
      eval_window(e, tc, w, frames, mine, sb, G, C, fs, warp, lane);
      bar_sync(kThreads);
    }
  }

  const size_t B = static_cast<size_t>(n_ships);
  double t = fstate[kFT * B + ship];
  double y[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) y[c] = fstate[(kFY + c) * B + ship];
  double next_h = fstate[kFNextH * B + ship];
  double h_try = fstate[kFHTry * B + ship];
  long long seg = istate[kISeg * B + ship];
  long long count = istate[kICount * B + ship];
  long long reason = istate[kIReason * B + ship];
  long long n_att = istate[kIN * B + ship];
  bool in_adv = istate[kIInAdv * B + ship] != 0;
  bool stale = istate[kIStale * B + ship] != 0;
  bool done = istate[kIDone * B + ship] != 0;
  const double end_t = fl.end_t[ship];
  double* kn = knots + static_cast<size_t>(ship) * (max_knots + 1) * 7;

  // the lane's component in the one-component-a-lane sums: ERK y[c]; ERKNG
  // lanes 0-2 a position y[k3] (its velocity y[3 + k3] beside it), 3-5 a
  // velocity
  const int c6 = lane % 6;
  const int k3 = c6 % 3;
  const bool pos_lane = c6 < 3;
  double yc = pick(y, c6), yv = pick(y, 3 + k3);
  // k_j, this lane's component (ERK k_j[c6], ERKNG k_j[k3]): the newest in
  // kc until stage j + 2's Partial moves it into kr[j]; the FSAL cache, this
  // lane's component too
  const int own = kNystrom ? k3 : c6;
  double kr[kS], kc = 0.0, cache_own = fstate[(kFCache + own) * B + ship];

  // the ship's timeline row, read again when its segment changes
  long long row_sc = -1, fb = 0;
  double row_end = 0.0, burn[3] = {0.0, 0.0, 0.0};
  bool relative = false, burning = false;

  // post a window, evaluate the lead warp's share, wait for the block
  auto window = [&](double h, int s0, int s1, int c0, int c1) {
    const Window w{t, h, fb, s0, s1, c0, c1, 0};
    if (lane == 0) cmd = w;
    bar_sync(kThreads);
    eval_window(e, tc, w, frames, mine, sb, G, C, fs, 0, lane);
    bar_sync(kThreads);
  };

  int it = 0;
  for (; it < budget && !done; ++it) {
    const long long sc = seg < fl.n_seg - 1 ? seg : fl.n_seg - 1;
    if (sc != row_sc) {
      const size_t row = static_cast<size_t>(ship) * fl.n_seg + sc;
      row_sc = sc;
      row_end = fl.ends[row];
#pragma unroll
      for (int k = 0; k < 3; ++k) burn[k] = fl.accels[row * 3 + k];
      relative = fl.kind[row] == kRelative;
      burning = burn[0] != 0.0 || burn[1] != 0.0 || burn[2] != 0.0;
      fb = fl.body[row];
    }
    const double bound = tmin(row_end, end_t);

    const bool start = !in_adv;
    const bool pre_bound = start && t >= bound;
    const bool pre_under = start && !pre_bound && dadd(t, next_h) == t;
    const bool pre_stop = pre_bound || pre_under || (start && n_att > prm.n_max);
    if (start) h_try = next_h;
    bool ok = false, adv_end = pre_stop;
    double h = 0.0, y_new[6];
    if (!pre_stop) {
      h = tmin(h_try, dsub(bound, t));
      const double hh = dmul(h, h);
      // no shared memory is handed over here: the reconvergence point alone
      // makes the Verner87 iteration 26,251 cycles instead of 26,704
      // (tools/fleet_scan_timeline.py, H100 80GB HBM3 at 700 W)
      __syncwarp();
      const bool cached = prm.fsal && !stale;
      int s0 = -1;  // the window's first stage (whole windows)
      // the next stage's state, formed as each stage ends (stage 0's here)
      double next = prm.fsal ? yc : state0<T>(yc, yv, h, pos_lane);
      // the stages (integrators/fixed.py erk_step, erkng_step)
#pragma unroll 1
      for (int s = 0; s < kS; ++s) {
        if (s == 0 && cached) {
          kc = cache_own;
          next = finish_state(partial_state_at<T, 1, kS + 1>(1, kr, kc, yc, yv, h, hh, pos_lane),
                              kc);
          continue;
        }
        if (n > 0 && C == n && (s0 < 0 || s == s0 + G)) {
          s0 = s;
          window(h, s, s + G < kS ? s + G : kS, 0, n);
        }
        // the stage's state, one component a lane (an FSAL tableau's fresh
        // evaluation: y itself, through the same shuffles)
        double pi[3], vi[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          pi[k] = shfl(next, k);
          vi[k] = shfl(next, 3 + k);
        }

        // the gravity: lane l's bodies, window by window
        double ax = 0.0, ay = 0.0, az = 0.0;
        for (int c0 = 0; c0 < n; c0 += C) {
          const int c1 = c0 + C < n ? c0 + C : n;
          if (C < n) {
            s0 = s;
            window(h, s, s + 1, c0, c1);
          }
          const double* bs = sb + (s - s0) * C - c0;
          for (int i = c0 + lane; i < c1; i += kLanes) {
            const double dx = dsub(bs[i], pi[0]);
            const double dy = dsub(bs[G * C + i], pi[1]);
            const double dz = dsub(bs[2 * G * C + i], pi[2]);
            const double mu = i < kLanes ? mu_lane : __ldg(e.mus + i);
            const double inv_r = rsqrt(dadd(dadd(dmul(dx, dx), dmul(dy, dy)), dmul(dz, dz)));
            const double w = dmul(mu, dmul(dmul(inv_r, inv_r), inv_r));
            ax = dadd(ax, dmul(dx, w));
            ay = dadd(ay, dmul(dy, w));
            az = dadd(az, dmul(dz, w));
          }
        }

        // the lane sums, with the TNB frame between their levels where the
        // ship burns about a body (spacecraft.py tnb_to_inertial)
        double man[3] = {burn[0], burn[1], burn[2]};
        if (frames && relative && burning) {
          const double* f = fs[s];
          double rp[3], x[3], yy[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            rp[k] = dsub(pi[k], f[k]);
            x[k] = dsub(vi[k], f[3 + k]);
          }
          cross3(rp, x, yy);
          tree_level(ax, ay, az, 16);
          // x on lanes 0-2, y on 3-5, a component a lane
          const double u0 = pos_lane ? x[0] : yy[0];
          const double u1 = pos_lane ? x[1] : yy[1];
          const double u2 = pos_lane ? x[2] : yy[2];
          const double nu = norm3(u0, u1, u2);
          tree_level(ax, ay, az, 8);
          const double q = ddiv(k3 == 0 ? u0 : (k3 == 1 ? u1 : u2), nu);
          tree_level(ax, ay, az, 4);
          double X[3], Y[3], Z[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            X[k] = shfl(q, k);
            Y[k] = shfl(q, 3 + k);
          }
          cross3(X, Y, Z);
          tree_level(ax, ay, az, 2);
          const double nz = norm3(Z[0], Z[1], Z[2]);
          tree_level(ax, ay, az, 1);
          const double zq = ddiv(k3 == 0 ? Z[0] : (k3 == 1 ? Z[1] : Z[2]), nz);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const double zk = shfl(zq, k);
            man[k] = dadd(dadd(dmul(X[k], burn[0]), dmul(zk, burn[1])), dmul(Y[k], burn[2]));
          }
        } else {
#pragma unroll
          for (int off = kLanes / 2; off >= 1; off /= 2) tree_level(ax, ay, az, off);
        }
        double acc3[3] = {shfl(ax, 0), shfl(ay, 0), shfl(az, 0)};
        // the next stage's state but for k_s's term, while the shuffles are
        // in flight (k_{s-1} into kr[s - 1])
        const Partial nx =
            partial_state_at<T, 1, kS + 1>(s + 1, kr, kc, yc, yv, h, hh, pos_lane);
        if (prm.burns) {
#pragma unroll
          for (int k = 0; k < 3; ++k) acc3[k] = dadd(acc3[k], burning ? man[k] : 0.0);
        }
        double k6[6];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          k6[k] = kNystrom ? acc3[k] : vi[k];
          k6[3 + k] = kNystrom ? 0.0 : acc3[k];
        }
        kc = pick(k6, own);
        next = finish_state(nx, kc);
      }

      // the new state and the embedded error, one component a lane
      double yn, ec = 0.0;
      kr[kS - 1] = kc;
      if (prm.fsal && !cached) {  // stage 0 was the fresh evaluation
        cache_own = kr[0];
        stale = false;
      }
      if constexpr (!kNystrom) {
        yn = yc;
        new_state<T, false>(yn, ec, h, kr);
      } else {
        double pn = dadd(yc, dmul(h, yv)), pe, vn = yv, ve;
        new_state<T, false>(pn, pe, hh, kr);
        new_state<T, true>(vn, ve, h, kr);
        yn = pos_lane ? pn : vn;
        ec = pos_lane ? pe : ve;
      }
      double err[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        y_new[c] = shfl(yn, c);
        err[c] = shfl(ec, c);
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
      n_att += 1;
      h_try = nh;
      ok = accepted && !fail;
      adv_end = accepted || fail || n_att > prm.n_max;
    }
    in_adv = !pre_stop && !adv_end;

    // commit and append
    if (ok) {
      t = dadd(t, h);
#pragma unroll
      for (int c = 0; c < 6; ++c) y[c] = y_new[c];
      yc = pick(y, c6);
      yv = pick(y, 3 + k3);
      next_h = h_try;
      if (prm.fsal) cache_own = kr[kS - 1];
      if (lane < 7 && count <= max_knots) kn[count * 7 + lane] = lane == 0 ? t : pick(y, lane - 1);
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
      n_att = 0;
      stale = true;
    }
  }

  // release the helpers
  if (lane == 0) cmd.stop = 1;
  bar_sync(kThreads);

  // the FSAL cache, from the lanes that hold its components (ERK 0-5,
  // ERKNG 0-2; an ERKNG k's velocity rows stay 0.0)
  if (lane < (kNystrom ? 3 : 6)) fstate[(kFCache + lane) * B + ship] = cache_own;
  if (lane == 0) {
    fstate[kFT * B + ship] = t;
#pragma unroll
    for (int c = 0; c < 6; ++c) fstate[(kFY + c) * B + ship] = y[c];
    fstate[kFNextH * B + ship] = next_h;
    fstate[kFHTry * B + ship] = h_try;
    istate[kISeg * B + ship] = seg;
    istate[kICount * B + ship] = count;
    istate[kIReason * B + ship] = reason;
    istate[kIN * B + ship] = n_att;
    istate[kIInAdv * B + ship] = in_adv;
    istate[kIStale * B + ship] = stale;
    istate[kIDone * B + ship] = done;
    istate[kIIters * B + ship] = it;
  }
}

// The body positions a window of this instance holds on device `dev`: the
// shared memory a block may opt into there, less the kernel's static shared
// memory, in slots.  Worked out, and opted into, once a device, so that a
// launch makes no attribute call.
template <class T>
cudaError_t window_slots(int dev, long long* slots) {
  static std::atomic<long long> cached[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  long long cap = cached[dev].load();
  if (cap == 0) {
    const auto kernel = fleet_scan_kernel<T>;
    int optin = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    cap = (static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes)) /
          kSlotBytes;
    if (cap < kLanes) return cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cap * kSlotBytes));
    if (err != cudaSuccess) return err;
    cached[dev].store(cap);
  }
  *slots = cap;
  return cudaSuccess;
}

template <class T>
int launch(const Params& prm, const Eph& e, const Fleet& fl, double* fstate, long long* istate,
           double* knots, int n_ships, int max_knots, int budget, cudaStream_t stream) {
  int dev = 0;
  long long cap = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = window_slots<T>(dev, &cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the windows: every stage at once where [3][S][N] fits, else G stages a
  // window, else one stage in chunks of C bodies
  constexpr int S = T::kStages;
  const int n = e.n;
  int G = S, C = n;
  if (static_cast<long long>(S) * n > cap) {
    if (n <= cap) {
      G = static_cast<int>(cap / n);
    } else {
      G = 1;
      C = static_cast<int>(cap / kLanes) * kLanes;
    }
  }
  const size_t bytes = static_cast<size_t>(G) * C * kSlotBytes;
  fleet_scan_kernel<T><<<n_ships, kThreads, bytes, stream>>>(
      prm, e, fl, fstate, istate, knots, n_ships, max_knots, budget, G, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// instance: the tableau (EET_FLEET_TABLEAUX's order); prm: host (8,) f64
// h_init, h_max, fac, fac_min, fac_max, 1/tol_pos, 1/tol_vel,
// -1/lower_order; the ephemeris (N bodies), the stacked timelines (B, S) and
// end_t (B,) on the device; fstate (15, B) f64, istate (8, B) int64 and knots
// (B, max_knots + 1, 7) f64 are read and advanced in place.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched; -1 for arguments
// out of range).
int eet_fleet_scan(int instance, const double* prm, long long n_max, int fsal, int burns,
                   int frames,
                   const double* mus, const double* starts, const double* intervals,
                   const long long* offsets, const long long* nsegs, const double* coeffs,
                   int n_bodies, const double* ends, const double* accels, const long long* kind,
                   const long long* body, int n_seg, const double* end_t, double* fstate,
                   long long* istate, double* knots, int n_ships, int max_knots, int budget,
                   cudaStream_t stream) {
  if (n_ships < 1 || n_seg < 1 || max_knots < 1 || budget < 1 || n_bodies < 0) return -1;
  Params p{prm[0], prm[1], prm[2], prm[3], prm[4], prm[5], prm[6], prm[7], n_max, fsal, burns,
           frames};
  const Eph e{mus, starts, intervals, offsets, nsegs, coeffs, n_bodies};
  const Fleet fl{ends, accels, kind, body, end_t, n_seg};
  int i = 0;
#define EET_FLEET_INSTANCE(NAME)                                                              \
  if (instance == i++)                                                                        \
    return launch<tableau::NAME>(p, e, fl, fstate, istate, knots, n_ships, max_knots, budget, \
                                 stream);
  EET_FLEET_TABLEAUX(EET_FLEET_INSTANCE)
#undef EET_FLEET_INSTANCE
  return -1;
}

}  // extern "C"
