// Kernels 8 and 9: the two-float strong-pair correction of the magnitude-split
// mode, on its three feeds.
//
// Replaces the TPU kernel ephemeris_explorer_tpu/ops/pallas_nbody.py
// `_strong_corr_kernel_fast` (reached through `_strong_correction_fast`,
// square and `rows=` forms, the default correction of `pairwise_accel_split`
// and `pairwise_accel_split_rows`).  For each receiver i it sums the force of
// its K strongest sources idx[i, :] in two-float arithmetic:
//
//     c_i = sum_k mu_j (p_j - p_i) / |p_j - p_i|^3,   j = idx[i, k],
//
// with the pair chain of pallas_nbody.py:1281-1295: d = sub(p_j, p_i) on the
// (hi, lo) limbs; r^2 = add(add(sqr(d0), sqr(d1)), sqr(d2)); r^2.hi == 0
// clamped to 1; the two-float rsqrt of pairforce.cuh; w = (u^2 mu) u; each
// component mul(w, d).
//
// The sum is the reference's `_dd_tree_sum` (pallas_nbody.py:47) over KP,
// the next power of two of K, with the KP - K padding entries in front
// (pallas_nbody.py:1327-1331): it halves as a[k] = add_sloppy(a[k], a[k+m]).
// A padding entry (mu = 0 and a gathered position of 0 in the reference, so
// d = -p_i) contributes a two-float zero, and add_sloppy of a normalised
// pair and a zero returns the pair unchanged, so the kernels add an exact
// zero in its place.
//
// What bounds kernel 8 on an H100: latency.  K = 16 sources per receiver is
// 65K pairs at N = 4096, ~400 dependent f32 operations each: ~26 MFLOP, 0.8
// us of the card's arithmetic.  Design (`strong_corr_lanes`): one leaf a
// lane.  A receiver takes a segment of L = min(KP, 32) lanes of one warp;
// lane l of the segment holds leaves l, l + L, l + 2L, ... (KP / L of them),
// so at K = 16 the 65,536 pairs are 65,536 lanes, ~15 warps on each of the
// 132 SMs, each lane one chain of ~400 operations and two dependent gathers
// (its idx entry, a coalesced run a segment; then its source).  The tree
// follows the lanes: its levels m >= L add within a lane (the lane's KP / L
// leaves walked in bit-reversed order through a stack of partial sums, the
// binary counter below, in registers), and its levels m < L are
// __shfl_down_sync by m within the segment, the lower lane's value the first
// operand.  Same adds, same operands, same order as the reference's tree:
// the kernel equals its plain version bitwise.  An index outside [0, N) is
// read as source 0 and makes its receiver's result NaN (a ballot over the
// segment), so a bad strong set shows in the output instead of reading out
// of bounds; no other receiver changes.
//
// Kernel 8 has two feeds and two epilogues.  The limb-fed entry
// (`eet_strong_corr`, `LimbFeed`) gathers the (hi, lo) position and mu limbs
// of each source from the (N, 3) and (N,) split arrays and writes the (hi,
// lo) pair.  The production entry (`eet_strong_corr_f64`, `SplitF64Feed`)
// reads the (N, 3) f64 positions, the (NL, 3) f64 receivers and the (N,) f64
// mu and splits them in registers (__double2float_rn, __dsub_rn: the exact
// split of `split_f64`, pallas_nbody.py:1312-1319; splitting and then
// gathering gives the same bits as gathering and then splitting), and writes
// the f64 sum (f64(hi) + f64(lo)) + f64(a32[i]), the reference's two f64
// adds (pallas_nbody.py:1363, then :1403) with kernel 7's f32 weak tail
// a32, or without a32 f64(hi) + f64(lo).  That removes the split mode's
// host-side splits, combine and final add.
//
// Kernel 9 replaces the TPU kernel `_strong_corr_kernel` (reached through
// `_strong_correction_df64`, `corr="dd"` of `pairwise_accel_split`, square
// form only): kernel 8's lane loop and epilogues on a third feed
// (`F64Feed`), so the same latency bounds it.  The reference differences the
// f64 positions on the host, d = pos[j] - pos[i] (one correctly rounded f64
// subtract), and only then splits d and mu[j] into (hi, lo) f32 as
// `_split_f64` does (pallas_nbody.py:1164-1168), so a close pair's d keeps
// ~2^-48 of |d| rather than of |p|.  Here each lane holds its receiver's f64
// row and does the same subtract and splits in registers (__dsub_rn,
// __double2float_rn), which removes the reference's host-side (N, K, 3) f64
// gather, transpose, split and padding.  Its padding entries (d = 0, mu = 0)
// would reach w = +0 through the r^2.hi == 0 clamp, so the exact two-float
// zero the loop adds in their place is theirs too.  Two entries:
// `eet_strong_corr_dd` writes the raw (hi, lo) pair (`PairOut`), and
// `eet_strong_corr_dd_f64` the `corr="dd"` split force's f64 sum (`F64Out`:
// (f64(hi) + f64(lo)) + f64(a32), the route's combine and final add, in its
// order), so that rung is two casts, kernel 7 and kernel 9.

#include "pairforce.cuh"

namespace {

using eet::TF;

constexpr unsigned kFull = 0xffffffffu;

// The exact (hi, lo) f32 split of an f64 value (pallas_nbody._split_f64).
__device__ __forceinline__ TF split_f64(double x) {
  const float hi = __double2float_rn(x);
  return TF{hi, __double2float_rn(__dsub_rn(x, static_cast<double>(hi)))};
}

// Kernel 8's limb feed: (hi, lo) f32 limbs, d = sub(p_j, p_i) in two-float.
struct LimbFeed {
  const float *pos_hi, *pos_lo, *rows_hi, *rows_lo, *mu_hi, *mu_lo;
  struct Row {
    TF p[3];
  };
  __device__ Row row(int i) const {
    Row r;
    for (int c = 0; c < 3; ++c) r.p[c] = TF{rows_hi[i * 3 + c], rows_lo[i * 3 + c]};
    return r;
  }
  __device__ void pair(int j, const Row& r, TF d[3], TF& mu) const {
    for (int c = 0; c < 3; ++c) d[c] = eet::sub(TF{pos_hi[j * 3 + c], pos_lo[j * 3 + c]}, r.p[c]);
    mu = TF{mu_hi[j], mu_lo[j]};
  }
};

// Kernel 8's production feed: f64 positions, receivers and mu, split in
// registers; then the limb feed's d = sub(p_j, p_i).
struct SplitF64Feed {
  const double *pos, *rows, *mu;
  using Row = LimbFeed::Row;
  __device__ Row row(int i) const {
    Row r;
    for (int c = 0; c < 3; ++c) r.p[c] = split_f64(rows[i * 3 + c]);
    return r;
  }
  __device__ void pair(int j, const Row& r, TF d[3], TF& m) const {
    for (int c = 0; c < 3; ++c) d[c] = eet::sub(split_f64(pos[j * 3 + c]), r.p[c]);
    m = split_f64(mu[j]);
  }
};

// Kernel 9's feed: f64 positions, d = p_j - p_i in f64, then split.
struct F64Feed {
  const double *pos, *mu;
  struct Row {
    double p[3];
  };
  __device__ Row row(int i) const {
    Row r;
    for (int c = 0; c < 3; ++c) r.p[c] = pos[i * 3 + c];
    return r;
  }
  __device__ void pair(int j, const Row& r, TF d[3], TF& m) const {
    for (int c = 0; c < 3; ++c) d[c] = split_f64(__dsub_rn(pos[j * 3 + c], r.p[c]));
    m = split_f64(mu[j]);
  }
};

// The limb-fed entry's epilogue: the raw (hi, lo) pair.
struct PairOut {
  float *hi, *lo;
  __device__ void write(int i, int c, TF v) const {
    hi[i * 3 + c] = v.hi;
    lo[i * 3 + c] = v.lo;
  }
};

// The production entry's epilogue: (f64(hi) + f64(lo)) [+ f64(a32)].
struct F64Out {
  const float* a32;  // (NL, 3) kernel 7's weak tail, or null
  double* out;
  __device__ void write(int i, int c, TF v) const {
    double s = __dadd_rn(static_cast<double>(v.hi), static_cast<double>(v.lo));
    if (a32 != nullptr) s = __dadd_rn(s, static_cast<double>(a32[i * 3 + c]));
    out[i * 3 + c] = s;
  }
};

// One strong pair's contribution mul(w, d) per component.
template <class Feed>
__device__ __forceinline__ void pair_term(const Feed& feed, int j, const typename Feed::Row& row,
                                          TF out[3]) {
  using namespace eet;
  TF d[3], mu;
  feed.pair(j, row, d, mu);
  TF r2 = add(add(sqr(d[0]), sqr(d[1])), sqr(d[2]));
  if (r2.hi == 0.0f) r2 = TF{1.0f, 0.0f};
  const TF u = rsqrt_df(r2);
  const TF w = mul(mul(sqr(u), mu), u);
  for (int c = 0; c < 3; ++c) out[c] = mul(w, d[c]);
}

// ---- kernels 8 and 9: one leaf a lane ------------------------------------------

constexpr int kLaneBlock = 256;

// kLogKp >= 0: KP = 2^kLogKp fixed at compile time (KP <= 128: at most four
// leaves a lane, the stack in registers); kLogKp < 0: log_kp_rt (> 5), the
// stack in local memory.
template <int kLogKp, class Feed, class Out>
__global__ void __launch_bounds__(kLaneBlock)
strong_corr_lanes(Feed feed, const int* __restrict__ idx, Out out, int n, int nl, int k,
                  int log_kp_rt) {
  using namespace eet;
  constexpr bool kFixed = kLogKp >= 0;
  constexpr int kLogSeg = kFixed && kLogKp < 5 ? kLogKp : 5;  // L = 2^kLogSeg lanes a receiver
  constexpr int kSeg = 1 << kLogSeg;
  constexpr int kDepth = kFixed ? kLogKp - kLogSeg + 1 : 32;
  const int log_leaves = (kFixed ? kLogKp : log_kp_rt) - kLogSeg;  // log2 of leaves a lane
  const int pad = (1 << (log_leaves + kLogSeg)) - k;

  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = g >> kLogSeg;  // the receiver
  const int s = g & (kSeg - 1);  // the lane in its segment
  const int ii = min(i, nl - 1);  // every lane of the warp takes part in the shuffles
  const typename Feed::Row row = feed.row(ii);
  const int* my_idx = idx + static_cast<size_t>(ii) * k;
  bool bad = false;

  // levels m >= L: the lane's leaves s + L j, j in bit-reversed order
  TF st[3][kDepth];
#pragma unroll
  for (int t = 0; t < (1 << log_leaves); ++t) {
    const int leaf = s + (bit_reverse(t, log_leaves) << kLogSeg);
    int top = pop_count(t);  // partial sums on the stack before this leaf
    if (leaf < pad) {
      for (int c = 0; c < 3; ++c) st[c][top] = TF{0.0f, 0.0f};
    } else {
      const int j = my_idx[leaf - pad];
      const bool in_range = static_cast<unsigned>(j) < static_cast<unsigned>(n);
      bad = bad || !in_range;
      TF term[3];
      pair_term(feed, in_range ? j : 0, row, term);
      for (int c = 0; c < 3; ++c) st[c][top] = term[c];
    }
    for (int m = t + 1; (m & 1) == 0; m >>= 1, --top) {
      for (int c = 0; c < 3; ++c) st[c][top - 1] = add_sloppy(st[c][top - 1], st[c][top]);
    }
  }

  // levels m < L: lane s adds lane s + m's partial sum
  TF v[3] = {st[0][0], st[1][0], st[2][0]};
#pragma unroll
  for (int m = kSeg / 2; m >= 1; m /= 2) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const TF o{__shfl_down_sync(kFull, v[c].hi, m, kSeg),
                 __shfl_down_sync(kFull, v[c].lo, m, kSeg)};
      v[c] = add_sloppy(v[c], o);
    }
  }

  const unsigned seg_bits = kSeg == 32 ? kFull : (1u << kSeg) - 1u;
  const int base = (threadIdx.x % 32) & ~(kSeg - 1);
  bad = ((__ballot_sync(kFull, bad) >> base) & seg_bits) != 0u;
  if (s != 0 || i >= nl) return;
  const float nan = __int_as_float(0x7fc00000);
  for (int c = 0; c < 3; ++c) out.write(i, c, bad ? TF{nan, nan} : v[c]);
}

// Launch kernel 8 or 9 on nl receivers: an unrolled instance for KP <= 128, the
// local-memory one above; returns cudaGetLastError().
template <class Feed, class Out>
int launch_lanes(const Feed& feed, const int* idx, const Out& out, int n, int nl, int k,
                 cudaStream_t stream) {
  int log_kp = 0;
  while ((1 << log_kp) < k) ++log_kp;
  const long long lanes = static_cast<long long>(nl) << (log_kp < 5 ? log_kp : 5);
  const int blocks = static_cast<int>((lanes + kLaneBlock - 1) / kLaneBlock);
  switch (log_kp) {
#define EET_CASE(L)                                                                  \
  case L:                                                                            \
    strong_corr_lanes<L, Feed, Out><<<blocks, kLaneBlock, 0, stream>>>(feed, idx, out, n, \
                                                                       nl, k, L);        \
    break;
    EET_CASE(0)
    EET_CASE(1)
    EET_CASE(2)
    EET_CASE(3)
    EET_CASE(4)
    EET_CASE(5)
    EET_CASE(6)
    EET_CASE(7)
#undef EET_CASE
    default:
      strong_corr_lanes<-1, Feed, Out><<<blocks, kLaneBlock, 0, stream>>>(feed, idx, out, n, nl,
                                                                          k, log_kp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Kernel 8 on split limbs.  pos_*: (N, 3) f32 split source positions;
// rows_*: (NL, 3) f32 split receivers; mu_*: (N,) f32 split mu; idx: (NL, K)
// int32 source indices; out_*: (NL, 3).  N, NL, K >= 1.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
int eet_strong_corr(const float* pos_hi, const float* pos_lo, const float* rows_hi,
                    const float* rows_lo, const float* mu_hi, const float* mu_lo, const int* idx,
                    float* out_hi, float* out_lo, int n, int nl, int k, cudaStream_t stream) {
  if (n < 1 || nl < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_lanes(LimbFeed{pos_hi, pos_lo, rows_hi, rows_lo, mu_hi, mu_lo}, idx,
                      PairOut{out_hi, out_lo}, n, nl, k, stream);
}

// Kernel 8 on f64 inputs (the split mode's production form).  pos: (N, 3)
// f64 sources; rows: (NL, 3) f64 receivers (pos itself in the square form);
// mu: (N,) f64; idx: (NL, K) int32 source indices; a32: (NL, 3) f32 added
// to the result, or null; out: (NL, 3) f64.  N, NL, K >= 1.
int eet_strong_corr_f64(const double* pos, const double* rows, const double* mu, const int* idx,
                        const float* a32, double* out, int n, int nl, int k,
                        cudaStream_t stream) {
  if (n < 1 || nl < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_lanes(SplitF64Feed{pos, rows, mu}, idx, F64Out{a32, out}, n, nl, k, stream);
}

// Kernel 9.  pos: (N, 3) f64 positions, sources and receivers; mu: (N,) f64;
// idx: (N, K) int32 source indices; out_*: (N, 3).  N, K >= 1.
int eet_strong_corr_dd(const double* pos, const double* mu, const int* idx, float* out_hi,
                       float* out_lo, int n, int k, cudaStream_t stream) {
  if (n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_lanes(F64Feed{pos, mu}, idx, PairOut{out_hi, out_lo}, n, n, k, stream);
}

// Kernel 9 with kernel 8's f64 epilogue (the corr="dd" split force).  pos,
// mu, idx as above; a32: (N, 3) f32 added to the result, or null; out: (N,
// 3) f64.  N, K >= 1.
int eet_strong_corr_dd_f64(const double* pos, const double* mu, const int* idx, const float* a32,
                           double* out, int n, int k, cudaStream_t stream) {
  if (n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_lanes(F64Feed{pos, mu}, idx, F64Out{a32, out}, n, n, k, stream);
}

}  // extern "C"
