// Kernels 8 and 9: the two-float strong-pair correction of the magnitude-split
// mode, on its two feeds.
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
// That tree adds leaf j first with leaf j XOR KP/2, so walking the leaves in
// bit-reversed order t -> j = rev(t) turns it into the adjacent-pairs tree,
// which a stack of log2(KP) + 1 partial sums reduces as the leaves arrive
// (a binary counter: after leaf t, merge ctz(t + 1) times, the earlier
// partial always the first operand).  Same adds, same operands, same order:
// the kernel equals the plain version's tree.  A padding entry (mu = 0 and a
// gathered position of 0 in the reference, so d = -p_i) contributes a
// two-float zero, and add_sloppy of a normalised pair and a zero returns the
// pair unchanged, so the kernel adds an exact zero in its place.
//
// What bounds it on an H100: latency.  K = 16 sources per receiver is 65K
// pairs at N = 4096, ~400 f32 operations each: ~26 MFLOP, a few microseconds
// of the card.  Design: one thread per receiver, 64 receivers per block (64
// blocks at N = 4096).  The kernel reads idx itself and gathers the (hi, lo)
// position limbs and the (hi, lo) mu limbs of each source from the (N, 3) and
// (N,) split arrays (all in L2 at N = 4096), which removes the reference's
// host-side packed gather, transpose and per-call split of mu[idx]: splitting
// mu once and then gathering gives the same bits.  For KP <= 32 the leaf loop
// is unrolled (a template on log2 KP), so the stack lives in registers; a
// larger K runs the same code with the stack in local memory.  An index
// outside [0, N) is read as source 0 and makes its receiver's result NaN, so
// a bad strong set shows in the output instead of reading out of bounds.
//
// Kernel 9 replaces the TPU kernel `_strong_corr_kernel` (reached through
// `_strong_correction_df64`, `corr="dd"` of `pairwise_accel_split`, square
// form only): the same chain and tree on another feed.  The reference
// differences the f64 positions on the host, d = pos[j] - pos[i] (one
// correctly rounded f64 subtract), and only then splits d and mu[j] into
// (hi, lo) f32 as `_split_f64` does (pallas_nbody.py:1164-1168), so a close
// pair's d keeps ~2^-48 of |d| rather than of |p|.  Here the kernel reads
// idx and the (N, 3) f64 positions and (N,) f64 mu itself and does the same
// subtract and splits in registers (__dsub_rn, __double2float_rn), which
// removes the reference's host-side (N, K, 3) f64 gather, transpose, split
// and padding.  Its padding entries (d = 0, mu = 0) reach w = +0 through
// the r^2.hi == 0 clamp, so each contributes the exact two-float zero that
// this kernel adds in their place.  The two feeds are the `LimbFeed` and
// `F64Feed` types below, one template argument of the same kernel; the f64
// feed moves 8-byte loads but stays latency-bound as kernel 8.

#include "pairforce.cuh"

namespace {

using eet::TF;

constexpr int kBlock = 64;

// Kernel 8's feed: (hi, lo) f32 limbs, d = sub(p_j, p_i) in two-float.
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

// The exact (hi, lo) f32 split of an f64 value (pallas_nbody._split_f64).
__device__ __forceinline__ TF split_f64(double x) {
  const float hi = __double2float_rn(x);
  return TF{hi, __double2float_rn(__dsub_rn(x, static_cast<double>(hi)))};
}

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

// kLogKp >= 0: KP = 2^kLogKp fixed at compile time; kLogKp < 0: log_kp_rt.
template <int kLogKp, class Feed>
__global__ void __launch_bounds__(kBlock)
strong_corr(Feed feed, const int* __restrict__ idx, float* __restrict__ out_hi,
            float* __restrict__ out_lo, int n, int nl, int k, int log_kp_rt) {
  using namespace eet;
  constexpr bool kFixed = kLogKp >= 0;
  constexpr int kDepth = kFixed ? kLogKp + 1 : 32;
  const int log_kp = kFixed ? kLogKp : log_kp_rt;
  const int kp = 1 << log_kp;

  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= nl) return;
  const typename Feed::Row row = feed.row(i);
  const int* my_idx = idx + static_cast<size_t>(i) * k;
  const int pad = kp - k;
  bool bad = false;

  TF st[3][kDepth];
#pragma unroll
  for (int t = 0; t < kp; ++t) {
    const int leaf = bit_reverse(t, log_kp);
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
  const float nan = __int_as_float(0x7fc00000);
  for (int c = 0; c < 3; ++c) {
    out_hi[i * 3 + c] = bad ? nan : st[c][0].hi;
    out_lo[i * 3 + c] = bad ? nan : st[c][0].lo;
  }
}

template <int kLogKp, class Feed>
void launch_one(const Feed& feed, const int* idx, float* out_hi, float* out_lo, int n, int nl,
                int k, int log_kp, cudaStream_t stream) {
  strong_corr<kLogKp, Feed><<<(nl + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      feed, idx, out_hi, out_lo, n, nl, k, log_kp);
}

// An unrolled instance for KP <= 32, the local-memory one above; returns
// cudaGetLastError().
template <class Feed>
int launch(const Feed& feed, const int* idx, float* out_hi, float* out_lo, int n, int nl, int k,
           cudaStream_t stream) {
  int log_kp = 0;
  while ((1 << log_kp) < k) ++log_kp;
  switch (log_kp) {
#define EET_CASE(L)                                                        \
  case L:                                                                  \
    launch_one<L>(feed, idx, out_hi, out_lo, n, nl, k, L, stream);         \
    break;
    EET_CASE(0)
    EET_CASE(1)
    EET_CASE(2)
    EET_CASE(3)
    EET_CASE(4)
    EET_CASE(5)
#undef EET_CASE
    default:
      launch_one<-1>(feed, idx, out_hi, out_lo, n, nl, k, log_kp, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Kernel 8.  pos_*: (N, 3) f32 split source positions; rows_*: (NL, 3) f32
// split receivers; mu_*: (N,) f32 split mu; idx: (NL, K) int32 source
// indices; out_*: (NL, 3).  N, K >= 1; KP <= 32 runs an unrolled instance.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
int eet_strong_corr(const float* pos_hi, const float* pos_lo, const float* rows_hi,
                    const float* rows_lo, const float* mu_hi, const float* mu_lo, const int* idx,
                    float* out_hi, float* out_lo, int n, int nl, int k, cudaStream_t stream) {
  return launch(LimbFeed{pos_hi, pos_lo, rows_hi, rows_lo, mu_hi, mu_lo}, idx, out_hi, out_lo, n,
                nl, k, stream);
}

// Kernel 9.  pos: (N, 3) f64 positions, sources and receivers; mu: (N,) f64;
// idx: (N, K) int32 source indices; out_*: (N, 3).  N, K >= 1.
int eet_strong_corr_dd(const double* pos, const double* mu, const int* idx, float* out_hi,
                       float* out_lo, int n, int k, cudaStream_t stream) {
  return launch(F64Feed{pos, mu}, idx, out_hi, out_lo, n, n, k, stream);
}

}  // extern "C"
