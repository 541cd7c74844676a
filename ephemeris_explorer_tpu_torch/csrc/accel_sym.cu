// Kernel 10: the symmetric (Newton's third law) two-float pair force.
//
// Replaces the TPU kernel ephemeris_explorer_tpu/ops/pallas_nbody.py
// `_accel_kernel_sym` (reached through `pairwise_accel_df64_sym` and the f64
// drop-in `pairwise_accel_sym`).  It computes kernel 1's accelerations
//
//     a_i = sum_{j != i} mu_j (p_j - p_i) / |p_j - p_i|^3
//
// but evaluates each unordered pair once, over the upper triangle of
// (32, 32) tile pairs (ti <= tj), and sends its force to both bodies.  The
// per-pair chain is the reference's (pallas_nbody.py:631-682): two-float
// differences d = p_j - p_i; r^2 from squares that share each difference's
// Dekker split; the two-float rsqrt of pairforce.cuh; u^2 masked to zero on
// the self pair; the row weight (u^2 mu_j) u and the column weight
// (u^2 mu_i) u (mu folded in before the last multiply by u, which keeps the
// distant-pair terms out of f32 subnormals); and the products with d, which
// share the weights' splits.  Row receivers i get + sum_j mu_j w d, column
// receivers j get - sum_i mu_i w d.
//
// The sums are the reference's, in its order.  Within a tile pair: the
// halving tree of `_dd_tree_sum` over the tile's 32 columns for each row
// receiver, and over its 32 rows for each column receiver.  Across tiles:
// the TPU kernel keeps a row accumulator in registers over j = ti .. NT-1
// and read-modify-writes a resident column accumulator over i = 0 .. tj in
// grid order, both with add_sloppy from zero, then adds row and column.  On
// the card the tile pairs run in parallel and a (hi, lo) pair cannot be
// added atomically, so each tile pair writes its row partial for tile ti
// into slot tj and its column partial for tile tj into slot ti of two
// (NT, N, 3) scratch arrays, and a second kernel folds the slots in the
// reference's order (row: slots ti .. NT-1; column: slots 0 .. tj-1, each
// negated; then add_sloppy(row, col), pallas_nbody.py:744-748).  The diagonal
// tile's column side, zero in the reference, is neither written nor read:
// add_sloppy of a normalised pair and a zero returns the pair unchanged.
// The result equals the plain version (ops/cuda_sym.py) bitwise.
//
// What bounds it on an H100: arithmetic.  The shared chain (differences, r^2,
// rsqrt, u^2) is about half of kernel 1's per-pair work, the two weights and
// six products the rest: ~380 f32 operations per unordered pair by the plain
// version's count, against ~420 per ordered pair for kernel 1, so half the
// pairs at ~90% of the cost each.
//
// Design: one warp per tile pair, lane = receiver row of tile ti, four tile
// pairs per block on a (NT/4, NT) grid whose lower-triangle warps return at
// once.  The warp stages the 32 source columns' (hi, lo) positions and mu
// in shared memory and walks them in bit-reversed order, so the row side's
// tree is a stack of partial sums in registers (eight columns unrolled at a
// time; the four chunks merge as the tree does).  The column side's tree
// runs across lanes; of the two ways to do it, a warp-shuffle tree (five
// levels of shuffles and adds per column) and a rotating accumulator, this
// kernel takes neither: the rotating accumulator adds in sequence, not in
// the reference's tree order, and the shuffle tree spends ~15 add_sloppy per
// pair on reduction.  Instead each chunk of eight columns stages its column
// terms (32 rows x 8 columns x 3 components, hi and lo, 6 KB a warp) in
// shared memory, and 24 lanes then sum one (column, component) each over the
// 32 rows with the same bit-reversed stack: about one add_sloppy per pair
// for each side, in the reference's order.

#include "pairforce.cuh"

namespace {

using eet::TF;

constexpr int kTile = 32;    // bodies per tile: the lanes of a warp
constexpr int kLogTile = 5;
constexpr int kWarps = 4;    // tile pairs per block
constexpr int kChunk = 8;    // source columns per pass of the column sums
constexpr int kLogChunk = 3;
constexpr int kChunks = kTile / kChunk;
constexpr int kLogChunks = kLogTile - kLogChunk;

// The pair (receiver i, source k of the staged tile): row and column terms.
__device__ __forceinline__ void sym_pair(const TF pi[3], TF mu_r, TF mu_rs,
                                         const float (*src)[kTile], int k, bool self,
                                         TF rterm[3], TF cterm[3]) {
  using namespace eet;
  TF d[3], ds[3];
  for (int c = 0; c < 3; ++c) {
    d[c] = sub(TF{src[c][k], src[3 + c][k]}, pi[c]);
    ds[c] = split(d[c].hi);
  }
  TF r2 = add(add(sqr_presplit(d[0], ds[0]), sqr_presplit(d[1], ds[1])),
              sqr_presplit(d[2], ds[2]));
  if (self) r2 = TF{1.0f, 0.0f};
  const TF u = rsqrt_df(r2);
  TF u2 = sqr(u);
  if (self) u2 = TF{0.0f, 0.0f};
  const TF u2s = split(u2.hi);
  const TF mu_c{src[6][k], src[7][k]};
  const TF wr = mul(mul_presplit(u2, u2s, mu_c, split(mu_c.hi)), u);
  const TF wc = mul(mul_presplit(u2, u2s, mu_r, mu_rs), u);
  const TF wrs = split(wr.hi), wcs = split(wc.hi);
  for (int c = 0; c < 3; ++c) {
    rterm[c] = mul_presplit(wr, wrs, d[c], ds[c]);
    cterm[c] = mul_presplit(wc, wcs, d[c], ds[c]);
  }
}

// row_*/col_*: (NT, N, 3) slots.  Tile pair (ti, tj), ti <= tj, writes
// row_*[tj, ti-tile rows] and, off the diagonal, col_*[ti, tj-tile rows].
__global__ void __launch_bounds__(kWarps * kTile)
accel_sym_tiles(const float* __restrict__ pos_hi, const float* __restrict__ pos_lo,
                const float* __restrict__ mu_hi, const float* __restrict__ mu_lo,
                float* __restrict__ row_hi, float* __restrict__ row_lo,
                float* __restrict__ col_hi, float* __restrict__ col_lo, int n) {
  using namespace eet;
  __shared__ float s_src[kWarps][8][kTile];                    // p hi x3, p lo x3, mu hi, lo
  __shared__ float s_col[kWarps][kChunk * 6][kTile + 1];       // a chunk's column terms
  const int warp = threadIdx.x / kTile, lane = threadIdx.x % kTile;
  const int nt = n / kTile;
  const int ti = blockIdx.y, tj = blockIdx.x * kWarps + warp;
  if (tj >= nt || tj < ti) return;  // the whole warp
  const int i = ti * kTile + lane, j0 = tj * kTile;

  TF pi[3];
  for (int c = 0; c < 3; ++c) pi[c] = TF{pos_hi[c * n + i], pos_lo[c * n + i]};
  const TF mu_r{mu_hi[i], mu_lo[i]};
  const TF mu_rs = split(mu_r.hi);
  for (int c = 0; c < 3; ++c) {
    s_src[warp][c][lane] = pos_hi[c * n + j0 + lane];
    s_src[warp][3 + c][lane] = pos_lo[c * n + j0 + lane];
  }
  s_src[warp][6][lane] = mu_hi[j0 + lane];
  s_src[warp][7][lane] = mu_lo[j0 + lane];
  __syncwarp();
  const float(*src)[kTile] = s_src[warp];
  float(*cbuf)[kTile + 1] = s_col[warp];

  // The row side's tree over the 32 columns: leaf t is column rev5(t);
  // chunk q holds leaves 8q .. 8q+7, column (rev3(s) << 2) | rev2(q).  Each
  // chunk reduces to one partial; the chunk partials merge as the stack
  // would: A = C0 + C1, B = C2 + C3, then A + B.
  TF acc_a[3], acc_b[3];
#pragma unroll 1
  for (int q = 0; q < kChunks; ++q) {
    TF st[kLogChunk + 1][3];
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const int k = (bit_reverse(s, kLogChunk) << kLogChunks) | bit_reverse(q, kLogChunks);
      TF rterm[3], cterm[3];
      sym_pair(pi, mu_r, mu_rs, src, k, i == j0 + k, rterm, cterm);
      int top = pop_count(s);
      for (int c = 0; c < 3; ++c) {
        st[top][c] = rterm[c];
        cbuf[(s * 3 + c) * 2][lane] = cterm[c].hi;
        cbuf[(s * 3 + c) * 2 + 1][lane] = cterm[c].lo;
      }
      for (int m = s + 1; (m & 1) == 0; m >>= 1, --top) {
        for (int c = 0; c < 3; ++c) st[top - 1][c] = add_sloppy(st[top - 1][c], st[top][c]);
      }
    }
    for (int c = 0; c < 3; ++c) {
      if (q == 0) {
        acc_a[c] = st[0][c];
      } else if (q == 1) {
        acc_a[c] = add_sloppy(acc_a[c], st[0][c]);
      } else if (q == 2) {
        acc_b[c] = st[0][c];
      } else {
        acc_a[c] = add_sloppy(acc_a[c], add_sloppy(acc_b[c], st[0][c]));
      }
    }
    // the column side: lane 3s + c sums column k's component c over the 32
    // rows, leaf t = row rev5(t); the diagonal tile has none
    __syncwarp();
    if (tj > ti && lane < kChunk * 3) {
      const int s = lane / 3, c = lane % 3;
      const float* ch = cbuf[(s * 3 + c) * 2];
      const float* cl = cbuf[(s * 3 + c) * 2 + 1];
      TF cst[kLogTile + 1];
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const int r = bit_reverse(t, kLogTile);
        int top = pop_count(t);
        cst[top] = TF{ch[r], cl[r]};
        for (int m = t + 1; (m & 1) == 0; m >>= 1, --top) {
          cst[top - 1] = add_sloppy(cst[top - 1], cst[top]);
        }
      }
      const int k = (bit_reverse(s, kLogChunk) << kLogChunks) | bit_reverse(q, kLogChunks);
      const size_t at = (static_cast<size_t>(ti) * n + j0 + k) * 3 + c;
      col_hi[at] = cst[0].hi;
      col_lo[at] = cst[0].lo;
    }
    __syncwarp();
  }
  for (int c = 0; c < 3; ++c) {
    const size_t at = (static_cast<size_t>(tj) * n + i) * 3 + c;
    row_hi[at] = acc_a[c].hi;
    row_lo[at] = acc_a[c].lo;
  }
}

// out[e] for e = 3 r + c: the row slots tile(r) .. NT-1, then the negated
// column slots 0 .. tile(r)-1, each add_sloppy from zero, then row + col.
__global__ void accel_sym_fold(const float* __restrict__ row_hi, const float* __restrict__ row_lo,
                               const float* __restrict__ col_hi, const float* __restrict__ col_lo,
                               float* __restrict__ out_hi, float* __restrict__ out_lo, int n) {
  using namespace eet;
  const int m = 3 * n;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  const int tile = e / 3 / kTile, nt = n / kTile;
  TF row{0.0f, 0.0f}, col{0.0f, 0.0f};
  for (int s = tile; s < nt; ++s) {
    const size_t at = static_cast<size_t>(s) * m + e;
    row = add_sloppy(row, TF{row_hi[at], row_lo[at]});
  }
  for (int s = 0; s < tile; ++s) {
    const size_t at = static_cast<size_t>(s) * m + e;
    col = add_sloppy(col, TF{-col_hi[at], -col_lo[at]});
  }
  const TF a = add_sloppy(row, col);
  out_hi[e] = a.hi;
  out_lo[e] = a.lo;
}

}  // namespace

extern "C" {

// pos_*: (3, N) f32 component-major; mu_*: (N,) f32; row_*, col_*: (N/32,
// N, 3) f32 scratch; out_*: (N, 3).  N a positive multiple of 32 (else -1).
// Launches both kernels on `stream` and returns cudaGetLastError().
int eet_accel_sym(const float* pos_hi, const float* pos_lo, const float* mu_hi,
                  const float* mu_lo, float* row_hi, float* row_lo, float* col_hi, float* col_lo,
                  float* out_hi, float* out_lo, int n, cudaStream_t stream) {
  if (n <= 0 || n % kTile != 0) return -1;
  const int nt = n / kTile;
  dim3 grid((nt + kWarps - 1) / kWarps, nt);
  accel_sym_tiles<<<grid, kWarps * kTile, 0, stream>>>(pos_hi, pos_lo, mu_hi, mu_lo, row_hi,
                                                      row_lo, col_hi, col_lo, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  accel_sym_fold<<<(3 * n + 255) / 256, 256, 0, stream>>>(row_hi, row_lo, col_hi, col_lo, out_hi,
                                                         out_lo, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
