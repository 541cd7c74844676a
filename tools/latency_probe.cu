// Instruction latencies of one warp on an NVIDIA GPU, by clock64 around
// dependent chains: what profile_port.py's chain bound multiplies a kernel's
// dependent path by.  Each chain runs `reps` dependent operations of one kind
// on one warp, unrolled so that the loop's own instructions stay off it;
// cycles an operation = the clock64 difference over reps.  Built with the
// port's flags (sm_90a, --fmad=false) by profile_port.py:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared \
//        -Xcompiler -fPIC -o liblatency_probe.so tools/latency_probe.cu
//
// eet_latency_probe(out, reps) writes kProbes cycle counts into `out` (host
// memory, long long), in the order of kNames, then the SM clock in kHz
// (clock64 cycles over %globaltimer nanoseconds on a long DADD chain, x
// 1e6); returns a cudaError_t (0 = ran).

#include <cuda_runtime.h>

namespace {

constexpr int kProbes = 11;
constexpr int kUnroll = 32;

__device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ double rsq_approx(double x) {
  double r;
  asm volatile("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  return r;
}

template <int kKind>
__device__ __forceinline__ void step(double& x, int& i, const double y, const int* s_idx,
                                     const double* s_val) {
  switch (kKind) {
    case 0: x = __dadd_rn(x, y); break;                               // DADD
    case 1: x = __dmul_rn(x, y); break;                               // DMUL
    case 2: x = __fma_rn(x, y, -1.0); break;                          // DFMA
    case 3: x = rsq_approx(x); break;                                 // MUFU.RSQ64H
    case 4: x = __ddiv_rn(x, y); break;                               // division sequence
    case 5: x = __dsqrt_rn(__dadd_rn(x, y)); break;                   // sqrt sequence + DADD
    case 6: x = rsqrt(x); break;                                      // f64 rsqrt sequence
    case 7: x = __dadd_rn(__shfl_xor_sync(0xffffffffu, x, 1), y); break;  // SHFL (two) + DADD
    case 8: i = s_idx[i]; break;                                      // LDS.32
    case 9: x = s_val[static_cast<int>(x) & 31]; break;               // LDS.64 + F2I + LOP
    case 10: i = (i * 3 + 1) & 31; break;                             // IMAD + LOP3
  }
}

template <int kKind>
__device__ long long chain(int reps, double& x, int& i, double y, const int* s_idx,
                           const double* s_val) {
  __syncwarp();
  const long long t0 = clock64();
  for (int r = 0; r < reps; r += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) step<kKind>(x, i, y, s_idx, s_val);
  }
  const long long t1 = clock64();
  __syncwarp();
  return t1 - t0;
}

__global__ void probe_kernel(long long* out, double* sink, int reps) {
  __shared__ int s_idx[32];
  __shared__ double s_val[32];
  const int lane = threadIdx.x;
  s_idx[lane] = (lane + 1) & 31;
  s_val[lane] = static_cast<double>((lane + 1) & 31);
  __syncwarp();
  // every chain starts from a value loaded at run time and ends in `keep`,
  // so that none is folded or dropped
  // y differs from lane to lane, so that no chain can be reassociated
  // across the shuffles
  const double y = sink[1] + lane * 1e-12;
  double x, keep = 0.0;
  int i = lane;
  long long c[kProbes];
  x = sink[2] + lane * 1e-3;
  c[0] = chain<0>(reps, x, i, y, s_idx, s_val);
  keep += x;
  x = sink[2] + lane * 1e-3;
  c[1] = chain<1>(reps, x, i, y, s_idx, s_val);
  keep += x;
  x = sink[2] + lane * 1e-3;
  c[2] = chain<2>(reps, x, i, y, s_idx, s_val);
  keep += x;
  x = sink[3];
  c[3] = chain<3>(reps, x, i, y, s_idx, s_val);
  keep += x;
  x = sink[3];
  c[4] = chain<4>(reps, x, i, y, s_idx, s_val);
  keep += x;
  c[5] = chain<5>(reps, x, i, y, s_idx, s_val);
  keep += x;
  c[6] = chain<6>(reps, x, i, y, s_idx, s_val);
  keep += x;
  c[7] = chain<7>(reps, x, i, y, s_idx, s_val);
  keep += x;
  c[8] = chain<8>(reps, x, i, y, s_idx, s_val);
  keep += i;
  x = sink[4];
  c[9] = chain<9>(reps, x, i, y, s_idx, s_val);
  keep += x;
  c[10] = chain<10>(reps, x, i, y, s_idx, s_val);
  keep += i;
  // the SM clock: a long DADD chain against the global timer
  x = sink[2];
  const long long n0 = now_ns();
  const long long k = chain<0>(reps * 64, x, i, y, s_idx, s_val);
  const long long n1 = now_ns();
  keep += x;
  if (lane == 0) {
    for (int p = 0; p < kProbes; ++p) out[p] = c[p];
    out[kProbes] = n1 > n0 ? k * 1000000LL / (n1 - n0) : 0;
  }
  sink[8 + lane] = keep;
}

}  // namespace

extern "C" int eet_latency_probe(long long* out, int reps) {
  long long* d_out = nullptr;
  double* d_sink = nullptr;
  // y, and the chains' starting values (sink[1..4]); the lanes' results at 8..39
  const double init[5] = {0.0, 1.0000001, 1.0, 1.5, 3.0};
  cudaError_t err = cudaMalloc(&d_out, (kProbes + 1) * sizeof(long long));
  if (err == cudaSuccess) err = cudaMalloc(&d_sink, 40 * sizeof(double));
  if (err == cudaSuccess) err = cudaMemcpy(d_sink, init, sizeof(init), cudaMemcpyHostToDevice);
  if (err == cudaSuccess) {
    probe_kernel<<<1, 32>>>(d_out, d_sink, reps);  // warm-up: the first launch loads the module
    probe_kernel<<<1, 32>>>(d_out, d_sink, reps);
    err = cudaDeviceSynchronize();
  }
  if (err == cudaSuccess)
    err = cudaMemcpy(out, d_out, (kProbes + 1) * sizeof(long long), cudaMemcpyDeviceToHost);
  cudaFree(d_out);
  cudaFree(d_sink);
  return static_cast<int>(err);
}
