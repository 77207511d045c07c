// K7 `mamba_chunk_scan`: the selective state-space (S6) scan of every chunk
// of a sequence from its own initial state.
//
// Replaces src/repro/kernels/mamba_scan.py::mamba_chunk_scan (Pallas body
// `_scan_kernel`).  Per chunk, per channel d and state n, for each step t:
//   h[d,n] = exp(dt[t,d] * a[d,n]) * h[d,n] + (dt[t,d] * x[t,d]) * B[t,n]
//   y[t,d] = sum_n h[d,n] * C[t,n]
// x, dt (Bt, L, D) and B, C (Bt, L, N) in one type T (float or bf16);
// a (D, N), h0 and h_out (Bt, n_chunks, D, N) float32; y (Bt, L, D) in T.
// ops.mamba_scan runs it twice around the chunk combine.
//
// Design.  The TPU kernel keeps a (128, N) channel block in VMEM and walks
// the chunk with a fori_loop.  Here the grid is (D/BD, n_chunks, Bt) and
// each thread owns one channel d: its N states and its row of a live in
// registers (N a template parameter), the chunk's B_t and C_t (chunk x N)
// are staged once in shared memory, and x_t and dt_t are read coalesced
// along d.  Every product and add rounds to nearest in the order of
// ref.mamba_chunk_scan_ref (y sums over n in increasing order), and the
// decay is the full-precision expf, not __expf.  Steps past L (a ragged
// last chunk) and channels past D are masked here; no caller pads.
// Bound: at jamba's 32k-token call (bf16, D = 8192, N = 16) the bytes of
// x, dt, y and the two state tensors, 1.9 GB, take 0.56 ms at 3.35 TB/s;
// its 4.3e9 expf (one MUFU.EX2 each, 16 a clock per SM) take about 1 ms,
// so the special-function units, not memory, bound a faithful kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BD = 128;  // channels per block, one per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

template <int N, typename T>
__global__ void __launch_bounds__(BD)
mamba_chunk_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                        const float* __restrict__ a, const T* __restrict__ bm,
                        const T* __restrict__ cm, const float* __restrict__ h0,
                        T* __restrict__ y, float* __restrict__ hout, int L,
                        int D, int chunk, int n_chunks) {
  extern __shared__ float smem[];
  float* bs = smem;              // (chunk, N)
  float* cs = smem + chunk * N;  // (chunk, N)
  const int d = blockIdx.x * BD + threadIdx.x;
  const int ci = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int t0 = ci * chunk;
  const int steps = min(chunk, L - t0);
  const int64_t row0 = bi * L + t0;  // first (b, t) of the chunk
  for (int i = threadIdx.x; i < steps * N; i += BD) {
    bs[i] = to_f(bm[row0 * N + i]);
    cs[i] = to_f(cm[row0 * N + i]);
  }
  __syncthreads();
  if (d >= D) return;

  float av[N], h[N];
  const int64_t hoff = ((bi * n_chunks + ci) * (int64_t)D + d) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = a[(int64_t)d * N + n];
    h[n] = h0[hoff + n];
  }
  const T* xp = x + row0 * D + d;
  const T* dtp = dt + row0 * D + d;
  T* yp = y + row0 * D + d;
  for (int t = 0; t < steps; ++t) {
    const float dtt = to_f(dtp[(int64_t)t * D]);
    const float dtx = __fmul_rn(dtt, to_f(xp[(int64_t)t * D]));
    const float* bt = bs + t * N;
    const float* ct = cs + t * N;
    float yt = 0.0f;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float decay = expf(__fmul_rn(dtt, av[n]));
      h[n] = __fadd_rn(__fmul_rn(decay, h[n]), __fmul_rn(dtx, bt[n]));
      const float p = __fmul_rn(h[n], ct[n]);
      yt = n == 0 ? p : __fadd_rn(yt, p);
    }
    yp[(int64_t)t * D] = from_f<T>(yt);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) hout[hoff + n] = h[n];
}

template <int N, typename T>
int launch(const void* x, const void* dt, const float* a, const void* bm,
           const void* cm, const float* h0, void* y, float* hout, int Bt, int L,
           int D, int chunk, cudaStream_t stream) {
  const int n_chunks = (L + chunk - 1) / chunk;
  if (n_chunks > 65535 || Bt > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)chunk * N * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 blocks((D + BD - 1) / BD, n_chunks, Bt);
  mamba_chunk_scan_kernel<N, T><<<blocks, BD, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a,
      static_cast<const T*>(bm), static_cast<const T*>(cm), h0,
      static_cast<T*>(y), hout, L, D, chunk, n_chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(const void* x, const void* dt, const float* a, const void* bm,
               const void* cm, const float* h0, void* y, float* hout, int Bt,
               int L, int D, int N, int chunk, cudaStream_t stream) {
  switch (N) {
    case 8:
      return launch<8, T>(x, dt, a, bm, cm, h0, y, hout, Bt, L, D, chunk, stream);
    case 16:
      return launch<16, T>(x, dt, a, bm, cm, h0, y, hout, Bt, L, D, chunk, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry for ctypes; returns the cudaError_t of the launch.
extern "C" int mamba_chunk_scan(const void* x, const void* dt, const float* a,
                                const void* bm, const void* cm, const float* h0,
                                void* y, float* hout, int is_bf16, int Bt, int L,
                                int D, int N, int chunk, cudaStream_t stream) {
  if (L <= 0 || D <= 0 || Bt <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch_n<__nv_bfloat16>(x, dt, a, bm, cm, h0, y, hout, Bt, L, D, N,
                                     chunk, stream);
  return dispatch_n<float>(x, dt, a, bm, cm, h0, y, hout, Bt, L, D, N, chunk, stream);
}
