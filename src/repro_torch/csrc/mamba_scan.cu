// K7 `mamba_chunk_scan`: the selective state-space (S6) scan of every chunk
// of a sequence from its own initial state; its states-only launch; and the
// chunk combine between the two.
//
// Replaces src/repro/kernels/mamba_scan.py::mamba_chunk_scan (Pallas body
// `_scan_kernel`).  Per chunk, per channel d and state n, for each step t:
//   h[d,n] = exp(dt[t,d] * a[d,n]) * h[d,n] + (dt[t,d] * x[t,d]) * B[t,n]
//   y[t,d] = sum_n h[d,n] * C[t,n]
// x, dt (Bt, L, D) and B, C (Bt, L, N) in one type T (float or bf16);
// a (D, N), h0 and h_out (Bt, n_chunks, D, N) float32; y (Bt, L, D) in T.
// ops.mamba_scan runs the states-only launch from zero states, the combine,
// then the full launch from the combined states.
//
// Design.  The TPU kernel keeps a (128, N) channel block in VMEM and walks
// the chunk with a fori_loop.  Here the grid is (D/BD, n_chunks, Bt) and
// each thread owns one channel d: its N states and its row of a live in
// registers (N a template parameter), the chunk's B_t and C_t (chunk x N)
// are staged once in shared memory, and x_t and dt_t
// are read coalesced along d.  Steps past L (a ragged last chunk) and
// channels past D are masked here; no caller pads.
// - The full launch rounds every product and add to nearest in the order
//   of ref.mamba_chunk_scan_ref (y sums over n in increasing order) with
//   the full-precision expf, so it equals its plain version bit for bit.
//   That expf is about ten FP32 instructions beside its MUFU.EX2, so this
//   launch is bound by the FP32 pipes' issue, about 16 instructions a
//   (t, d, n) term: about 2.3 ms at jamba's 32k-token call (bf16, D = 8192,
//   N = 16), where the bytes of x, dt, y and the states take 0.56 ms.
// - The states-only launch (y == NULL: no C, no y, no h.C sum; h0 == NULL:
//   zero states) runs the same arithmetic, so its states equal the full
//   launch's bit for bit.  It keeps the exact expf too: decayed by
//   ex2.approx, the states land an ulp or so away, and the bf16 y that the
//   full launch rounds from the chunk states combined from them flips often
//   enough to read most of SCAN_TOL (tools/scan_bmm_ab.py, variant ex2).
//
// The combine: H(0) = 0, H(c) = exp(a * sum of chunk c-1's dt) * H(c-1) +
// S(c-1), with S the states-only launch's output.  A block owns CD channels
// of one batch row and walks the chunks in order: its threads first sum
// each chunk's dt in increasing t into shared memory (CG chunks at a time,
// coalesced along d), then a thread per (d, n) carries H through the
// chunks with the full-precision expf.  Bound: the bytes of dt, S and H,
// 0.81 GB at jamba's 32k call, 0.24 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BD = 128;           // channels per scan block, one per thread
constexpr int CD = 32;            // channels per combine block
constexpr int CG = 64;            // chunks whose dt sums a combine block stages at a time

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

template <int N, typename T, bool WRITE_Y>
__global__ void __launch_bounds__(BD)
mamba_chunk_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                        const float* __restrict__ a, const T* __restrict__ bm,
                        const T* __restrict__ cm, const float* __restrict__ h0,
                        T* __restrict__ y, float* __restrict__ hout, int L,
                        int D, int chunk, int n_chunks) {
  extern __shared__ float smem[];
  float* bs = smem;              // (chunk, N)
  float* cs = smem + chunk * N;  // (chunk, N), WRITE_Y only
  const int d = blockIdx.x * BD + threadIdx.x;
  const int ci = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int t0 = ci * chunk;
  const int steps = min(chunk, L - t0);
  const int64_t row0 = bi * L + t0;  // first (b, t) of the chunk
  for (int i = threadIdx.x; i < steps * N; i += BD) {
    bs[i] = to_f(bm[row0 * N + i]);
    if (WRITE_Y) cs[i] = to_f(cm[row0 * N + i]);
  }
  __syncthreads();
  if (d >= D) return;

  float av[N], h[N];
  const int64_t hoff = ((bi * n_chunks + ci) * (int64_t)D + d) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = a[(int64_t)d * N + n];
    h[n] = h0 != nullptr ? h0[hoff + n] : 0.0f;
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
      if (WRITE_Y) {
        const float p = __fmul_rn(h[n], ct[n]);
        yt = n == 0 ? p : __fadd_rn(yt, p);
      }
    }
    if (WRITE_Y) yp[(int64_t)t * D] = from_f<T>(yt);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) hout[hoff + n] = h[n];
}

template <int N, typename T>
__global__ void __launch_bounds__(CD * N)
mamba_chunk_combine_kernel(const T* __restrict__ dt, const float* __restrict__ a,
                           const float* __restrict__ s_local, float* __restrict__ h_init,
                           int L, int D, int chunk, int n_chunks) {
  __shared__ float dsum[CG][CD];
  const int64_t bi = blockIdx.y;
  const int d0 = blockIdx.x * CD;
  // carrying H: channel d0 + dl, state n
  const int dl = threadIdx.x / N, n = threadIdx.x % N;
  const int d = d0 + dl;
  const bool live = d < D;
  const float an = live ? a[(int64_t)d * N + n] : 0.0f;
  // summing dt: channel d0 + sl, chunks sr, sr + N, ... of each group
  const int sl = threadIdx.x % CD, sr = threadIdx.x / CD;
  float h = 0.0f;  // H(c)
  for (int c0 = 0; c0 < n_chunks - 1; c0 += CG) {
    const int cn = min(CG, n_chunks - 1 - c0);
    __syncthreads();  // the previous group's sums are read
    for (int cc = sr; cc < cn; cc += N) {
      float s = 0.0f;
      if (d0 + sl < D) {
        const T* p = dt + (bi * L + (int64_t)(c0 + cc) * chunk) * D + d0 + sl;
#pragma unroll 8
        for (int t = 0; t < chunk; ++t) s = __fadd_rn(s, to_f(p[(int64_t)t * D]));
      }
      dsum[cc][sl] = s;
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int cc = 0; cc < cn; ++cc) {
        const int64_t off = ((bi * n_chunks + c0 + cc) * (int64_t)D + d) * N + n;
        h_init[off] = h;
        const float decay = expf(__fmul_rn(dsum[cc][dl], an));
        h = __fadd_rn(__fmul_rn(decay, h), s_local[off]);
      }
    }
  }
  if (live) h_init[((bi * n_chunks + n_chunks - 1) * (int64_t)D + d) * N + n] = h;
}

template <int N, typename T, bool WRITE_Y>
int launch(const void* x, const void* dt, const float* a, const void* bm,
           const void* cm, const float* h0, void* y, float* hout, int Bt, int L,
           int D, int chunk, cudaStream_t stream) {
  const int n_chunks = (L + chunk - 1) / chunk;
  if (n_chunks > 65535 || Bt > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (WRITE_Y ? 2 : 1) * (size_t)chunk * N * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 blocks((D + BD - 1) / BD, n_chunks, Bt);
  mamba_chunk_scan_kernel<N, T, WRITE_Y><<<blocks, BD, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a,
      static_cast<const T*>(bm), static_cast<const T*>(cm), h0,
      static_cast<T*>(y), hout, L, D, chunk, n_chunks);
  return (int)cudaGetLastError();
}

template <int N, typename T>
int dispatch_mode(const void* x, const void* dt, const float* a, const void* bm,
                  const void* cm, const float* h0, void* y, float* hout, int Bt, int L,
                  int D, int chunk, cudaStream_t stream) {
  if (y == nullptr)
    return launch<N, T, false>(x, dt, a, bm, cm, h0, y, hout, Bt, L, D, chunk, stream);
  return launch<N, T, true>(x, dt, a, bm, cm, h0, y, hout, Bt, L, D, chunk, stream);
}

template <typename T>
int dispatch_n(const void* x, const void* dt, const float* a, const void* bm,
               const void* cm, const float* h0, void* y, float* hout, int Bt, int L,
               int D, int N, int chunk, cudaStream_t stream) {
  switch (N) {
    case 8:
      return dispatch_mode<8, T>(x, dt, a, bm, cm, h0, y, hout, Bt, L, D, chunk, stream);
    case 16:
      return dispatch_mode<16, T>(x, dt, a, bm, cm, h0, y, hout, Bt, L, D, chunk, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int N, typename T>
int launch_combine(const void* dt, const float* a, const float* s_local, float* h_init,
                   int Bt, int L, int D, int chunk, cudaStream_t stream) {
  const int n_chunks = (L + chunk - 1) / chunk;
  if (Bt > 65535) return (int)cudaErrorInvalidValue;
  const dim3 blocks((D + CD - 1) / CD, Bt);
  mamba_chunk_combine_kernel<N, T><<<blocks, CD * N, 0, stream>>>(
      static_cast<const T*>(dt), a, s_local, h_init, L, D, chunk, n_chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int combine_n(const void* dt, const float* a, const float* s_local, float* h_init, int Bt,
              int L, int D, int N, int chunk, cudaStream_t stream) {
  switch (N) {
    case 8:
      return launch_combine<8, T>(dt, a, s_local, h_init, Bt, L, D, chunk, stream);
    case 16:
      return launch_combine<16, T>(dt, a, s_local, h_init, Bt, L, D, chunk, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entries for ctypes; each returns the cudaError_t of its launch.
// y NULL: states only (cm unused); h0 NULL: every chunk starts from zero.
extern "C" int mamba_chunk_scan(const void* x, const void* dt, const float* a,
                                const void* bm, const void* cm, const float* h0,
                                void* y, float* hout, int is_bf16, int Bt, int L, int D,
                                int N, int chunk, cudaStream_t stream) {
  if (L <= 0 || D <= 0 || Bt <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  if (y != nullptr && cm == nullptr) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch_n<__nv_bfloat16>(x, dt, a, bm, cm, h0, y, hout, Bt, L, D, N, chunk,
                                     stream);
  return dispatch_n<float>(x, dt, a, bm, cm, h0, y, hout, Bt, L, D, N, chunk, stream);
}

extern "C" int mamba_chunk_combine(const void* dt, const float* a, const float* s_local,
                                   float* h_init, int is_bf16, int Bt, int L, int D, int N,
                                   int chunk, cudaStream_t stream) {
  if (L <= 0 || D <= 0 || Bt <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return combine_n<__nv_bfloat16>(dt, a, s_local, h_init, Bt, L, D, N, chunk, stream);
  return combine_n<float>(dt, a, s_local, h_init, Bt, L, D, N, chunk, stream);
}
