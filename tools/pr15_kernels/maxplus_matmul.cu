// K2 `maxplus_bmm` and K3 `maxplus_bmv`: float32 (max,+) semiring
// products over a stack of G matrices.
//
// K2 replaces src/repro/kernels/maxplus_matmul.py::maxplus_bmm (and, as its
// G = 1 launch, ::maxplus_matmul):
//   C[g,i,j] = max_k A[g,i,k] + B[g,k,j]
// K3 replaces src/repro/kernels/maxplus_matmul.py::maxplus_bmv:
//   y[g,i] = max_k A[g,i,k] + x[g,k]
// All arrays are contiguous row-major float32; -inf is the neutral element.
//
// K2 design.  The TPU kernel streams (128,128) VMEM blocks through a
// sequential K grid axis with a scratch accumulator.  Here one block owns a
// 64x64 output tile of one matrix g; 256 threads each keep a 4x4 register
// micro-tile of accumulators, and the K loop runs inside the block over
// 16-deep slabs of A and B staged in shared memory.  Ragged edges are
// masked at load time with -inf, so no caller pads to a block multiple.
// Bound: G*M*N*K adds plus as many maxes on the FP32 CUDA cores (no tensor
// core path exists for (max,+)); each term is one rounded add and max is
// exact, so K2 equals the plain version bit for bit in any order.
//
// K3 design.  One warp per output row (g,i): lanes stride along k, so each
// load of A is coalesced, and a shuffle tree takes the max across the warp.
// Bound: the bytes of A over 3.35 TB/s (x and y are n times smaller).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int TK = 16;
constexpr int THREADS = 256;  // 16 x 16, each 4 x 4 outputs

__global__ void maxplus_bmm_kernel(const float* __restrict__ A,
                                   const float* __restrict__ B,
                                   float* __restrict__ C, int M, int N, int K) {
  __shared__ float As[TK][TM];
  __shared__ float Bs[TK][TN];
  const int64_t g = blockIdx.z;
  A += g * (int64_t)M * K;
  B += g * (int64_t)K * N;
  C += g * (int64_t)M * N;
  const int tx = threadIdx.x;  // 0..15, output columns tx + 16j
  const int ty = threadIdx.y;  // 0..15, output rows ty + 16i
  const int tid = ty * 16 + tx;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = -INFINITY;

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int idx = tid; idx < TM * TK; idx += THREADS) {
      const int m = idx / TK, kk = idx % TK;
      const int gm = row0 + m, gk = k0 + kk;
      As[kk][m] = (gm < M && gk < K) ? A[(int64_t)gm * K + gk] : -INFINITY;
    }
    for (int idx = tid; idx < TK * TN; idx += THREADS) {
      const int kk = idx / TN, n = idx % TN;
      const int gk = k0 + kk, gn = col0 + n;
      Bs[kk][n] = (gk < K && gn < N) ? B[(int64_t)gk * N + gn] : -INFINITY;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaxf(acc[i][j], __fadd_rn(a[i], b[j]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N) C[(int64_t)r * N + c] = acc[i][j];
    }
  }
}

__global__ void maxplus_bmv_kernel(const float* __restrict__ A,
                                   const float* __restrict__ x,
                                   float* __restrict__ y, int64_t rows, int M,
                                   int K) {
  const int lane = threadIdx.x & 31;
  const int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (r >= rows) return;  // whole warps exit together
  const int64_t g = r / M;
  const float* a = A + r * K;
  const float* xv = x + g * K;
  float acc = -INFINITY;
  for (int k = lane; k < K; k += 32) acc = fmaxf(acc, __fadd_rn(a[k], xv[k]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = fmaxf(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) y[r] = acc;
}

}  // namespace

// Plain C entries for ctypes; each returns the cudaError_t of its launch.
extern "C" int maxplus_bmm(const float* A, const float* B, float* C, int G,
                           int M, int N, int K, cudaStream_t stream) {
  if (G > 65535) return (int)cudaErrorInvalidValue;
  const dim3 threads(16, 16);
  const dim3 blocks((N + TN - 1) / TN, (M + TM - 1) / TM, G);
  maxplus_bmm_kernel<<<blocks, threads, 0, stream>>>(A, B, C, M, N, K);
  return (int)cudaGetLastError();
}

extern "C" int maxplus_bmv(const float* A, const float* x, float* y, int G,
                           int M, int K, cudaStream_t stream) {
  const int64_t rows = (int64_t)G * M;
  const int threads = 256;  // 8 warps, one output row each
  const unsigned blocks = (unsigned)((rows * 32 + threads - 1) / threads);
  maxplus_bmv_kernel<<<blocks, threads, 0, stream>>>(A, x, y, rows, M, K);
  return (int)cudaGetLastError();
}
