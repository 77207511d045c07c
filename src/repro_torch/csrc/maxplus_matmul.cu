// K2 `maxplus_bmm` and K3 `maxplus_bmv`: float32 (max,+) semiring
// products over a stack of G matrices.
//
// K2 replaces src/repro/kernels/maxplus_matmul.py::maxplus_bmm (and, as its
// G = 1 launch, ::maxplus_matmul):
//   C[g,i,j] = max_k A[g,i,k] + B[g,k,j]
// K3 replaces src/repro/kernels/maxplus_matmul.py::maxplus_bmv:
//   y[g,i] = max_k A[g,i,k] + x[g,k]
// All arrays are contiguous row-major float32; -inf is the neutral element.
// Each term is one rounded add and max is exact, so any tiling and any k
// order give the plain version's result bit for bit.
//
// K2 design.  The TPU kernel streams (128,128) VMEM blocks through a
// sequential K grid axis with a scratch accumulator.  Here a block owns a
// BM x BN output tile of one matrix g and walks K in TK-deep slabs that
// cp.async brings into a ring of STAGES slabs in shared memory, so the
// next slabs' loads fly while this one is used.  A's slab stays row-major
// (a[m][k], rows padded by 4 floats so the rows a warp reads land in
// distinct banks) and B's too (b[k][n]); each thread keeps a TM x TN tile
// of accumulators (rows ty + TY*i, columns 4tx..4tx+3 of each 4TX-wide
// part) fed by 128-bit shared loads: at 8 x 4, per 4 k, 8 of A and 4 of B
// for 256 FP32 instructions.  A ragged edge or the K tail is filled with
// -inf by plain stores instead of copies, so no caller pads.  The tile
// shape was swept on the card (tools/scan_bmm_ab.py): 64 x 64 tiles of
// 8 x 4 a thread (128 threads, 576 blocks at (64,192,192)^2, all resident
// at once) ran fastest; 8 x 8 a thread (168 registers) and larger tiles
// ran slower, and so did deeper or wider slabs.
// Bound: a term is an FADD and an FMNMX on the FP32 pipes (no tensor-core
// path exists for (max,+)); Hopper has no packed or three-operand FP32 max.
// Two FADDs a term in place of the pair run no faster (variant
// diag_addonly), so the FMNMX's half rate is not what holds it.
//
// K3 design.  One warp per output row (g,i): lanes stride along k, so each
// load of A is coalesced, and a shuffle tree takes the max across the warp.
// K2's C entry takes N = 1 (K4's matvec call) to this body too.
// Bound: the bytes of A over 3.35 TB/s (x and y are n times smaller).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output rows of a block tile
constexpr int BN = 64;          // output columns of a block tile
constexpr int TK = 16;          // k of a slab
constexpr int STAGES = 3;       // slabs in the ring
constexpr int TM = 8, TN = 4;   // outputs a thread: rows, columns
constexpr int TX = BN / TN;     // threads along the columns
constexpr int TY = BM / TM;     // threads along the rows
constexpr int THREADS = TX * TY;
constexpr int AS = TK + 4;      // row stride of the A slab, in floats
static_assert(TK % 4 == 0 && TN % 4 == 0 && BN == TN * TX && BM == TM * TY, "tile shape");

struct Stage {
  float a[BM][AS];
  float b[TK][BN];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// slab i of A (rows row0.., k0..k0+TK) and B (k0.., columns col0..) into
// its stage, then close the copy group (empty past the last slab, so that
// the wait count holds); out-of-range elements are stored as -inf
template <bool VEC>
__device__ __forceinline__ void issue_slab(Stage* ring, int i, int n_slabs, const float* A,
                                           const float* B, int row0, int col0, int M, int N,
                                           int K) {
  if (i < n_slabs) {
    Stage& st = ring[i % STAGES];
    const int k0 = i * TK;
    if (VEC) {  // K and N multiples of 4: a 4-float chunk is all in range or all out
      for (int idx = threadIdx.x; idx < BM * TK / 4; idx += THREADS) {
        const int m = idx / (TK / 4), k = 4 * (idx % (TK / 4));
        float* dst = &st.a[m][k];
        if (row0 + m < M && k0 + k < K)
          cp16(dst, A + (int64_t)(row0 + m) * K + k0 + k);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      }
      for (int idx = threadIdx.x; idx < TK * BN / 4; idx += THREADS) {
        const int k = idx / (BN / 4), n = 4 * (idx % (BN / 4));
        float* dst = &st.b[k][n];
        if (k0 + k < K && col0 + n < N)
          cp16(dst, B + (int64_t)(k0 + k) * N + col0 + n);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      }
    } else {
      for (int idx = threadIdx.x; idx < BM * TK; idx += THREADS) {
        const int m = idx / TK, k = idx % TK;
        if (row0 + m < M && k0 + k < K)
          cp4(&st.a[m][k], A + (int64_t)(row0 + m) * K + k0 + k);
        else
          st.a[m][k] = -INFINITY;
      }
      for (int idx = threadIdx.x; idx < TK * BN; idx += THREADS) {
        const int k = idx / BN, n = idx % BN;
        if (k0 + k < K && col0 + n < N)
          cp4(&st.b[k][n], B + (int64_t)(k0 + k) * N + col0 + n);
        else
          st.b[k][n] = -INFINITY;
      }
    }
  }
  cp_commit();
}

__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
maxplus_bmm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ C, int M, int N, int K) {
  extern __shared__ float4 smem4[];
  Stage* ring = reinterpret_cast<Stage*>(smem4);
  const int64_t g = blockIdx.z;
  A += g * (int64_t)M * K;
  B += g * (int64_t)K * N;
  C += g * (int64_t)M * N;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int n_slabs = (K + TK - 1) / TK;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = -INFINITY;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue_slab<VEC>(ring, i, n_slabs, A, B, row0, col0, M, N, K);

#pragma unroll 1
  for (int i = 0; i < n_slabs; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // slab i is in; every thread is done with slab i - 1's stage
    issue_slab<VEC>(ring, i + STAGES - 1, n_slabs, A, B, row0, col0, M, N, K);
    const Stage& st = ring[i % STAGES];
#pragma unroll
    for (int kq = 0; kq < TK; kq += 4) {
      float4 av[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r)
        av[r] = *reinterpret_cast<const float4*>(&st.a[ty + TY * r][kq]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float bv[TN];
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {  // columns 4tx.. of each 4TX-wide part
          const float4 b4 = *reinterpret_cast<const float4*>(&st.b[kq + q][4 * (tx + TX * h)]);
          bv[4 * h] = b4.x, bv[4 * h + 1] = b4.y, bv[4 * h + 2] = b4.z, bv[4 * h + 3] = b4.w;
        }
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float a = lane_of(av[r], q);
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[r][j] = fmaxf(acc[r][j], __fadd_rn(a, bv[j]));
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = row0 + ty + TY * r;
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int col = col0 + 4 * (tx + TX * h);
      float* out = C + (int64_t)row * N + col;
      if (VEC) {
        if (col < N)
          *reinterpret_cast<float4*>(out) = make_float4(acc[r][4 * h], acc[r][4 * h + 1],
                                                         acc[r][4 * h + 2], acc[r][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < N) out[j] = acc[r][4 * h + j];
      }
    }
  }
}

template <bool VEC>
int launch_bmm(const float* A, const float* B, float* C, int G, int M, int N, int K,
               cudaStream_t stream) {
  const size_t smem = STAGES * sizeof(Stage);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        maxplus_bmm_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 blocks((N + BN - 1) / BN, (M + BM - 1) / BM, G);
  maxplus_bmm_kernel<VEC><<<blocks, THREADS, smem, stream>>>(A, B, C, M, N, K);
  return (int)cudaGetLastError();
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
extern "C" int maxplus_bmv(const float* A, const float* x, float* y, int G,
                           int M, int K, cudaStream_t stream) {
  const int64_t rows = (int64_t)G * M;
  const int threads = 256;  // 8 warps, one output row each
  const unsigned blocks = (unsigned)((rows * 32 + threads - 1) / threads);
  maxplus_bmv_kernel<<<blocks, threads, 0, stream>>>(A, x, y, rows, M, K);
  return (int)cudaGetLastError();
}

extern "C" int maxplus_bmm(const float* A, const float* B, float* C, int G,
                           int M, int N, int K, cudaStream_t stream) {
  if (G > 65535) return (int)cudaErrorInvalidValue;
  // a (G,K,1) B is a (G,K) vector and a (G,M,1) C a (G,M) one: K3's matvec
  if (N == 1) return maxplus_bmv(A, B, C, G, M, K, stream);
  const bool vec = K % 4 == 0 && N % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B) |
                     reinterpret_cast<uintptr_t>(C)) & 15) == 0;
  return vec ? launch_bmm<true>(A, B, C, G, M, N, K, stream)
             : launch_bmm<false>(A, B, C, G, M, N, K, stream);
}
