// K5 `lif_crossbar_step`: neuromorphic tiles executing their clusters, the
// crossbar current fused with the leaky-integrate-and-fire update, for a
// stack of G independent blocks in one launch.
//
// Replaces src/repro/kernels/lif_crossbar.py::lif_crossbar_step (Pallas body
// `_lif_kernel`), with the reference's `vmap` over blocks written out as a
// batch dimension: for every block g,
//   I[g,b,j] = sum_k s[g,b,k] * W[g,k,j]            (float32)
//   v'       = leak * v[g,b,j] + I[g,b,j]
//   spike    = v' >= v_th
//   v_out    = spike ? v_reset : v'
// s (G, B, n_in), W (G, n_in, n_out), v (G, B, n_out): contiguous row-major
// float32.  A single (B, n_in) x (n_in, n_out) call is the G = 1 launch.
//
// Bound on this card.  The work is a stream over W: at the SNN path's stack
// (G = 1013 blocks of (8,128) x (128,128)) W is 66 MB of the 83 MB the step
// must move, against 4 flops a W element, so it sits far under the float32
// ridge and its bound is bytes / 3.35 TB/s (about 25 us).
//
// Design.  One block owns one g and NB output columns, and each thread
// one column of RPT rows of a row tile of BB = 8, their accumulators in
// registers; W is read from device memory once per row tile (once at the
// path's B = 8).  W and s move through a STAGES-deep ring of KS-row slabs
// in shared memory by cp.async (16-byte copies where n_out is a multiple
// of 4 and W is 16-byte aligned, 4-byte copies otherwise, zero-filled past
// the ragged edges), so several slabs per block are in flight while the
// block computes on an earlier one.  s is staged transposed (sT[k][b]) and
// read as broadcast vectors.  The split of the rows adapts to the launch:
// when the stack gives every SM several blocks (the path's G = 1013 gives
// 7.7), a thread keeps all 8 rows (RPT = 8, 128 threads, at most 64
// registers so that 8 blocks fit an SM and the whole stack runs in one
// wave), which reads each W element from shared memory once; when there
// are fewer blocks than SMs (the example's G = 1 call), nothing else hides
// a block's latency, so 2 threads share a column, 4 rows each (RPT = 4,
// 256 threads), and each scheduler has 2 warps to interleave.  B, n_in and
// n_out are masked in the kernel; no caller pads.  Ragged B loops over row
// tiles inside the block.
//
// Not taken: cp.async.bulk / TMA into the ring behind mbarriers needs
// 16-byte aligned rows, so the ragged shapes (n_out = 129) would still need
// this loader, and with every thread consuming every slab the wait_group +
// __syncthreads pair does the mbarrier's job; a register prefetch of W rows
// has no room beside 8 accumulators under the 64-register cap that keeps 8
// blocks an SM.  Measured and dropped (tools/relax_lif_ab.py): a 16-slab
// ring for small stacks (no faster at G = 1: the block's serial walk over
// its slabs, not load latency, bounds that call), and 16-row slabs.
//
// Rounding.  Each output accumulates in increasing k with one
// round-to-nearest product and one round-to-nearest add per term (and the
// library is built with --fmad=false); k is never split, the parallelism
// comes from G x B x n_out outputs.  So the result equals
// ref.lif_crossbar_step_ref bit for bit.  Tensor cores are out: TF32 rounds
// W to 10 mantissa bits, and an mma accumulator sums in its own order and
// truncates.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BB = 8;       // rows of a row tile
constexpr int NB = 128;     // output columns per block
constexpr int KS = 8;       // W rows per slab
constexpr int STAGES = 3;   // slabs in the ring

struct Stage {
  float w[KS][NB];
  float4 s[KS][BB / 4];     // sT[k][b]
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy 4 or 16 bytes; valid = false zero-fills the destination
__device__ __forceinline__ void cp4(void* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp16(void* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// slab i of W (rows k0..k0+KS, columns col0..col0+NB) and of sT into its
// stage, then close the copy group (an empty group past the last slab
// keeps the count)
template <bool VEC, int THREADS>
__device__ __forceinline__ void issue_slab(Stage* ring, int i, int n_slabs, const float* wg,
                                           const float* sg, int r0, int col0, int B,
                                           int n_in, int n_out) {
  const int tid = threadIdx.x;
  if (i < n_slabs) {
    Stage& st = ring[i % STAGES];
    const int k0 = i * KS;
    if (VEC) {
#pragma unroll
      for (int p = tid; p < KS * NB / 4; p += THREADS) {
        const int kk = p / (NB / 4), cc = col0 + 4 * (p % (NB / 4));
        const bool ok = k0 + kk < n_in && cc < n_out;
        cp16(&st.w[kk][cc - col0], ok ? wg + (int64_t)(k0 + kk) * n_out + cc : wg, ok);
      }
    } else {
#pragma unroll
      for (int p = tid; p < KS * NB; p += THREADS) {
        const int kk = p / NB, c = col0 + p % NB;
        const bool ok = k0 + kk < n_in && c < n_out;
        cp4(&st.w[kk][p % NB], ok ? wg + (int64_t)(k0 + kk) * n_out + c : wg, ok);
      }
    }
    for (int p = tid; p < KS * BB; p += THREADS) {
      const int kk = p % KS, b = p / KS;
      const bool ok = k0 + kk < n_in && r0 + b < B;
      cp4(reinterpret_cast<float*>(&st.s[kk][0]) + b,
          ok ? sg + (int64_t)(r0 + b) * n_in + k0 + kk : sg, ok);
    }
  }
  cp_commit();
}

// acc[r] += s[row0 + r, k] * W[k, col] for this thread's RPT rows (a
// multiple of 4), each product and add rounded
template <int RPT>
__device__ __forceinline__ void add_term(float (&acc)[RPT], const Stage& st, int kk, int col,
                                         int row0) {
  const float wk = st.w[kk][col];
#pragma unroll
  for (int q = 0; q < RPT / 4; ++q) {
    const float4 x = st.s[kk][row0 / 4 + q];
    const int r = 4 * q;
    acc[r] = __fadd_rn(acc[r], __fmul_rn(x.x, wk));
    acc[r + 1] = __fadd_rn(acc[r + 1], __fmul_rn(x.y, wk));
    acc[r + 2] = __fadd_rn(acc[r + 2], __fmul_rn(x.z, wk));
    acc[r + 3] = __fadd_rn(acc[r + 3], __fmul_rn(x.w, wk));
  }
}

template <bool VEC, int RPT>
__global__ void __launch_bounds__(NB * BB / RPT, RPT == BB ? 8 : 1) lif_crossbar_kernel(
    const float* __restrict__ s, const float* __restrict__ w, const float* __restrict__ v,
    float* __restrict__ out_s, float* __restrict__ out_v, int B, int n_in, int n_out,
    float leak, float v_th, float v_reset) {
  constexpr int THREADS = NB * BB / RPT;
  __shared__ Stage ring[STAGES];
  const int col = threadIdx.x % NB;          // this thread's column in the block
  const int row0 = threadIdx.x / NB * RPT;   // and its first row in the row tile
  const int64_t g = blockIdx.x;
  const int col0 = blockIdx.y * NB;
  const int c = col0 + col;
  const float* wg = w + g * n_in * (int64_t)n_out;
  const float* sg = s + g * B * (int64_t)n_in;
  const int n_slabs = (n_in + KS - 1) / KS;

  for (int r0 = 0; r0 < B; r0 += BB) {
    float acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i)
      issue_slab<VEC, THREADS>(ring, i, n_slabs, wg, sg, r0, col0, B, n_in, n_out);
    // unrolled by STAGES, this loop hoisted shared loads into up to 254 registers
#pragma unroll 1
    for (int i = 0; i < n_slabs; ++i) {
      cp_wait<STAGES - 2>();   // this thread's copies of slab i have landed
      __syncthreads();         // everyone's have, and slab i-1 is consumed
      issue_slab<VEC, THREADS>(ring, i + STAGES - 1, n_slabs, wg, sg, r0, col0, B, n_in, n_out);
      const Stage& st = ring[i % STAGES];
      const int depth = min(KS, n_in - i * KS);
      if (depth == KS) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) add_term<RPT>(acc, st, kk, col, row0);
      } else {
        for (int kk = 0; kk < depth; ++kk) add_term<RPT>(acc, st, kk, col, row0);
      }
    }
    __syncthreads();   // the ring is free before the next row tile fills it

    if (c < n_out) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = r0 + row0 + r;
        if (row >= B) break;
        const int64_t o = (g * B + row) * (int64_t)n_out + c;
        const float vn = __fadd_rn(__fmul_rn(leak, v[o]), acc[r]);
        const bool fired = vn >= v_th;
        out_s[o] = fired ? 1.0f : 0.0f;
        out_v[o] = fired ? v_reset : vn;
      }
    }
  }
}

template <int RPT>
void launch(const float* s, const float* w, const float* v, float* out_s, float* out_v,
            dim3 blocks, int B, int n_in, int n_out, float leak, float v_th, float v_reset,
            cudaStream_t stream) {
  constexpr int THREADS = NB * BB / RPT;
  if (n_out % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    lif_crossbar_kernel<true, RPT><<<blocks, THREADS, 0, stream>>>(
        s, w, v, out_s, out_v, B, n_in, n_out, leak, v_th, v_reset);
  } else {
    lif_crossbar_kernel<false, RPT><<<blocks, THREADS, 0, stream>>>(
        s, w, v, out_s, out_v, B, n_in, n_out, leak, v_th, v_reset);
  }
}

}  // namespace

// Plain C entry for ctypes; returns the cudaError_t of the launch.  G blocks
// on blockIdx.x, column blocks on blockIdx.y.
extern "C" int lif_crossbar_step(const float* s, const float* w, const float* v,
                                 float* out_s, float* out_v, int G, int B, int n_in,
                                 int n_out, float leak, float v_th, float v_reset,
                                 cudaStream_t stream) {
  const int col_blocks = (n_out + NB - 1) / NB;
  if (G < 1 || col_blocks > 65535) return (int)cudaErrorInvalidValue;
  int dev, n_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks(G, col_blocks);
  if ((int64_t)G * col_blocks < n_sm) {
    launch<4>(s, w, v, out_s, out_v, blocks, B, n_in, n_out, leak, v_th, v_reset, stream);
  } else {
    launch<BB>(s, w, v, out_s, out_v, blocks, B, n_in, n_out, leak, v_th, v_reset, stream);
  }
  return (int)cudaGetLastError();
}
