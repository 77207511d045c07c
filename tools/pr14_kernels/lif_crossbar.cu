// K5 `lif_crossbar_step`: one neuromorphic tile executing a cluster, the
// crossbar current fused with the leaky-integrate-and-fire update.
//
// Replaces src/repro/kernels/lif_crossbar.py::lif_crossbar_step (Pallas body
// `_lif_kernel`):
//   I[b,j]   = sum_k s[b,k] * W[k,j]            (float32)
//   v'       = leak * v[b,j] + I[b,j]
//   spike    = v' >= v_th
//   v_out    = spike ? v_reset : v'
// s (B, n_in), W (n_in, n_out), v (B, n_out): contiguous row-major float32.
//
// Design.  The TPU kernel runs the accumulate on the MXU over (8,128)
// blocks with a VMEM accumulator carried along a sequential k grid axis.
// Here the kernel is a tiled GEMM with the LIF update as its epilogue: one
// block owns a BB x BN output tile, each thread one (b, j); 32-deep slabs of
// s and W are staged through shared memory and every thread accumulates in
// increasing k with explicit round-to-nearest products and adds (and the
// global --fmad=false), so the result equals ref.lif_crossbar_step_ref bit
// for bit.  B, n_in and n_out are masked in the kernel; no caller pads.
// Bound: the path's calls are (8,128) x (128,128), 80 KB of operands and
// 0.26 MFLOP, far under a microsecond by bytes or operations, so the launch
// itself bounds it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BB = 8;   // batch rows per block
constexpr int BN = 64;  // output columns per block
constexpr int TK = 32;  // depth of one shared-memory slab
constexpr int THREADS = BB * BN;

__global__ void lif_crossbar_kernel(const float* __restrict__ s,
                                    const float* __restrict__ w,
                                    const float* __restrict__ v,
                                    float* __restrict__ out_s,
                                    float* __restrict__ out_v, int B, int n_in,
                                    int n_out, float leak, float v_th,
                                    float v_reset) {
  __shared__ float ss[BB][TK];
  __shared__ float ws[TK][BN];
  const int tx = threadIdx.x;  // column within the tile
  const int ty = threadIdx.y;  // batch row within the tile
  const int tid = ty * BN + tx;
  const int row0 = blockIdx.y * BB;
  const int col0 = blockIdx.x * BN;
  float acc = 0.0f;
  for (int k0 = 0; k0 < n_in; k0 += TK) {
    for (int i = tid; i < BB * TK; i += THREADS) {
      const int r = row0 + i / TK, k = k0 + i % TK;
      ss[i / TK][i % TK] = (r < B && k < n_in) ? s[(int64_t)r * n_in + k] : 0.0f;
    }
    for (int i = tid; i < TK * BN; i += THREADS) {
      const int k = k0 + i / BN, c = col0 + i % BN;
      ws[i / BN][i % BN] = (k < n_in && c < n_out) ? w[(int64_t)k * n_out + c] : 0.0f;
    }
    __syncthreads();
    const int depth = min(TK, n_in - k0);
    for (int kk = 0; kk < depth; ++kk)
      acc = __fadd_rn(acc, __fmul_rn(ss[ty][kk], ws[kk][tx]));
    __syncthreads();
  }
  const int r = row0 + ty, c = col0 + tx;
  if (r >= B || c >= n_out) return;
  const int64_t o = (int64_t)r * n_out + c;
  const float vn = __fadd_rn(__fmul_rn(leak, v[o]), acc);
  const bool fired = vn >= v_th;
  out_s[o] = fired ? 1.0f : 0.0f;
  out_v[o] = fired ? v_reset : vn;
}

}  // namespace

// Plain C entry for ctypes; returns the cudaError_t of the launch.
extern "C" int lif_crossbar_step(const float* s, const float* w, const float* v,
                                 float* out_s, float* out_v, int B, int n_in,
                                 int n_out, float leak, float v_th,
                                 float v_reset, cudaStream_t stream) {
  const int row_blocks = (B + BB - 1) / BB;
  if (row_blocks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 threads(BN, BB);
  const dim3 blocks((n_out + BN - 1) / BN, row_blocks);
  lif_crossbar_kernel<<<blocks, threads, 0, stream>>>(
      s, w, v, out_s, out_v, B, n_in, n_out, leak, v_th, v_reset);
  return (int)cudaGetLastError();
}
