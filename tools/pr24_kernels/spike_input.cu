// `spike_input`: the synaptic input of one step of the LIF spike recording
// (core/lif.py), in a fixed order.
//
// It stands where src/repro/core/lif.py::_simulate calls
// jax.ops.segment_sum (not a Pallas kernel):
//   i[v] = sum over v's incoming synapses e of w[e] * s[pre[e]]
// over a destination-sorted CSR (indptr, pre, w), whose synapses keep, per
// neuron, their order in the SNN's synapse list.  Every product rounds once
// and the sum starts from 0 and adds in synapse order (__fmul_rn and
// __fadd_rn), as the CPU's index_add_ does, so the result is the same bit
// for bit on the card, on the host and from run to run: float atomics
// would add in a different order each run, and one spike flipped at the
// threshold changes the partitioner's clustering.
//
// Design.  One warp per neuron: its lanes load 32 synapses at a time,
// coalesced (pre, w, then the gather of s), each forms its product, and the
// warp adds the 32 products in order from lane 0 up by shuffles; every lane
// keeps the same running sum, lane 0 stores it.  (A thread per neuron
// walking its synapses alone took 1.5 times as long on an H100 over
// HeartClass's synapses.)
// Bound: the bytes of pre and w (8 a synapse) and of indptr and i; the
// gathers of s (4 bytes a synapse) come from the L2, where s lives.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
spike_input_warp(const int* __restrict__ indptr, const int* __restrict__ pre,
                 const float* __restrict__ w, const float* __restrict__ s,
                 float* __restrict__ out, int n) {
  const int lane = threadIdx.x & 31;
  const int64_t v = ((int64_t)blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (v >= n) return;  // whole warps exit together
  const int e1 = indptr[v + 1];
  float acc = 0.0f;
  for (int base = indptr[v]; base < e1; base += 32) {
    const int e = base + lane;
    const float p = e < e1 ? __fmul_rn(w[e], s[pre[e]]) : 0.0f;
    const int cnt = min(32, e1 - base);  // the same in every lane
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      if (j < cnt) acc = __fadd_rn(acc, pj);
    }
  }
  if (lane == 0) out[v] = acc;
}

}  // namespace

// Plain C entry for ctypes; returns the cudaError_t of the launch.
extern "C" int spike_input(const int* indptr, const int* pre, const float* w,
                           const float* s, float* out, int n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(((int64_t)n * 32 + THREADS - 1) / THREADS);
  spike_input_warp<<<blocks, THREADS, 0, stream>>>(indptr, pre, w, s, out, n);
  return (int)cudaGetLastError();
}
