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
// threshold changes the partitioner's clustering.  s is any float32; the
// weights are finite (spike_sum.cuh says why).
//
// Design.  One warp per neuron runs spike_sum.cuh's ordered sum: 128
// synapses at a time, coalesced loads of pre, the gather of s, w loaded
// only where s is nonzero, and the nonzero products alone, compacted in
// synapse order through shared memory, added in order.  The body before
// it added all 32 products of every group in 32 shuffles and predicated
// adds whatever they were: issue-bound at 31 % of the byte bound on
// HeartClass, where most of the recording's 0/1 spikes are 0.
// (A thread per neuron walking its synapses alone took 1.5 times as long
// as a warp on an H100 over HeartClass's synapses.)
// Bound: the bytes of pre and w (8 a synapse; w only 4 a synapse whose
// source fired) and of indptr, s and i; the gathers of s come from the L2.
// Since the recording runs as one launch (lif_record.cu, the same sum),
// no path calls this kernel: it stays callable and checked.
#include <cuda_runtime.h>
#include <stdint.h>

#include "spike_sum.cuh"

namespace {

constexpr int THREADS = 256;

struct GlobalSpikes {
  const float* __restrict__ s;
  __device__ __forceinline__ float operator()(int p) const { return __ldg(s + p); }
};

__global__ void __launch_bounds__(THREADS)
spike_input_warp(const int* __restrict__ indptr, const int* __restrict__ pre,
                 const float* __restrict__ w, const float* __restrict__ s,
                 float* __restrict__ out, int n) {
  __shared__ __align__(16) float buf[THREADS / 32][spike_sum::WARP_BUF];
  const int lane = threadIdx.x & 31;
  const int64_t v = ((int64_t)blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (v >= n) return;  // whole warps exit together
  const float acc = spike_sum::ordered_sum(spike_sum::GlobalSynapses{pre, w}, indptr[v],
                                           indptr[v + 1], GlobalSpikes{s}, lane,
                                           buf[threadIdx.x >> 5]);
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
