// `lif_record`: the whole LIF spike recording of core/lif.py in one
// persistent launch.
//
// It stands where src/repro/core/lif.py::_simulate runs its jitted
// lax.scan over the steps (not a Pallas kernel).  For t = 0 .. n_steps-1,
// in float32, with the parameters rounded to float32:
//   fired  = input ? draws[t] < input_rate : v >= v_th && refr <= 0
//   i      = the ordered synaptic sum of spike_sum.cuh over the fired flags
//   v      = (fired ? v_reset : v * leak) + (input ? 0 : i)
//   refr   = fired ? refractory : max(refr - 1, 0)
//   counts += fired
// from v = 0 and refr = 0; outputs the float32 counts and the last v and
// refr.  Every product and add rounds once (__fmul_rn, __fadd_rn, and the
// library is built with --fmad=false), and each neuron's synapses are added
// in synapse order, skipping only zero products, so counts, v and refr
// equal ref.lif_record_ref on the host bit for bit: one spike flipped at
// the threshold would change the partitioner's clustering.  The add of +0
// for an input neuron stays (-0 + 0 = +0).
//
// Why one launch.  The step as eager PyTorch ops is about fifteen launches
// around the synaptic sum (the comparisons, the selects, the casts), so a
// 256-step recording spent nearly all of its wall launching work: the
// sum's own device time was some 5 ms of 0.16-0.20 s.
//
// Design.  A cooperative grid of one 1024-thread block an SM (it takes the
// SM's shared memory, below), sized by the occupancy query, stays resident
// for the whole recording and meets at a grid barrier once a step.  Each
// block owns a contiguous range of whole 32-neuron words, so each word of
// the fired bitmask belongs to exactly one block and no atomics are
// needed.  The ranges share the work out evenly: block b starts at the
// first word whose prefix costs b/G of the whole, a word's cost being its
// synapses plus NEURON_COST a neuron (a binary search over indptr in the
// prologue); HeartClass's 6,724 input neurons have no synapses, and equal
// ranges of neurons took 1.5 times as long on an H100.  Two bitmasks of
// ceil(n/32) words in device memory alternate: step t reads mask t and
// writes mask t+1.  A step: the block copies mask t into shared memory
// (through the L2, __ldcg: another SM wrote it); its warps sum their
// neurons' synapses (a warp a neuron, spike_sum.cuh, the spike a bit of
// the shared mask, so w is read only for synapses whose source fired) into
// shared memory; then a lane a neuron updates v, refr and counts, computes
// the next step's fired flag, and the warp's ballot is the next mask's
// word; then the grid barrier.  A prologue sets the state and step 0's
// flags and copies the first synapses of the block's range (pre and w, 8
// bytes each: as many as the SM's shared memory holds beside the flags,
// which is all of HeartClass's) into shared memory, where the steps read
// them; any others are read from device memory (the L2) every step.  Read
// from the L2 every step, they made HeartClass's recording 1.2 times as
// long on an H100; 256-thread blocks, 1.3 times.  What is left is
// issue-bound: every synapse is looked at every step (a load of pre, a bit
// of the mask), some 140 warp instructions a batch of 128.
// Bound: the bytes read from device memory once (indptr, pre, w, is_input,
// the input neurons' draws, the state written) against 2 flops a synapse
// whose source fired, a step; and in practice the grid barrier a step.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "spike_sum.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
// neurons whose synaptic input a block holds in shared memory at once
constexpr int CHUNK = THREADS;
// a neuron's share of the balance, in synapses: its indptr reads, its
// update and the step's other per-neuron work
constexpr int NEURON_COST = 32;

struct LIFParams {
  float v_th, v_reset, leak, input_rate;
  int refractory;
};

struct MaskSpikes {
  const uint32_t* m;   // shared memory
  __device__ __forceinline__ float operator()(int p) const {
    return (m[p >> 5] >> (p & 31)) & 1u ? 1.0f : 0.0f;
  }
};

__device__ __forceinline__ int64_t prefix_cost(const int* __restrict__ indptr, int n,
                                               int64_t word) {
  const int64_t u = min(word * 32, (int64_t)n);
  return (int64_t)indptr[u] + NEURON_COST * u;
}

// The first word whose prefix costs at least `target` (at most `words`).
__device__ int64_t first_word(const int* __restrict__ indptr, int n, int words,
                              int64_t target) {
  int64_t a = 0, b = words;
  while (a < b) {
    const int64_t m = (a + b) / 2;
    if (prefix_cost(indptr, n, m) >= target) b = m; else a = m + 1;
  }
  return a;
}

__global__ void __launch_bounds__(THREADS)
lif_record_kernel(const int* __restrict__ indptr, const int* __restrict__ pre,
                  const float* __restrict__ w, const uint8_t* __restrict__ is_input,
                  const float* __restrict__ draws, float* __restrict__ counts,
                  float* __restrict__ v, int* __restrict__ refr, uint32_t* masks, int n,
                  int n_steps, int cap, LIFParams pr) {
  // dynamic shared memory: this step's flags (ceil(n/32) words), then the
  // cache of up to `cap` synapses (their pre, then their w)
  extern __shared__ uint32_t smask[];
  __shared__ float isyn[CHUNK];
  __shared__ __align__(16) float buf[WARPS][spike_sum::WARP_BUF];
  __shared__ int64_t range[2];            // this block's first and end word
  cg::grid_group grid = cg::this_grid();
  const int words = (n + 31) >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < 2) {
    const int64_t total = prefix_cost(indptr, n, words);
    range[threadIdx.x] = first_word(indptr, n, words,
                                    total * (blockIdx.x + threadIdx.x) / gridDim.x);
  }
  __syncthreads();
  const int64_t lo = range[0] * 32;
  const int64_t hi = min((int64_t)n, range[1] * 32);
  int* spre = reinterpret_cast<int*>(smask + words);
  float* sw = reinterpret_cast<float*>(spre + cap);
  const int e_lo = lo < hi ? indptr[lo] : 0;
  const int n_cached = lo < hi ? min(cap, indptr[hi] - e_lo) : 0;
  for (int i = threadIdx.x; i < n_cached; i += THREADS) {
    spre[i] = pre[e_lo + i];
    sw[i] = w[e_lo + i];
  }   // read after the first step's __syncthreads
  const spike_sum::CachedSynapses syn{pre, w, spre, sw, e_lo, e_lo + n_cached};

  // prologue: v = 0, refr = 0, counts = 0, and step 0's flags into mask 0
  for (int64_t base = lo + warp * 32; base < hi; base += THREADS) {
    const int64_t u = base + lane;
    bool f = false;
    if (u < hi) {
      v[u] = 0.0f;
      refr[u] = 0;
      counts[u] = 0.0f;
      f = is_input[u] ? draws[u] < pr.input_rate : (0.0f >= pr.v_th);
    }
    const unsigned word = __ballot_sync(spike_sum::FULL, f);
    if (lane == 0) masks[base >> 5] = word;
  }
  grid.sync();

  for (int t = 0; t < n_steps; ++t) {
    const uint32_t* cur = masks + (t & 1) * (int64_t)words;
    uint32_t* nxt = masks + ((t + 1) & 1) * (int64_t)words;
    const bool last = t + 1 == n_steps;
    if (lo < hi) {
      for (int i = threadIdx.x; i < words; i += THREADS) smask[i] = __ldcg(cur + i);
      __syncthreads();
    }
    for (int64_t c0 = lo; c0 < hi; c0 += CHUNK) {
      const int64_t c1 = min(hi, c0 + CHUNK);
      for (int64_t u = c0 + warp; u < c1; u += WARPS) {
        const float acc = spike_sum::ordered_sum(syn, indptr[u], indptr[u + 1],
                                                 MaskSpikes{smask}, lane, buf[warp]);
        if (lane == 0) isyn[u - c0] = acc;
      }
      __syncthreads();
      for (int64_t base = c0 + warp * 32; base < c1; base += THREADS) {
        const int64_t u = base + lane;
        bool f = false;
        if (u < c1) {
          const bool fired = (smask[u >> 5] >> (u & 31)) & 1u;
          const bool input = is_input[u] != 0;
          const float vn = __fadd_rn(fired ? pr.v_reset : __fmul_rn(v[u], pr.leak),
                                     input ? 0.0f : isyn[u - c0]);
          const int rn = fired ? pr.refractory : max(refr[u] - 1, 0);
          v[u] = vn;
          refr[u] = rn;
          if (fired) counts[u] = __fadd_rn(counts[u], 1.0f);
          if (!last)
            f = input ? draws[(int64_t)(t + 1) * n + u] < pr.input_rate
                      : (vn >= pr.v_th && rn <= 0);
        }
        const unsigned word = __ballot_sync(spike_sum::FULL, f);
        if (lane == 0 && !last) nxt[base >> 5] = word;
      }
      __syncthreads();   // isyn is refilled by the next chunk
    }
    if (!last) grid.sync();
  }
}

// The barrier floor: the same grid meeting n_steps times and doing nothing.
__global__ void __launch_bounds__(THREADS) barrier_floor_kernel(int n_steps) {
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < n_steps; ++t) grid.sync();
}

// The launch floor: one block that does nothing.
__global__ void empty_kernel() {}

// The recording's grid for n neurons and e synapses: blocks, synapses a
// block caches and dynamic shared memory bytes.  A block takes all the
// shared memory an SM offers: the flags, and as many synapses as fit in the
// rest (at most e).
cudaError_t grid_of(int n, int e, int* blocks, int* cap, size_t* smem) {
  int dev = 0, sms = 0, coop = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, lif_record_kernel);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const size_t mask_bytes = (size_t)((n + 31) / 32) * sizeof(uint32_t);
  const size_t room = (size_t)optin > fa.sharedSizeBytes ? optin - fa.sharedSizeBytes : 0;
  if (mask_bytes > room) return cudaErrorCooperativeLaunchTooLarge;
  *cap = (int)std::min<size_t>((room - mask_bytes) / (sizeof(int) + sizeof(float)),
                               (size_t)std::max(e, 0));
  *smem = mask_bytes + (size_t)*cap * (sizeof(int) + sizeof(float));
  if (*smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lif_record_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)*smem);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lif_record_kernel, THREADS, *smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = sms * per_sm;
  return cudaSuccess;
}

}  // namespace

// Plain C entries for ctypes; each returns a cudaError_t.
//
// The recording: indptr (n+1), pre and w (e) the destination-sorted CSR;
// is_input (n) 0/1 bytes; draws (n_steps, n); out counts, v (n) float32 and
// refr (n) int32; masks 2 * ceil(n/32) words of scratch.
extern "C" int lif_record(const int* indptr, const int* pre, const float* w,
                          const uint8_t* is_input, const float* draws, float* counts, float* v,
                          int* refr, uint32_t* masks, int n, int e, int n_steps, float v_th,
                          float v_reset, float leak, int refractory, float input_rate,
                          cudaStream_t stream) {
  if (n <= 0 || e < 0 || n_steps <= 0) return (int)cudaErrorInvalidValue;
  int blocks = 0, cap = 0;
  size_t smem = 0;
  cudaError_t err = grid_of(n, e, &blocks, &cap, &smem);
  if (err != cudaSuccess) return (int)err;
  LIFParams pr{v_th, v_reset, leak, input_rate, refractory};
  void* args[] = {&indptr, &pre, &w, &is_input, &draws, &counts, &v, &refr, &masks,
                  &n, &n_steps, &cap, &pr};
  err = cudaLaunchCooperativeKernel((const void*)lif_record_kernel, dim3(blocks), dim3(THREADS),
                                    args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// out[0..4]: the recording's blocks, threads a block, neurons whose input
// a block holds at once, synapses a block caches and dynamic shared memory
// bytes for n neurons and e synapses on the current device.
extern "C" int lif_record_grid(int n, int e, int* out) {
  if (n <= 0 || e < 0) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  const cudaError_t err = grid_of(n, e, &out[0], &out[3], &smem);
  out[1] = THREADS;
  out[2] = CHUNK;
  out[4] = (int)smem;
  return (int)err;
}

// The recording's grid for n neurons and e synapses meeting at n_steps
// grid barriers.
extern "C" int lif_barrier_floor(int n, int e, int n_steps, cudaStream_t stream) {
  if (n <= 0 || e < 0) return (int)cudaErrorInvalidValue;
  int blocks = 0, cap = 0;
  size_t smem = 0;
  cudaError_t err = grid_of(n, e, &blocks, &cap, &smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&n_steps};
  err = cudaLaunchCooperativeKernel((const void*)barrier_floor_kernel, dim3(blocks),
                                    dim3(THREADS), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}
