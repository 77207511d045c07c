// The ordered synaptic sum of one neuron by one warp, shared by
// `spike_input` (spike_input.cu) and the LIF recording (lif_record.cu):
//   i[v] = sum over v's synapses e, in synapse order, of w[e] * s[pre[e]]
// with one round-to-nearest product and one round-to-nearest add per term,
// from +0, as the CPU's index_add_ adds (ref.spike_input_ref).
//
// Only the nonzero products are added.  In round-to-nearest a sum that
// starts at +0 becomes -0 only by adding -0 to -0, so the running sum is
// never -0, and acc + (+-0) == acc bit for bit (for acc a number, an
// infinity or a NaN).  Skipping a zero product therefore changes no bit.
// A NaN or infinite product is not zero and is added.  The recording's s
// is 0/1, so most products are exactly zero and the chain walks only the
// synapses whose source fired.
//
// w is loaded only where s[pre] != 0: a zero s then stands for a zero
// product, which holds for finite weights (an SNN's are; an infinite or
// NaN weight times a zero s is NaN in the reference, and would be skipped
// here).
//
// Per batch of BATCH groups of 32 synapses: each lane loads pre and
// gathers s, loads w where s != 0 and forms its product (all the batch's
// loads before any use, so a neuron waits for two round trips, pre then w,
// a batch).  Then per group the warp takes a ballot of the nonzero
// products and each lane holding one writes it to the warp's shared buffer
// at its rank, so the buffer holds the batch's nonzero products in synapse
// order; every lane adds them from there, 8 at a time (+0 pads the last 8:
// acc + (+0) == acc), and ends with the same sum.  The chain is as long as
// the nonzero products plus a ballot a group.  (Walking the ballot's bits
// with a shuffle from each lane took 1.4 times as long on an H100 at a
// recorded step of HeartClass, 3.7 times with every s 1.)
//
// The synapses come from device memory (GlobalSynapses) or, for those a
// block copied there, from shared memory (CachedSynapses), chosen per batch.
#pragma once

#include <cuda_runtime.h>

namespace spike_sum {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BATCH = 4;
// floats of shared memory a warp's walk needs (16-byte aligned): a batch's
// products and 8 zeros after them
constexpr int WARP_BUF = 32 * BATCH + 8;

// The synapses as they lie in device memory.
struct GlobalSynapses {
  const int* __restrict__ pre;
  const float* __restrict__ w;
  static constexpr bool kCached = false;
};

// A block's synapses: those in [e_lo, e_end) also copied into shared memory
// (spre[i] = pre[e_lo + i], sw likewise), the rest read from device memory.
struct CachedSynapses {
  const int* __restrict__ pre;
  const float* __restrict__ w;
  const int* spre;
  const float* sw;
  int e_lo, e_end;
  static constexpr bool kCached = true;
};

// A batch's products: lane's p[k] for synapse base + 32 k + lane (0 past
// e1 and where s is 0), from shared memory or, through the read-only
// cache, from device memory; pre and w are indexed by the synapse.
template <bool kShared, class Spike>
__device__ __forceinline__ void products(const int* pre, const float* w, int base, int e1,
                                         const Spike& spike, int lane, float (&p)[BATCH]) {
  float s[BATCH];
#pragma unroll
  for (int k = 0; k < BATCH; ++k) {
    const int e = base + 32 * k + lane;
    s[k] = e < e1 ? spike(kShared ? pre[e] : __ldg(pre + e)) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < BATCH; ++k) {
    const int e = base + 32 * k + lane;
    p[k] = s[k] != 0.0f ? __fmul_rn(kShared ? w[e] : __ldg(w + e), s[k]) : 0.0f;
  }
}

// `syn` is GlobalSynapses or CachedSynapses, `spike(p)` is s[p] as a float;
// e0 and e1 are the same in every lane of the warp, and every lane of the
// warp calls this; `buf` is the warp's WARP_BUF floats of shared memory.
template <class Synapses, class Spike>
__device__ __forceinline__ float ordered_sum(const Synapses& syn, int e0, int e1,
                                             const Spike& spike, int lane, float* buf) {
  float acc = 0.0f;
  const unsigned below = (1u << lane) - 1u;
  for (int base = e0; base < e1; base += 32 * BATCH) {
    float p[BATCH];
    if constexpr (Synapses::kCached) {
      // the same in every lane: the whole batch in the cache, or not
      if (base >= syn.e_lo && min(e1, base + 32 * BATCH) <= syn.e_end)
        products<true>(syn.spre - syn.e_lo, syn.sw - syn.e_lo, base, e1, spike, lane, p);
      else
        products<false>(syn.pre, syn.w, base, e1, spike, lane, p);
    } else {
      products<false>(syn.pre, syn.w, base, e1, spike, lane, p);
    }
    int count = 0;
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const unsigned live = __ballot_sync(FULL, p[k] != 0.0f);   // a NaN product is != 0
      if (p[k] != 0.0f) buf[count + __popc(live & below)] = p[k];
      count += __popc(live);
    }
    // +0 after the last product: the walk reads 8 at a time, and
    // acc + (+0) == acc (acc is never -0)
    if (lane < 8) buf[count + lane] = 0.0f;
    __syncwarp();
    for (int i = 0; i < count; i += 8) {
      const float4 a = *reinterpret_cast<const float4*>(buf + i);
      const float4 b = *reinterpret_cast<const float4*>(buf + i + 4);
      acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, a.x), a.y), a.z), a.w);
      acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, b.x), b.y), b.z), b.w);
    }
    __syncwarp();
  }
  return acc;
}

}  // namespace spike_sum
