// Flash attention (online softmax) for the LM substrate's prefill path.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (Pallas
// body _flash_kernel):
//   o[b,h,i] = sum_j softmax_j(q[b,h,i] . k[b,h/G,j] / sqrt(D)) v[b,h/G,j]
// over the keys j that the masks keep: j <= i (causal) and i - j < window
// (window > 0).  G = Hq / Hkv groups query heads onto KV heads (GQA, MQA).
// Running max, sum and accumulator are float32; a row that keeps no key
// gives 0; q, k and v are float32 or bf16 and the output has q's type.
//
// Plan.  The TPU kernel walks a sequential kv grid axis and keeps the
// running statistics in VMEM scratch between grid steps.  Hopper blocks run
// in no order, so here a block owns a q tile of one (batch, query head) and
// loops over kv tiles itself, with the running max, sum and accumulator in
// registers.  The tile skips are the TPU kernel's: the loop starts at the
// first kv tile that reaches into the window and ends after the last tile
// a causal row can see, and only tiles on a mask's edge are masked
// element by element.  Ragged Sq and Skv are handled in the kernel, so
// callers never pad, and causal=False needs no fallback.  Blocks are issued
// latest q tile first, so the longest causal rows do not finish last on a
// few SMs.  Two bodies share this plan:
//
// * float32 (flash_kernel): float32 FMAs on the CUDA cores, no TF32.  256
//   threads, a 64-row q tile; each holds 4 q rows (ty*4 + i) by D/16 output
//   columns (tx + 16c) and 4 x 2 scores of a 32-row kv tile, and the 16
//   threads of a row reduce its max and sum with warp shuffles.  q (scaled
//   by 1/sqrt(D) on load, as the TPU kernel does), K, V and the
//   probabilities are staged in shared memory as float32, rows padded to
//   D + 4 floats so eight threads reading eight k rows hit distinct banks.
//   It runs only float32 prefill steps at serving batch, where a call takes
//   microseconds and launch cost bounds it.
//
// * bf16 (flash_wgmma_kernel), the 32k prefill path: a warp-specialised
//   Hopper pipeline.  A block owns 128 q rows and has three warpgroups: a
//   producer, of which one thread issues every load as a TMA copy, and two
//   consumers of 64 q rows each, whose products are wgmma.  Q is loaded
//   once; K and V come through a ring of STAGES 64-key tiles, each stage
//   guarded by full barriers (K and V apart, so Q K^T starts before V has
//   landed) and an empty barrier that all eight consumer warps arrive on
//   when they are done with the stage.  One tensor map per operand covers
//   (D, S, H, B) with the caller's strides, so strided and transposed views
//   load without a copy.  A box is 64 columns (128 bytes, the widest a
//   128-byte swizzle takes) by 64 rows: D = 128 loads as two boxes, and
//   D = 96 as two whose last 32 columns lie out of bounds; TMA fills those,
//   and the rows past Sq or Skv, with zeros.
//   S = Q K^T is wgmma m64n64k16 with both operands K-major in shared
//   memory.  The softmax runs in log2 units: a score is scaled by
//   log2(e)/sqrt(D) in the one FMA that subtracts the running max, and P is
//   ex2.approx, one MUFU op, where the mma.sync body spent a full-precision
//   expf, about ten FP32 instructions.  Only tiles on a mask's edge are
//   masked, behind one branch the warp takes or skips; the row max and sum
//   are trees of four chains, both rows side by side (one warp a scheduler
//   has little else to hide latency with).  The S accumulator is repacked in
//   registers as the A operand of P V (the accumulator and A fragment
//   layouts coincide), and V is read by wgmma as an MN-major B operand
//   straight from its TMA tile: V is never transposed by hand.  P V is one
//   m64n128k16 a 16-key step at D = 96 and 128 (the 32 padding columns of
//   D = 96 come out 0 and are not stored), m64n64k16 at D = 64.
//   The TPU kernel and the plain version multiply V by float32
//   probabilities; a bf16 P would be off by 2^-9 of each term.  So P goes
//   in as two bf16 operands, P rounded and the rest of P rounded (P kept to
//   about 2^-17), and P V takes two wgmma a step.  The tensor cores
//   truncate an addition into their accumulator instead of rounding it, so
//   a 32768-key row summed there drifts past kernels/ref.py's ATTN_TOL:
//   each tile's P V sums in a fresh accumulator, and the CUDA cores add it
//   to the float32 running output after the rescale, one FMA an element.
//   Within a consumer the loop is software-pipelined: Q K^T of tile i + 1
//   is issued with P V of tile i, and tile i + 1's softmax runs while P V is
//   in flight.  Registers: S 32, P hi + lo 32, the fresh sum 64 and the
//   running output 64 a thread at D = 128; setmaxnreg gives the consumers
//   232 and the producer 40, one block an SM.  Measured against the
//   alternatives (tools/flash_ab.py; PERF.md has the numbers): 2 stages
//   wait on loads, more than 3 gain nothing; a named-barrier ping-pong
//   between the two consumers gains nothing, their warps interleave on the
//   schedulers anyway; and a Q K^T issued under a branch makes ptxas
//   serialise every wgmma of the kernel, so the last iteration issues one on
//   a resident tile and drops it.
//
// Bound on the H100: 4*D flops per (query, key) pair the masks keep, per
// query head; bytes are only q, k, v and o, read or written once.  At the
// prefill shapes the flops bound it: 989 TFLOP/s on the tensor cores in
// bf16, 67 TFLOP/s on the CUDA cores in float32.  The split P makes the
// bf16 body issue 1.5x the bound's tensor-core work (P V twice), so 1.5x
// the bound is its own floor.  What held the mma.sync body it replaces, and
// what this one does instead: loads by all threads, synchronous, two block
// syncs per 64 keys (a TMA ring that runs ahead of the products); V
// transposed element by element into shared memory (an MN-major operand);
// mma.sync fed by 32-bit shared-memory loads (wgmma reading its operands
// itself); 64-row tiles at two blocks an SM (128 rows, one 384-thread
// block); a full-precision expf per kept pair (ex2.approx), with the
// softmax serialised between the products (issued under them).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;          // q rows per block
constexpr int BKV = 32;         // kv rows per tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int RQ = BQ / 16;     // q rows per thread
constexpr int CS = BKV / 16;    // score columns per thread
constexpr int PP = BKV + 4;     // row stride of the probability tile

struct Strides {
  int64_t b, h, s;  // elements; the head dimension is contiguous
};

// ---------------------------------------------------------------------------
// float32 body: FMAs on the CUDA cores
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 4) + BKV * (D + 4) + BKV * D + BQ * PP);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int Hq, int group, int Sq,
             int Skv, Strides qs, Strides ks, Strides vs, int causal, int window, float scale) {
  constexpr int DP = D + 4;    // row stride of the q and k tiles
  constexpr int CO = D / 16;   // output columns per thread
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);  // BQ x DP
  float* Ks = Qs + BQ * DP;                        // BKV x DP
  float* Vs = Ks + BKV * DP;                       // BKV x D
  float* Ps = Vs + BKV * D;                        // BQ x PP

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hq = blockIdx.y, b = blockIdx.z, hk = hq / group;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  q += b * qs.b + hq * qs.h;
  k += b * ks.b + hk * ks.h;
  v += b * vs.b + hk * vs.h;
  o += ((int64_t)b * Hq + hq) * Sq * D;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int qi = q0 + r;
    Qs[r * DP + d] = qi < Sq ? q[qi * qs.s + d] * scale : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][CO];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BKV * BKV : 0;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the last tile's reads are done (and q is staged)
    for (int idx = tid; idx < BKV * D; idx += THREADS) {
      const int r = idx / D, d = idx - r * D;
      const int kj = k0 + r;
      const bool in = kj < Skv;
      Ks[r * DP + d] = in ? k[kj * ks.s + d] : 0.f;
      Vs[r * D + d] = in ? v[kj * vs.s + d] : 0.f;
    }
    __syncthreads();

    // scores of this thread's 4 rows x 2 columns
    float s[RQ][CS];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CS; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 qv[RQ], kv[CS];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * RQ + i) * DP + d);
#pragma unroll
      for (int j = 0; j < CS; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * DP + d);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CS; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // masks and the online-softmax update, row by row
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = q0 + ty * RQ + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool keep = kj < Skv && (!causal || qi >= kj) && (window <= 0 || qi - kj < window);
        s[i][j] = keep ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_safe);  // 0 while the row has seen no key
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const float p = expf(s[i][j] - m_safe);  // 0 where masked
        Ps[(ty * RQ + i) * PP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V
#pragma unroll
    for (int kk = 0; kk < BKV; kk += 4) {
      float4 p4[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (ty * RQ + i) * PP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[CO];
#pragma unroll
        for (int c = 0; c < CO; ++c) vv[c] = Vs[(kk + u) * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float pu = u == 0 ? p4[i].x : u == 1 ? p4[i].y : u == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < CO; ++c) acc[i][c] = fmaf(pu, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty * RQ + i;
    if (qi < Sq) {
      const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
      for (int c = 0; c < CO; ++c) o[(int64_t)qi * D + tx + 16 * c] = acc[i][c] / den;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 body: TMA ring, warp-specialised wgmma
// ---------------------------------------------------------------------------
constexpr int WQ = 128;                   // q rows per block, 64 per consumer
constexpr int WKV = 64;                   // keys per kv tile
constexpr int STAGES = 3;                 // kv tiles in flight
constexpr int CONSUMERS = 2;              // consumer warpgroups
constexpr int WTHREADS = 128 * (1 + CONSUMERS);
constexpr uint32_t BOX = 64 * 128;        // bytes of one 64-row x 64-column box

template <int D>
struct Ring {
  static constexpr int NA = (D + 63) / 64;             // boxes across a row
  static constexpr uint32_t TILE = NA * BOX;           // 64 rows of K, V or q
  static constexpr uint32_t K_OFF = 2 * TILE;          // q: two 64-row halves
  static constexpr uint32_t V_OFF = K_OFF + STAGES * TILE;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * TILE;
  // q_full, then k_full, v_full and empty for each stage; 1 KB for alignment
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
};

// two bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x0, x1) as hi + lo, two bf16 each with x0 in the low half: hi the pair
// rounded, lo the remainder rounded
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(hi) : "f"(x1), "f"(x0));
  const float h0 = __uint_as_float(hi << 16), h1 = __uint_as_float(hi & 0xffff0000u);
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n"
      : "=r"(lo)
      : "f"(__fsub_rn(x1, h1)), "f"(__fsub_rn(x0, h0)));
}

// This thread's place in a consumer's 64 rows: the warp's first row, the
// thread's first row (the other is row0 + 8) and its column pair in an n8
// block of the accumulator
struct Rows {
  int qwarp, row0, tq;
};

struct Masks {
  int Skv, causal, window;
  float scale_log2;
};

// Scores the masks drop become -inf: only on tiles where the warp's 16
// rows meet an edge (a branch the whole warp takes or skips).
// Accumulator element 4j + 2r + e is row row0 + 8r, key k0 + 8j + 2tq + e.
__device__ __forceinline__ void mask_tile(float (&sc)[32], int k0, const Rows& w,
                                          const Masks& mk) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = w.row0 + 8 * r, kj = k0 + 8 * j + 2 * w.tq + e;
        const bool keep =
            kj < mk.Skv && (!mk.causal || qi >= kj) && (mk.window <= 0 || qi - kj < mk.window);
        if (!keep) sc[4 * j + 2 * r + e] = -INFINITY;
      }
}

// The online-softmax update of one 64-key tile for this thread's two rows,
// in log2 units (m is the running max of the scaled scores): turns sc into
// P (0 where masked), updates m and the running sum l, and gives the
// rescale alpha of the running output.  The two rows go side by side and
// each reduction is a tree of four chains, for the instruction-level
// parallelism one warp a scheduler needs.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, const Rows& w,
                                             const Masks& mk) {
  const bool inside = k0 + WKV <= mk.Skv && (!mk.causal || k0 + WKV - 1 <= w.qwarp) &&
                      (mk.window <= 0 || w.qwarp + 15 - k0 < mk.window);
  if (!inside) mask_tile(sc, k0, w, mk);
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      mx[r][c] = fmaxf(fmaxf(sc[8 * c + 2 * r], sc[8 * c + 2 * r + 1]),
                       fmaxf(sc[8 * c + 4 + 2 * r], sc[8 * c + 4 + 2 * r + 1]));
  float m_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(m[r], __fmul_rn(x, mk.scale_log2));
    m_safe[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = ex2(__fsub_rn(m[r], m_safe[r]));  // 0 while the row has seen no key
    m[r] = m_new;
  }
  float rs[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) rs[r][c] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * r + e];
        x = ex2(__fmaf_rn(x, mk.scale_log2, -m_safe[r]));  // 0 where masked
        rs[r][j % 4] = __fadd_rn(rs[r][j % 4], x);
      }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = __fadd_rn(__fadd_rn(rs[r][0], rs[r][1]), __fadd_rn(rs[r][2], rs[r][3]));
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
    l[r] = __fmaf_rn(l[r], alpha[r], x);
  }
}

// P as the A operand of keys 16kk..16kk+15: the accumulator's n8 blocks 2kk
// and 2kk + 1, split into bf16 hi and lo parts
__device__ __forceinline__ void split_p(const float (&sc)[32], uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f)
      split_bf16(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1], hi[kk][f], lo[kk][f]);
}

// S = q K^T for 64 rows x 64 keys: D / 16 k-steps, a k-step 32 bytes along
// a box's swizzled rows
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
    wgmma_ss(sc, smem_desc(q + off, 16, 1024), smem_desc(k + off, 16, 1024), kk > 0);
  }
}

// a tile's P V in a fresh accumulator, one wgmma of N = 64 * NA columns
// per 16 keys (2048 bytes down each V box), lo then hi
template <int NA>
__device__ __forceinline__ void issue_pv(float (&pv)[NA * 32], const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4], uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dv = smem_desc(v + kk * 2048, BOX, 1024);
    wgmma_rs(pv, lo[kk], dv, kk > 0);
    wgmma_rs(pv, hi[kk], dv, 1);
  }
}

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle's
// period): q as two halves of NA boxes, then STAGES K tiles, STAGES V tiles
// (NA boxes each), then the barriers.  A box holds 64 rows of 128 bytes.
template <int D>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                   int Hq, int group, int Sq, int Skv, int causal, int window, float scale_log2) {
  using R = Ring<D>;
  constexpr int NA = R::NA;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + R::K_OFF, sV = base + R::V_OFF;
  const uint32_t q_full = base + R::BAR_OFF;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * STAGES + s); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * WQ;
  const int hq = blockIdx.y, b = blockIdx.z, hk = hq / group;
  const int q_last = min(q0 + WQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / WKV * WKV : 0;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + WKV - 1) / WKV : 0;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 4 * CONSUMERS);  // every consumer warp arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      mbar_expect_tx(q_full, 2 * R::TILE);
      for (int h = 0; h < 2; ++h)
        for (int a = 0; a < NA; ++a)
          tma_load(sQ + (h * NA + a) * BOX, &qmap, q_full, 64 * a, q0 + 64 * h, hq, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, k0 = kv_begin + i * WKV;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);  // a fresh barrier passes
        mbar_expect_tx(k_full(s), R::TILE);
        for (int a = 0; a < NA; ++a)
          tma_load(sK + s * R::TILE + a * BOX, &kmap, k_full(s), 64 * a, k0, hk, b);
        mbar_expect_tx(v_full(s), R::TILE);
        for (int a = 0; a < NA; ++a)
          tma_load(sV + s * R::TILE + a * BOX, &vmap, v_full(s), 64 * a, k0, hk, b);
      }
    }
    return;
  }

  // ---- consumers: 64 q rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, t = tid % 128, warp = t / 32, lane = t % 32;
  const Rows rows{q0 + 64 * c + 16 * warp, q0 + 64 * c + 16 * warp + lane / 4, lane % 4};
  const Masks masks{Skv, causal, window, scale_log2};
  const uint32_t my_q = sQ + c * R::TILE;

  // accumulator element 4j + 2r + e: row row0 + 8r, column 8j + 2tq + e
  float acc[NA * 32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
  for (int e = 0; e < NA * 32; ++e) acc[e] = 0.f;
  float sc[32], pv[NA * 32];
  uint32_t hi[4][4], lo[4][4];

  // Software pipeline within the warpgroup: Q K^T of tile i + 1 is issued
  // with P V of tile i, and its softmax runs while P V is in flight.
  mbar_wait(q_full, 0);
  if (n_tiles > 0) {
    mbar_wait(k_full(0), 0);
    wg_fence();
    issue_qk<D>(sc, my_q, sK);
    wg_commit();
    wg_wait<0>();
    hold(sc);
    softmax_tile(sc, m, l, alpha, kv_begin, rows, masks);
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES, s1 = (i + 1) % STAGES;
    const bool next = i + 1 < n_tiles;
    split_p(sc, hi, lo);
    if (next) mbar_wait(k_full(s1), ((i + 1) / STAGES) & 1);
    mbar_wait(v_full(s), (i / STAGES) & 1);
    wg_fence();
    // Q K^T of the next tile, issued with P V of this one; the last
    // iteration repeats this tile's (still resident) and drops it, since a
    // wgmma under a branch makes ptxas serialise every wgmma of the kernel
    issue_qk<D>(sc, my_q, sK + (next ? s1 : s) * R::TILE);
    wg_commit();
    issue_pv<NA>(pv, hi, lo, sV + s * R::TILE);
    wg_commit();
    float alpha_next[2];
    wg_wait<1>();  // Q K^T is done, P V may not be
    hold(sc);
    if (next) softmax_tile(sc, m, l, alpha_next, kv_begin + (i + 1) * WKV, rows, masks);
    wg_wait<0>();
    hold(pv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hold(hi[kk]);
      hold(lo[kk]);
    }
    if (lane == 0) mbar_arrive(empty(s));  // this warp is done with the stage

#pragma unroll
    for (int e = 0; e < NA * 32; ++e) acc[e] = __fmaf_rn(acc[e], alpha[(e / 2) % 2], pv[e]);
    if (next) {
      alpha[0] = alpha_next[0];
      alpha[1] = alpha_next[1];
    }
  }

  const int row0 = rows.row0, tq = rows.tq;

  o += ((int64_t)b * Hq + hq) * Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi < Sq) {
      const float den = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)   // D = 96: the last 32 columns are padding
        *reinterpret_cast<uint32_t*>(o + (int64_t)qi * D + 8 * j + 2 * tq) =
            pack_bf16(acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (D, S, H, B) bf16 map with (64, 64, 1, 1) boxes, 128-byte swizzle and
// zero fill out of bounds.  A dimension of extent 1 takes the packed stride,
// whatever the caller's (it is never stepped).
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int D, int S, int H, int B,
                       Strides st) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t S1 = S > 0 ? S : 1;
  const cuuint64_t dims[4] = {(cuuint64_t)D, S1, (cuuint64_t)H, (cuuint64_t)B};
  cuuint64_t strides[3] = {2ull * st.s, 2ull * st.h, 2ull * st.b};
  const cuuint64_t packed[3] = {2ull * D, 2ull * D * S1, 2ull * D * S1 * H};
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] == 1) strides[i] = packed[i];
  const cuuint32_t box[4] = {64, 64, 1, 1}, unit[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
         unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidPitchValue;
}

template <int D>
cudaError_t launch(bool bf16, const void* q, const void* k, const void* v, void* o, int B,
                   int Hq, int Hkv, int Sq, int Skv, Strides qs, Strides ks, Strides vs,
                   int causal, int window, cudaStream_t stream) {
  cudaError_t err;
  if (bf16) {
    CUtensorMap qm, km, vm;
    if ((err = tensor_map(&qm, q, D, Sq, Hq, B, qs)) != cudaSuccess) return err;
    if ((err = tensor_map(&km, k, D, Skv, Hkv, B, ks)) != cudaSuccess) return err;
    if ((err = tensor_map(&vm, v, D, Skv, Hkv, B, vs)) != cudaSuccess) return err;
    constexpr size_t smem = Ring<D>::SMEM;
    err = cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
    dim3 grid((Sq + WQ - 1) / WQ, Hq, B);
    flash_wgmma_kernel<D><<<grid, WTHREADS, smem, stream>>>(
        qm, km, vm, static_cast<__nv_bfloat16*>(o), Hq, Hq / Hkv, Sq, Skv, causal, window,
        scale_log2);
  } else {
    const float scale = (float)(1.0 / sqrt((double)D));
    constexpr size_t smem = smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
    flash_kernel<D><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), Hq, Hq / Hkv, Sq, Skv, qs, ks, vs, causal, window, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, H, S, D) with the given element strides for B, H and S and a
// contiguous D; o: contiguous (B, Hq, Sq, D) of q's type.  is_bf16 selects
// bf16 for all four (pointers and the strides of every dimension longer
// than 1 multiples of 16 bytes, as TMA takes them), else float32.  D must
// be 64, 96 or 128.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int is_bf16, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                               int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                               int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                               int64_t v_ss, int causal, int window, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq < 0 || Skv < 0)
    return cudaErrorInvalidValue;
  if (Sq == 0) return cudaSuccess;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(is_bf16, q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, causal, window, st);
    case 96:
      return launch<96>(is_bf16, q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, causal, window, st);
    case 128:
      return launch<128>(is_bf16, q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, causal, window,
                         st);
    default:
      return cudaErrorInvalidValue;
  }
}
