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
// * float32 (flash_tf32_kernel), serving's float32 prefill and the train
//   step (56 launches a step at qwen2-1.5b's (8, 12, 256, 128)): products on
//   the tensor cores in 3xTF32.  TF32 keeps 10 mantissa bits, 2^-11 of a
//   product, where kernels/ref.py's ATTN_TOL allows 2^-14 of a row's size;
//   so every float32 operand x becomes hi = x rounded to TF32 and lo = the
//   remainder rounded to TF32 (cvt.rna.tf32.f32's rounding, by two integer
//   operations, which measured faster than the instruction; x to about
//   2^-22), and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi as three
//   mma.sync.m16n8k8 .tf32, for Q K^T (the small products in an accumulator
//   of their own) and for P V.  A block owns 64 q rows with eight warps:
//   warps w and w + 4 take rows 16w .. 16w + 15, w the first 32 keys of each
//   64-key tile and w + 4 the last 32, each with its own running max, sum
//   and output, merged at the end; a half tile the masks drop for all of a
//   warp's rows is skipped.  q is split once when the block stages it; K
//   and V come through a ring of FSTAGES 64-key tiles by 16-byte cp.async
//   (rows past Skv zero-filled), one wait_group and one block sync a tile;
//   each warp splits the K and V values it loads, once a tile, and reuses
//   each for the two products that need it.  Contraction indices are
//   permuted so that no value crosses threads: along D, thread t's 16-byte
//   chunk gives its k columns of two m16n8k8 steps, for q and K alike; along
//   the keys, P's accumulator (rows g and g + 8, keys 2t and 2t + 1 of each
//   n8 block) is the A operand as it lies, with V's rows read in the same
//   order; and output column 4c + i of a 32-column group sits in n8 block i,
//   so one 16-byte load of a V row feeds four blocks.  Rows are padded (q
//   and K by 16 floats, V by 4) so that every fragment load reads 32
//   distinct banks at an offset known when compiled.  The softmax is the
//   bf16 body's (below), in registers: float32 running max and sum,
//   ex2.approx of one FMA.  The tensor cores truncate what they add into an
//   accumulator, so each P V pass sums one tile in a fresh accumulator and
//   the CUDA cores add it to the float32 running output after the rescale,
//   as the bf16 body does.  The merged rows go out through shared memory,
//   whole rows of 16-byte stores: stored from the accumulator layout they
//   took a third of the time (tools/flash_ab.py, PERF.md).  What bounds it
//   (tools/flash_ab.py's variants at the train call): mma.sync's TF32 rate,
//   each pass of products about a seventh of the time; the splits; and
//   loads and stores not hidden behind products, one block an SM (eight
//   warps of 255 registers; 210 KB of shared memory at D = 128).  wgmma
//   would read its operands from shared memory, which cannot hold q, K and
//   V^T split into hi and lo (192 KB at 64 rows and keys) beside the ring.
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
// bf16; in float32, 67 TFLOP/s on the CUDA cores, or three TF32 products
// per float32 product at 495 TFLOP/s (a third of TF32's rate), which the
// 3xTF32 body can approach.  The split P makes the bf16 body issue 1.5x the
// bound's tensor-core work (P V twice), so 1.5x the bound is its own floor.
//
// What held the bodies each replaces, and what each does instead.  float32:
// every product a scalar FMA on the CUDA cores, 67 TFLOP/s at most (3xTF32
// on the tensor cores); loads by all threads, synchronous, one float each,
// and three block syncs per 32 keys (16-byte cp.async into a ring, one sync
// per 64 keys); the probabilities through shared memory (P from the
// accumulator in registers).  bf16, the mma.sync body before it: loads by
// all threads, synchronous, two block syncs per 64 keys (a TMA ring that
// runs ahead of the products); V transposed element by element into shared
// memory (an MN-major operand); mma.sync fed by 32-bit shared-memory loads
// (wgmma reading its operands itself); 64-row tiles at two blocks an SM
// (128 rows, one 384-thread block); a full-precision expf per kept pair
// (ex2.approx), with the softmax serialised between the products (issued
// under them).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

struct Strides {
  int64_t b, h, s;  // elements; the head dimension is contiguous
};

// ---------------------------------------------------------------------------
// The online softmax, shared by both bodies.  A warp holds 16 q rows by
// 8 NJ keys of scores (a bf16 warp a 64-key tile, a float32 warp half of
// one) in the m16n8 accumulator layout of mma.sync and of wgmma alike:
// element 4j + 2r + e is row row0 + 8r, key k0 + 8j + 2tq + e.
// ---------------------------------------------------------------------------
constexpr int WKV = 64;  // keys per kv tile

// This thread's place in a warp's 16 rows: the warp's first row, the
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
template <int N>
__device__ __forceinline__ void mask_tile(float (&sc)[N], int k0, const Rows& w,
                                          const Masks& mk) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
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

// The online-softmax update of one tile of 2N keys for this thread's two
// rows, in log2 units (m is the running max of the scaled scores): turns
// sc into P (0 where masked), updates m and the running sum l, and gives
// the rescale alpha of the running output.  The two rows go side by side
// and each reduction is a tree of four chains, for the instruction-level
// parallelism one warp a scheduler needs.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, const Rows& w,
                                             const Masks& mk) {
  constexpr int KEYS = 2 * N, JC = N / 16;  // keys, and n8 blocks a chain
  const bool inside = k0 + KEYS <= mk.Skv && (!mk.causal || k0 + KEYS - 1 <= w.qwarp) &&
                      (mk.window <= 0 || w.qwarp + 15 - k0 < mk.window);
  if (!inside) mask_tile(sc, k0, w, mk);
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mx[r][c] = fmaxf(sc[4 * JC * c + 2 * r], sc[4 * JC * c + 2 * r + 1]);
#pragma unroll
      for (int jj = 1; jj < JC; ++jj)
        mx[r][c] = fmaxf(mx[r][c], fmaxf(sc[4 * (JC * c + jj) + 2 * r],
                                         sc[4 * (JC * c + jj) + 2 * r + 1]));
    }
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
  for (int j = 0; j < N / 4; ++j)
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

// ---------------------------------------------------------------------------
// float32 body: 3xTF32 mma.sync, K and V through a cp.async ring
// ---------------------------------------------------------------------------
constexpr int FQ = 64;                // q rows per block, 16 per warp pair
constexpr int FSTAGES = 2;            // kv tiles in flight
constexpr int FTHREADS = 256;         // eight warps: two halves of a tile's keys
constexpr int FHALF = WKV / 2;        // keys a warp takes of a tile

// Row strides in floats: q and K rows padded by 16 floats, V rows by 4, so
// that every fragment load of a warp reads 32 distinct banks (q and K: 16-
// byte chunks t of rows g, g + 1 apart by 64 bytes mod 128; V: rows 2t + e
// at chunks g, apart by 16 bytes mod 128) with offsets known when compiled.
template <int D>
struct F32Tiles {
  static constexpr int QP = D + 16, VP = D + 4;
  static constexpr int Q_HI = 0, Q_LO = FQ * QP;
  static constexpr int K_OFF = 2 * FQ * QP, V_OFF = K_OFF + FSTAGES * WKV * QP;
  static constexpr size_t SMEM = sizeof(float) * (V_OFF + FSTAGES * WKV * VP);
};

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (10 mantissa bits, ties
// away from zero), by two integer operations: half a TF32 unit added to
// the magnitude and the 13 low bits cleared
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as hi + lo, two TF32 values: hi x rounded, lo the remainder (exact in
// float32) rounded; hi + lo keeps x to about 2^-22 of itself
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// d += A B for one m16n8k8 step: a the A fragment (rows g and g + 8, k
// columns t and t + 4), b the B fragment (k rows t and t + 4, column g)
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the two small products first, then the large one,
// all into one accumulator (P V; Q K^T keeps the small ones apart)
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], uint32_t b0_hi,
                                           uint32_t b1_hi, uint32_t b0_lo, uint32_t b1_lo) {
  mma_tf32(d, a_lo, b0_hi, b1_hi);
  mma_tf32(d, a_hi, b0_lo, b1_lo);
  mma_tf32(d, a_hi, b0_hi, b1_hi);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Warps w and w + 4 own q rows 16w .. 16w + 15; of each 64-key tile, warp
// w takes keys 0-31 and w + 4 keys 32-63, each with its own running max,
// sum and output, merged at the end.  Shared memory: q's hi and lo parts,
// then FSTAGES K tiles and FSTAGES V tiles (F32Tiles).
template <int D>
__global__ void __launch_bounds__(FTHREADS, 1)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int Hq, int group, int Sq,
                  int Skv, Strides qs, Strides ks, Strides vs, int causal, int window,
                  float scale_log2) {
  using T = F32Tiles<D>;
  constexpr int QP = T::QP, VP = T::VP, CH = D / 4, NB = D / 8;
  constexpr int AG = D % 64 == 0 ? 2 : 1;   // 32-column groups of V a P V pass
  extern __shared__ float4 smem_f4[];
  float* const sm = reinterpret_cast<float*>(smem_f4);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * FQ;
  const int hq = blockIdx.y, b = blockIdx.z, hk = hq / group;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wrow = 16 * (warp % 4), half = warp / 4;  // rows, and half of each tile
  q += b * qs.b + hq * qs.h;
  k += b * ks.b + hk * ks.h;
  v += b * vs.b + hk * vs.h;

  const int q_last = min(q0 + FQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / WKV * WKV : 0;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + WKV - 1) / WKV : 0;

  // K and V rows past Skv are zero-filled; every thread copies D / 16
  // 16-byte chunks of each
  auto load_tile = [&](int i) {
    const int k0 = kv_begin + i * WKV, s = i % FSTAGES;
    const uint32_t kbase = smem_addr(sm + T::K_OFF + s * WKV * QP);
    const uint32_t vbase = smem_addr(sm + T::V_OFF + s * WKV * VP);
#pragma unroll
    for (int n = 0; n < WKV * CH / FTHREADS; ++n) {
      const int idx = tid + n * FTHREADS, r = idx / CH, c = idx % CH, kj = k0 + r;
      const bool in = kj < Skv;
      cp_async16(kbase + 4 * (r * QP + 4 * c), in ? k + (int64_t)kj * ks.s + 4 * c : k, in);
      cp_async16(vbase + 4 * (r * VP + 4 * c), in ? v + (int64_t)kj * vs.s + 4 * c : v, in);
    }
  };
#pragma unroll
  for (int i = 0; i < FSTAGES - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }

  // q, split once: its hi and lo parts stay in shared memory for every
  // tile; all of a thread's loads are issued before the first is used
  constexpr int QN = FQ * CH / FTHREADS;
  float4 xq[QN];
#pragma unroll
  for (int n = 0; n < QN; ++n) {
    const int idx = tid + n * FTHREADS, r = idx / CH, c = idx % CH, qi = q0 + r;
    xq[n] = qi < Sq ? *reinterpret_cast<const float4*>(q + (int64_t)qi * qs.s + 4 * c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int n = 0; n < QN; ++n) {
    const int idx = tid + n * FTHREADS, r = idx / CH, c = idx % CH;
    uint4 hi, lo;
    split_tf32(xq[n].x, hi.x, lo.x);
    split_tf32(xq[n].y, hi.y, lo.y);
    split_tf32(xq[n].z, hi.z, lo.z);
    split_tf32(xq[n].w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(sm + T::Q_HI + r * QP + 4 * c) = hi;
    *reinterpret_cast<uint4*>(sm + T::Q_LO + r * QP + 4 * c) = lo;
  }

  const Rows rows{q0 + wrow, q0 + wrow + g, t};
  const Masks masks{Skv, causal, window, scale_log2};
  // this thread's fragment bases: q rows wrow + g (+ 8) at chunk t; K rows
  // 32 half + g (+ 8j) at chunk t; V rows 32 half + 2t (+ 8kk + e) at chunk g
  const float* const qh_at = sm + T::Q_HI + (wrow + g) * QP + 4 * t;
  const float* const ql_at = sm + T::Q_LO + (wrow + g) * QP + 4 * t;
  const int k_at = T::K_OFF + (FHALF * half + g) * QP + 4 * t;
  const int v_at = T::V_OFF + (FHALF * half + 2 * t) * VP + 4 * g;
  // output element [j][2r + e]: row g + 8r, column 32 (j / 4) + 4 (2t + e) + j % 4
  float acc[NB][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<FSTAGES - 2>();  // this thread's copies of tile i have landed
    __syncthreads();               // everyone's; and the stage tile i - 1 used is free
    if (i + FSTAGES - 1 < n_tiles) load_tile(i + FSTAGES - 1);
    cp_async_commit();
    const int s = i % FSTAGES, k0 = kv_begin + i * WKV + FHALF * half;
    // a half tile the masks drop for all 16 rows of the warp changes nothing
    if (k0 >= Skv || (causal && k0 > rows.qwarp + 15) ||
        (window > 0 && rows.qwarp - (k0 + FHALF - 1) >= window))
      continue;
    const float* const kt = sm + k_at + s * WKV * QP;
    const float* const vt = sm + v_at + s * WKV * VP;

    // S = q K^T over D in steps of 16: thread t's chunk 4kk + t gives the
    // k columns t and t + 4 of two m16n8k8 steps (d = 16kk + 4t + 2h + e),
    // the same permutation of d for q and K
    // the large products in sc, the small ones in sl: eight chains of
    // products a k-step, each with half the additions to truncate
    float sc[16], sl[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) sc[e] = sl[e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint4 h0 = *reinterpret_cast<const uint4*>(qh_at + 16 * kk);
      const uint4 h1 = *reinterpret_cast<const uint4*>(qh_at + 8 * QP + 16 * kk);
      const uint4 l0 = *reinterpret_cast<const uint4*>(ql_at + 16 * kk);
      const uint4 l1 = *reinterpret_cast<const uint4*>(ql_at + 8 * QP + 16 * kk);
      const uint32_t qh[2][4] = {{h0.x, h1.x, h0.y, h1.y}, {h0.z, h1.z, h0.w, h1.w}};
      const uint32_t ql[2][4] = {{l0.x, l1.x, l0.y, l1.y}, {l0.z, l1.z, l0.w, l1.w}};
      uint32_t kh[4][4], kl[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(kt + 8 * j * QP + 16 * kk);
        split_tf32(x.x, kh[j][0], kl[j][0]);
        split_tf32(x.y, kh[j][1], kl[j][1]);
        split_tf32(x.z, kh[j][2], kl[j][2]);
        split_tf32(x.w, kh[j][3], kl[j][3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(sl + 4 * j, ql[h], kh[j][2 * h], kh[j][2 * h + 1]);
          mma_tf32(sl + 4 * j, qh[h], kl[j][2 * h], kl[j][2 * h + 1]);
          mma_tf32(sc + 4 * j, qh[h], kh[j][2 * h], kh[j][2 * h + 1]);
        }
    }

#pragma unroll
    for (int e = 0; e < 16; ++e) sc[e] = __fadd_rn(sc[e], sl[e]);
    float alpha[2];
    softmax_tile(sc, m, l, alpha, k0, rows, masks);

    // P straight from the accumulator as the A operand: its k column t is
    // key 8kk + 2t and t + 4 is key 8kk + 2t + 1 (V's rows are read in the
    // same order), so no value moves between threads
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split_tf32(sc[4 * kk + 0], ph[kk][0], pl[kk][0]);
      split_tf32(sc[4 * kk + 2], ph[kk][1], pl[kk][1]);
      split_tf32(sc[4 * kk + 1], ph[kk][2], pl[kk][2]);
      split_tf32(sc[4 * kk + 3], ph[kk][3], pl[kk][3]);
    }

    // P V, 32 AG columns a pass in a fresh accumulator (the tensor cores
    // truncate what they add into it), added to the running output after
    // the rescale.  Output column j of n8 block 4a + i is 32a + 4j + i, so
    // thread g reads chunk 8a + g of a V row: one 16-byte load gives four
    // blocks' B values.
#pragma unroll
    for (int a0 = 0; a0 < D / 32; a0 += AG) {
      float pv[4 * AG][4];
#pragma unroll
      for (int j = 0; j < 4 * AG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t vh[AG][2][4], vl[AG][2][4];
#pragma unroll
        for (int aa = 0; aa < AG; ++aa)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 x =
                *reinterpret_cast<const float4*>(vt + (8 * kk + e) * VP + 32 * (a0 + aa));
            split_tf32(x.x, vh[aa][e][0], vl[aa][e][0]);
            split_tf32(x.y, vh[aa][e][1], vl[aa][e][1]);
            split_tf32(x.z, vh[aa][e][2], vl[aa][e][2]);
            split_tf32(x.w, vh[aa][e][3], vl[aa][e][3]);
          }
#pragma unroll
        for (int aa = 0; aa < AG; ++aa)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            mma_3xtf32(pv[4 * aa + c], ph[kk], pl[kk], vh[aa][0][c], vh[aa][1][c],
                       vl[aa][0][c], vl[aa][1][c]);
      }
#pragma unroll
      for (int j = 0; j < 4 * AG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * a0 + j][e] = __fmaf_rn(acc[4 * a0 + j][e], alpha[e / 2], pv[j][e]);
    }
  }

  // The two halves' states merge in the first: warps 4-7 leave theirs in
  // the (now idle) K ring, [j][thread] for coalesced 16-byte accesses; the
  // first half writes the merged rows to the V ring, and all threads store
  // them, whole rows of 16-byte pieces
  __syncthreads();
  float4* const part = reinterpret_cast<float4*>(sm + T::K_OFF);
  float* const out = sm + T::V_OFF;   // FQ rows of VP floats
  const int slot = tid % (FTHREADS / 2);
  if (half == 1) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
      part[j * (FTHREADS / 2) + slot] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    part[NB * (FTHREADS / 2) + slot] = make_float4(m[0], m[1], l[0], l[1]);
  }
  __syncthreads();
  if (half == 0) {
    const float4 ml = part[NB * (FTHREADS / 2) + slot];
    const float m1[2] = {ml.x, ml.y}, l1[2] = {ml.z, ml.w};
    float w0[2], w1[2], inv[2];   // the two halves' rescales, 1 / the row's sum
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mm = fmaxf(m[r], m1[r]), ms = mm == -INFINITY ? 0.f : mm;
      w0[r] = ex2(__fsub_rn(m[r], ms));
      w1[r] = ex2(__fsub_rn(m1[r], ms));
      const float lr = __fmaf_rn(l[r], w0[r], __fmul_rn(l1[r], w1[r]));
      inv[r] = lr == 0.f ? 1.f : __frcp_rn(lr);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float4 p = part[j * (FTHREADS / 2) + slot];
      const float o1[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = __fmul_rn(__fmaf_rn(acc[j][e], w0[e / 2], __fmul_rn(o1[e], w1[e / 2])),
                              inv[e / 2]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int a = 0; a < D / 32; ++a)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float4*>(out + (wrow + g + 8 * r) * VP + 32 * a + 4 * (2 * t + e)) =
              make_float4(acc[4 * a][2 * r + e], acc[4 * a + 1][2 * r + e],
                          acc[4 * a + 2][2 * r + e], acc[4 * a + 3][2 * r + e]);
  }
  __syncthreads();
  o += ((int64_t)b * Hq + hq) * Sq * D;
#pragma unroll
  for (int n = 0; n < FQ * CH / FTHREADS; ++n) {
    const int idx = tid + n * FTHREADS, r = idx / CH, c = idx % CH;
    if (q0 + r < Sq)
      *reinterpret_cast<float4*>(o + (int64_t)(q0 + r) * D + 4 * c) =
          *reinterpret_cast<const float4*>(out + r * VP + 4 * c);
  }
}

// ---------------------------------------------------------------------------
// bf16 body: TMA ring, warp-specialised wgmma
// ---------------------------------------------------------------------------
constexpr int WQ = 128;                   // q rows per block, 64 per consumer
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
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  if (bf16) {
    CUtensorMap qm, km, vm;
    if ((err = tensor_map(&qm, q, D, Sq, Hq, B, qs)) != cudaSuccess) return err;
    if ((err = tensor_map(&km, k, D, Skv, Hkv, B, ks)) != cudaSuccess) return err;
    if ((err = tensor_map(&vm, v, D, Skv, Hkv, B, vs)) != cudaSuccess) return err;
    constexpr size_t smem = Ring<D>::SMEM;
    err = cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + WQ - 1) / WQ, Hq, B);
    flash_wgmma_kernel<D><<<grid, WTHREADS, smem, stream>>>(
        qm, km, vm, static_cast<__nv_bfloat16*>(o), Hq, Hq / Hkv, Sq, Skv, causal, window,
        scale_log2);
  } else {
    constexpr size_t smem = F32Tiles<D>::SMEM;
    err = cudaFuncSetAttribute(flash_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + FQ - 1) / FQ, Hq, B);
    flash_tf32_kernel<D><<<grid, FTHREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), Hq, Hq / Hkv, Sq, Skv, qs, ks, vs, causal, window, scale_log2);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, H, S, D) with the given element strides for B, H and S and a
// contiguous D; o: contiguous (B, Hq, Sq, D) of q's type.  is_bf16 selects
// bf16 for all four, else float32; either way the pointers and the strides
// of every dimension longer than 1 are multiples of 16 bytes (TMA and
// 16-byte cp.async take no less).  D must be 64, 96 or 128.
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
