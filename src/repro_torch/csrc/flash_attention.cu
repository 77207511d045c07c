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
// Design.  The TPU kernel walks a sequential kv grid axis and keeps the
// running statistics in VMEM scratch between grid steps.  Hopper blocks run
// in no order, so here one block owns a 64-row q tile of one (batch, query
// head) and loops over kv tiles itself, with the running max, sum and
// accumulator in registers.  The tile skips are the TPU kernel's: the loop
// starts at the first kv tile that reaches into the window and ends after
// the last tile a causal row can see.  Ragged Sq and Skv are masked inside
// the kernel, so callers never pad, and causal=False needs no fallback.
// Blocks are issued latest q tile first, so the longest causal rows do not
// finish last on a few SMs.  Two bodies share this plan:
//
// * float32 (flash_kernel): float32 FMAs on the CUDA cores, no TF32.  256
//   threads; each holds 4 q rows (ty*4 + i) by D/16 output columns
//   (tx + 16c) and 4 x 2 scores of a 32-row kv tile, and the 16 threads of
//   a row reduce its max and sum with warp shuffles.  q (scaled by 1/sqrt(D)
//   on load, as the TPU kernel does), K, V and the probabilities are staged
//   in shared memory as float32; q k^T reads q and k rows as float4, rows
//   padded to D + 4 floats so eight threads reading eight k rows hit
//   distinct banks.
// * bf16 (flash_mma_kernel): the tensor cores through mma.sync m16n8k16
//   with float32 accumulation.  4 warps, 16 q rows each, 64-row kv tiles.
//   q's fragments stay in registers for the whole loop; S = q k^T comes out
//   in the accumulator layout, is scaled by 1/sqrt(D) in float32 (as the
//   plain version scales the product), masked and exponentiated there, and
//   its registers are repacked as bf16 A fragments of P V without a trip
//   through shared memory (FlashAttention-2's layout identity).  K is
//   staged row-major and V transposed, rows padded by 8 bf16, so that every
//   fragment load is one conflict-free 32-bit read.  The TPU kernel and the
//   plain version multiply V by float32 probabilities; a bf16 P would be
//   off by 2^-9 of each term.  So P goes in as two bf16 fragments, P
//   rounded and the rest of P rounded, and P V takes two mma per k-step:
//   P is then kept to about 2^-17, below the float32 sums' own error.
//   The tensor cores truncate an addition into their accumulator instead
//   of rounding it to nearest, so the error of a sum kept there grows with
//   its length (on an H100, a 32768-key row summed over its 512 kv tiles
//   in the accumulator landed 1.5x over kernels/ref.py's ATTN_TOL).  So
//   each tile's P V sums in a fresh accumulator of 8 mma steps, and the
//   running output is rescaled and added to on the CUDA cores.
//
// Bound on the H100: 4*D flops per (query, key) pair the masks keep, per
// query head; bytes are only q, k, v and o, read or written once.  At the
// prefill shapes the flops bound it: 989 TFLOP/s on the tensor cores in
// bf16, 67 TFLOP/s on the CUDA cores in float32.  The split P makes the
// bf16 body issue 1.5x the bound's tensor-core work (P V twice).  Neither
// body overlaps its tile loads with its arithmetic (no cp.async or TMA
// pipeline yet), so both leave much of their bound unused; in float32 the
// shared-memory loads of q k^T (six float4 loads per 32 FMAs) also keep it
// below the FMA rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
// bf16 body: tensor cores through mma.sync
// ---------------------------------------------------------------------------
constexpr int MQ = 64;          // q rows per block, 16 per warp
constexpr int MKV = 64;         // kv rows per tile
constexpr int MTHREADS = 128;   // 4 warps
constexpr int VP = MKV + 8;     // row stride (bf16) of the transposed V tile

// c += a b for a 16x16 bf16 A (row-major fragments), a 16x8 B (col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x0, x1) as hi + lo: hi the pair rounded to bf16, lo the remainder rounded
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (MQ * (D + 8) + MKV * (D + 8) + D * VP);
}

// q, k, v rows must be 16-byte aligned (the wrapper sees to it).
template <int D>
__global__ void __launch_bounds__(MTHREADS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Hq,
                 int group, int Sq, int Skv, Strides qs, Strides ks, Strides vs, int causal,
                 int window, float scale) {
  constexpr int KP = D + 8;       // row stride (bf16) of the q and k tiles
  constexpr int KSTEPS = D / 16;  // k-steps of q k^T
  constexpr int NT = MKV / 8;     // score n-tiles per warp
  constexpr int ND = D / 8;       // output n-tiles per warp
  constexpr int CH = D / 8;       // 16-byte chunks per row
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);  // MQ x KP
  __nv_bfloat16* Ks = Qs + MQ * KP;                                // MKV x KP
  __nv_bfloat16* Vt = Ks + MKV * KP;                               // D x VP

  const int q0 = (gridDim.x - 1 - blockIdx.x) * MQ;
  const int hq = blockIdx.y, b = blockIdx.z, hk = hq / group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in group
  q += b * qs.b + hq * qs.h;
  k += b * ks.b + hk * ks.h;
  v += b * vs.b + hk * vs.h;
  o += ((int64_t)b * Hq + hq) * Sq * D;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int idx = tid; idx < MQ * CH; idx += MTHREADS) {
    const int r = idx / CH, c = idx - r * CH;
    const int qi = q0 + r;
    *reinterpret_cast<uint4*>(Qs + r * KP + c * 8) =
        qi < Sq ? *reinterpret_cast<const uint4*>(q + qi * qs.s + c * 8) : zero;
  }
  __syncthreads();
  const int qr = warp * 16 + g;  // this thread's tile rows: qr and qr + 8
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kb = 0; kb < KSTEPS; ++kb) {
    const __nv_bfloat16* p = Qs + qr * KP + kb * 16 + 2 * t;
    qf[kb][0] = ld32(p);
    qf[kb][1] = ld32(p + 8 * KP);
    qf[kb][2] = ld32(p + 8);
    qf[kb][3] = ld32(p + 8 * KP + 8);
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  const int qw = q0 + warp * 16;  // first row of this warp
  const int q_last = min(q0 + MQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / MKV * MKV : 0;

  for (int k0 = kv_begin; k0 < kv_end; k0 += MKV) {
    __syncthreads();  // every warp is done with the last tile
    for (int idx = tid; idx < MKV * CH; idx += MTHREADS) {  // K: chunks fastest
      const int r = idx / CH, c = idx - r * CH;
      const int kj = k0 + r;
      *reinterpret_cast<uint4*>(Ks + r * KP + c * 8) =
          kj < Skv ? *reinterpret_cast<const uint4*>(k + kj * ks.s + c * 8) : zero;
    }
    for (int idx = tid; idx < MKV * CH; idx += MTHREADS) {  // V^T: rows fastest
      const int r = idx % MKV, c = idx / MKV;
      const int kj = k0 + r;
      const uint4 val = kj < Skv ? *reinterpret_cast<const uint4*>(v + kj * vs.s + c * 8) : zero;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(c * 8 + i) * VP + r] = e[i];
    }
    __syncthreads();

    // S = q k^T for rows (qr, qr + 8) x this tile's 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kb = 0; kb < KSTEPS; ++kb) {
        const __nv_bfloat16* p = Ks + (j * 8 + g) * KP + kb * 16 + 2 * t;
        mma_bf16(s[j], qf[kb], ld32(p), ld32(p + 8));
      }
    }

    // scale, mask (only where this warp's rows meet an edge) and the
    // online-softmax update; s[j][2r + e] is row qr + 8r, key 8j + 2t + e
    const bool inside = k0 + MKV <= Skv && (!causal || k0 + MKV - 1 <= qw) &&
                        (window <= 0 || qw + 15 - k0 < window);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qw + g + 8 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[j][2 * r + e] * scale;
          if (!inside) {
            const int kj = k0 + j * 8 + 2 * t + e;
            const bool keep =
                kj < Skv && (!causal || qi >= kj) && (window <= 0 || qi - kj < window);
            x = keep ? x : -INFINITY;
          }
          s[j][2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = expf(m[r] - m_safe);  // 0 while the row has seen no key
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[j][2 * r + e] - m_safe);  // 0 where masked
          s[j][2 * r + e] = p;
          rs += p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[r] = l[r] * alpha[r] + rs;
      m[r] = m_new;
    }

    // acc = alpha acc + P V.  The score accumulators of n-tiles 2kk, 2kk+1
    // are the A fragment of k-step kk, split into its bf16 hi and lo parts.
    // This tile's P V sums in a fresh accumulator, added to acc here.
    uint32_t hi[MKV / 16][4], lo[MKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < MKV / 16; ++kk) {
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[kk][0], lo[kk][0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[kk][1], lo[kk][1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[kk][2], lo[kk][2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[kk][3], lo[kk][3]);
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < MKV / 16; ++kk) {
        const __nv_bfloat16* p = Vt + (nd * 8 + g) * VP + kk * 16 + 2 * t;
        const uint32_t b0 = ld32(p), b1 = ld32(p + 8);
        mma_bf16(pv, lo[kk], b0, b1);
        mma_bf16(pv, hi[kk], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] = acc[nd][e] * alpha[e / 2] + pv[e];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qw + g + 8 * r;
    if (qi < Sq) {
      const float den = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        *reinterpret_cast<uint32_t*>(o + (int64_t)qi * D + nd * 8 + 2 * t) =
            pack_bf16(acc[nd][2 * r] / den, acc[nd][2 * r + 1] / den);
    }
  }
}

template <int D>
cudaError_t launch(bool bf16, const void* q, const void* k, const void* v, void* o, int B,
                   int Hq, int Hkv, int Sq, int Skv, Strides qs, Strides ks, Strides vs,
                   int causal, int window, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaError_t err;
  if (bf16) {
    using T = __nv_bfloat16;
    constexpr size_t smem = mma_smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + MQ - 1) / MQ, Hq, B);
    flash_mma_kernel<D><<<grid, MTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), Hq, Hq / Hkv, Sq, Skv, qs, ks, vs, causal, window, scale);
  } else {
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
// bf16 for all four (rows 16-byte aligned: pointers and strides multiples of
// 8 elements), else float32.  D must be 64, 96 or 128.
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
