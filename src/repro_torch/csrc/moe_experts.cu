// The routed experts of a MoE layer where the weights bound them: a SwiGLU
// over the kept choices' rows only, streaming the weights of each expert
// that was routed to, once.
//
// Replaces no Pallas kernel: the reference's MoE is plain JAX (its capacity
// dispatch pads every expert to C rows and XLA lowers the (E, C, D) einsums
// to batched GEMMs), and so was the port's one route until this pair.  It
// was added for decode, where the padded route computed E x C rows for
// T x k choices: at deepseek-v3's decode (T 32, k 8, E 256, dropless C 32)
// 8,192 rows for 256 choices, every one of the 256 experts' 176 MB of
// float32 weights read though about 163 carry a choice, and 721 GFLOP of
// FFMAs a step; at jamba's (E 16, k 2) 512 rows a layer for 64.
//
//   moe_gate_up  h[c, :]   = silu(x[c / k] @ Wg[e]) * (x[c / k] @ Wu[e])
//   moe_down     out[c, :] = h[c] @ Wd[e]
//
// for every choice c = t * k + j in flat order whose expert e = idx[t, j]
// has fewer than `capacity` earlier choices (the padded route's cumsum
// `pos < C`); every other choice's row is written 0, so the combine's
// weighted sum over k reads a zero there as the padded route's overflow
// row gives it.  x (T, D), h (T*k, F), out (T*k, D), the stacked weights
// (E, D, F) and (E, F, D): contiguous row-major float32; idx (T, k) int64
// with row stride ld_idx.  N (the output width) and K (the reduction
// depth) are multiples of 4 and every pointer 16-byte aligned (the wrapper
// checks); any T, k, E, capacity.
//
// Bound on this card.  A weight element does 2 flops for each of its
// expert's kept rows, R of them, against 4 bytes: at the card's float32
// ridge (67 TFLOP/s over 3.35 TB/s, 20 flop/B) R = 40.  Decode sits far
// below (mean R = 1 at deepseek, 4 at jamba), so the bound is bytes: the
// weights of the experts hit, plus x, h and out, over 3.35 TB/s (28.7 GB,
// 8.6 ms, at deepseek's decode step; 44.4 GB, 13.3 ms, over jamba's four
// MoE layers).  models/moe.py takes this route only at a mean of R_MAX (16)
// or fewer rows an expert, where it was timed faster than the padded GEMMs,
// and leaves the shapes nearer the ridge to them.
//
// Design.  Block (e, tile) owns expert e's output columns [n0, n0 + FT).
// It first finds its rows: it walks idx in flat choice order, a chunk of
// THREADS choices at a time, and gives each choice of e its position by a
// block-wide prefix count (ballots), keeping positions under the capacity;
// an expert with no choice exits there, before any weight is read.  Then
// it streams its (K x FT) column strip of each weight matrix, DT rows a
// stage, through a STAGES-deep ring of cp.async copies in shared memory,
// with the stage's DT columns of its x rows (or h rows) beside them, so
// that several stages are in flight while the block multiplies an earlier
// one.  A thread owns 4 adjacent columns and RA rows, in float32 FMAs in
// registers, over its own DPG of each stage's DT depth rows; the depth
// groups' partial sums meet in shared memory and are added in group order.
// (Tiles timed on the card: DT 16 against 32, 3, 4 and 6 stages, 32, 64
// and 128 gate-up columns, 64, 128 and 256 down columns were within 3 % of
// each other; DT 16, 4 stages, 64 and 128 were best.)
// Rows come in passes of at most RP; a pass of more than 8 rows splits the
// threads into row groups (fewer depth groups), so up to RP = 32 rows
// read each weight once.  Passes of 1 to 4 rows share 4 rows'
// accumulators: the bytes bound them, and 1- and 2-row instantiations
// were within 0.3 % of it on the card.  The grid is E x tiles, from host-known shapes
// alone: nothing waits on the host.
//
// Rounding.  No split of K across blocks and no atomics: every output is
// one thread's FMA chain over its depth rows in increasing order, then the
// groups' sums in increasing group order, the same in every run.  The
// order differs from a GEMM's, so the result differs from the plain
// version's (ref.moe_gate_up_ref / moe_down_ref) within ref.MOE_TOL.  No
// TF32: the tensor cores would round every weight to 10 mantissa bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int DT = 16;       // depth rows of a stage
constexpr int RP = 32;       // rows of a pass
constexpr int STAGES = 4;    // stages in the ring
constexpr int RA_MAX = 8;    // rows a thread accumulates

template <int NMAT, int FT>
struct Stage {
  float w[NMAT][DT][FT];
  float x[RP][DT];
};

template <int NMAT, int FT>
struct Smem {
  static constexpr size_t RING = STAGES * sizeof(Stage<NMAT, FT>);
  // the depth groups' partial sums, over the ring once it is drained
  static constexpr size_t RED = (size_t)NMAT * (THREADS / (FT / 4)) * RA_MAX * FT * sizeof(float);
  static constexpr size_t BYTES = RING > RED ? RING : RED;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy 16 bytes; valid = false zero-fills the destination
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

// Walk the choices in flat order, THREADS at a time, and call
// visit(c, pos) on the thread of every choice c routed to expert e, pos
// its place among e's choices.  Block-uniform; returns e's choice count.
template <class Visit>
__device__ int walk_choices(const int64_t* __restrict__ idx, int n_choices, int k,
                            int64_t ld_idx, int e, int* warp_cnt, Visit visit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int c0 = 0; c0 < n_choices; c0 += THREADS) {
    const int c = c0 + threadIdx.x;
    const bool hit = c < n_choices && idx[(int64_t)(c / k) * ld_idx + c % k] == e;
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_cnt[warp] = __popc(m);
    __syncthreads();
    int off = base, total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      const int n = warp_cnt[w];
      off += w < warp ? n : 0;
      total += n;
    }
    if (hit) visit(c, off + __popc(m & ((1u << lane) - 1u)));
    base += total;
    __syncthreads();   // warp_cnt is rewritten by the next chunk
  }
  return base;
}

struct Args {
  const float* src;      // x (T, D) or h (T*k, F): the rows the choices read
  int src_div;           // a choice c reads src row c / src_div (k, or 1)
  const int64_t* idx;
  int64_t ld_idx;
  const float* w0;       // (E, K, N)
  const float* w1;       // (E, K, N) for the gate-up pair, else null
  float* out;            // (T*k, N)
  int n_choices, k, K, N, capacity, n_tiles;
};

// One pass: rows[0, nr) of the block's kept choices (nr <= RA * G), over
// the whole depth K, into out.  RA rows a thread, G row groups.
template <int NMAT, int FT, int RA, int G>
__device__ __forceinline__ void pass(const Args& a, int e, int n0, const int* rows, int nr,
                                     unsigned char* smem) {
  constexpr int CG = FT / 4;              // column groups of 4
  constexpr int LANES = THREADS / CG;     // (row group, depth group) slots
  constexpr int DG = LANES / G;           // depth groups
  constexpr int DPG = DT / DG;            // depth rows a group takes of a stage
  constexpr int ROWS = RA * G;            // x rows a stage stages
  static_assert(LANES % G == 0 && DT % DG == 0 && ROWS <= RP, "tiling");
  using S = Stage<NMAT, FT>;
  S* ring = reinterpret_cast<S*>(smem);
  const int tid = threadIdx.x;
  const int cg = tid % CG, slot = tid / CG;
  const int rg = slot % G, dg = slot / G;
  const int n_stages = (a.K + DT - 1) / DT;
  const int64_t wbase = (int64_t)e * a.K * a.N + n0;

  // this thread's x chunk of every stage: row xr, depth columns 4 xq..+4
  const int xr = tid / (DT / 4), xq = tid % (DT / 4);
  const bool x_row = xr < nr;
  const float* xsrc = a.src + (x_row ? (int64_t)(rows[xr] / a.src_div) * a.K : 0) + 4 * xq;

  auto issue = [&](int i) {
    if (i < n_stages) {
      S& st = ring[i % STAGES];
      const int d0 = i * DT;
#pragma unroll
      for (int m = 0; m < NMAT; ++m) {
        const float* w = (m == 0 ? a.w0 : a.w1) + wbase;
#pragma unroll
        for (int p = tid; p < DT * CG; p += THREADS) {
          const int dd = p / CG, q = p % CG;
          const bool ok = d0 + dd < a.K && n0 + 4 * q < a.N;
          cp16(&st.w[m][dd][4 * q], ok ? w + (int64_t)(d0 + dd) * a.N + 4 * q : a.w0, ok);
        }
      }
      if (xr < ROWS) {
        const bool ok = x_row && d0 + 4 * xq < a.K;
        cp16(&st.x[xr][4 * xq], ok ? xsrc + d0 : a.src, ok);
      }
    }
    cp_commit();   // an empty group past the last stage keeps the count
  };

  float acc[NMAT][RA][4];
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int r = 0; r < RA; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][r][q] = 0.0f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
#pragma unroll 1
  for (int i = 0; i < n_stages; ++i) {
    cp_wait<STAGES - 2>();   // this thread's copies of stage i have landed
    __syncthreads();         // everyone's have, and stage i-1 is consumed
    issue(i + STAGES - 1);
    const S& st = ring[i % STAGES];
#pragma unroll
    for (int j = 0; j < DPG; ++j) {
      const int dd = dg * DPG + j;
      float4 w[NMAT];
#pragma unroll
      for (int m = 0; m < NMAT; ++m) w[m] = *reinterpret_cast<const float4*>(&st.w[m][dd][4 * cg]);
#pragma unroll
      for (int r = 0; r < RA; ++r) {
        const float xv = st.x[rg * RA + r][dd];
#pragma unroll
        for (int m = 0; m < NMAT; ++m) {
          acc[m][r][0] = __fmaf_rn(xv, w[m].x, acc[m][r][0]);
          acc[m][r][1] = __fmaf_rn(xv, w[m].y, acc[m][r][1]);
          acc[m][r][2] = __fmaf_rn(xv, w[m].z, acc[m][r][2]);
          acc[m][r][3] = __fmaf_rn(xv, w[m].w, acc[m][r][3]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();   // the ring is drained: its space takes the partial sums

  // red[m][dg][row][col], row = rg * RA + r
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int r = 0; r < RA; ++r)
      *reinterpret_cast<float4*>(&red[((m * DG + dg) * ROWS + rg * RA + r) * FT + 4 * cg]) =
          make_float4(acc[m][r][0], acc[m][r][1], acc[m][r][2], acc[m][r][3]);
  __syncthreads();
  for (int o = tid; o < nr * FT; o += THREADS) {
    const int r = o / FT, col = o % FT;
    if (n0 + col >= a.N) continue;
    float s[NMAT];
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      s[m] = 0.0f;
#pragma unroll
      for (int g = 0; g < DG; ++g) s[m] = __fadd_rn(s[m], red[((m * DG + g) * ROWS + r) * FT + col]);
    }
    float v = s[0];
    if (NMAT == 2) v = __fmul_rn(__fdiv_rn(s[0], __fadd_rn(1.0f, expf(-s[0]))), s[NMAT - 1]);
    a.out[(int64_t)rows[r] * a.N + n0 + col] = v;
  }
  __syncthreads();   // red and rows are rewritten by the next pass
}

template <int NMAT, int FT>
__global__ void __launch_bounds__(THREADS, 2) moe_rows_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int rows[RP];
  __shared__ int warp_cnt[THREADS / 32];
  const int e = blockIdx.x / a.n_tiles;
  const int n0 = (blockIdx.x % a.n_tiles) * FT;

  int count = 0;
  for (int p0 = 0; p0 == 0 || p0 < min(count, a.capacity); p0 += RP) {
    count = walk_choices(a.idx, a.n_choices, a.k, a.ld_idx, e, warp_cnt, [&](int c, int pos) {
      if (pos >= p0 && pos < p0 + RP && pos < a.capacity) rows[pos - p0] = c;
    });
    const int nr = min(RP, min(count, a.capacity) - p0);
    if (nr <= 0) break;        // block-uniform: an expert no choice was routed to
    if (nr <= 4) pass<NMAT, FT, 4, 1>(a, e, n0, rows, nr, smem);
    else if (nr <= 8) pass<NMAT, FT, 8, 1>(a, e, n0, rows, nr, smem);
    else if (nr <= 16) pass<NMAT, FT, 8, 2>(a, e, n0, rows, nr, smem);
    else pass<NMAT, FT, 8, 4>(a, e, n0, rows, nr, smem);
  }
  if (count > a.capacity) {   // the dropped choices' rows are 0
    walk_choices(a.idx, a.n_choices, a.k, a.ld_idx, e, warp_cnt, [&](int c, int pos) {
      if (pos >= a.capacity)
        for (int col = 0; col < FT && n0 + col < a.N; col += 4)
          *reinterpret_cast<float4*>(&a.out[(int64_t)c * a.N + n0 + col]) =
              make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    });
  }
}

template <int NMAT, int FT>
int launch(const Args& a, int E, cudaStream_t stream) {
  constexpr size_t smem = Smem<NMAT, FT>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(moe_rows_kernel<NMAT, FT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)E * a.n_tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  moe_rows_kernel<NMAT, FT><<<(unsigned)blocks, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the gate-up pair's output columns a block (F), and the down kernel's (D)
constexpr int FT_GATE_UP = 64;
constexpr int FT_DOWN = 128;

}  // namespace

// Plain C entries for ctypes; each returns the cudaError_t of its launch.
// h (T*k, F) = silu(x Wg) * (x Wu) at the kept choices, 0 elsewhere.
extern "C" int moe_gate_up(const float* x, const int64_t* idx, const float* w_gate,
                           const float* w_up, float* h, int T, int k, int64_t ld_idx, int E,
                           int D, int F, int capacity, cudaStream_t stream) {
  if (T < 0 || k < 1 || E < 1 || D % 4 || F % 4 || capacity < 1) return (int)cudaErrorInvalidValue;
  if ((int64_t)T * k == 0 || F == 0) return (int)cudaSuccess;
  const Args a{x, k, idx, ld_idx, w_gate, w_up, h, T * k, k, D, F, capacity,
               (F + FT_GATE_UP - 1) / FT_GATE_UP};
  return launch<2, FT_GATE_UP>(a, E, stream);
}

// out (T*k, D) = h Wd at the kept choices, 0 elsewhere.
extern "C" int moe_down(const float* h, const int64_t* idx, const float* w_down, float* out,
                        int T, int k, int64_t ld_idx, int E, int F, int D, int capacity,
                        cudaStream_t stream) {
  if (T < 0 || k < 1 || E < 1 || D % 4 || F % 4 || capacity < 1) return (int)cudaErrorInvalidValue;
  if ((int64_t)T * k == 0 || D == 0) return (int)cudaSuccess;
  const Args a{h, 1, idx, ld_idx, w_down, nullptr, out, T * k, k, F, D, capacity,
               (D + FT_DOWN - 1) / FT_DOWN};
  return launch<1, FT_DOWN>(a, E, stream);
}
