// K7 `mamba_chunk_scan`: the selective state-space (S6) scan of every chunk
// of a sequence from its own initial state; its states-only launch; the
// chunk combine between the two; and the route, one walk over the chunks
// that does the work of all three.
//
// Replaces src/repro/kernels/mamba_scan.py::mamba_chunk_scan (Pallas body
// `_scan_kernel`).  Per chunk, per channel d and state n, for each step t:
//   h[d,n] = exp(dt[t,d] * a[d,n]) * h[d,n] + (dt[t,d] * x[t,d]) * B[t,n]
//   y[t,d] = sum_n h[d,n] * C[t,n]
// x, dt (Bt, L, D) and B, C (Bt, L, N) in one type T (float or bf16);
// a (D, N), h0 and h_out (Bt, n_chunks, D, N) float32; y (Bt, L, D) in T.
// ops.mamba_scan runs the route over more than one chunk, K7 from zero
// states over one.
//
// Design.  The TPU kernel keeps a (128, N) channel block in VMEM and walks
// the chunk with a fori_loop.  Here the grid is (D/BD, n_chunks, Bt) and
// each thread owns one channel d: its N states and its row of a live in
// registers (N a template parameter), the chunk's B_t and C_t (chunk x N)
// are staged once in shared memory, and x_t and dt_t
// are read coalesced along d.  Steps past L (a ragged last chunk) and
// channels past D are masked here; no caller pads.
// - The full launch rounds every product and add to nearest in the order
//   of ref.mamba_chunk_scan_ref (y sums over n in increasing order) with
//   the full-precision expf, so it equals its plain version bit for bit.
//   That expf is about ten FP32 instructions beside its MUFU.EX2, so this
//   launch is bound by the FP32 pipes' issue, about 16 instructions a
//   (t, d, n) term: about 2.3 ms at jamba's 32k-token call (bf16, D = 8192,
//   N = 16), where the bytes of x, dt, y and the states take 0.56 ms.
// - The states-only launch (y == NULL: no C, no y, no h.C sum; h0 == NULL:
//   zero states) runs the same arithmetic, so its states equal the full
//   launch's bit for bit.  It keeps the exact expf too: decayed by
//   ex2.approx, the states land an ulp or so away, and the bf16 y that the
//   full launch rounds from the chunk states combined from them flips often
//   enough to read most of SCAN_TOL (tools/scan_bmm_ab.py, variant ex2).
//
// The combine: H(0) = 0, H(c) = exp(a * sum of chunk c-1's dt) * H(c-1) +
// S(c-1), with S the states-only launch's output.  A block owns CD channels
// of one batch row and walks the chunks in order: its threads first sum
// each chunk's dt in increasing t into shared memory (CG chunks at a time,
// coalesced along d), then a thread per (d, n) carries H through the
// chunks with the full-precision expf.  Bound: the bytes of dt, S and H,
// 0.81 GB at jamba's 32k call, 0.24 ms.
//
// The route (`mamba_scan_route`): the states pass, the combine and the full
// launch from the combined states compute every term's decay twice and
// send the chunk states through device memory.  A block that walks the
// chunks in order knows H(c) when chunk c starts, so it runs both
// recurrences of the chunk off one decay a term: h_loc from zero (the
// states pass's S(c)) and h_true from H(c) (the full launch's), and at the
// chunk's end H(c+1) = exp(dt sum * a) * H(c) + h_loc as the combine does.
// Every product and add is the three launches' own, rounded in their order,
// so the route equals them bit for bit (in chunk 0 h_loc is h_true from
// H(0) = 0; the last chunk's h_loc is unused).  It writes y and the last
// state (Bt, D, N).
// - Parallelism comes from (d, n): the walk leaves none across chunks.  A
//   block owns RW = 32 channels, lane = channel, and N / G warps, warp j
//   carrying states [jG, jG + G) (G = ROUTE_G = 4: 4096 warps at jamba's
//   call, 256 blocks, two an SM).
// - y's sum over n runs through the warps in order: warp j walks tile
//   i - j in iteration i, adds its G products to the partial sums warp j - 1
//   left in shared memory for that tile the iteration before, and leaves
//   its own for warp j + 1; warp NJ - 1's are y.  That moves 8 bytes a
//   (t, d) between warps where staging all N products moved 128, and every
//   chunk start falls at a tile start, the same for a whole warp.
// - Tiles of RT steps of x, dt, B and C come in through an RS-stage TMA
//   ring (one thread issues, an mbarrier a stage), are converted once to
//   float32 (dt, dt * x) per (t, d) and B, C per (t, n), and kept NS tiles
//   deep for the lagging warps; one barrier a tile.
// - Bound: FP32 issue, about 19 SASS instructions a term against the three
//   launches' 16 + 13 (tools/scan_bmm_ab.py --route counts them), with the
//   exact expf on the SFUs 1.03 ms and the bytes of x, dt, y, B and C
//   0.48 ms at jamba's call.  The walk computes a tile's decays and inputs
//   before its recurrences, behind a branch ptxas keeps, so that the
//   scheduler has 64 exponentials to interleave with two warps a scheduler.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BD = 128;           // channels per scan block, one per thread
constexpr int CD = 32;            // channels per combine block
constexpr int CG = 64;            // chunks whose dt sums a combine block stages at a time

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

template <int N, typename T, bool WRITE_Y>
__global__ void __launch_bounds__(BD)
mamba_chunk_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                        const float* __restrict__ a, const T* __restrict__ bm,
                        const T* __restrict__ cm, const float* __restrict__ h0,
                        T* __restrict__ y, float* __restrict__ hout, int L,
                        int D, int chunk, int n_chunks) {
  extern __shared__ float smem[];
  float* bs = smem;              // (chunk, N)
  float* cs = smem + chunk * N;  // (chunk, N), WRITE_Y only
  const int d = blockIdx.x * BD + threadIdx.x;
  const int ci = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int t0 = ci * chunk;
  const int steps = min(chunk, L - t0);
  const int64_t row0 = bi * L + t0;  // first (b, t) of the chunk
  for (int i = threadIdx.x; i < steps * N; i += BD) {
    bs[i] = to_f(bm[row0 * N + i]);
    if (WRITE_Y) cs[i] = to_f(cm[row0 * N + i]);
  }
  __syncthreads();
  if (d >= D) return;

  float av[N], h[N];
  const int64_t hoff = ((bi * n_chunks + ci) * (int64_t)D + d) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = a[(int64_t)d * N + n];
    h[n] = h0 != nullptr ? h0[hoff + n] : 0.0f;
  }
  const T* xp = x + row0 * D + d;
  const T* dtp = dt + row0 * D + d;
  T* yp = y + row0 * D + d;
  for (int t = 0; t < steps; ++t) {
    const float dtt = to_f(dtp[(int64_t)t * D]);
    const float dtx = __fmul_rn(dtt, to_f(xp[(int64_t)t * D]));
    const float* bt = bs + t * N;
    const float* ct = cs + t * N;
    float yt = 0.0f;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float decay = expf(__fmul_rn(dtt, av[n]));
      h[n] = __fadd_rn(__fmul_rn(decay, h[n]), __fmul_rn(dtx, bt[n]));
      if (WRITE_Y) {
        const float p = __fmul_rn(h[n], ct[n]);
        yt = n == 0 ? p : __fadd_rn(yt, p);
      }
    }
    if (WRITE_Y) yp[(int64_t)t * D] = from_f<T>(yt);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) hout[hoff + n] = h[n];
}

template <int N, typename T>
__global__ void __launch_bounds__(CD * N)
mamba_chunk_combine_kernel(const T* __restrict__ dt, const float* __restrict__ a,
                           const float* __restrict__ s_local, float* __restrict__ h_init,
                           int L, int D, int chunk, int n_chunks) {
  __shared__ float dsum[CG][CD];
  const int64_t bi = blockIdx.y;
  const int d0 = blockIdx.x * CD;
  // carrying H: channel d0 + dl, state n
  const int dl = threadIdx.x / N, n = threadIdx.x % N;
  const int d = d0 + dl;
  const bool live = d < D;
  const float an = live ? a[(int64_t)d * N + n] : 0.0f;
  // summing dt: channel d0 + sl, chunks sr, sr + N, ... of each group
  const int sl = threadIdx.x % CD, sr = threadIdx.x / CD;
  float h = 0.0f;  // H(c)
  for (int c0 = 0; c0 < n_chunks - 1; c0 += CG) {
    const int cn = min(CG, n_chunks - 1 - c0);
    __syncthreads();  // the previous group's sums are read
    for (int cc = sr; cc < cn; cc += N) {
      float s = 0.0f;
      if (d0 + sl < D) {
        const T* p = dt + (bi * L + (int64_t)(c0 + cc) * chunk) * D + d0 + sl;
#pragma unroll 8
        for (int t = 0; t < chunk; ++t) s = __fadd_rn(s, to_f(p[(int64_t)t * D]));
      }
      dsum[cc][sl] = s;
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int cc = 0; cc < cn; ++cc) {
        const int64_t off = ((bi * n_chunks + c0 + cc) * (int64_t)D + d) * N + n;
        h_init[off] = h;
        const float decay = expf(__fmul_rn(dsum[cc][dl], an));
        h = __fadd_rn(__fmul_rn(decay, h), s_local[off]);
      }
    }
  }
  if (live) h_init[((bi * n_chunks + n_chunks - 1) * (int64_t)D + d) * N + n] = h;
}

template <int N, typename T, bool WRITE_Y>
int launch(const void* x, const void* dt, const float* a, const void* bm,
           const void* cm, const float* h0, void* y, float* hout, int Bt, int L,
           int D, int chunk, cudaStream_t stream) {
  const int n_chunks = (L + chunk - 1) / chunk;
  if (n_chunks > 65535 || Bt > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (WRITE_Y ? 2 : 1) * (size_t)chunk * N * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 blocks((D + BD - 1) / BD, n_chunks, Bt);
  mamba_chunk_scan_kernel<N, T, WRITE_Y><<<blocks, BD, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a,
      static_cast<const T*>(bm), static_cast<const T*>(cm), h0,
      static_cast<T*>(y), hout, L, D, chunk, n_chunks);
  return (int)cudaGetLastError();
}

template <int N, typename T>
int dispatch_mode(const void* x, const void* dt, const float* a, const void* bm,
                  const void* cm, const float* h0, void* y, float* hout, int Bt, int L,
                  int D, int chunk, cudaStream_t stream) {
  if (y == nullptr)
    return launch<N, T, false>(x, dt, a, bm, cm, h0, y, hout, Bt, L, D, chunk, stream);
  return launch<N, T, true>(x, dt, a, bm, cm, h0, y, hout, Bt, L, D, chunk, stream);
}

template <typename T>
int dispatch_n(const void* x, const void* dt, const float* a, const void* bm,
               const void* cm, const float* h0, void* y, float* hout, int Bt, int L,
               int D, int N, int chunk, cudaStream_t stream) {
  switch (N) {
    case 8:
      return dispatch_mode<8, T>(x, dt, a, bm, cm, h0, y, hout, Bt, L, D, chunk, stream);
    case 16:
      return dispatch_mode<16, T>(x, dt, a, bm, cm, h0, y, hout, Bt, L, D, chunk, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int N, typename T>
int launch_combine(const void* dt, const float* a, const float* s_local, float* h_init,
                   int Bt, int L, int D, int chunk, cudaStream_t stream) {
  const int n_chunks = (L + chunk - 1) / chunk;
  if (Bt > 65535) return (int)cudaErrorInvalidValue;
  const dim3 blocks((D + CD - 1) / CD, Bt);
  mamba_chunk_combine_kernel<N, T><<<blocks, CD * N, 0, stream>>>(
      static_cast<const T*>(dt), a, s_local, h_init, L, D, chunk, n_chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int combine_n(const void* dt, const float* a, const float* s_local, float* h_init, int Bt,
              int L, int D, int N, int chunk, cudaStream_t stream) {
  switch (N) {
    case 8:
      return launch_combine<8, T>(dt, a, s_local, h_init, Bt, L, D, chunk, stream);
    case 16:
      return launch_combine<16, T>(dt, a, s_local, h_init, Bt, L, D, chunk, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- the route
constexpr int RW = 32;       // channels a route block walks: a warp's lanes
constexpr int RT = 16;       // steps a tile
constexpr int RS = 4;        // tiles in flight: the TMA ring's stages
constexpr int NS = 8;        // converted tiles a block keeps
constexpr int ROUTE_G = 4;   // states a thread carries
constexpr int SUB = RT < 16 ? RT : 16;   // steps whose decays a thread computes ahead

constexpr uint32_t align128(uint32_t bytes) { return (bytes + 127u) & ~127u; }

// Shared memory of a route block, from a 128-byte aligned base: the ring
// (per stage the x, dt, B and C boxes of one tile of RT steps); NS
// converted tiles, each (dt, dt * x) per (t, d) and B, C per (t, n) in
// float32; two sets (by iteration) of the partial y sums warps 0..NJ-2
// pass on, a row of RT a channel (PR floats: padded so that 8 rows' 16-byte
// pieces fall in distinct banks); then the ring's mbarriers.
template <int N, int G, typename T>
struct RouteSmem {
  static constexpr int NJ = N / G;          // warps: one a group of G states
  static constexpr int THREADS = 32 * NJ;
  static constexpr int PR = RT + 4;
  static constexpr uint32_t X_TX = RT * RW * sizeof(T);   // an x or dt box
  static constexpr uint32_t B_TX = RT * N * sizeof(T);    // a B or C box
  static constexpr uint32_t TX = 2 * X_TX + 2 * B_TX;     // a tile's bytes
  static constexpr uint32_t XB = align128(X_TX), BB = align128(B_TX);
  static constexpr uint32_t STAGE = 2 * XB + 2 * BB;
  static constexpr uint32_t CVT = align128(RT * RW * 8 + 2 * RT * N * 4);
  static constexpr uint32_t CV = RS * STAGE;
  static constexpr uint32_t PS = align128((NJ > 1 ? NJ - 1 : 1) * RW * PR * 4);
  static constexpr uint32_t P = CV + NS * CVT;
  static constexpr uint32_t BAR = P + 2 * PS;
  static constexpr uint32_t BYTES = BAR + RS * 8;
  static_assert(N % G == 0 && RT % NJ == 0 && RT % SUB == 0 && NJ + 1 <= NS &&
                    (NS & (NS - 1)) == 0,
                "states a thread must divide N, warps RT");
};

template <int G>
__device__ __forceinline__ void load_g(const float* p, float (&v)[G]) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int g = 0; g < G; g += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + g);
      v[g] = q.x, v[g + 1] = q.y, v[g + 2] = q.z, v[g + 3] = q.w;
    }
  } else if constexpr (G == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

template <int G>
__device__ __forceinline__ void store_g(float* p, const float (&v)[G]) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int g = 0; g < G; g += 4)
      *reinterpret_cast<float4*>(p + g) = make_float4(v[g], v[g + 1], v[g + 2], v[g + 3]);
  } else if constexpr (G == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// A thread of a route block (lane = channel, warp j = states [jG, jG + G))
// and its state.
template <int N, int G, typename T>
struct RouteThread {
  using S = RouteSmem<N, G, T>;
  static constexpr int NJ = S::NJ;
  uint8_t* sm;
  int tid, lane, j, d, D, L, chunk;
  float av[G];                     // a's row
  float hs[G], hl[G], ht[G];       // H(c), states from zero, states from H(c)
  float dsum;                      // chunk c's dt sum so far
  int next_start;                  // the next chunk's first step

  __device__ __forceinline__ float2* dtx(int tile) const {
    return reinterpret_cast<float2*>(sm + S::CV + (tile & (NS - 1)) * S::CVT);
  }
  __device__ __forceinline__ float* bs(int tile) const {
    return reinterpret_cast<float*>(dtx(tile) + RT * RW);
  }
  __device__ __forceinline__ float* cs(int tile) const { return bs(tile) + RT * N; }
  // warp w's partial y sums of iteration i, this lane's row
  __device__ __forceinline__ float* part(int i, int w) const {
    return reinterpret_cast<float*>(sm + S::P + (i & 1) * S::PS) + (w * RW + lane) * S::PR;
  }

  // ring stage s into converted tile `tile`: (dt, dt * x) per (t, d), B and
  // C per (t, n) in float32
  __device__ __forceinline__ void convert(int s, int tile) const {
    const uint8_t* st = sm + s * S::STAGE;
    const T* xs = reinterpret_cast<const T*>(st);
    const T* dts = reinterpret_cast<const T*>(st + S::XB);
    const T* bt = reinterpret_cast<const T*>(st + 2 * S::XB);
    const T* ct = reinterpret_cast<const T*>(st + 2 * S::XB + S::BB);
    float2* q2 = dtx(tile);
    float* bf = bs(tile);
    float* cf = cs(tile);
#pragma unroll
    for (int q = 0; q < RT / NJ; ++q) {
      const int e = (q * NJ + j) * RW + lane;
      const float dv = to_f(dts[e]);
      q2[e] = make_float2(dv, __fmul_rn(dv, to_f(xs[e])));
    }
#pragma unroll
    for (int q = 0; q < (RT * N + S::THREADS - 1) / S::THREADS; ++q) {
      const int e = q * S::THREADS + tid;
      if ((RT * N) % S::THREADS == 0 || e < RT * N) {
        bf[e] = to_f(bt[e]);
        cf[e] = to_f(ct[e]);
      }
    }
  }

  // chunk c starts: H(c) = exp(dt sum * a) * H(c - 1) + h_loc, then
  // h_true = H(c), h_loc = 0
  __device__ __forceinline__ void start_chunk() {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      hs[g] = __fadd_rn(__fmul_rn(expf(__fmul_rn(dsum, av[g])), hs[g]), hl[g]);
      ht[g] = hs[g];
      hl[g] = 0.0f;
    }
    dsum = 0.0f;
    next_start += chunk;
  }

  // This warp's tile `tile` (steps tile * RT..) in iteration i: one decay
  // a term feeds h_loc and h_true.  y's partial sum of each step in
  // increasing n comes from warp j - 1 (written the iteration before; warp 0
  // starts from -0, which adds exactly), takes this warp's G products and
  // goes on to warp j + 1; warp NJ - 1's is y, written to yp + r * D.  FAST:
  // the tile is whole and starts no chunk past its first step; it is walked
  // SUB steps at a time (the whole tile), their decays and inputs dt * x *
  // B first (none depends on a state), so that the scheduler has SUB * G
  // exponentials to interleave.  Otherwise each step is checked: a chunk
  // may start at it, and the walk stops at L.
  template <bool FAST>
  __device__ __forceinline__ void walk(int i, int tile, T* yp, bool live) {
    const float2* q2 = dtx(tile) + lane;
    const float* bv0 = bs(tile) + j * G;
    const float* cv0 = cs(tile) + j * G;
    const float* pin = part(i - 1, j > 0 ? j - 1 : 0);
    float* pout = part(i, j);
    const bool last = j == NJ - 1;
    if constexpr (FAST) {
      if (tile * RT == next_start) start_chunk();
#pragma unroll 1
      for (int r0 = 0; r0 < RT; r0 += SUB) {
        float decay[SUB][G], u[SUB][G], acc[SUB];
        if (j > 0) {
          load_g<SUB>(pin + r0, acc);
        } else {
#pragma unroll
          for (int r = 0; r < SUB; ++r) acc[r] = -0.0f;
        }
#pragma unroll
        for (int r = 0; r < SUB; ++r) {
          const float2 q = q2[(r0 + r) * RW];   // (dt, dt * x)
          dsum = __fadd_rn(dsum, q.x);
          float bv[G];
          load_g<G>(bv0 + (r0 + r) * N, bv);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            decay[r][g] = expf(__fmul_rn(q.x, av[g]));
            u[r][g] = __fmul_rn(q.y, bv[g]);
          }
        }
        // a branch ptxas cannot drop keeps the decays above it, computed
        // ahead of the walk (without it ptxas sinks each beside its use)
        if (L < 0) break;
#pragma unroll
        for (int r = 0; r < SUB; ++r) {
          float cv[G], pv[G];
          load_g<G>(cv0 + (r0 + r) * N, cv);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            hl[g] = __fadd_rn(__fmul_rn(decay[r][g], hl[g]), u[r][g]);
            ht[g] = __fadd_rn(__fmul_rn(decay[r][g], ht[g]), u[r][g]);
            pv[g] = __fmul_rn(ht[g], cv[g]);
          }
#pragma unroll
          for (int g = 0; g < G; ++g) acc[r] = __fadd_rn(acc[r], pv[g]);
        }
        if (last) {
          if (live)
#pragma unroll
            for (int r = 0; r < SUB; ++r) yp[(int64_t)(r0 + r) * D] = from_f<T>(acc[r]);
        } else {
          store_g<SUB>(pout + r0, acc);
        }
      }
    } else {
#pragma unroll 1
      for (int r = 0; r < RT; ++r) {
        const int step = tile * RT + r;
        if (step >= L) break;
        if (step == next_start) start_chunk();
        const float2 q = q2[r * RW];
        float bv[G], cv[G];
        load_g<G>(bv0 + r * N, bv);
        load_g<G>(cv0 + r * N, cv);
        dsum = __fadd_rn(dsum, q.x);
        float acc = j > 0 ? pin[r] : -0.0f;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float decay = expf(__fmul_rn(q.x, av[g]));
          const float u = __fmul_rn(q.y, bv[g]);
          hl[g] = __fadd_rn(__fmul_rn(decay, hl[g]), u);
          ht[g] = __fadd_rn(__fmul_rn(decay, ht[g]), u);
          acc = __fadd_rn(acc, __fmul_rn(ht[g], cv[g]));
        }
        if (!last)
          pout[r] = acc;
        else if (live)
          yp[(int64_t)r * D] = from_f<T>(acc);
      }
    }
  }
};

template <int N, int G, typename T>
__global__ void __launch_bounds__(RouteSmem<N, G, T>::THREADS)
mamba_scan_route_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap dtmap,
                        const __grid_constant__ CUtensorMap bmap,
                        const __grid_constant__ CUtensorMap cmap, const float* __restrict__ a,
                        T* __restrict__ y, float* __restrict__ h_final, int L, int D,
                        int chunk) {
  using S = RouteSmem<N, G, T>;
  constexpr int NJ = S::NJ;
  extern __shared__ uint8_t route_raw[];
  const uint32_t raw = smem_addr(route_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  const int tid = threadIdx.x;
  RouteThread<N, G, T> th;
  th.sm = route_raw + (base - raw);
  th.tid = tid;
  th.lane = tid % 32;
  th.j = tid / 32;
  th.d = blockIdx.x * RW + th.lane;
  th.D = D;
  th.L = L;
  th.chunk = chunk;
  const bool live = th.d < D;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    th.av[g] = live ? a[(int64_t)th.d * N + th.j * G + g] : 0.0f;
    th.hs[g] = th.hl[g] = th.ht[g] = 0.0f;
  }
  th.dsum = 0.0f;
  th.next_start = chunk;
  const int d0 = blockIdx.x * RW, bi = blockIdx.y;
  auto full = [&](int s) { return base + S::BAR + 8u * s; };

  // the sequence's tiles of RT steps come through the ring in order; in
  // iteration i warp j walks tile i - j, so warp NJ - 1 ends NJ - 1
  // iterations after warp 0
  const int n_tiles = (L + RT - 1) / RT, n_iter = n_tiles + NJ - 1;
  auto issue = [&](int i) {   // tile i into its stage
    const int s = i % RS;
    const uint32_t st = base + s * S::STAGE;
    mbar_expect_tx(full(s), S::TX);
    tma_load(st, &xmap, full(s), d0, i * RT, bi, 0);
    tma_load(st + S::XB, &dtmap, full(s), d0, i * RT, bi, 0);
    tma_load(st + 2 * S::XB, &bmap, full(s), 0, i * RT, bi, 0);
    tma_load(st + 2 * S::XB + S::BB, &cmap, full(s), 0, i * RT, bi, 0);
  };
  if (tid == 0) {
    for (int s = 0; s < RS; ++s) mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < RS && i < n_tiles; ++i) issue(i);
  mbar_wait(full(0), 0);
  th.convert(0, 0);
  __syncthreads();
  if (tid == 0 && RS < n_tiles) issue(RS);

  const bool aligned = chunk % RT == 0;   // chunks start at tile starts
  for (int i = 0; i < n_iter; ++i) {
    if (i + 1 < n_tiles) mbar_wait(full((i + 1) % RS), ((i + 1) / RS) & 1);
    const int tile = i - th.j;   // the same for the whole warp
    T* yp = y + ((int64_t)bi * L + (int64_t)tile * RT) * D + th.d;
    if (tile >= 0 && tile < n_tiles) {
      if (aligned && (tile + 1) * RT <= L)
        th.template walk<true>(i, tile, yp, live);
      else
        th.template walk<false>(i, tile, yp, live);
    }
    if (i + 1 < n_tiles) th.convert((i + 1) % RS, i + 1);
    __syncthreads();   // tile i + 1 converted, its stage free; partial sums passed on
    if (tid == 0 && i + 1 + RS < n_tiles) issue(i + 1 + RS);
  }
  if (live)
#pragma unroll
    for (int g = 0; g < G; ++g) h_final[((int64_t)bi * D + th.d) * N + th.j * G + g] = th.ht[g];
}

// A (W, L, Bt, 1) map of a tensor whose rows lie ld elements apart, boxes
// of (box_w, RT) with zero fill past W and L.
cudaError_t route_map(CUtensorMap* map, const void* ptr, bool bf16, int W, int ld, int L,
                      int Bt, int box_w) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t e = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)L, (cuuint64_t)Bt, 1};
  const cuuint64_t strides[3] = {e * ld, e * ld * L, e * ld * L * Bt};
  const cuuint32_t box[4] = {(cuuint32_t)box_w, RT, 1, 1}, unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
      const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidPitchValue;
}

template <int N, typename T>
int launch_route(const void* x, const void* dt, const float* a, const void* bm, const void* cm,
                 void* y, float* h_final, int Bt, int L, int D, int ld, int chunk,
                 cudaStream_t stream) {
  constexpr int G = ROUTE_G < N ? ROUTE_G : N;
  using S = RouteSmem<N, G, T>;
  constexpr bool bf16 = sizeof(T) == 2;
  if (Bt > 65535 || ld < D || (ld * sizeof(T)) % 16 != 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dt) |
       reinterpret_cast<uintptr_t>(bm) | reinterpret_cast<uintptr_t>(cm)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xm, dm, bmap, cmap;
  cudaError_t err;
  if ((err = route_map(&xm, x, bf16, D, ld, L, Bt, RW)) != cudaSuccess ||
      (err = route_map(&dm, dt, bf16, D, ld, L, Bt, RW)) != cudaSuccess ||
      (err = route_map(&bmap, bm, bf16, N, N, L, Bt, N)) != cudaSuccess ||
      (err = route_map(&cmap, cm, bf16, N, N, L, Bt, N)) != cudaSuccess)
    return (int)err;
  constexpr size_t smem = S::BYTES + 128;   // + the base's alignment
  err = cudaFuncSetAttribute(mamba_scan_route_kernel<N, G, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((D + RW - 1) / RW, Bt);
  mamba_scan_route_kernel<N, G, T><<<blocks, S::THREADS, smem, stream>>>(
      xm, dm, bmap, cmap, a, static_cast<T*>(y), h_final, L, D, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int route_n(const void* x, const void* dt, const float* a, const void* bm, const void* cm,
            void* y, float* h_final, int Bt, int L, int D, int ld, int N, int chunk,
            cudaStream_t stream) {
  switch (N) {
    case 8:
      return launch_route<8, T>(x, dt, a, bm, cm, y, h_final, Bt, L, D, ld, chunk, stream);
    case 16:
      return launch_route<16, T>(x, dt, a, bm, cm, y, h_final, Bt, L, D, ld, chunk, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entries for ctypes; each returns the cudaError_t of its launch.
// y NULL: states only (cm unused); h0 NULL: every chunk starts from zero.
extern "C" int mamba_chunk_scan(const void* x, const void* dt, const float* a,
                                const void* bm, const void* cm, const float* h0,
                                void* y, float* hout, int is_bf16, int Bt, int L, int D,
                                int N, int chunk, cudaStream_t stream) {
  if (L <= 0 || D <= 0 || Bt <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  if (y != nullptr && cm == nullptr) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch_n<__nv_bfloat16>(x, dt, a, bm, cm, h0, y, hout, Bt, L, D, N, chunk,
                                     stream);
  return dispatch_n<float>(x, dt, a, bm, cm, h0, y, hout, Bt, L, D, N, chunk, stream);
}

extern "C" int mamba_chunk_combine(const void* dt, const float* a, const float* s_local,
                                   float* h_init, int is_bf16, int Bt, int L, int D, int N,
                                   int chunk, cudaStream_t stream) {
  if (L <= 0 || D <= 0 || Bt <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return combine_n<__nv_bfloat16>(dt, a, s_local, h_init, Bt, L, D, N, chunk, stream);
  return combine_n<float>(dt, a, s_local, h_init, Bt, L, D, N, chunk, stream);
}

// The whole scan from a zero state: y (Bt, L, D) in x's type and the last
// state h_final (Bt, D, N) float32.  x and dt rows lie ld >= D elements
// apart, ld * sizeof(T) a multiple of 16; x, dt, B and C 16-byte aligned.
extern "C" int mamba_scan_route(const void* x, const void* dt, const float* a, const void* bm,
                                const void* cm, void* y, float* h_final, int is_bf16, int Bt,
                                int L, int D, int ld, int N, int chunk, cudaStream_t stream) {
  if (L <= 0 || D <= 0 || Bt <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return route_n<__nv_bfloat16>(x, dt, a, bm, cm, y, h_final, Bt, L, D, ld, N, chunk,
                                  stream);
  return route_n<float>(x, dt, a, bm, cm, y, h_final, Bt, L, D, ld, N, chunk, stream);
}
