// K1 `relax_round`: one Jacobi relaxation round of the batched max-plus
// lambda-search, float64, over the flat dst-sorted CSR of an EdgeStack.
//
// Replaces src/repro/kernels/maxplus_bellman.py::segment_max_pallas (the
// TPU fold inside csr_bisect) together with the candidate computation
// around it: for every destination node v of the stack (B rows x n actors)
// and every probe k,
//
//   best[v,k] = max over incoming edges e of dist[src_e,k] + (w_e - lam[row_v,k]*t_e)
//
// and -inf where v has no incoming edge.  The witness variant also writes
// psrc[v,k], the LARGEST src among the edges that reach the max (-1 for a
// node without incoming edges) -- the tie rule of the reference's segment
// path and of repro_torch.kernels.ref.segment_relax_witness_ref.
//
// Design.  The TPU kernel walks sorted edge blocks through a sequential
// grid and read-modify-writes one VMEM accumulator.  Blocks on Hopper run
// in no order, and float64 has no atomicMax, so here a team of TEAM = 8
// lanes owns one destination node.  The lanes stride the node's CSR
// segment, so src, w and t load coalesced; each lane loads EDGES = 2
// edges of a pass before it gathers their dist rows, so the two gathers
// wait on one load latency; each lane keeps its K partial maxima in
// registers, and the team folds them with __shfl_xor_sync butterflies.
// Keys are sorted, so no two teams ever write the same output and no
// atomics are needed.  A node longer than TEAM x EDGES edges just loops
// (on HeartClass's admission stack the in-degree is 15 on average, 25 at
// most).  Rounds are Jacobi: the kernel reads `dist` and writes the
// separate `best` buffer, never `dist`.
//
// TEAM and EDGES were fixed by measurement (tools/relax_lif_ab.py, at
// every shape the admission and dense paths launch; PERF.md): weighted by
// launches, 8 lanes came within 2 % of the best width chosen per shape,
// and 2 edges a pass gained 8 % over 1 (4 gained nothing more).  The mean
// in-degree did not predict the best width: it followed the node count.
//
// Rounding and order.  w - lam*t and the add are evaluated with explicit
// round-to-nearest intrinsics (and the library is built with
// --fmad=false), so each candidate rounds exactly like the plain PyTorch
// version.  The fold is the lexicographic max of (c, src) over the
// non-NaN candidates and the identity (-inf, -1): the larger c wins, on
// equal c the larger src (a NaN candidate never wins, as `c > b` has it).
// That rule is associative and commutative, so the tree gives what a
// serial walk gives, psrc included; a node whose every candidate is -inf
// gets psrc = its largest src.  The one freedom left is the sign of a
// zero: +0 and -0 compare equal, so a node whose maximum is both may come
// out as either.  torch.equal treats them as equal, and no later
// comparison of the search can tell them apart.
//
// Bound on this card.  The round is bytes-bound: it reads each edge once
// (src 4 B, w 8 B, t 8 B, dist[src] 8K B) and the row pointers, and writes
// best (8K B per node, +8K B psrc for the witness), over 3.35 TB/s.
// Keeping the K probes in registers means the edge arrays and dist rows
// are read once per round rather than once per probe; dist is 24 B a node
// at K = 3 (1.5 MB on HeartClass's stack), so its gathers stay in L2.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TEAM = 8;    // lanes per destination node
constexpr int EDGES = 2;   // edges a lane loads before it gathers their dist rows

// (b, p) <- the lexicographic max of (b, p) and (c, s); NaN never wins
template <bool WITNESS>
__device__ __forceinline__ void fold(double& b, int32_t& p, double c, int32_t s) {
  if (WITNESS) {
    if (c > b || (c == b && s > p)) {
      b = c;
      p = s;
    }
  } else if (c > b) {
    b = c;
  }
}

template <int K, bool WITNESS>
__global__ void __launch_bounds__(THREADS) relax_round_kernel(
    const double* __restrict__ dist,     // (n_nodes, K)
    const double* __restrict__ lams,     // (n_nodes / n_actors, K)
    const int32_t* __restrict__ indptr,  // (n_nodes + 1,)
    const int32_t* __restrict__ src,     // (E,) flat source node ids
    const double* __restrict__ w,        // (E,) edge weights
    const double* __restrict__ t,        // (E,) edge tokens
    double* __restrict__ best,           // (n_nodes, K) out
    int64_t* __restrict__ psrc,          // (n_nodes, K) out, witness only
    int64_t n_nodes, int n_actors) {
  const int64_t v = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / TEAM;
  const int lane = threadIdx.x % TEAM;
  const bool live = v < n_nodes;   // dead lanes still join the shuffles
  double lam[K], b[K];
  int32_t p[K];
  int32_t e0 = 0, e1 = 0;
  if (live) {
    const int row = (int)v / n_actors;   // n_nodes < 2^31 (int32 row pointers)
#pragma unroll
    for (int k = 0; k < K; ++k) lam[k] = lams[row * K + k];
    e0 = indptr[v];
    e1 = indptr[v + 1];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    b[k] = -INFINITY;
    p[k] = -1;
  }
  for (int32_t e = e0 + lane; e < e1; e += TEAM * EDGES) {
    bool ok[EDGES];
    int32_t s[EDGES];
    double we[EDGES], te[EDGES];
#pragma unroll
    for (int u = 0; u < EDGES; ++u) {
      const int32_t eu = e + u * TEAM;
      ok[u] = eu < e1;
      s[u] = ok[u] ? src[eu] : 0;
      we[u] = ok[u] ? w[eu] : 0.0;
      te[u] = ok[u] ? t[eu] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < EDGES; ++u) {
      if (!ok[u]) continue;
      const double* ds = dist + (int64_t)s[u] * K;
#pragma unroll
      for (int k = 0; k < K; ++k)
        fold<WITNESS>(b[k], p[k], __dadd_rn(ds[k], __dsub_rn(we[u], __dmul_rn(lam[k], te[u]))),
                      s[u]);
    }
  }
#pragma unroll
  for (int off = TEAM / 2; off > 0; off /= 2) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const double ob = __shfl_xor_sync(0xffffffffu, b[k], off);
      const int32_t op = WITNESS ? __shfl_xor_sync(0xffffffffu, p[k], off) : -1;
      fold<WITNESS>(b[k], p[k], ob, op);
    }
  }
  if (live && lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      best[v * K + k] = b[k];
      if (WITNESS) psrc[v * K + k] = p[k];
    }
  }
}

template <int K>
void launch(const double* dist, const double* lams, const int32_t* indptr,
            const int32_t* src, const double* w, const double* t, double* best,
            int64_t* psrc, int64_t n_nodes, int n_actors, int witness,
            cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n_nodes * TEAM + THREADS - 1) / THREADS);
  if (witness) {
    relax_round_kernel<K, true><<<blocks, THREADS, 0, stream>>>(
        dist, lams, indptr, src, w, t, best, psrc, n_nodes, n_actors);
  } else {
    relax_round_kernel<K, false><<<blocks, THREADS, 0, stream>>>(
        dist, lams, indptr, src, w, t, best, psrc, n_nodes, n_actors);
  }
}

}  // namespace

// Plain C entry for ctypes.  Returns the cudaError_t of the launch (0 on
// success).  k is the search's 3 probes or the deadlock probe's 1; any
// other k returns cudaErrorInvalidValue without launching.
extern "C" int relax_round(const double* dist, const double* lams,
                           const int32_t* indptr, const int32_t* src,
                           const double* w, const double* t, double* best,
                           int64_t* psrc, int64_t n_nodes, int n_actors, int k,
                           int witness, cudaStream_t stream) {
  switch (k) {
    case 1: launch<1>(dist, lams, indptr, src, w, t, best, psrc, n_nodes, n_actors, witness, stream); break;
    case 3: launch<3>(dist, lams, indptr, src, w, t, best, psrc, n_nodes, n_actors, witness, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
