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
// in no order, and float64 has no atomicMax, so here one thread owns one
// destination node: it walks its own CSR segment and keeps the K probe
// maxima in registers.  Keys are sorted, so no two threads ever write the
// same output and no atomics are needed.  Rounds are Jacobi: the kernel
// reads `dist` and writes the separate `best` buffer, never `dist`.
//
// Rounding.  w - lam*t and the add are evaluated with explicit
// round-to-nearest intrinsics (and the library is built with
// --fmad=false), so each step rounds exactly like the plain PyTorch
// version; max is exact, so the two agree bit for bit.
//
// Bound on this card.  The round is bytes-bound: it reads each edge once
// (src 4 B, w 8 B, t 8 B, dist[src] 8K B) and the row pointers, and writes
// best (8K B per node, +8K B psrc for the witness), over 3.35 TB/s.
// Keeping the K probes in registers means the edge arrays and dist rows
// are read once per round rather than once per probe.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <int K, bool WITNESS>
__global__ void relax_round_kernel(
    const double* __restrict__ dist,     // (n_nodes, K)
    const double* __restrict__ lams,     // (n_nodes / n_actors, K)
    const int32_t* __restrict__ indptr,  // (n_nodes + 1,)
    const int32_t* __restrict__ src,     // (E,) flat source node ids
    const double* __restrict__ w,        // (E,) edge weights
    const double* __restrict__ t,        // (E,) edge tokens
    double* __restrict__ best,           // (n_nodes, K) out
    int64_t* __restrict__ psrc,          // (n_nodes, K) out, witness only
    int64_t n_nodes, int n_actors) {
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_nodes) return;
  const int64_t row = v / n_actors;
  double lam[K], b[K];
  int64_t p[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    lam[k] = lams[row * K + k];
    b[k] = -INFINITY;
    p[k] = -1;
  }
  const int32_t e1 = indptr[v + 1];
  for (int32_t e = indptr[v]; e < e1; ++e) {
    const int64_t s = src[e];
    const double we = w[e];
    const double te = t[e];
    const double* ds = dist + s * K;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const double c = __dadd_rn(ds[k], __dsub_rn(we, __dmul_rn(lam[k], te)));
      if (WITNESS) {
        if (c > b[k] || (c == b[k] && s > p[k])) {
          b[k] = c;
          p[k] = s;
        }
      } else if (c > b[k]) {
        b[k] = c;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    best[v * K + k] = b[k];
    if (WITNESS) psrc[v * K + k] = p[k];
  }
}

template <int K>
void launch(const double* dist, const double* lams, const int32_t* indptr,
            const int32_t* src, const double* w, const double* t, double* best,
            int64_t* psrc, int64_t n_nodes, int n_actors, int witness,
            cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((n_nodes + threads - 1) / threads);
  if (witness) {
    relax_round_kernel<K, true><<<blocks, threads, 0, stream>>>(
        dist, lams, indptr, src, w, t, best, psrc, n_nodes, n_actors);
  } else {
    relax_round_kernel<K, false><<<blocks, threads, 0, stream>>>(
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
