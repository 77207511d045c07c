"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes exactly what its kernel in ``csrc/`` computes, with
the same rounding: the (max,+) products round one add per term and the
relaxation rounds ``w - lam*t`` and the add separately, while max is
exact, so on the same inputs kernel and plain version agree bit for bit.
:mod:`repro_torch.kernels.ops` routes CPU tensors here; ``chip_smoke.py``
holds every kernel against these on the card.
"""

from __future__ import annotations

import dataclasses

import torch

NEG_INF = float("-inf")

#: elements of the broadcast (G, M, chunk, N) intermediate per step
_BMM_CHUNK_ELEMS = 1 << 24


# ----------------------------------------------------------------------
# (max,+) products
# ----------------------------------------------------------------------
def maxplus_bmm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[g,i,j] = max_k A[g,i,k] + B[g,k,j] for (G,M,K) x (G,K,N).

    The K axis is folded in chunks so the broadcast intermediate stays
    bounded; max is exact, so chunking never changes a bit.
    """
    g, m, k = a.shape
    n = b.shape[2]
    out = torch.full((g, m, n), NEG_INF, dtype=a.dtype, device=a.device)
    step = max(1, _BMM_CHUNK_ELEMS // max(1, g * m * n))
    for k0 in range(0, k, step):
        part = (a[:, :, k0:k0 + step, None] + b[:, None, k0:k0 + step, :]).amax(dim=2)
        torch.maximum(out, part, out=out)
    return out


def maxplus_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[i,j] = max_k A[i,k] + B[k,j] (the G = 1 case of the batched form)."""
    return maxplus_bmm_ref(a[None], b[None])[0]


def maxplus_bmv_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[g,i] = max_k A[g,i,k] + x[g,k] for (G,M,K) x (G,K)."""
    g, m, k = a.shape
    if k == 0:
        return torch.full((g, m), NEG_INF, dtype=a.dtype, device=a.device)
    return (a + x[:, None, :]).amax(dim=2)


# ----------------------------------------------------------------------
# one relaxation round of the lambda-search
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RelaxCSR:
    """A batched EdgeStack as one flat dst-sorted CSR, on one device.

    Node ids are flat: ``row * n_actors + actor``.  Edges are sorted by
    destination; ``indptr[v]:indptr[v+1]`` are node v's incoming edges.
    ``dst``/``dst_row`` repeat what ``indptr`` implies, per edge, for the
    scatter of the plain version.
    """

    n_actors: int
    indptr: torch.Tensor   # (n_nodes + 1,) int32
    src: torch.Tensor      # (E,) int32 flat source node ids
    w: torch.Tensor        # (E,) float64 weights
    t: torch.Tensor        # (E,) float64 tokens
    dst: torch.Tensor      # (E,) int64 flat destination node ids
    dst_row: torch.Tensor  # (E,) int64 stack row of each edge

    @property
    def n_nodes(self) -> int:
        return int(self.indptr.shape[0]) - 1


def _candidates(dist: torch.Tensor, lams: torch.Tensor, csr: RelaxCSR):
    ww = csr.w[:, None] - lams[csr.dst_row] * csr.t[:, None]
    return dist[csr.src.long()] + ww


def segment_relax_ref(
    dist: torch.Tensor, lams: torch.Tensor, csr: RelaxCSR
) -> torch.Tensor:
    """(n_nodes, K) ``best[v,k] = max_e dist[src_e,k] + (w_e - lam[row_v,k]*t_e)``.

    ``-inf`` where v has no incoming edge.  ``dist`` is (n_nodes, K),
    ``lams`` (B, K) per-row probe lambdas.
    """
    cand = _candidates(dist, lams, csr)
    best = torch.full_like(dist, NEG_INF)
    idx = csr.dst[:, None].expand_as(cand)
    return best.scatter_reduce_(0, idx, cand, "amax", include_self=True)


def segment_relax_witness_ref(
    dist: torch.Tensor, lams: torch.Tensor, csr: RelaxCSR
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`segment_relax_ref` plus ``psrc``, an argmax predecessor.

    ``psrc[v,k]`` is the largest source node id among v's incoming edges
    whose candidate equals ``best[v,k]``; -1 where v has no incoming edge.
    """
    cand = _candidates(dist, lams, csr)
    idx = csr.dst[:, None].expand_as(cand)
    best = torch.full_like(dist, NEG_INF).scatter_reduce_(
        0, idx, cand, "amax", include_self=True
    )
    at_max = cand >= best[csr.dst]
    src = csr.src.long()[:, None].expand_as(cand)
    tagged = torch.where(at_max, src, torch.full_like(src, -1))
    psrc = torch.full(dist.shape, -1, dtype=torch.int64, device=dist.device)
    psrc.scatter_reduce_(0, idx, tagged, "amax", include_self=True)
    return best, psrc
