"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes exactly what its kernel in ``csrc/`` computes.  The
(max,+) products round one add per term and the relaxation rounds
``w - lam*t`` and the add separately, while max is exact, so on the same
inputs kernel and plain version agree bit for bit.  Attention sums in
another order than its kernel, so the two agree within a stated tolerance.
:mod:`repro_torch.kernels.ops` routes CPU tensors here; ``chip_smoke.py``
holds every kernel against these on the card.
"""

from __future__ import annotations

import dataclasses
import math

import torch

NEG_INF = float("-inf")

#: elements of the broadcast (G, M, chunk, N) intermediate per step
_BMM_CHUNK_ELEMS = 1 << 24
#: query rows per step of the plain attention: bounds the (Sq, Skv) scores
_ATTN_CHUNK = 2048


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------
def attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0
) -> torch.Tensor:
    """Masked softmax attention with grouped KV heads, in float32.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); query head ``h`` reads KV
    head ``h // (Hq // Hkv)``.  Query ``i`` sees key ``j`` when ``i >= j``
    (``causal``) and ``i - j < window`` (``window > 0``); a row that sees
    no key gives 0.  Scores, softmax and the weighted sum are float32 and
    the result has q's dtype.  Queries go in chunks of 2048 rows, so the
    score tensor stays bounded at long sequence lengths.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, g, sq, d)
    kf, vf = k.float(), v.float()
    kv_idx = torch.arange(skv, device=q.device)[None, :]
    outs = []
    for start in range(0, sq, _ATTN_CHUNK):
        stop = min(start + _ATTN_CHUNK, sq)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg[:, :, :, start:stop].float(), kf) * scale
        q_idx = torch.arange(start, stop, device=q.device)[:, None]
        mask = torch.ones((stop - start, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_idx >= kv_idx
        if window > 0:
            mask &= (q_idx - kv_idx) < window
        p = torch.softmax(s.masked_fill_(~mask, NEG_INF), dim=-1)
        del s
        p.masked_fill_(torch.isnan(p), 0.0)             # fully masked rows
        outs.append(torch.einsum("bhgqk,bhkd->bhgqd", p, vf).to(q.dtype))
        del p
    return torch.cat(outs, dim=3).reshape(b, hq, sq, d)


#: how far a kernel's attention output may lie from :func:`attention_ref`'s,
#: per element: ``rtol`` of the element (one rounding step of the output
#: type, since both round a float32 value once) plus ``row_tol`` of the
#: root mean square of its (b, h, q) row (another float32 summation order,
#: which moves a row of 4096 keys by about 5e-6 of its size).  Row by row,
#: because a long causal row averages many values of v and its outputs
#: shrink with its length.
ATTN_TOL = {torch.float32: (2.0**-20, 2.0**-14), torch.bfloat16: (2.0**-7, 2.0**-14)}


def attention_excess(out: torch.Tensor, plain: torch.Tensor) -> float:
    """The largest ``|out - plain| / (rtol |plain| + row_tol rms(plain row))``
    over the elements, with :data:`ATTN_TOL` of ``plain``'s type; ``out``
    agrees with ``plain`` when it is at most 1."""
    rtol, row_tol = ATTN_TOL[plain.dtype]
    ref_f = plain.float()
    diff = (out.float() - ref_f).abs()
    limit = rtol * ref_f.abs() + row_tol * ref_f.square().mean(dim=-1, keepdim=True).sqrt()
    ratio = torch.where(diff == 0, torch.zeros_like(diff), diff / limit)
    return float(ratio.max()) if ratio.numel() else 0.0


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
