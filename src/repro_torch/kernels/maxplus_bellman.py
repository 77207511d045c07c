"""Exact float64 max-plus lambda-search on a device: CSR Bellman-Ford.

:func:`repro_torch.core.maxplus.mcr_batch` (backend ``"csr"``) bisects a
per-row lambda and asks, per probe, whether ``weights - lam*tokens``
contains a positive cycle: a longest-path Bellman-Ford relaxation over the
whole EdgeStack.  This module runs that search on the stack's device:

  * the bisection state (lo, hi, has_cycle) and the ``(B*n, K)`` distance
    buffer stay on the device across every probe round;
  * each relaxation sweep evaluates ``K`` probe lambdas per row at once, so
    sequential sweeps drop from ``~log2(range/tol)`` to ``~log_{K+1}``;
  * rows whose interval has closed start their probes resolved, so one slow
    row never drags the batch through extra rounds;
  * every ``check_every`` rounds a witness round points each node at an
    argmax predecessor, and pointer doubling over those tight edges
    certifies a (>= 0)-weight cycle in log2(n) gathers.

Each relaxation round is the hand-written kernel K1
(:func:`repro_torch.kernels.ops.relax_round`, ``csrc/relax_round.cu``) on a
CUDA tensor and its plain version on a CPU tensor; the interval update,
converged-row masking, deadlock probe and pointer doubling are PyTorch
operations on the same device.  The reference runs both loops inside one
jitted program; here they are host loops, which read the device once per
check block (``resolved.all()``) and once per outer step (the interval
test).  :data:`COUNTS` counts those reads.

Host-side packing (the CSR sort, the path bounds) stays in
:mod:`repro_torch.core.maxplus`; this module is tensors in, tensors out.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ops
from .ref import RelaxCSR

#: Probe lambdas evaluated per relaxation sweep (the broadcast axis K).
#: Sweeps shrink the interval (K+1)x while per-round work grows ~linearly
#: in K; K=3 is the reference's choice and is kept.
DEFAULT_K_PROBES = 3

#: host reads of device state by the lambda-search since the last reset
COUNTS = {"syncs": 0}


def reset_counts() -> None:
    """Set :data:`COUNTS` to 0."""
    COUNTS["syncs"] = 0


def _host_bool(t: torch.Tensor) -> bool:
    COUNTS["syncs"] += 1
    return bool(t.item())


def csr_bisect(
    csr: RelaxCSR,
    lo: torch.Tensor,        # (B,) float64 sound lower bounds
    hi: torch.Tensor,        # (B,) float64 interval tops (> any finite cycle ratio)
    has_cycle: torch.Tensor,  # (B,) bool rows already known cyclic
    rel_tol: float,
    *,
    k_probes: int = DEFAULT_K_PROBES,
    max_steps: int = 40,
    detect_deadlock: bool = False,
):
    """Whole-stack lambda bisection on the device of ``lo``.

    Returns ``(lo, hi, has_cycle, deadlocked)`` tensors; the caller's
    result is ``0.5 * (lo + hi)`` where ``has_cycle`` (and ``inf``/``-inf``
    elsewhere).  ``upper``, the per-row simple-path bound whose breach
    flags a pumping positive cycle, is recovered from ``hi`` (the host
    passes ``hi = max(upper, lo) + 1``).  Mirrors the reference's
    ``csr_bisect`` rule for rule: Jacobi rounds, verdicts every
    ``check_every = 4`` rounds, improvement ``atol`` 1e-12.  ``k_probes``
    is 1 or 3 (:data:`repro_torch.kernels.ops.PROBE_COUNTS`).
    """
    n_actors = csr.n_actors
    dev = lo.device
    b = lo.shape[0]
    nk = b * n_actors
    check_every = 4                        # relaxation rounds per verdict
    n_blocks = -(-(n_actors + 1) // check_every)   # n+1 rounds per probe
    n_doublings = max(1, (n_actors + 1).bit_length())
    upper = hi - 1.0                       # host invariant: hi = upper' + 1
    over_node = upper.repeat_interleave(n_actors)[:, None] + 1.0   # (B*n, 1)
    ids = torch.arange(nk, dtype=torch.int64, device=dev)[:, None]

    def probe(lams: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """(B, k) positive-cycle verdicts at per-row probe lambdas."""
        k = lams.shape[1]
        resolved = (~active)[:, None].expand(b, k).clone()
        positive = torch.zeros((b, k), dtype=torch.bool, device=dev)
        dist = torch.zeros((nk, k), dtype=torch.float64, device=dev)
        blk = 0
        while blk < n_blocks and not _host_bool(resolved.all()):
            for _ in range(check_every - 1):
                dist = torch.maximum(dist, ops.relax_round(dist, lams, csr))
            # the block's last round doubles as the verdict pass
            best, psrc = ops.relax_round_witness(dist, lams, csr)
            # once a round improves nothing, no later round can
            improving = (best > dist + 1e-12).reshape(b, n_actors, k).any(dim=1)
            # tight-edge parents: only nodes that can still match or beat
            # their pre-round distance join the cycle-candidate graph
            par = torch.where(best >= dist, psrc, ids)
            dist = torch.maximum(dist, best)
            over = (dist > over_node).reshape(b, n_actors, k).any(dim=1)
            anc = par
            for _ in range(n_doublings):
                anc = torch.gather(anc, 0, anc)
            on_cycle = torch.gather(par, 0, anc) != anc
            cyc = on_cycle.reshape(b, n_actors, k).any(dim=1)
            positive |= (over | cyc) & ~resolved
            resolved |= over | cyc | ~improving
            blk += 1
        # probes still improving after n+1 rounds contain a positive cycle
        return positive | ~resolved

    deadlocked = torch.zeros(b, dtype=torch.bool, device=dev)
    if detect_deadlock:
        # any cycle with >= 1 token has ratio <= upper < hi, so a positive
        # cycle AT lam = hi can only be a zero-token (deadlock) cycle
        deadlocked = probe(hi[:, None], torch.ones(b, dtype=torch.bool, device=dev))[:, 0]

    frac = torch.arange(1, k_probes + 1, dtype=torch.float64, device=dev) / (k_probes + 1)
    for _ in range(max_steps):
        tol = rel_tol * torch.clamp(hi.abs(), min=1.0)
        # rows outside `active` keep lo/hi/has_cycle unchanged, so stopping
        # once none is active equals running the reference's remaining steps
        active = ((hi - lo) > tol) & ~deadlocked
        if not _host_bool(active.any()):
            break
        lams = lo[:, None] + (hi - lo)[:, None] * frac[None, :]   # ascending
        positive = probe(lams, active)
        # positives form a prefix of the ascending probes (positive iff
        # lam < rho); the count locates rho in (lams[c-1], lams[c]]
        c = (positive & active[:, None]).sum(dim=1)

        def pick(idx):
            return torch.gather(lams, 1, idx.clamp(0, k_probes - 1)[:, None])[:, 0]

        lo = torch.where(active & (c > 0), pick(c - 1), lo)
        hi = torch.where(active & (c < k_probes), pick(c), hi)
        has_cycle = has_cycle | (active & (c > 0))
    return lo, hi, has_cycle, deadlocked


def mcr_bisect_device(
    packed: tuple,
    lo: np.ndarray,
    hi: np.ndarray,
    has_cycle: np.ndarray,
    *,
    n_actors: int,
    rel_tol: float,
    device: torch.device,
    k_probes: int = DEFAULT_K_PROBES,
    max_steps: int = 40,
    detect_deadlock: bool = False,
):
    """Host-facing entry: numpy CSR arrays in, numpy results out.

    ``packed`` is ``(indptr, src, w, tok)``: the flat dst-sorted CSR that
    :func:`repro_torch.core.maxplus._pack_csr` builds over all ``B*n``
    nodes.  Everything moves to ``device`` once; the search runs there.
    """
    indptr, src, w, tok = packed
    b = int(np.asarray(lo).shape[0])
    counts = np.diff(indptr)
    dst = np.repeat(np.arange(b * n_actors, dtype=np.int64), counts)

    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device=device, dtype=dtype)

    csr = RelaxCSR(
        n_actors=n_actors,
        indptr=put(indptr, torch.int32),
        src=put(src, torch.int32),
        w=put(w, torch.float64),
        t=put(tok, torch.float64),
        dst=put(dst, torch.int64),
        dst_row=put(dst // n_actors, torch.int64),
    )
    out = csr_bisect(
        csr, put(lo, torch.float64), put(hi, torch.float64),
        put(has_cycle, torch.bool), rel_tol,
        k_probes=k_probes, max_steps=max_steps,
        detect_deadlock=detect_deadlock,
    )
    return tuple(x.cpu().numpy() for x in out)
