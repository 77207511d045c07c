"""Max-Plus Algebra performance analysis (paper §3.2, §4.4), on PyTorch.

Throughput of a (hardware-aware) SDFG = 1 / maximum cycle mean of its
max-plus matrix (Eq. 6).  For a timed event graph with markings ``m`` and
edge weights ``w = tau[dst] + delay`` this is the *maximum cycle ratio*

    rho_max = max over cycles C of  sum_{e in C} w(e) / sum_{e in C} m(e).

Per-graph evaluators (host numpy, as in the reference):

  * :func:`mcr_howard`        — Howard's policy iteration (exact)
  * :func:`mcr_binary_search` — lambda-search + vectorized Bellman-Ford
  * :func:`maxplus_matrix`    — the explicit Eq.-4 matrix ``T = A0* (x) A1``
  * :func:`mcm_power_iteration` — ``t_k = T (x) t_{k-1}`` through the
    (max,+) matmul kernel on a device

Batched evaluator (the design-space-exploration hot path):

  * :func:`mcr_batch` — lambda-search over an :class:`EdgeStack`, one row
    per candidate.  Backends: ``"edges"`` (float64 numpy, the reference's
    exact oracle, kept verbatim), ``"csr"`` (the same exact float64 search
    on a device, each relaxation round one launch of the CUDA kernel K1
    over the flat dst-sorted CSR; the default) and ``"dense"`` (float32
    max-plus matrix squaring through the CUDA kernel K2).

Batched Eq.-4 evolution (the self-timed engine's start-time path):

  * :func:`maxplus_matrix_batch` — (B, n, n) matrices ``T = A0* (x) A1``
    with the Kleene star computed by repeated K2 squaring.
  * :func:`evolve_batch` — iterate ``x(k) = T (x) x(k-1)`` through the
    batched matvec kernel K3.

Every entry point that touches a device takes ``device=``: ``None`` means
CUDA and raises when there is none (see :func:`repro_torch.device.resolve`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve
from ..kernels import maxplus_bellman as kbell
from ..kernels import ops as kops
from ..launch.sharding import row_chunks
from .sdfg import SDFG

NEG_INF = -math.inf


# ======================================================================
# Howard's policy iteration for Maximum Cycle Ratio
# ======================================================================
def mcr_howard(g: SDFG, *, eps: float = 1e-9, max_iter: int = 10_000) -> float:
    """Exact maximum cycle ratio via Howard's algorithm.

    Returns ``inf`` for a deadlocked graph (zero-token cycle) and ``-inf``
    for a graph with no cycles at all (throughput unbounded by the graph).
    """
    src, dst, w, m = g.edges_arrays()
    n = g.n_actors
    ne = src.size
    if ne == 0:
        return NEG_INF

    # adjacency: outgoing edge ids per node
    out: list[list[int]] = [[] for _ in range(n)]
    for e in range(ne):
        out[int(src[e])].append(e)

    has_out = np.array([len(o) > 0 for o in out])
    # nodes with no outgoing edge can't be on a cycle; give them a virtual
    # self-loop of ratio -inf by excluding them from policies.
    policy = np.full(n, -1, dtype=np.int64)
    for v in range(n):
        if out[v]:
            policy[v] = out[v][0]

    lam = np.full(n, NEG_INF)
    u = np.zeros(n)

    for _ in range(max_iter):
        # ---- policy evaluation -------------------------------------
        lam, u, dead = _evaluate_policy(n, policy, src, dst, w, m, has_out)
        if dead:
            return math.inf
        # ---- policy improvement ------------------------------------
        changed = False
        for e in range(ne):
            x, y = int(src[e]), int(dst[e])
            if policy[x] == -1 or lam[y] == NEG_INF:
                continue
            if lam[y] > lam[x] + eps:
                policy[x] = e
                changed = True
            elif abs(lam[y] - lam[x]) <= eps:
                cand = w[e] - lam[x] * m[e] + u[y]
                if cand > u[x] + eps:
                    policy[x] = e
                    changed = True
        if not changed:
            break
    finite = lam[np.isfinite(lam)]
    return float(finite.max()) if finite.size else NEG_INF


def _evaluate_policy(n, policy, src, dst, w, m, has_out):
    """Evaluate a policy (functional graph): per-node cycle ratio + bias."""
    lam = np.full(n, NEG_INF)
    u = np.zeros(n)
    color = np.zeros(n, dtype=np.int8)  # 0 white 1 on-stack 2 done
    dead = False

    for start in range(n):
        if color[start] != 0 or not has_out[start]:
            color[start] = 2
            continue
        path: list[int] = []
        v = start
        while color[v] == 0:
            color[v] = 1
            path.append(v)
            v = int(dst[policy[v]])
            if not has_out[v]:
                break
        if color[v] == 1:
            # found a new cycle: v .. path[-1]
            ci = path.index(v)
            cyc = path[ci:]
            wsum = sum(w[policy[x]] for x in cyc)
            msum = sum(m[policy[x]] for x in cyc)
            if msum == 0:
                dead = True
                return lam, u, dead
            ratio = wsum / msum
            for x in cyc:
                lam[x] = ratio
            # bias along the cycle: u(x) = w̄(x) + u(pi(x)), anchored u(v)=0;
            # walk the cycle backwards so each successor is resolved first
            u[v] = 0.0
            for x in reversed(cyc[1:]):
                y = int(dst[policy[x]])
                u[x] = w[policy[x]] - ratio * m[policy[x]] + u[y]
        # resolve tree part (suffix of `path` before the cycle / known node)
        for x in reversed(path):
            if lam[x] != NEG_INF:
                continue
            y = int(dst[policy[x]])
            if lam[y] == NEG_INF:
                lam[x] = NEG_INF  # leads nowhere cyclic
                u[x] = 0.0
            else:
                lam[x] = lam[y]
                u[x] = w[policy[x]] - lam[x] * m[policy[x]] + u[y]
        for x in path:
            color[x] = 2
        color[v] = 2
    return lam, u, dead


# ======================================================================
# Binary search + vectorized Bellman-Ford (independent cross-check)
# ======================================================================
def mcr_binary_search(
    g: SDFG, *, tol: float = 1e-6, lo: float = 0.0, hi: Optional[float] = None
) -> float:
    """MCR via lambda-search: a positive cycle in weights ``w - lam*m``
    exists iff lam < rho_max.  Longest-path Bellman-Ford, fully vectorized.
    """
    src, dst, w, m = g.edges_arrays()
    n = g.n_actors
    if hi is None:
        hi = float(w.sum()) + 1.0  # any cycle ratio is below total weight

    def has_positive_cycle(lam: float) -> bool:
        ww = w - lam * m
        dist = np.zeros(n)
        for _ in range(n):
            cand = dist[src] + ww
            new = dist.copy()
            np.maximum.at(new, dst, cand)
            new = np.maximum(new, dist)
            if np.allclose(new, dist, rtol=0, atol=1e-12):
                return False
            dist = new
        return True

    if not has_positive_cycle(lo + tol):
        return lo
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if has_positive_cycle(mid):
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


# ======================================================================
# Explicit max-plus matrix T = A0* (x) A1 and power iteration (Eq. 4)
# ======================================================================
def maxplus_matrix(g: SDFG) -> np.ndarray:
    """Build T with t_k = T (x) t_{k-1}.

    Dependencies within an iteration (0-token edges) are closed transitively
    over the acyclic 0-token subgraph (Kleene star A0*); dependencies across
    iterations (>=1-token edges) contribute A1.  Markings > 1 relax the
    dependency further into the past and — for a conservative (upper-bound
    period, lower-bound throughput) T — are kept as if 1 token; the exact
    multi-token analysis is done by :func:`mcr_howard`.
    """
    src, dst, w, m = g.edges_arrays()
    n = g.n_actors
    T = np.full((n, n), NEG_INF)

    # A1 edges: j fires after i's previous firing + w
    one = m >= 1
    for s, d, ww in zip(src[one], dst[one], w[one]):
        T[int(d), int(s)] = max(T[int(d), int(s)], float(ww))

    # longest-path closure over 0-token edges, topological order
    zero = m == 0
    z_src, z_dst, z_w = src[zero], dst[zero], w[zero]
    indeg = np.zeros(n, dtype=np.int64)
    adj: list[list[tuple[int, float]]] = [[] for _ in range(n)]
    for s, d, ww in zip(z_src, z_dst, z_w):
        adj[int(s)].append((int(d), float(ww)))
        indeg[int(d)] += 1
    topo: list[int] = [i for i in range(n) if indeg[i] == 0]
    head = 0
    while head < len(topo):
        x = topo[head]
        head += 1
        for y, _ in adj[x]:
            indeg[y] -= 1
            if indeg[y] == 0:
                topo.append(y)
    assert len(topo) == n, "0-token subgraph must be acyclic (liveness)"

    # propagate rows of T along zero edges: T[y,:] >= T[x,:] + w(x->y)
    for x in topo:
        row = T[x]
        for y, ww in adj[x]:
            np.maximum(T[y], row + ww, out=T[y])
    return T


def mcm_power_iteration(
    T: np.ndarray, *, iters: int = 200, device=None
) -> float:
    """Estimate the max-plus eigenvalue (MCM) of T by power iteration.

    ``x_k = T (x) x_{k-1}`` in float32 on ``device``, each step one
    (n, n) x (n, 1) launch of the (max,+) matmul kernel.  For irreducible
    T the growth rate converges to the MCM.
    """
    dev = resolve(device)
    n = T.shape[0]
    t = torch.as_tensor(np.asarray(T, dtype=np.float32), device=dev)
    x = torch.zeros((n, 1), dtype=torch.float32, device=dev)
    warm = max(4, iters // 2)
    x0_at_warm = None
    for k in range(iters):
        x = kops.maxplus_matmul(t, x)
        # renormalize to avoid drift; track growth of the max component
        mx = float(x.max())
        if not math.isfinite(mx):
            return mx
        if k == warm:
            x0_at_warm = np.float32(mx)
        if mx > 1e12:
            x -= mx
            if x0_at_warm is not None:
                x0_at_warm -= np.float32(mx)
    if x0_at_warm is None:  # pragma: no cover
        return float("nan")
    return float((np.float32(float(x.max())) - x0_at_warm) / (iters - 1 - warm))


# ======================================================================
# Batched analysis: lambda-search over a stack of edge-weight arrays
# ======================================================================
@dataclasses.dataclass(frozen=True)
class EdgeStack:
    """A batch of timed event graphs as parallel edge arrays.

    Row ``b`` is one candidate graph (a binding / hardware config / static
    order under evaluation).  All rows share the padded edge count ``E`` and
    actor count ``n_actors``; padding slots carry ``weights = -inf``, which
    is the (max,+) neutral element, so they never influence any longest
    path.  Markings may differ per row (buffer sizes are a design axis).
    """

    n_actors: int
    src: np.ndarray       # (B, E) int64
    dst: np.ndarray       # (B, E) int64
    tokens: np.ndarray    # (B, E) int64
    weights: np.ndarray   # (B, E) float64; -inf marks an inactive slot

    @property
    def n_graphs(self) -> int:
        return int(self.weights.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.weights.shape[1])


def stack_graphs(graphs: Sequence[SDFG]) -> EdgeStack:
    """Pack per-graph edge arrays into one padded :class:`EdgeStack`.

    Graphs may have different topologies and actor counts; rows are padded
    to the maximum edge count with -inf-weight slots and to the maximum
    actor count (extra actors are isolated, so they cannot join a cycle).
    """
    assert graphs, "need at least one graph"
    b = len(graphs)
    n = max(g.n_actors for g in graphs)
    e = max(g.n_channels for g in graphs)
    src = np.zeros((b, e), dtype=np.int64)
    dst = np.zeros((b, e), dtype=np.int64)
    tokens = np.ones((b, e), dtype=np.int64)
    weights = np.full((b, e), NEG_INF)
    for i, g in enumerate(graphs):
        s, d, w, m = g.edges_arrays()
        k = s.size
        src[i, :k] = s
        dst[i, :k] = d
        weights[i, :k] = w
        tokens[i, :k] = m
    return EdgeStack(n_actors=n, src=src, dst=dst, tokens=tokens, weights=weights)


def _bisection_bounds(
    stack: EdgeStack, upper: np.ndarray, lo0: Optional[np.ndarray]
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shared lambda-search bootstrap for both mcr backends.

    Returns ``(lo, hi, has_cycle)``: the per-row lower bound from one-token
    self-loop cycles folded with the caller's sound ``lo0`` bounds, the
    bisection interval top ``max(upper, lo) + 1``, and which rows are
    already known to contain a cycle.
    """
    finite = np.isfinite(stack.weights)
    self_loop = finite & (stack.src == stack.dst) & (stack.tokens > 0)
    ratio = np.where(self_loop, stack.weights / np.maximum(stack.tokens, 1), NEG_INF)
    lo = np.maximum(ratio.max(axis=1, initial=NEG_INF), 0.0)
    has_cycle = ratio.max(axis=1, initial=NEG_INF) > NEG_INF
    if lo0 is not None:
        lo0 = np.asarray(lo0, dtype=np.float64)
        lo = np.maximum(lo, np.where(np.isfinite(lo0), lo0, NEG_INF))
        has_cycle |= np.isfinite(lo0)
    hi = np.maximum(upper, lo) + 1.0
    return lo, hi, has_cycle


def _upper_path_bound(
    stack: EdgeStack,
    order: np.ndarray,
    uniq_keys: np.ndarray,
    seg_starts: np.ndarray,
) -> np.ndarray:
    """(B,) sound upper bound on any simple-path (hence cycle) weight.

    A simple path or cycle enters each node at most once, so its weight is
    bounded by the per-row sum over nodes of the (positive part of the)
    heaviest incoming edge.  Much tighter than summing every positive edge
    weight when the average in-degree is high, which shrinks both the
    bisection interval and the distance threshold that detects a pumping
    positive cycle.
    """
    b, n = stack.n_graphs, stack.n_actors
    max_in = np.full(b * n, NEG_INF)
    max_in[uniq_keys] = np.maximum.reduceat(stack.weights.ravel()[order], seg_starts)
    return np.clip(max_in.reshape(b, n), 0.0, None).sum(axis=1)


def _positive_cycle_masks(
    stack: EdgeStack,
    lam: np.ndarray,
    src_ord: np.ndarray,
    w_ord: np.ndarray,
    t_ord: np.ndarray,
    row_ord: np.ndarray,
    key_row: np.ndarray,
    uniq_keys: np.ndarray,
    seg_starts: np.ndarray,
    upper: np.ndarray,
    active: Optional[np.ndarray] = None,
    *,
    atol: float = 1e-12,
) -> np.ndarray:
    """Per-row: does weights - lam*tokens contain a positive cycle?

    One vectorized longest-path Bellman-Ford over the whole batch.  A row
    resolves early when a relaxation round changes nothing (no positive
    cycle) or when any distance exceeds the row's maximum simple-path
    weight (positive cycle — only a cycle can pump past it).  Rows outside
    ``active`` start resolved: their probe point sits at (or below) the
    true cycle ratio, where relaxation may never settle, and their answer
    is discarded by the caller anyway — without this, one slow row would
    drag every later bisection step to the full n+1 rounds.

    The relaxation runs in destination-key space: only actors with an
    incoming edge (``uniq_keys``) can ever move off the zero start
    distance, and a zero distance can never exceed ``upper + 1``
    (``upper >= 0``), so tracking the ``(n_keys,)`` vector is exact while
    skipping every full ``(b*n,)`` copy/compare of the dense form.  Edge
    arrays arrive pre-permuted into segment order (``*_ord``), removing
    the per-round gather through ``order``.
    """
    b, n = stack.n_graphs, stack.n_actors
    ww = w_ord - lam[row_ord] * t_ord
    dist = np.zeros(b * n)
    dist_k = np.zeros(len(uniq_keys))
    over_key = upper[key_row] + 1.0
    positive = np.zeros(b, dtype=bool)
    resolved = np.zeros(b, dtype=bool) if active is None else ~active
    for _ in range(n + 1):
        seg_max = np.maximum.reduceat(dist[src_ord] + ww, seg_starts)
        improved = (seg_max - dist_k) > atol
        row_changed = np.bincount(key_row, weights=improved, minlength=b) > 0
        resolved |= ~row_changed
        np.maximum(dist_k, seg_max, out=dist_k)
        over = (
            np.bincount(key_row, weights=dist_k > over_key, minlength=b) > 0
        ) & ~resolved
        positive |= over
        resolved |= over
        dist[uniq_keys] = dist_k
        if resolved.all():
            break
    # rows still improving after n+1 rounds must contain a positive cycle
    positive |= ~resolved
    return positive


def mcr_batch(
    stack: EdgeStack,
    *,
    rel_tol: float = 1e-8,
    max_steps: int = 80,
    backend: str = "auto",
    lo0: Optional[np.ndarray] = None,
    detect_deadlock: bool = False,
    device=None,
    devices=None,
) -> np.ndarray:
    """Maximum cycle ratio for every row of an :class:`EdgeStack`.

    Lambda-search: a positive cycle in ``weights - lam*tokens`` exists iff
    ``lam < rho_max`` — all rows bisect together.  Inputs must be live
    graphs (a zero-token cycle drives the result to the upper bound instead
    of ``inf``); every graph built by this pipeline is live by construction.
    ``detect_deadlock=True`` adds one probe at the interval top, where any
    remaining positive cycle must be a zero-token one, and reports those
    rows as ``inf``.

    Returns a ``(B,)`` float64 array of cycle ratios in the same time unit
    as ``stack.weights`` (microseconds throughout this pipeline);
    ``-inf`` marks an acyclic row.  ``lo0``, when given, is a ``(B,)``
    per-row *sound lower bound* on the cycle ratio; it shrinks the
    bisection interval and never changes the result.

    ``backend``: ``"edges"`` (numpy float64 on the host, the reference's
    exact oracle), ``"csr"`` (the exact float64 search on ``device``, K1
    per relaxation round), ``"dense"`` (float32 max-plus matrix squaring
    on ``device``, K2/K3, looser tolerance) or ``"auto"`` (``"csr"``).
    ``device`` is resolved for every backend, so a call without one
    raises where there is no CUDA device.

    ``devices`` (``"csr"`` only): two or more devices shard the batch
    axis — contiguous row chunks, chunk k on ``devices[k]`` (a CUDA
    device on a stream of its own, so one card may repeat), all
    in flight at once and bit-identical to the unsharded solve; a single
    device pins the unsharded solve to it.  Any other backend with
    ``devices`` raises ``ValueError``.
    """
    dev = resolve(device)
    if backend == "auto":
        backend = "csr"
    if devices and backend != "csr":
        raise ValueError(f"devices= requires the 'csr' backend, got {backend!r}")
    if backend == "dense":
        if detect_deadlock:
            raise ValueError("detect_deadlock is not supported by 'dense'")
        # float32 squaring can't resolve below ~1e-4 relative; honor a
        # caller-requested looser tolerance but clamp tighter requests
        return _mcr_batch_dense(
            stack, max_steps=max_steps, rel_tol=max(rel_tol, 1e-4), lo0=lo0,
            device=dev,
        )
    if backend == "csr":
        return _mcr_batch_csr(
            stack, max_steps=max_steps, rel_tol=rel_tol, lo0=lo0,
            detect_deadlock=detect_deadlock, device=dev,
            devices=[resolve(d) for d in devices] if devices else None,
        )
    if backend != "edges":
        raise ValueError(
            f"unknown backend {backend!r}; have ('auto', 'edges', 'csr', 'dense')"
        )

    b, n, e = stack.n_graphs, stack.n_actors, stack.n_edges
    if e == 0:
        return np.full(b, NEG_INF)

    # flat batched CSR over (row, dst): segment-max targets, computed once
    rows = np.arange(b, dtype=np.int64)[:, None]
    flat_src = (rows * n + stack.src).ravel()
    flat_dst = (rows * n + stack.dst).ravel()
    order = np.argsort(flat_dst, kind="stable")
    uniq_keys, seg_starts = np.unique(flat_dst[order], return_index=True)
    # segment-ordered edge views + key->row map, hoisted out of the probes
    src_ord = flat_src[order]
    w_ord = stack.weights.ravel()[order]
    t_ord = stack.tokens.ravel()[order]
    row_ord = order // e
    key_row = uniq_keys // n

    upper = _upper_path_bound(stack, order, uniq_keys, seg_starts)
    lo, hi, has_cycle = _bisection_bounds(stack, upper, lo0)

    deadlocked = np.zeros(b, dtype=bool)
    if detect_deadlock:
        deadlocked = _positive_cycle_masks(
            stack, hi, src_ord, w_ord, t_ord, row_ord, key_row,
            uniq_keys, seg_starts, upper, None,
        )

    for _ in range(max_steps):
        tol = rel_tol * np.maximum(1.0, np.abs(hi))
        active = ((hi - lo) > tol) & ~deadlocked
        if not active.any():
            break
        mid = np.where(active, 0.5 * (lo + hi), lo)
        pos = _positive_cycle_masks(
            stack, mid, src_ord, w_ord, t_ord, row_ord, key_row,
            uniq_keys, seg_starts, upper, active,
        )
        has_cycle |= active & pos
        lo = np.where(active & pos, mid, lo)
        hi = np.where(active & ~pos, mid, hi)
    # rows that never showed a positive cycle at any probed lambda (and have
    # no self-loop cycle) are acyclic: no cycle bounds their throughput
    res = np.where(has_cycle, 0.5 * (lo + hi), NEG_INF)
    return np.where(deadlocked, np.inf, res) if detect_deadlock else res


def _pack_csr(stack: EdgeStack, lo0: Optional[np.ndarray]) -> Optional[tuple]:
    """Host-side packing of an EdgeStack for the device bisection.

    Returns ``((indptr, src, w, tok), lo, hi, has_cycle)`` or ``None`` when
    the stack has no finite edge at all (every row is acyclic padding).
    The layout is the flat dst-sorted CSR over all ``B*n`` nodes:
    ``indptr`` (B*n+1,) row pointers, then per edge its flat source id,
    weight and tokens.  ``-inf`` padding slots are dropped: the neutral
    element contributes nothing, and a skewed in-degree costs no padding.
    """
    b, n, e = stack.n_graphs, stack.n_actors, stack.n_edges
    rows = np.arange(b, dtype=np.int64)[:, None]
    flat_src = (rows * n + stack.src).ravel()
    flat_dst = (rows * n + stack.dst).ravel()
    keep = np.isfinite(stack.weights.ravel())
    flat_src = flat_src[keep]
    flat_dst = flat_dst[keep]
    w_flat = stack.weights.ravel()[keep]
    t_flat = stack.tokens.ravel()[keep].astype(np.float64)
    if flat_dst.size == 0:
        return None
    order = np.argsort(flat_dst, kind="stable")
    uniq_keys, seg_starts = np.unique(flat_dst[order], return_index=True)
    src_ord = flat_src[order]
    w_ord = w_flat[order]
    t_ord = t_flat[order]

    # per-row simple-path bound (same construction as _upper_path_bound,
    # over the filtered edge set), summed left to right: numpy's pairwise
    # sum groups a row's terms by its length, so isolated actors padded on
    # at the end (fuse_stacks, pad_stack_to_buckets) would move the bound
    # by an ulp and the bisection's probes with it; a running sum is
    # unchanged by trailing zeros, which keeps every row's search local
    max_in = np.full(b * n, NEG_INF)
    max_in[uniq_keys] = np.maximum.reduceat(w_ord, seg_starts)
    upper = np.cumsum(np.clip(max_in.reshape(b, n), 0.0, None), axis=1)[:, -1]
    lo, hi, has_cycle = _bisection_bounds(stack, upper, lo0)

    indptr = np.zeros(b * n + 1, dtype=np.int64)
    np.cumsum(np.bincount(flat_dst, minlength=b * n), out=indptr[1:])
    if indptr[-1] > np.iinfo(np.int32).max or b * n > np.iinfo(np.int32).max:
        raise ValueError(f"stack too large for int32 CSR ids: {b} x {n} x {e}")
    return (indptr, src_ord, w_ord, t_ord), lo, hi, has_cycle


def _mcr_batch_csr(
    stack: EdgeStack,
    *,
    device: torch.device,
    max_steps: int = 80,
    rel_tol: float = 1e-8,
    lo0: Optional[np.ndarray] = None,
    detect_deadlock: bool = False,
    k_probes: Optional[int] = None,
    devices: Optional[Sequence[torch.device]] = None,
) -> np.ndarray:
    """Exact float64 lambda-search on ``device`` (the ``"csr"`` backend).

    Same flat batched CSR packing and path bounds as the ``"edges"`` path;
    the bisection — multi-lambda probes, relaxation rounds (kernel K1),
    interval updates — runs on the device
    (:func:`repro_torch.kernels.maxplus_bellman.csr_bisect`).  Exact to the
    same ``rel_tol`` contract as ``"edges"``; the two agree to
    bisection-interval width on every row.

    ``devices`` (two or more) shards the batch axis: the rows split into
    ``len(devices)`` contiguous chunks (:func:`repro_torch.launch.sharding.row_chunks`),
    each packed alone and solved on its own device and stream with all
    chunks in flight at once
    (:func:`repro_torch.kernels.maxplus_bellman.mcr_bisect_device_sharded`).
    A chunk's rows get the same CSR segments and path bounds as in the
    whole stack, so device count never changes a result.  A single device
    in ``devices`` pins the unsharded solve to it.  Chunks are not padded
    to a common row count (the reference pads them so that each device
    compiles once; nothing here is compiled per shape).
    """
    b, e = stack.n_graphs, stack.n_edges
    if e == 0:
        return np.full(b, NEG_INF)
    if k_probes is None:
        k_probes = kbell.DEFAULT_K_PROBES
    # multi-probe steps shrink the interval (k+1)x per sweep, so the
    # classic bisection budget over-covers by the same log factor
    steps = max(4, int(math.ceil(max_steps / math.log2(k_probes + 1))) + 1)
    devices = list(devices) if devices else []
    if len(devices) == 1:
        device = devices[0]
    n_chunks = min(len(devices), b) if len(devices) > 1 else 1
    search = dict(n_actors=stack.n_actors, rel_tol=rel_tol, k_probes=k_probes,
                  max_steps=steps, detect_deadlock=detect_deadlock)

    if n_chunks <= 1:
        packed = _pack_csr(stack, lo0)
        if packed is None:
            return np.full(b, NEG_INF)
        arrays, lo, hi, has_cycle = packed
        lo, hi, has_cycle, deadlocked = kbell.mcr_bisect_device(
            arrays, lo, hi, has_cycle, device=device, **search,
        )
        res = np.where(has_cycle, 0.5 * (lo + hi), NEG_INF)
        return np.where(deadlocked, np.inf, res) if detect_deadlock else res

    res = np.full(b, NEG_INF)
    dead = np.zeros(b, dtype=bool)
    chunks, slices, devs = [], [], []
    for k, sl in enumerate(row_chunks(b, n_chunks)):
        sub = EdgeStack(
            n_actors=stack.n_actors, src=stack.src[sl], dst=stack.dst[sl],
            tokens=stack.tokens[sl], weights=stack.weights[sl],
        )
        packed = _pack_csr(sub, lo0[sl] if lo0 is not None else None)
        if packed is None:
            continue                       # all-padding rows stay -inf
        chunks.append(packed)
        slices.append(sl)
        devs.append(devices[k])
    if not chunks:
        return res
    lo, hi, has_cycle, deadlocked = kbell.mcr_bisect_device_sharded(
        chunks, devs, **search,
    )
    rows = np.r_[tuple(slices)]             # the solved chunks' rows, in order
    res[rows] = np.where(has_cycle, 0.5 * (lo + hi), NEG_INF)
    dead[rows] = deadlocked
    return np.where(dead, np.inf, res) if detect_deadlock else res


def _maxplus_fixpoint(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when one more max-plus squaring left the closure unchanged.

    Supports must match exactly; finite entries may drift by float32
    re-association slack, so they compare under a relative tolerance two
    decades tighter than the dense backend's 1e-4 growth threshold.  A
    positive cycle above that threshold keeps pumping the on-cycle entries
    geometrically, so it can never masquerade as a fixpoint.
    """
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        return False
    av, bv = a[fa], b[fa]
    if av.numel() == 0:
        return True
    return bool(((av - bv).abs() <= 1e-6 * torch.clamp(bv.abs(), min=1.0)).all())


def _mcr_batch_dense(
    stack: EdgeStack,
    *,
    device: torch.device,
    max_steps: int = 60,
    rel_tol: float = 1e-4,
    lo0: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Dense-kernel lambda-search: positive-cycle detection by max-plus
    matrix squaring through the batched (max,+) matmul (K2).

    ``W[b, i, j] = max over edges j->i of (w - lam*m)`` with a 0 diagonal
    (the (max,+) identity folded in), so ``W^(2^k)`` holds longest paths of
    length <= 2^k.  Each bisection step squares until the closure stops
    changing (:func:`_maxplus_fixpoint`), at most ceil(log2 n) times; one
    extra relaxation (the matvec K3) then detects growth.  float32, so
    tolerances are looser than ``"edges"``/``"csr"``.
    """
    b, n = stack.n_graphs, stack.n_actors
    finite = np.isfinite(stack.weights)
    # loose positive-weight-sum upper bound: the float32 squaring path
    # saturates long before a per-node bound would pay off
    wpos = np.where(finite & (stack.weights > 0), stack.weights, 0.0)
    upper = wpos.sum(axis=1)
    lo, hi, has_cycle = _bisection_bounds(stack, upper, lo0)

    rows = np.arange(b, dtype=np.int64)[:, None]
    flat = (rows * n * n + stack.dst * n + stack.src).ravel()
    order = np.argsort(flat, kind="stable")
    uniq_keys, seg_starts = np.unique(flat[order], return_index=True)
    diag = np.arange(n)
    n_sq_cap = max(1, int(math.ceil(math.log2(max(n, 2)))))

    for _ in range(max_steps):
        tol = rel_tol * np.maximum(1.0, np.abs(hi))
        active = (hi - lo) > tol
        if not active.any():
            break
        mid = np.where(active, 0.5 * (lo + hi), lo)
        ww = (stack.weights - mid[:, None] * stack.tokens).ravel()
        w_dense = np.full(b * n * n, NEG_INF, dtype=np.float32)
        w_dense[uniq_keys] = np.maximum.reduceat(
            ww[order].astype(np.float32), seg_starts
        )
        w_dense = w_dense.reshape(b, n, n)
        w_dense[:, diag, diag] = np.maximum(w_dense[:, diag, diag], 0.0)

        w_t = torch.from_numpy(w_dense).to(device)
        m_pow = w_t
        for _ in range(n_sq_cap):
            m_new = kops.maxplus_bmm(m_pow, m_pow)
            saturated = _maxplus_fixpoint(m_new, m_pow)
            m_pow = m_new
            if saturated:
                break
        dist = m_pow.amax(dim=2)                       # paths from 0-vector
        dist1 = kops.maxplus_bmv(w_t, dist)
        growth = torch.clamp(dist.abs(), min=1.0) * 1e-4
        pos = (dist1 > dist + growth).any(dim=1).cpu().numpy()
        has_cycle |= active & pos
        lo = np.where(active & pos, mid, lo)
        hi = np.where(active & ~pos, mid, hi)
    # rows that never showed a positive cycle at any probed lambda (and have
    # no self-loop cycle) are acyclic — same convention as the edges backend
    return np.where(has_cycle, 0.5 * (lo + hi), NEG_INF).astype(np.float64)


def _dense_weight_matrix(
    stack: EdgeStack, mask: np.ndarray, *, dtype=np.float32
) -> np.ndarray:
    """(B, n, n) dense ``W[b, d, s] = max weight over masked edges s->d``."""
    b, n = stack.n_graphs, stack.n_actors
    w = np.full(b * n * n, NEG_INF, dtype=dtype)
    rows = np.arange(b, dtype=np.int64)[:, None]
    flat = (rows * n * n + stack.dst * n + stack.src).ravel()
    sel = mask.ravel()
    fl = flat[sel]
    if fl.size:
        ww = stack.weights.ravel()[sel].astype(dtype)
        order = np.argsort(fl, kind="stable")
        uniq, seg = np.unique(fl[order], return_index=True)
        w[uniq] = np.maximum.reduceat(ww[order], seg)
    return w.reshape(b, n, n)


def maxplus_matrix_batch(stack: EdgeStack, *, device=None) -> torch.Tensor:
    """Batched Eq.-4 matrices: ``T[b] = A0*[b] (x) A1[b]`` as (B, n, n).

    The Kleene star ``A0* = (I (+) A0)^(2^ceil(log2 n))`` comes from
    repeated max-plus squaring through K2 — every candidate's closure
    advances together.  Multi-token edges are conservatively kept as
    one-token dependencies (same convention as :func:`maxplus_matrix`);
    exact multi-token periods come from :func:`mcr_batch`.  Rows must be
    live (an acyclic 0-token subgraph), which this pipeline guarantees.
    Returns a float32 tensor on ``device``.
    """
    dev = resolve(device)
    n = stack.n_actors
    finite = np.isfinite(stack.weights)
    w0 = _dense_weight_matrix(stack, finite & (stack.tokens == 0))
    w1 = _dense_weight_matrix(stack, finite & (stack.tokens >= 1))
    diag = np.arange(n)
    w0[:, diag, diag] = np.maximum(w0[:, diag, diag], 0.0)
    star = torch.from_numpy(w0).to(dev)
    for _ in range(max(1, int(math.ceil(math.log2(max(n, 2)))))):
        star = kops.maxplus_bmm(star, star)
    return kops.maxplus_bmm(star, torch.from_numpy(w1).to(dev))


def evolve_batch(
    t_batch, *, iters: int = 64, x0: Optional[np.ndarray] = None, device=None
) -> tuple[np.ndarray, np.ndarray]:
    """Iterate ``x(k) = T (x) x(k-1)`` for a whole batch of candidates.

    ``t_batch`` is (B, n, n), a numpy array or a tensor.  Returns
    ``(x, period_estimate)``: the final (renormalized) start-time vectors,
    whose *relative* offsets converge to the steady-state static schedule,
    and the mean per-iteration growth over the tail half of the run — a
    float32 MCM estimate (use :func:`mcr_batch` when the exact period is
    needed).  Each step is one K3 launch and renormalizes by the row
    maximum (max-plus scaling invariance) so float32 never drifts.
    """
    dev = resolve(device)
    t = torch.as_tensor(t_batch, device=dev).to(torch.float32).contiguous()
    b, n, _ = t.shape
    if x0 is None:
        x = torch.zeros((b, n), dtype=torch.float32, device=dev)
    else:
        x = torch.as_tensor(np.asarray(x0, dtype=np.float32), device=dev).clone()
    warm = max(1, iters // 2)
    growth = torch.zeros(b, dtype=torch.float64, device=dev)
    counted = 0
    for k in range(iters):
        x = kops.maxplus_bmv(t, x)
        mx = torch.where(torch.isfinite(x), x, NEG_INF).amax(dim=1)
        step = torch.where(torch.isfinite(mx), mx, 0.0)
        x = x - step[:, None]
        if k >= warm:
            growth += step.double()
            counted += 1
    return x.double().cpu().numpy(), (growth / max(counted, 1)).cpu().numpy()


def throughput_batch(
    graphs: Sequence[SDFG],
    *,
    backend: str = "auto",
    rel_tol: float = 1e-8,
    group_factor: float = 1.5,
    device=None,
) -> np.ndarray:
    """Per-graph throughput (1/MCR) for a batch of graphs.

    Rows of an :class:`EdgeStack` all pay the padded maximum edge and actor
    count, so stacking a 20-actor graph with a 700-actor one wastes most of
    the sweep.  Graphs are therefore grouped into similar-size sub-stacks
    (within ``group_factor`` in both actors and edges) and each group is
    analyzed in one :func:`mcr_batch` call; a homogeneous batch (the common
    sweep/admission shape) stays a single call.
    """
    order = sorted(
        range(len(graphs)), key=lambda i: (graphs[i].n_actors, graphs[i].n_channels)
    )
    groups: list[list[int]] = []
    for i in order:
        if groups:
            anchor = graphs[groups[-1][0]]
            g = graphs[i]
            if (
                g.n_actors <= group_factor * max(anchor.n_actors, 1)
                and g.n_channels <= group_factor * max(anchor.n_channels, 1)
            ):
                groups[-1].append(i)
                continue
        groups.append([i])

    out = np.zeros(len(graphs))
    for grp in groups:
        rho = mcr_batch(
            stack_graphs([graphs[i] for i in grp]), backend=backend,
            rel_tol=rel_tol, device=device,
        )
        ok = np.isfinite(rho) & (rho > 0)
        out[np.asarray(grp)[ok]] = 1.0 / rho[ok]
    return out


# ======================================================================
def throughput(g: SDFG, *, method: str = "howard", device=None) -> float:
    """Application throughput = 1 / MCM (paper's headline metric).

    ``"howard"`` and ``"binary"`` run on the host; ``"power"`` iterates
    the float32 max-plus matrix on ``device`` (see
    :func:`mcm_power_iteration`).
    """
    if method == "howard":
        rho = mcr_howard(g)
    elif method == "binary":
        rho = mcr_binary_search(g)
    elif method == "power":
        rho = mcm_power_iteration(maxplus_matrix(g), device=device)
    else:
        raise ValueError(f"unknown method {method!r}")
    if rho <= 0 or not np.isfinite(rho):
        return 0.0
    return 1.0 / rho
