"""Batched self-timed execution engine (paper §4.4–§5, array-native).

Once static orders exist, the order-edge-augmented event graph fully
determines self-timed execution: its evolution is the max-plus recursion
``x(k) = A (x) x(k-1)`` (Eq. 4), so the steady-state period and per-actor
start times follow from *analysis* rather than discrete-event replay.  This
module evaluates MANY candidate configurations of one application at once —
bindings, free-tile subsets, static orders — exploiting that all candidates
share the application's topology (self-edges, data flow, buffer back-edges)
and differ only in NoC delays and TDMA order edges:

  * :func:`stack_hardware_aware` builds the whole candidate batch directly
    as an :class:`~.maxplus.EdgeStack` (B, E) — per-row §4.4 transformation
    without materializing B ``SDFG`` objects.
  * :func:`batch_execute` analyzes the stack in one shot: exact periods via
    the batched lambda-search (:func:`~.maxplus.mcr_batch`), and optionally
    steady-state start-time vectors by iterating the batched max-plus
    recursion through the CUDA (max,+) kernels K2/K3
    (:func:`~.maxplus.maxplus_matrix_batch` / :func:`~.maxplus.evolve_batch`).

Static orders travel through this module array-natively as well: an
:class:`OrderBatch` carries B candidates' TDMA order cycles as (B, n)
edge arrays (built in one shot by :func:`project_order_batch` or
:func:`~.schedule.build_static_orders_batch`), keeping stacked shapes
candidate-count-invariant; :func:`batch_execute` additionally rounds the
stacked (B, n, E) shape up to pow2-ish buckets on the device backends
(:func:`compile_cache_stats` counts how often a shape recurs).

The heapq :class:`~.schedule.SelfTimedExecutor` remains the operational
cross-validation oracle — see ``tests/test_engine.py`` and
``tests/test_frontend.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional, Sequence, Union

import numpy as np

from .hardware import ChipState, HardwareConfig
from ..device import resolve
from ..launch.sharding import current_mesh, mesh_devices
from .maxplus import (
    NEG_INF,
    EdgeStack,
    evolve_batch,
    maxplus_matrix_batch,
    mcr_batch,
)
from .sdfg import SDFG, hardware_static_parts, order_edges


# ======================================================================
# batched §4.4 graph construction: one EdgeStack for B candidates
# ======================================================================
def _as_binding_matrix(bindings, n_actors: int) -> np.ndarray:
    b = np.asarray(bindings, dtype=np.int64)
    if b.ndim == 1:
        b = b[None, :]
    assert b.ndim == 2 and b.shape[1] == n_actors, b.shape
    return b


# ======================================================================
# array-native static orders: (B, n) TDMA order-edge batch
# ======================================================================
@dataclasses.dataclass(frozen=True)
class OrderBatch:
    """Batched §4.4 step-2 TDMA order cycles as (B, n_actors) edge arrays.

    Row ``b`` holds candidate b's order edges: every actor appears exactly
    once as a source (``src[b]`` is a permutation of the actors) and its
    edge points to the next actor in its tile's firing cycle, with one
    initial token on each cycle's wrap-around edge.  A single-actor tile
    degenerates to a one-token self-edge, whose cycle ratio (``tau``) is
    already implied by the actor's own self-edge — so the slot count is
    exactly ``n_actors`` for EVERY candidate, making stacked shapes
    invariant across bindings (the shape-bucket compile cache's best
    case).  Replaces ``list[list[int]]`` orders on every batched hot path;
    the list form remains supported for hand-built schedules.
    """

    src: np.ndarray        # (B, n_actors) int64; row = permutation of actors
    dst: np.ndarray        # (B, n_actors) int64 successor on the tile cycle
    tokens: np.ndarray     # (B, n_actors) int64; 1 on each wrap-around edge

    @property
    def n_graphs(self) -> int:
        """Number of candidate rows B."""
        return int(self.src.shape[0])

    @property
    def n_actors(self) -> int:
        """Actor count n shared by all rows."""
        return int(self.src.shape[1])

    def row(
        self, b: int, binding: np.ndarray, n_tiles: Optional[int] = None
    ) -> list[list[int]]:
        """Row ``b`` as per-tile order lists (compat with the list form).

        ``binding`` is the row's (n_actors,) tile assignment; tiles are
        returned in id order (``n_tiles`` of them — defaults to the highest
        bound tile + 1) with their actors in firing order.
        """
        binding = np.asarray(binding)
        if n_tiles is None:
            n_tiles = int(binding.max(initial=0)) + 1
        per_tile: list[list[int]] = [[] for _ in range(n_tiles)]
        for a in self.src[b]:
            per_tile[int(binding[a])].append(int(a))
        return per_tile


#: Orders accepted by the batched engine: per-candidate Python lists
#: (entries may be None) or one array-native :class:`OrderBatch`.
OrdersLike = Union[Sequence[Optional[Sequence[Sequence[int]]]], OrderBatch]


def project_order_batch(single_order: Sequence[int], bindings) -> OrderBatch:
    """Lemma-1 projection of ONE total order onto B bindings, batched.

    ``single_order`` is the design-time single-tile actor order (a
    permutation of ``range(n_actors)``; missing actors are appended in id
    order, exactly like :func:`repro_torch.core.runtime.project_order`);
    ``bindings`` is (B, n_actors) int tile ids (a single (n,) binding is
    promoted).  Returns the :class:`OrderBatch` whose row ``b`` chains each
    tile's actors in ``single_order``'s relative order — the same per-tile
    sequences ``project_order`` + ``order_edges`` produce, built with three
    vectorized array ops instead of a per-candidate Python loop.
    """
    bindings = np.asarray(bindings, dtype=np.int64)
    if bindings.ndim == 1:
        bindings = bindings[None, :]
    n_b, n = bindings.shape
    order_arr = np.asarray(list(single_order), dtype=np.int64)
    pos = np.full(n, -1, dtype=np.int64)
    pos[order_arr] = np.arange(order_arr.size)
    missing = np.flatnonzero(pos < 0)
    pos[missing] = order_arr.size + np.arange(missing.size)

    idx = np.arange(n)
    key = bindings * n + pos[None, :]
    sortidx = np.argsort(key, axis=1)                 # actors by (tile, rank)
    sb = np.take_along_axis(bindings, sortidx, axis=1)
    is_start = np.ones((n_b, n), dtype=bool)
    is_start[:, 1:] = sb[:, 1:] != sb[:, :-1]
    is_last = np.ones((n_b, n), dtype=bool)
    is_last[:, :-1] = sb[:, 1:] != sb[:, :-1]
    run_start = np.maximum.accumulate(
        np.where(is_start, idx[None, :], 0), axis=1
    )
    nxt_pos = np.where(is_last, run_start, np.minimum(idx[None, :] + 1, n - 1))
    dst = np.take_along_axis(sortidx, nxt_pos, axis=1)
    return OrderBatch(
        src=sortidx, dst=dst, tokens=is_last.astype(np.int64)
    )


def _order_shortcuts_batch(
    ob: OrderBatch, tau: np.ndarray, bindings: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Batched max-plus path-doubling shortcuts over an :class:`OrderBatch`.

    Same contract as :func:`_order_shortcuts`, vectorized across rows: for
    span s = 2, 4, 8, … one composed edge per actor whose weight / tokens
    are the sums along the underlying span-s path of its tile's order
    cycle, so every cycle ratio — hence :func:`~.maxplus.mcr_batch` — is
    exactly preserved while relaxation crosses a length-k cycle in O(log k)
    rounds.  Returns ``(src, dst, tokens, weights)`` as (B, n * n_spans)
    arrays (possibly zero-width).  NOT valid as Eq.-4 dependencies.
    """
    n_b, n = ob.src.shape
    rows = np.arange(n_b)[:, None]
    empty = np.zeros((n_b, 0), dtype=np.int64)
    n_tiles = int(bindings.max(initial=0)) + 1
    occ = np.bincount(
        (rows * n_tiles + bindings).ravel(), minlength=n_b * n_tiles
    )
    max_len = int(occ.max(initial=0))
    if n < 4 or max_len < 4:
        return empty, empty, empty, np.zeros((n_b, 0))

    nxt = np.empty((n_b, n), dtype=np.int64)
    nxt[rows, ob.src] = ob.dst
    m = np.zeros((n_b, n), dtype=np.int64)
    m[rows, ob.src] = ob.tokens
    w = np.take_along_axis(
        np.broadcast_to(tau, (n_b, n)), nxt, axis=1
    ).astype(np.float64)
    base = np.broadcast_to(np.arange(n), (n_b, n))
    srcs, dsts, toks, ws = [], [], [], []
    span = 1
    while 2 * span < max_len:
        w = w + np.take_along_axis(w, nxt, axis=1)
        m = m + np.take_along_axis(m, nxt, axis=1)
        nxt = np.take_along_axis(nxt, nxt, axis=1)
        span *= 2
        srcs.append(base)
        dsts.append(nxt.copy())
        toks.append(m.copy())
        ws.append(w.copy())
    if not srcs:
        return empty, empty, empty, np.zeros((n_b, 0))
    return (
        np.concatenate(srcs, axis=1),
        np.concatenate(dsts, axis=1),
        np.concatenate(toks, axis=1),
        np.concatenate(ws, axis=1),
    )


def _order_shortcuts(
    n_actors: int, t, tau: np.ndarray, max_len: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Max-plus path-doubling shortcuts along one row's TDMA order cycles.

    The order edges of a row form disjoint per-tile cycles (a functional
    graph on the ordered actors), which makes them the *diameter* of the
    hardware-aware graph: plain Bellman-Ford needs O(cycle length) rounds
    to move information around a tile.  This emits, for span ``s = 2, 4,
    8, … < max_len``, one composed edge per ordered actor with ``weight`` /
    ``tokens`` equal to the SUM along the underlying span-``s`` path.  Each
    shortcut is the max-plus composition of a real path, so every cycle
    through shortcuts corresponds to a closed walk of the original graph
    with identical weight and token sums — the maximum cycle ratio is
    *exactly* preserved while relaxation reaches across a length-k cycle
    in O(log k) rounds.

    Returns ``(src, dst, tokens, weights)`` arrays of the shortcut edges
    (possibly empty).  NOT valid as Eq.-4 dependencies: a multi-token
    shortcut is a *relaxed* multi-iteration dependency, so these edges
    must never feed :func:`~.maxplus.maxplus_matrix_batch`.
    """
    nodes = t.src
    k = nodes.size
    if k < 4 or max_len < 4:
        empty = np.array([], dtype=np.int64)
        return empty, empty, empty, np.array([], dtype=np.float64)
    inv = np.full(n_actors, -1, dtype=np.int64)
    inv[nodes] = np.arange(k)
    nx = inv[t.dst]                      # successor, as an index into nodes
    w = tau[t.dst].astype(np.float64)    # span-1 path weight
    m = t.tokens.astype(np.int64)        # span-1 token sum
    srcs, dsts, toks, ws = [], [], [], []
    span = 1
    while 2 * span < max_len:
        w = w + w[nx]
        m = m + m[nx]
        nx = nx[nx]
        span *= 2
        srcs.append(nodes)
        dsts.append(nodes[nx])
        toks.append(m.copy())
        ws.append(w.copy())
    if not srcs:
        empty = np.array([], dtype=np.int64)
        return empty, empty, empty, np.array([], dtype=np.float64)
    return (
        np.concatenate(srcs),
        np.concatenate(dsts),
        np.concatenate(toks),
        np.concatenate(ws),
    )


def order_cycle_lower_bounds(
    tau: np.ndarray,
    bindings: np.ndarray,
    orders_list: Optional[OrdersLike],
) -> Optional[np.ndarray]:
    """(B,) sound per-row lower bounds on the steady-state period.

    Every tile whose static order serializes >= 2 actors contributes a real
    cycle (the TDMA order cycle, one token on the wrap-around edge) whose
    ratio is the sum of its actors' execution times ``tau`` (time units of
    ``tau``, microseconds here).  The row bound is the max over tiles;
    rows without orders get ``-inf``.  Feeding this into
    :func:`~.maxplus.mcr_batch` (``lo0``) shrinks the bisection interval —
    in the paper's compute-bound regime (Table 2) it is usually within a
    few percent of the true period.  Returns None when no row has orders.
    An :class:`OrderBatch` (every actor ordered on its tile) is scored with
    two vectorized bincounts instead of the per-row Python walk.
    """
    if orders_list is None:
        return None
    if isinstance(orders_list, OrderBatch):
        n_b, n = bindings.shape
        n_tiles = int(bindings.max(initial=0)) + 1
        flat = (np.arange(n_b)[:, None] * n_tiles + bindings).ravel()
        sums = np.bincount(
            flat,
            weights=np.broadcast_to(tau, (n_b, n)).ravel(),
            minlength=n_b * n_tiles,
        ).reshape(n_b, n_tiles)
        counts = np.bincount(flat, minlength=n_b * n_tiles).reshape(
            n_b, n_tiles
        )
        return np.where(counts >= 2, sums, -np.inf).max(
            axis=1, initial=-np.inf
        )
    n_b = bindings.shape[0]
    lo0 = np.full(n_b, -np.inf)
    any_orders = False
    for row, orders in enumerate(orders_list):
        if orders is None:
            continue
        any_orders = True
        best = -np.inf
        binding = bindings[row]
        for tile, order in enumerate(orders):
            members = [a for a in order if binding[a] == tile]
            if len(members) > 1:
                best = max(best, float(tau[np.asarray(members)].sum()))
        lo0[row] = best
    return lo0 if any_orders else None


@dataclasses.dataclass(frozen=True)
class ChipMetrics:
    """Per-candidate chip-objective accumulators of one EdgeStack build.

    Computed from the SAME vectorized hop pass that produces the stack's
    NoC delays (no second traversal of the flow edges, no per-candidate
    Python): ``cut_traffic[b]`` is candidate b's inter-tile spikes per
    iteration (SpiNeMap's objective), ``spike_hops[b]`` the rate-weighted
    NoC hop count (the link-energy term), ``tiles_used[b]`` the number of
    occupied tiles (the idle-leakage term), ``total_spikes`` the
    binding-independent spikes delivered per iteration, and
    ``read_charge`` those spikes weighted by the destination actor's mean
    OxRAM row length (``SDFG.read_cost``): one delivered spike drives one
    crossbar row and reads every crosspoint on it, so the crossbar read
    energy scales with fan-out row length.  When the graph carries no
    ``read_cost`` the charge equals ``total_spikes`` (flat model).
    Feed into :meth:`~repro_torch.core.hardware.HardwareConfig.chip_energy`
    together with the periods to get (B,) chip energies.
    """

    cut_traffic: np.ndarray   # (B,) inter-tile spikes per iteration
    spike_hops: np.ndarray    # (B,) rate-weighted NoC hops per iteration
    tiles_used: np.ndarray    # (B,) occupied tiles per candidate
    total_spikes: float       # spikes delivered per iteration (all rows)
    read_charge: float        # row-length-weighted crossbar reads (all rows)


def stack_hardware_aware(
    app: SDFG,
    bindings,
    hw: HardwareConfig,
    orders_list: Optional[OrdersLike] = None,
    *,
    relax_shortcuts: bool = False,
    with_metrics: bool = False,
    chip_state: Optional[ChipState] = None,
    rate_scale=None,
) -> Union[EdgeStack, tuple[EdgeStack, ChipMetrics]]:
    """Hardware-aware graphs of B candidate bindings as ONE EdgeStack.

    ``bindings`` is (B, n_actors) int (a single (n,) binding is promoted);
    ``orders_list`` optionally gives per-candidate static orders — either
    per-candidate Python lists (entries may be None for order-free
    candidates) or one array-native :class:`OrderBatch`, whose uniform
    ``n_actors`` order-edge slots skip the per-row Python path entirely
    AND keep the stacked shape invariant across candidate batches (the
    shape-bucket compile cache's best case).  Self-edges, flow edges and
    buffer back-edges share src/dst/tokens across rows — only flow delays
    (NoC hops of each candidate's binding) and the order-edge slots differ.
    Order-edge slots are padded to the batch maximum with ``-inf`` weight,
    the (max,+) neutral element, so padding never joins a longest path.

    ``relax_shortcuts=True`` additionally emits path-doubling shortcut
    edges along each row's order cycles (:func:`_order_shortcuts` /
    :func:`_order_shortcuts_batch`): the maximum cycle ratio — and
    therefore every period computed by :func:`~.maxplus.mcr_batch` — is
    exactly preserved, while Bellman-Ford relaxation converges in
    O(log cycle-length) instead of O(cycle-length) rounds.  Stacks built
    this way are for cycle-ratio analysis ONLY; do not pass them to
    :func:`~.maxplus.maxplus_matrix_batch`.

    Returns an :class:`~.maxplus.EdgeStack` with (B, E) arrays; weights
    carry ``tau[dst] + delay`` in the time unit of ``app.exec_time``
    (microseconds throughout this pipeline).  ``with_metrics=True``
    returns ``(stack, ChipMetrics)`` instead: the per-candidate chip
    accumulators (cut traffic, spike-hops, occupied tiles) fall out of
    the same vectorized hop pass that produced the NoC delays, so the
    energy objective costs no extra traversal.

    ``chip_state`` (a :class:`~repro_torch.core.hardware.ChipState`) applies the
    chip's current degradation inside the SAME hop pass: throttled-route
    scale factors are gathered per (candidate, flow-edge) pair and
    multiply the NoC link time.  Dead tiles do NOT change the stack — they
    make whole candidate rows infeasible, which :func:`batch_execute`
    masks to ``inf`` periods.  ``rate_scale`` (scalar, or (n_flow_edges,)
    per-flow-edge factors — the per-app drift multipliers of a union
    graph) scales the observed spike rates used for both NoC delays and
    the chip-metric accumulators; the design-time buffer provisioning
    (back-edge tokens) and crossbar firing times ``tau`` stay at their
    design values.
    """
    bindings = _as_binding_matrix(bindings, app.n_actors)
    n_b = bindings.shape[0]
    assert bindings.min(initial=0) >= 0 and bindings.max(initial=0) < hw.n_tiles, (
        f"binding tile ids must lie in [0, {hw.n_tiles})"
    )
    order_batch: Optional[OrderBatch] = None
    if isinstance(orders_list, OrderBatch):
        order_batch = orders_list
        assert order_batch.src.shape == (n_b, app.n_actors), (
            order_batch.src.shape, (n_b, app.n_actors)
        )
        orders_list = None
    elif orders_list is not None:
        assert len(orders_list) == n_b, (len(orders_list), n_b)

    keep_self, flow, back = hardware_static_parts(app, hw)
    tau = app.exec_time

    # shared part: (E0,) arrays broadcast over rows.  Self/buffer edges keep
    # their app-level delay (flow delays are *replaced* by the NoC model,
    # exactly as in hardware_aware_sdfg).
    base_src = np.concatenate([keep_self.src, flow.src, back.src])
    base_dst = np.concatenate([keep_self.dst, flow.dst, back.dst])
    base_tok = np.concatenate([keep_self.tokens, flow.tokens, back.tokens])
    e0 = base_src.size
    ef = len(flow)

    # per-row NoC hops in one vectorized gather: delays — and, when asked,
    # the chip-objective accumulators — derive from this single pass
    flow_rate = flow.rate
    if rate_scale is not None:
        scale = np.asarray(rate_scale, dtype=np.float64)
        assert scale.ndim == 0 or scale.shape == (ef,), (
            f"rate_scale must be scalar or ({ef},), got {scale.shape}"
        )
        flow_rate = flow_rate * scale
    if ef:
        src_t = np.take(bindings, flow.src, axis=-1)
        dst_t = np.take(bindings, flow.dst, axis=-1)
        hops = hw.hops_array(src_t, dst_t)
        link_scale = (
            chip_state.route_scale_array(src_t, dst_t)
            if chip_state is not None
            else None
        )
        delays = hw.comm_delay_from_hops(flow_rate, hops, link_scale)
    else:
        hops = np.zeros((n_b, 0), dtype=np.int64)
        delays = np.zeros((n_b, 0))
    metrics: Optional[ChipMetrics] = None
    if with_metrics:
        occ = np.bincount(
            (np.arange(n_b)[:, None] * hw.n_tiles + bindings).ravel(),
            minlength=n_b * hw.n_tiles,
        ).reshape(n_b, hw.n_tiles)
        read_w = (
            app.read_cost[flow.dst] if app.read_cost is not None else 1.0
        )
        metrics = ChipMetrics(
            cut_traffic=(flow_rate * (hops > 0)).sum(axis=1),
            spike_hops=(flow_rate * hops).sum(axis=1),
            tiles_used=(occ > 0).sum(axis=1),
            total_spikes=float(np.asarray(flow_rate).sum()),
            read_charge=float((flow_rate * read_w).sum()),
        )
    base_w = (tau[base_dst] + np.concatenate(
        [keep_self.delay, np.zeros(ef), back.delay]
    ))[None, :].repeat(n_b, axis=0)
    base_w[:, keep_self.src.size : keep_self.src.size + ef] += delays

    if order_batch is not None:
        # array-native order part: (B, n [+ shortcut spans]) — no per-row
        # Python, and a candidate-count-invariant slot width.  Unlike the
        # list path (order_edges filters each order by binding), the batch
        # arrays are used as-is — so a stale OrderBatch reused after the
        # bindings changed would chain actors across tiles; reject it.
        rows_ix = np.arange(n_b)[:, None]
        assert np.array_equal(
            bindings[rows_ix, order_batch.src],
            bindings[rows_ix, order_batch.dst],
        ), "OrderBatch is inconsistent with bindings (edge crosses tiles); " \
           "rebuild it with project_order_batch for these bindings"
        o_src, o_dst = order_batch.src, order_batch.dst
        o_tok = order_batch.tokens
        o_w = tau[o_dst]
        if relax_shortcuts:
            s_src, s_dst, s_tok, s_w = _order_shortcuts_batch(
                order_batch, tau, bindings
            )
            if s_src.shape[1]:
                o_src = np.concatenate([o_src, s_src], axis=1)
                o_dst = np.concatenate([o_dst, s_dst], axis=1)
                o_tok = np.concatenate([o_tok, s_tok], axis=1)
                o_w = np.concatenate([o_w, s_w], axis=1)
        src = np.concatenate(
            [np.broadcast_to(base_src, (n_b, e0)), o_src], axis=1
        )
        dst = np.concatenate(
            [np.broadcast_to(base_dst, (n_b, e0)), o_dst], axis=1
        )
        tokens = np.concatenate(
            [np.broadcast_to(base_tok, (n_b, e0)), o_tok], axis=1
        )
        weights = np.concatenate([base_w, o_w], axis=1)
        stack = EdgeStack(
            n_actors=app.n_actors, src=src, dst=dst, tokens=tokens,
            weights=weights,
        )
        return (stack, metrics) if with_metrics else stack

    # per-row order edges (+ optional shortcuts), padded to the batch max
    order_rows: list[Optional[tuple]] = []
    if orders_list is not None:
        for row, orders in enumerate(orders_list):
            if orders is None:
                order_rows.append(None)
                continue
            t = order_edges(orders, bindings[row])
            o_src, o_dst = t.src, t.dst
            o_tok, o_w = t.tokens, tau[t.dst]
            if relax_shortcuts and len(t):
                max_len = int(np.bincount(bindings[row]).max(initial=0))
                s_src, s_dst, s_tok, s_w = _order_shortcuts(
                    app.n_actors, t, tau, max_len
                )
                if s_src.size:
                    o_src = np.concatenate([o_src, s_src])
                    o_dst = np.concatenate([o_dst, s_dst])
                    o_tok = np.concatenate([o_tok, s_tok])
                    o_w = np.concatenate([o_w, s_w])
            order_rows.append((o_src, o_dst, o_tok, o_w))
    eo = max((r[0].size for r in order_rows if r is not None), default=0)

    src = np.zeros((n_b, e0 + eo), dtype=np.int64)
    dst = np.zeros((n_b, e0 + eo), dtype=np.int64)
    tokens = np.ones((n_b, e0 + eo), dtype=np.int64)
    weights = np.full((n_b, e0 + eo), NEG_INF)
    src[:, :e0] = base_src
    dst[:, :e0] = base_dst
    tokens[:, :e0] = base_tok
    weights[:, :e0] = base_w
    for row, r in enumerate(order_rows):
        if r is None or not r[0].size:
            continue
        o_src, o_dst, o_tok, o_w = r
        k = o_src.size
        src[row, e0 : e0 + k] = o_src
        dst[row, e0 : e0 + k] = o_dst
        tokens[row, e0 : e0 + k] = o_tok
        weights[row, e0 : e0 + k] = o_w
    stack = EdgeStack(
        n_actors=app.n_actors, src=src, dst=dst, tokens=tokens, weights=weights
    )
    return (stack, metrics) if with_metrics else stack


# ======================================================================
# shape-bucket compile cache: stable stacked shapes across admissions
# ======================================================================
def _bucket_size(x: int) -> int:
    """Round up to the next pow2-ish bucket (1, 2, 3, 4, 6, 8, 12, 16, …).

    Half-steps between powers of two keep the bucket within 2x of the
    request (< 50% padding waste, vs the plain next-power-of-two's ~100%)
    while collapsing the long tail of one-off shapes onto a few buckets.
    """
    if x <= 1:
        return 1
    p = 1 << (x - 1).bit_length()          # next power of two >= x
    if x <= (3 * p) // 4:
        return (3 * p) // 4
    return p


@dataclasses.dataclass
class CompileCacheStats:
    """Shape-bucket reuse counters of the batched analysis layer.

    Every :func:`batch_execute` call records its (backend, B, n_actors,
    n_edges) stacked shape after bucket rounding; a shape seen before is a
    ``hit`` (device buffers of that shape were needed before), a first
    sighting is a ``miss``.  The admission trajectory records these
    counters per controller.  ``shapes``
    maps each shape key to its occurrence count.
    """

    hits: int = 0
    misses: int = 0
    shapes: dict = dataclasses.field(default_factory=dict)

    @property
    def hit_rate(self) -> float:
        """hits / (hits + misses); 0.0 before any recorded call."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def record(self, key: tuple) -> None:
        """Count one analysis call with stacked-shape signature ``key``."""
        if key in self.shapes:
            self.hits += 1
            self.shapes[key] += 1
        else:
            self.misses += 1
            self.shapes[key] = 1

    def as_dict(self) -> dict:
        """JSON-ready snapshot of the counters."""
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate,
            "n_distinct_shapes": len(self.shapes),
        }


_CACHE_STATS = CompileCacheStats()
_CACHE_SINKS: list[CompileCacheStats] = []


def compile_cache_stats() -> CompileCacheStats:
    """The engine's live shape-bucket counters (see :class:`CompileCacheStats`)."""
    return _CACHE_STATS


@contextlib.contextmanager
def record_cache_stats(stats: CompileCacheStats):
    """Additionally record every batched-analysis shape into ``stats``.

    Context manager: while active, each :func:`batch_execute` call records
    its bucketed shape key into ``stats`` AS WELL AS the module-global
    counters — hit/miss is judged against ``stats``' own history, so the
    caller gets counters scoped to its lifetime (the
    :class:`~repro_torch.core.runtime.AdmissionController` wraps every admission
    in one of these, keeping per-controller counters from leaking into
    each other).  Re-entrant; sinks nest.
    """
    _CACHE_SINKS.append(stats)
    try:
        yield stats
    finally:
        # remove by identity: CompileCacheStats is a value-equal dataclass,
        # so list.remove() could unregister a DIFFERENT sink with equal
        # counters (e.g. two fresh controllers nesting)
        for i in range(len(_CACHE_SINKS) - 1, -1, -1):
            if _CACHE_SINKS[i] is stats:
                del _CACHE_SINKS[i]
                break


def reset_compile_cache_stats() -> None:
    """Zero the engine's shape-bucket counters (benchmark harness hook)."""
    _CACHE_STATS.hits = 0
    _CACHE_STATS.misses = 0
    _CACHE_STATS.shapes.clear()


def pad_stack_to_buckets(
    stack: EdgeStack, lo0: Optional[np.ndarray] = None
) -> tuple[EdgeStack, Optional[np.ndarray]]:
    """Pad an EdgeStack's (B, E) arrays and actor count up to pow2-ish
    bucket sizes (:func:`_bucket_size`).

    Padded edge slots carry ``-inf`` weight (the (max,+) neutral element),
    padded rows are entirely ``-inf`` (analyzed as acyclic and sliced off
    by the caller), and padded actors are isolated — results over the
    original rows/actors are bit-for-bit unchanged.  ``lo0`` (per-row
    lower bounds) is padded with ``-inf`` rows alongside.  Bucketing the
    shapes means repeated admissions and optimizer generations see a few
    stacked shapes instead of every one-off (B, n, E) combination.
    """
    b, e, n = stack.n_graphs, stack.n_edges, stack.n_actors
    b2, e2, n2 = _bucket_size(b), _bucket_size(e), _bucket_size(n)
    if (b2, e2, n2) == (b, e, n):
        return stack, lo0
    src = np.zeros((b2, e2), dtype=np.int64)
    dst = np.zeros((b2, e2), dtype=np.int64)
    tokens = np.ones((b2, e2), dtype=np.int64)
    weights = np.full((b2, e2), NEG_INF)
    src[:b, :e] = stack.src
    dst[:b, :e] = stack.dst
    tokens[:b, :e] = stack.tokens
    weights[:b, :e] = stack.weights
    padded = EdgeStack(
        n_actors=n2, src=src, dst=dst, tokens=tokens, weights=weights
    )
    if lo0 is not None:
        lo0 = np.concatenate([lo0, np.full(b2 - b, -np.inf)])
    return padded, lo0


# ======================================================================
# batched execution: periods (+ optional steady-state start times)
# ======================================================================
@dataclasses.dataclass
class EngineReport:
    """Batched self-timed analysis of B candidate configurations.

    ``periods[b]`` is candidate b's steady-state iteration period (the MCR
    of its order-augmented event graph) in the model's time unit
    (microseconds, see :mod:`repro_torch.core.hardware`); ``starts``, when
    requested, holds per-actor steady-state start-time offsets from the
    max-plus recursion (normalized so each row's earliest actor starts at
    0) — the static schedule the paper's Eq. 4 evolution converges to.
    ``energies``/``metrics``, when requested (``with_energy=True``), hold
    per-candidate chip energy (pJ per iteration,
    :meth:`~repro_torch.core.hardware.HardwareConfig.chip_energy`; ``inf`` for
    dead rows) and the raw :class:`ChipMetrics` accumulators.
    ``build_time_s`` / ``analysis_time_s`` are wall-clock seconds of the
    EdgeStack build and the batched analysis.
    """

    periods: np.ndarray                 # (B,) microseconds of model time
    starts: Optional[np.ndarray]        # (B, n_actors) microseconds, or None
    build_time_s: float
    analysis_time_s: float
    energies: Optional[np.ndarray] = None   # (B,) pJ per iteration, or None
    metrics: Optional[ChipMetrics] = None

    @property
    def throughputs(self) -> np.ndarray:
        """(B,) iterations per microsecond (1/period); 0.0 for dead or
        acyclic rows (non-finite or non-positive period)."""
        ok = np.isfinite(self.periods) & (self.periods > 0)
        out = np.zeros_like(self.periods)
        out[ok] = 1.0 / self.periods[ok]
        return out

    @property
    def n_candidates(self) -> int:
        """Number of candidate configurations B in this batch."""
        return int(self.periods.size)


@dataclasses.dataclass
class PreparedExec:
    """One application's stacked analysis inputs, built but not yet solved.

    Produced by :func:`prepare_execution`; consumed either by
    :func:`batch_execute` (one solve per prepared stack) or by
    :func:`batch_execute_fused`, which concatenates the rows of MANY
    independent prepared stacks into one fused :class:`EdgeStack` so a
    whole tick's worth of scoring — several optimizer populations,
    several region components — pays the device round trips once.
    ``rel_tol`` rides along so a fused solve can take the tightest
    tolerance over its members (tighter is sound for all rows, it only
    costs bisection rounds).
    """

    app: SDFG
    bindings: np.ndarray                 # (B, n_actors) int tile ids
    hw: HardwareConfig
    stack: EdgeStack
    metrics: Optional[ChipMetrics]
    lo0: Optional[np.ndarray]            # (B,) per-row lower bounds
    n_rows: int
    n_act: int
    rel_tol: float
    with_energy: bool
    chip_state: Optional[ChipState]
    build_time_s: float


def prepare_execution(
    app: SDFG,
    bindings,
    hw: HardwareConfig,
    orders_list: Optional[OrdersLike] = None,
    *,
    rel_tol: float = 1e-8,
    with_energy: bool = False,
    chip_state: Optional[ChipState] = None,
    rate_scale=None,
    relax_shortcuts: bool = True,
) -> PreparedExec:
    """Build one candidate batch's :class:`EdgeStack` and row bounds.

    The build half of :func:`batch_execute` (host numpy), factored out so
    independent batches (different apps, different region components) can
    be fused into a single analysis call (:func:`batch_execute_fused`).
    """
    bindings = _as_binding_matrix(bindings, app.n_actors)
    t0 = time.perf_counter()
    built = stack_hardware_aware(
        app, bindings, hw, orders_list, relax_shortcuts=relax_shortcuts,
        with_metrics=with_energy, chip_state=chip_state,
        rate_scale=rate_scale,
    )
    stack, metrics = built if with_energy else (built, None)
    lo0 = order_cycle_lower_bounds(app.exec_time, bindings, orders_list)
    return PreparedExec(
        app=app,
        bindings=bindings,
        hw=hw,
        stack=stack,
        metrics=metrics,
        lo0=lo0,
        n_rows=stack.n_graphs,
        n_act=stack.n_actors,
        rel_tol=rel_tol,
        with_energy=with_energy,
        chip_state=chip_state,
        build_time_s=time.perf_counter() - t0,
    )


def finish_execution(
    prep: PreparedExec,
    periods: np.ndarray,
    *,
    analysis_time_s: float,
    starts: Optional[np.ndarray] = None,
) -> EngineReport:
    """Turn one prepared batch's solved periods into an :class:`EngineReport`.

    Slices padded rows off, masks dead-tile rows to ``inf`` under the
    prepared :class:`~repro_torch.core.hardware.ChipState`, and computes chip
    energies from the metrics that rode the stack build.
    """
    periods = periods[:prep.n_rows]
    chip_state = prep.chip_state
    if chip_state is not None and chip_state.dead.any():
        periods = np.where(
            chip_state.dead_rows(prep.bindings), np.inf, periods
        )
    energies = None
    if prep.with_energy:
        m = prep.metrics
        energies = prep.hw.chip_energy(
            periods,
            m.cut_traffic,
            m.spike_hops,
            m.tiles_used,
            m.read_charge,
        )
    return EngineReport(
        periods=periods,
        starts=starts,
        build_time_s=prep.build_time_s,
        analysis_time_s=analysis_time_s,
        energies=energies,
        metrics=prep.metrics,
    )


def _resolve_backend(backend: str) -> str:
    """Resolve ``"auto"`` to the exact device backend ``"csr"`` (which is
    also the one backend that shards, so a mesh needs no other rule)."""
    return "csr" if backend == "auto" else backend


def _mesh_solve(backend: str, mesh) -> tuple[str, list]:
    """The resolved backend and the devices its solve shards over: the flat
    device list of the scoring mesh (explicit arg wins, else the ambient
    :func:`repro_torch.launch.sharding.current_mesh`; ``[]`` when no mesh
    is active).  A backend other than ``"csr"`` drops the mesh
    (``mcr_batch`` itself raises for ``devices=`` there)."""
    backend = _resolve_backend(backend)
    if backend != "csr":
        return backend, []
    return backend, mesh_devices(mesh if mesh is not None else current_mesh())


def fuse_stacks(
    stacks: Sequence[EdgeStack],
) -> tuple[EdgeStack, list[slice]]:
    """Concatenate independent EdgeStacks into ONE row-stacked batch.

    Pads every stack to the common (n_actors, n_edges) envelope — padded
    edge slots carry ``-inf`` weight (the (max,+) neutral element) so
    they are invisible to every backend, and extra actors are isolated —
    then stacks rows.  The ``"csr"`` lambda-search is row-local, so its
    fused result restricted to each member's row slice is bit-for-bit
    the result of analyzing that member alone (at equal tolerance);
    ``"edges"`` keeps the reference's pairwise-summed path bound, which
    padding can move by an ulp.  Returns the fused stack and each
    member's row slice.
    """
    assert stacks, "need at least one stack to fuse"
    if len(stacks) == 1:
        return stacks[0], [slice(0, stacks[0].n_graphs)]
    n_max = max(s.n_actors for s in stacks)
    e_max = max(s.n_edges for s in stacks)
    srcs, dsts, toks, ws = [], [], [], []
    slices: list[slice] = []
    row = 0
    for s in stacks:
        b, e = s.n_graphs, s.n_edges
        pad = e_max - e
        if pad:
            srcs.append(np.pad(s.src, ((0, 0), (0, pad))))
            dsts.append(np.pad(s.dst, ((0, 0), (0, pad))))
            toks.append(np.pad(s.tokens, ((0, 0), (0, pad)),
                               constant_values=1))
            ws.append(np.pad(s.weights, ((0, 0), (0, pad)),
                             constant_values=NEG_INF))
        else:
            srcs.append(s.src)
            dsts.append(s.dst)
            toks.append(s.tokens)
            ws.append(s.weights)
        slices.append(slice(row, row + b))
        row += b
    fused = EdgeStack(
        n_actors=n_max,
        src=np.concatenate(srcs),
        dst=np.concatenate(dsts),
        tokens=np.concatenate(toks),
        weights=np.concatenate(ws),
    )
    return fused, slices


def batch_execute_fused(
    preps: Sequence[PreparedExec],
    *,
    backend: str = "auto",
    pad_shapes: Optional[bool] = None,
    mesh=None,
    device=None,
) -> list[EngineReport]:
    """Solve MANY independent prepared batches in ONE analysis call.

    The cross-region fused scoring path: rows from every prepared stack
    (one optimizer generation per region component, elite re-scores,
    pending admissions) are concatenated (:func:`fuse_stacks`) and run
    through a single :func:`~repro_torch.core.maxplus.mcr_batch` on
    ``device``, so its transfers, host syncs and kernel launches are paid
    once per tick instead of once per region.  The fused solve uses the
    TIGHTEST member tolerance (sound for all rows).  Under ``"csr"``
    per-member results are bit-for-bit the standalone results at that
    tolerance (see :func:`fuse_stacks`).  ``with_starts`` is deliberately
    unsupported — scoring paths never need start vectors.  ``backend``,
    ``pad_shapes`` and ``device`` are as in :func:`batch_execute`.

    ``mesh`` (or an ambient :func:`repro_torch.launch.sharding.use_mesh`)
    shards the fused batch axis across the mesh devices — contiguous row
    chunks, one concurrent ``"csr"`` solve per device and stream, merged
    on the host.  Results are bit-identical to the single-device solve at
    the same (tightest-member) tolerance, so device count never changes
    which candidate wins.
    """
    assert preps, "need at least one prepared execution to fuse"
    dev = resolve(device)
    t1 = time.perf_counter()
    backend, devices = _mesh_solve(backend, mesh)
    if pad_shapes is None:
        pad_shapes = backend in ("dense", "csr")
    fused, slices = fuse_stacks([p.stack for p in preps])
    if any(p.lo0 is not None for p in preps):
        lo0 = np.concatenate([
            p.lo0 if p.lo0 is not None
            else np.full(p.n_rows, -np.inf)
            for p in preps
        ])
    else:
        lo0 = None
    rel_tol = min(p.rel_tol for p in preps)
    if pad_shapes:
        fused, lo0 = pad_stack_to_buckets(fused, lo0)
    key = (backend, fused.n_graphs, fused.n_actors, fused.n_edges)
    _CACHE_STATS.record(key)
    for sink in _CACHE_SINKS:
        sink.record(key)
    periods = mcr_batch(
        fused, backend=backend, rel_tol=rel_tol, lo0=lo0, device=dev,
        devices=devices or None,
    )
    analysis_s = (time.perf_counter() - t1) / len(preps)
    return [
        finish_execution(p, periods[s], analysis_time_s=analysis_s)
        for p, s in zip(preps, slices)
    ]


def batch_execute(
    app: SDFG,
    bindings,
    hw: HardwareConfig,
    orders_list: Optional[OrdersLike] = None,
    *,
    backend: str = "auto",
    rel_tol: float = 1e-8,
    with_starts: bool = False,
    with_energy: bool = False,
    power_iters: int = 64,
    pad_shapes: Optional[bool] = None,
    chip_state: Optional[ChipState] = None,
    rate_scale=None,
    mesh=None,
    device=None,
) -> EngineReport:
    """Self-timed steady state of every candidate, in one batched pass.

    ``bindings`` is (B, n_actors) int tile ids (a single (n,) binding is
    promoted to B=1); the result's ``periods`` is (B,) in the time unit of
    ``app.exec_time`` (microseconds here) and ``starts`` — when requested —
    is (B, n_actors) steady-state start offsets in the same unit.
    ``orders_list`` is per-candidate order lists or one
    :class:`OrderBatch` (the array-native fast path).

    Replaces the per-candidate heapq simulation loop: periods come from the
    batched lambda-search over the stacked edge arrays (order-cycle
    shortcuts + per-row order-cycle lower bounds keep the search fast on
    large graphs; both are exact), and start-time vectors (optional — they
    cost a dense (B, n, n) matrix build) from iterating ``x(k) = A (x)
    x(k-1)`` through the batched semiring kernels.  ``rel_tol`` is the
    period's relative tolerance: 1e-8 for exact comparisons, looser (1e-4)
    when only ranking candidates matters.

    ``backend`` is ``"auto"`` (the exact device search ``"csr"``),
    ``"csr"``, ``"edges"`` (host numpy) or ``"dense"``; ``device`` is where
    the analysis runs (``None``: CUDA, raising when there is none).
    ``mesh`` (or an ambient :func:`repro_torch.launch.sharding.use_mesh`)
    shards the candidate batch axis across the mesh devices exactly as in
    :func:`batch_execute_fused` — bit-identical, merged on the host.

    ``pad_shapes`` rounds the stacked (B, n_actors, n_edges) shape up to
    pow2-ish buckets (:func:`pad_stack_to_buckets`) so repeated calls see
    few distinct shapes; ``None`` (the default) enables it exactly when the
    resolved backend runs on the device (``"csr"``/``"dense"``).  Padding
    is result-neutral.  Every call is recorded in
    :func:`compile_cache_stats` either way.

    ``with_energy=True`` additionally returns per-candidate chip energy
    (``energies``, pJ per iteration) and the raw :class:`ChipMetrics`:
    the accumulators ride the stack build's own hop pass, so the energy
    objective adds no second traversal and no per-candidate Python.

    ``chip_state``/``rate_scale`` apply run-time degradation (see
    :func:`stack_hardware_aware`): throttled routes and drifted spike
    rates rescale the stacked delays, and any candidate row binding a
    dead tile reports an ``inf`` period (hence zero throughput and ``inf``
    energy) — degraded candidates rank in the same batched pass as
    healthy ones.
    """
    # shortcut edges preserve every cycle ratio but are NOT Eq.-4
    # dependencies, so the starts path must build the plain stack
    prep = prepare_execution(
        app, bindings, hw, orders_list, rel_tol=rel_tol,
        with_energy=with_energy, chip_state=chip_state,
        rate_scale=rate_scale, relax_shortcuts=not with_starts,
    )

    dev = resolve(device)
    t1 = time.perf_counter()
    backend, devices = _mesh_solve(backend, mesh)
    if pad_shapes is None:
        pad_shapes = backend in ("dense", "csr")
    stack, lo0 = prep.stack, prep.lo0
    if pad_shapes:
        stack, lo0 = pad_stack_to_buckets(stack, lo0)
    key = (backend, stack.n_graphs, stack.n_actors, stack.n_edges)
    _CACHE_STATS.record(key)
    for sink in _CACHE_SINKS:
        sink.record(key)
    periods = mcr_batch(
        stack, backend=backend, rel_tol=rel_tol, lo0=lo0, device=dev,
        devices=devices or None,
    )
    starts = None
    if with_starts:
        t_mat = maxplus_matrix_batch(stack, device=dev)
        x, _ = evolve_batch(t_mat, iters=power_iters, device=dev)
        finite = np.isfinite(x)
        lo = np.where(finite, x, np.inf).min(axis=1, keepdims=True)
        starts = np.where(finite, x - lo, np.inf)[:prep.n_rows, :prep.n_act]
    return finish_execution(
        prep, periods,
        analysis_time_s=time.perf_counter() - t1,
        starts=starts,
    )


def batch_throughputs(
    app: SDFG,
    bindings,
    hw: HardwareConfig,
    orders_list: Optional[OrdersLike] = None,
    *,
    backend: str = "auto",
    rel_tol: float = 1e-8,
    device=None,
) -> np.ndarray:
    """Throughput (1/period) per candidate; zero for dead/acyclic rows."""
    return batch_execute(
        app, bindings, hw, orders_list, backend=backend, rel_tol=rel_tol,
        device=device,
    ).throughputs


# ======================================================================
# per-component cycle ratios: each app's TRUE steady-state rate
# ======================================================================
def weak_components(n_actors: int, src, dst) -> np.ndarray:
    """Weakly connected component labels of an edge list.

    In a hardware-aware event graph every edge lies on a cycle (data
    channels pair with buffer back-edges, order edges form tile cycles,
    self-edges are 1-cycles), so weak components ARE the strongly
    connected components — and the graph's maximum cycle ratio is the max
    over its components.  Union-find with path halving; returns (n_actors,)
    int64 labels compacted to ``0..n_components-1`` (isolated actors get
    their own label).
    """
    parent = np.arange(n_actors, dtype=np.int64)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = int(parent[x])
        return x

    for a, b in zip(
        np.asarray(src, dtype=np.int64).tolist(),
        np.asarray(dst, dtype=np.int64).tolist(),
    ):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra
    roots = np.fromiter(
        (find(i) for i in range(n_actors)), dtype=np.int64, count=n_actors
    )
    return np.unique(roots, return_inverse=True)[1]


def union_component_periods(
    app: SDFG,
    binding,
    hw: HardwareConfig,
    orders_list: Optional[OrdersLike] = None,
    *,
    backend: str = "auto",
    rel_tol: float = 1e-8,
    with_metrics: bool = False,
    chip_state: Optional[ChipState] = None,
    rate_scale=None,
    device=None,
):
    """Per-component steady-state periods of ONE bound configuration.

    The union period reported by :func:`batch_execute` is the max cycle
    ratio over the whole chip — conservative for any resident app that
    does not sit on the chip's critical cycle.  This splits the bound
    graph into its (weak = strong, see :func:`weak_components`) components
    and computes every component's exact cycle ratio with ONE masked
    :func:`~repro_torch.core.maxplus.mcr_batch` call of batch size
    ``n_components`` on ``device``: row k keeps only component k's edge
    weights, every other edge is ``-inf`` (the (max,+) neutral element),
    so row k's MCR is exactly component k's.

    Returns ``(labels, periods)``: ``labels`` is (n_actors,) component ids,
    ``periods`` (n_components,) each component's period.  An app's true
    steady-state rate is ``1 / max(periods of components it touches)``.
    With ``with_metrics=True`` returns ``(labels, periods, metrics)`` where
    ``metrics`` is the :class:`ChipMetrics` of the same (single-row) build,
    so callers caching per-component records pay for one stack build only.

    ``chip_state``/``rate_scale`` score the configuration under run-time
    degradation (see :func:`stack_hardware_aware`); a component whose
    actors bind any dead tile reports an ``inf`` period.
    """
    binding = _as_binding_matrix(binding, app.n_actors)
    assert binding.shape[0] == 1, "one configuration at a time"
    dev = resolve(device)
    metrics = None
    if with_metrics:
        stack, metrics = stack_hardware_aware(
            app, binding, hw, orders_list, relax_shortcuts=True,
            with_metrics=True, chip_state=chip_state, rate_scale=rate_scale,
        )
    else:
        stack = stack_hardware_aware(
            app, binding, hw, orders_list, relax_shortcuts=True,
            chip_state=chip_state, rate_scale=rate_scale,
        )
    src, dst = stack.src[0], stack.dst[0]
    tokens, w = stack.tokens[0], stack.weights[0]
    live = np.isfinite(w)
    labels = weak_components(app.n_actors, src[live], dst[live])
    n_comp = int(labels.max(initial=-1)) + 1
    backend = _resolve_backend(backend)
    # row k masks every edge outside component k; shortcut edges never
    # cross components (they compose real order-cycle paths)
    mask = labels[src][None, :] == np.arange(max(n_comp, 1))[:, None]
    comp_stack = EdgeStack(
        n_actors=app.n_actors,
        src=np.repeat(src[None, :], max(n_comp, 1), axis=0),
        dst=np.repeat(dst[None, :], max(n_comp, 1), axis=0),
        tokens=np.repeat(tokens[None, :], max(n_comp, 1), axis=0),
        weights=np.where(mask, w[None, :], NEG_INF),
    )
    periods = mcr_batch(comp_stack, backend=backend, rel_tol=rel_tol, device=dev)
    if chip_state is not None and chip_state.dead.any():
        dead_actors = chip_state.dead[binding[0]]
        if dead_actors.any():
            periods = periods.copy()
            periods[np.unique(labels[dead_actors])] = np.inf
    if with_metrics:
        return labels, periods, metrics
    return labels, periods
