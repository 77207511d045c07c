"""Static-order scheduling + self-timed execution (paper §4.4 steps 2-3).

Two engines, cross-validated in tests:

  * :func:`analyze_throughput` — analytical: augment the hardware-aware SDFG
    with the per-tile TDMA order cycles and take 1/MCR (Max-Plus, Eq. 6).
  * :class:`SelfTimedExecutor` — operational: a discrete-event simulator with
    the exact §4.4 semantics (atomic crossbar execution, output-buffer claim
    at firing start, AER link delays, per-tile firing order).  Static-order
    construction (§4.4 step 2) records the firing order of one steady-state
    iteration of this executor in FCFS mode; run-time execution (§5) replays
    orders self-timed.

For strongly-connected live event graphs the executor's steady-state period
equals the MCR — a property test asserts this.

Batched evaluation of many candidate configurations does NOT loop this
executor: once static orders exist, the order-augmented event graph fully
determines self-timed execution, and :mod:`repro_torch.core.engine` analyzes a
whole candidate batch in one array pass (``x(k) = A (x) x(k-1)``).
Static-order *construction* is batched too:
:func:`build_static_orders_batch` builds the FCFS orders of B candidate
bindings in one dense tile-synchronous pass and matches the heapq
executor's first-firing record exactly.  The heapq executor remains the
§4.4 step-2 oracle and the operational cross-validation oracle
(:meth:`ExecutionTrace.steady_period` matches the engine to ~1e-9).
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Optional, Sequence

import numpy as np

from .hardware import HardwareConfig
from .maxplus import mcr_howard
from .sdfg import SDFG, flow_delays, hardware_aware_sdfg, hardware_static_parts


# ======================================================================
# analytical path
# ======================================================================
def analyze_throughput(
    app: SDFG,
    binding: np.ndarray,
    hw: HardwareConfig,
    static_orders: Optional[Sequence[Sequence[int]]] = None,
) -> float:
    """Throughput (1/MCM) of the hardware-aware SDFG (§4.4)."""
    g = hardware_aware_sdfg(app, binding, hw, static_orders)
    rho = mcr_howard(g)
    if rho <= 0 or not np.isfinite(rho):
        return 0.0
    return 1.0 / rho


# ======================================================================
# operational path: self-timed discrete-event execution
# ======================================================================
@dataclasses.dataclass
class ExecutionTrace:
    finish_times: np.ndarray      # (iters, n_actors) firing end times
    tile_orders: list[list[int]]  # realized firing order per tile (1st period)
    period: float                 # steady-state average iteration period
    makespan: float

    @property
    def throughput(self) -> float:
        return 0.0 if self.period <= 0 else 1.0 / self.period

    def steady_period(self, *, atol: float = 1e-9) -> float:
        """Asymptotic per-iteration period, free of the fill transient.

        A live event graph reaches a periodic regime after finitely many
        iterations: ``finish(k + c) = finish(k) + c * period`` for some
        cyclicity ``c``.  Detect the smallest ``c`` whose last two windows
        agree exactly and return the exact per-iteration growth — this is
        what the batched engine's MCR must match to float precision.  Falls
        back to the tail slope when the recorded window is too short for a
        clean periodic match, and to ``period`` (0.0) on deadlock.
        """
        f = self.finish_times
        if self.period <= 0 or f.size == 0 or np.isnan(f).any():
            return self.period
        n_iters = f.shape[0]
        if n_iters < 3:  # no two disjoint windows to compare
            return self.period
        scale = max(1.0, float(np.abs(f[-1]).max()))
        # all candidate cyclicities at once: window deltas a(c) and b(c) are
        # (C, n_actors) slices of the recorded finish times; the smallest c
        # whose two windows agree wins (one vectorized comparison, no
        # per-cycle-length Python loop)
        cs = np.arange(1, (n_iters - 1) // 2 + 1)
        a = f[n_iters - 1][None, :] - f[n_iters - 1 - cs]
        b = f[n_iters - 1 - cs] - f[n_iters - 1 - 2 * cs]
        ok = np.flatnonzero(np.all(np.abs(a - b) <= atol * scale, axis=1))
        if ok.size:
            # per-actor rates agree across windows; the slowest actor's
            # rate is the iteration period of the whole graph
            return float(a[ok[0]].max() / cs[ok[0]])
        k0 = n_iters // 2
        return float((f[n_iters - 1] - f[k0]).max() / (n_iters - 1 - k0))


class SelfTimedExecutor:
    """Discrete-event self-timed execution of a bound SDFG on tiles.

    Modes:
      * ``orders=None``  — FCFS list scheduling (used at design time to
        *construct* static orders, and as the SpiNeMap/PyCARL random-order
        stand-in when given a seeded permutation).
      * ``orders=[...]`` — strict static-order (TDMA) replay per tile.

    Readiness is tracked incrementally: ``deficit[a]`` counts input channels
    of ``a`` with zero tokens, so every event costs O(degree), not O(graph).
    """

    def __init__(
        self,
        app: SDFG,
        binding: np.ndarray,
        hw: HardwareConfig,
        *,
        orders: Optional[Sequence[Sequence[int]]] = None,
        priorities: Optional[np.ndarray] = None,
    ):
        self.app = app
        self.binding = np.asarray(binding, dtype=np.int64)
        self.hw = hw
        # hardware-aware graph WITHOUT order edges: ordering is enforced
        # operationally by the executor itself.
        self.graph = hardware_aware_sdfg(app, binding, hw, None)
        self.orders = [list(o) for o in orders] if orders is not None else None
        # random-order baselines (SpiNeMap/PyCARL §6.3): an ARBITRARY fixed
        # priority decides which ready cluster fires when a tile frees —
        # never deadlocks (only ready actors fire), unlike a strict random
        # TDMA cycle, but pays the throughput cost the paper measures.
        self.priorities = priorities

    # ------------------------------------------------------------------
    def run(self, iterations: int = 30, warmup: int = 5) -> ExecutionTrace:
        g = self.graph
        n = g.n_actors
        binding = self.binding
        n_tiles = self.hw.n_tiles

        table = g.table
        edge_dst = table.dst
        tokens = table.tokens.copy()
        delay = table.delay
        d_order, d_starts, d_ends = table.csr_by("dst", n)
        s_order, s_starts, s_ends = table.csr_by("src", n)
        in_edges = [
            d_order[d_starts[a] : d_ends[a]].tolist() for a in range(n)
        ]
        out_edges = [
            s_order[s_starts[a] : s_ends[a]].tolist() for a in range(n)
        ]
        tau = g.exec_time

        deficit = np.zeros(n, dtype=np.int64)
        for a in range(n):
            deficit[a] = sum(1 for e in in_edges[a] if tokens[e] == 0)

        tile_actors = [
            [int(a) for a in np.flatnonzero(binding == t)] for t in range(n_tiles)
        ]

        fired = np.zeros(n, dtype=np.int64)
        finish_times = np.full((iterations, n), np.nan)
        tile_busy = np.zeros(n_tiles, dtype=bool)
        order_pos = [0] * n_tiles
        tile_orders: list[list[int]] = [[] for _ in range(n_tiles)]
        ready_since = np.full(n, np.inf)  # FCFS tie-break stamps

        def is_ready(a: int) -> bool:
            return fired[a] < iterations and deficit[a] == 0

        for a in range(n):
            if deficit[a] == 0:
                ready_since[a] = 0.0

        # event heap: (time, seq, kind, payload); kind 0=token-arrival, 1=finish
        events: list[tuple[float, int, int, int]] = []
        seq = 0

        def produce(e: int, t: float) -> None:
            nonlocal seq
            tokens[e] += 1
            if tokens[e] == 1:
                d = int(edge_dst[e])
                deficit[d] -= 1
                if deficit[d] == 0 and not np.isfinite(ready_since[d]):
                    ready_since[d] = t

        def try_start(t: float) -> None:
            nonlocal seq
            progress = True
            while progress:
                progress = False
                for tile in range(n_tiles):
                    if tile_busy[tile]:
                        continue
                    a = self._pick(
                        tile, is_ready, ready_since, order_pos, tile_actors
                    )
                    if a is None:
                        continue
                    for e in in_edges[a]:
                        tokens[e] -= 1
                        if tokens[e] == 0:
                            d = int(edge_dst[e])
                            deficit[d] += 1
                            ready_since[d] = np.inf
                    # consuming may have unreadied a itself (self-edge)
                    if deficit[a] > 0:
                        ready_since[a] = np.inf
                    tile_busy[tile] = True
                    heapq.heappush(events, (t + tau[a], seq, 1, a))
                    seq += 1
                    if self.orders is not None and self.orders[tile]:
                        order_pos[tile] = (order_pos[tile] + 1) % len(
                            self.orders[tile]
                        )
                    progress = True

        try_start(0.0)
        makespan = 0.0
        while events:
            now, _, kind, payload = heapq.heappop(events)
            if kind == 1:  # actor finished
                a = payload
                tile = int(binding[a])
                k = int(fired[a])
                if k < iterations:
                    finish_times[k, a] = now
                fired[a] += 1
                if fired[a] == 1:
                    tile_orders[tile].append(a)
                tile_busy[tile] = False
                makespan = max(makespan, now)
                for e in out_edges[a]:
                    if delay[e] <= 0:
                        produce(e, now)
                    else:
                        heapq.heappush(events, (now + delay[e], seq, 0, e))
                        seq += 1
            else:  # token arrival after NoC delay
                produce(payload, now)
            try_start(now)

        done = int(fired.min())
        if done < iterations:
            # deadlock or starvation: report zero throughput
            return ExecutionTrace(finish_times, tile_orders, 0.0, makespan)

        # Steady-state period = total time / iterations.  (A tail-window
        # estimator over per-iteration completion times is poisoned when
        # deep buffers let fast actors run thousands of iterations ahead:
        # the "last iterations" then complete back-to-back as the straggler
        # drains, reporting its single-firing time as the period.)  Fill/
        # drain bias vanishes as iterations grow; callers use >= 30.
        period = float(makespan / iterations)
        return ExecutionTrace(finish_times, tile_orders, period, makespan)

    # ------------------------------------------------------------------
    def _pick(self, tile, is_ready, ready_since, order_pos, tile_actors):
        if self.orders is not None:
            order = self.orders[tile]
            if not order:
                return None
            a = order[order_pos[tile]]
            return a if is_ready(a) else None
        best, best_key = None, None
        for a in tile_actors[tile]:
            if is_ready(a) and np.isfinite(ready_since[a]):
                if self.priorities is not None:
                    key = (self.priorities[a], a)
                else:
                    key = (ready_since[a], a)
                if best_key is None or key < best_key:
                    best, best_key = a, key
        return best


# ======================================================================
# schedule construction (§4.4 step 2) and random-order baselines
# ======================================================================
def build_static_orders(
    app: SDFG,
    binding: np.ndarray,
    hw: HardwareConfig,
    *,
    iterations: int = 12,
) -> tuple[list[list[int]], float]:
    """Construct per-tile static orders by FCFS self-timed execution.

    Returns (orders, construction_time_s).  The recorded order of the first
    steady period is the static-order schedule the paper builds with its
    Max-Plus formulation at design time (§4.4 step 2).
    """
    t0 = time.perf_counter()
    trace = SelfTimedExecutor(app, binding, hw).run(iterations=iterations)
    return trace.tile_orders, time.perf_counter() - t0


def build_static_orders_batch(
    app: SDFG,
    bindings,
    hw: HardwareConfig,
) -> list[list[list[int]]]:
    """FCFS static orders of B candidate bindings in ONE dense array pass.

    ``bindings`` is (B, n_actors) int tile ids (a single (n,) binding is
    promoted to B=1); returns ``orders[b][tile]`` = tile's firing order
    (actor ids) for candidate ``b`` — the same §4.4 step-2 product as
    :func:`build_static_orders`, constructed without a per-candidate Python
    event loop.

    The §4.4 step-2 schedule records each actor's FIRST firing, so the
    construction simulates exactly one firing per actor.  In that regime an
    actor, once ready, stays ready until it fires (every channel has a
    single consumer), so each tile's FCFS order is its actors sorted by
    first-ready time — and readiness is a pure array recursion over the
    zero-token ("gating") edges: ``ready[a] = max over gating in-edges of
    (finish[src] + delay)``.  The simulator advances all B candidates in
    tile-synchronous rounds; a tile's FCFS head with ready time ``r`` is
    committed in the current round only when ``r < s_min + min unfired
    tau`` (``s_min`` = the row's earliest possible next firing), which
    guarantees no later token arrival could produce an earlier-ready
    competitor — the committed prefix always equals the discrete-event
    order.  Matches ``SelfTimedExecutor.run(iterations=1).tile_orders``
    exactly (cross-validated in ``tests/test_frontend.py``); times are in
    the unit of ``app.exec_time`` (microseconds here).
    """
    bindings = np.asarray(bindings, dtype=np.int64)
    if bindings.ndim == 1:
        bindings = bindings[None, :]
    n_b, n = bindings.shape
    assert n == app.n_actors, (bindings.shape, app.n_actors)
    n_tiles = hw.n_tiles
    tau = app.exec_time
    rows = np.arange(n_b)

    # §4.4 edge set WITHOUT order edges (ordering is what we construct),
    # with per-row NoC delays — the same graph the FCFS executor runs on.
    keep_self, flow, back = hardware_static_parts(app, hw)
    base_src = np.concatenate([keep_self.src, flow.src, back.src])
    base_dst = np.concatenate([keep_self.dst, flow.dst, back.dst])
    base_tok = np.concatenate([keep_self.tokens, flow.tokens, back.tokens])
    gating = base_tok == 0          # only empty channels gate a first firing
    g_src = base_src[gating]
    g_dst = base_dst[gating]
    n_gate = g_src.size
    base_delay = np.concatenate([keep_self.delay, np.zeros(len(flow)), back.delay])
    g_delay = np.broadcast_to(base_delay[gating], (n_b, n_gate)).copy()
    if len(flow):
        # flow edges keep NO app delay; gating flow columns get the per-row
        # NoC delays (exactly as in hardware_aware_sdfg / the executor)
        flow_lo = keep_self.src.size
        is_flow_gate = np.zeros(base_src.size, dtype=bool)
        is_flow_gate[flow_lo : flow_lo + len(flow)] = True
        is_flow_gate &= gating
        gate_pos = np.cumsum(gating) - 1          # column among gating edges
        cols = gate_pos[is_flow_gate]
        flow_sel = is_flow_gate[flow_lo : flow_lo + len(flow)]
        g_delay[:, cols] = flow_delays(flow, bindings, hw)[:, flow_sel]

    # gating out-edge CSR by src (token-arrival fan-out of one firing)
    out_order = np.argsort(g_src, kind="stable")
    src_sorted = g_src[out_order]
    out_starts = np.searchsorted(src_sorted, np.arange(n), side="left")
    out_counts = np.searchsorted(src_sorted, np.arange(n), side="right") - out_starts

    # per-(row, tile) segments over actors sorted by (tile, actor id)
    order2d = np.argsort(bindings, axis=1, kind="stable")
    sorted_binding = np.take_along_axis(bindings, order2d, axis=1)
    flat_group = (rows[:, None] * n_tiles + sorted_binding).ravel()
    seg_keys, seg_pos = np.unique(flat_group, return_index=True)

    gin = np.bincount(g_dst, minlength=n)
    defc = np.broadcast_to(gin, (n_b, n)).copy().ravel()
    rmax = np.zeros(n_b * n)
    ready = np.where(defc == 0, 0.0, np.inf).reshape(n_b, n)
    unfired = np.ones((n_b, n), dtype=bool)
    tile_clock = np.zeros((n_b, n_tiles))
    start = np.full((n_b, n), np.inf)
    actor_ids = np.broadcast_to(np.arange(n), (n_b, n))

    for _ in range(n + 1):
        if not unfired.any():
            break
        eligible = unfired & np.isfinite(ready)
        keyr = np.where(eligible, ready, np.inf)
        vals = np.take_along_axis(keyr, order2d, axis=1).ravel()
        m1 = np.full(n_b * n_tiles, np.inf)
        m1[seg_keys] = np.minimum.reduceat(vals, seg_pos)
        m1 = m1.reshape(n_b, n_tiles)
        valid_t = np.isfinite(m1)
        if not valid_t.any():
            break  # deadlock (never for live graphs); report partial orders
        # FCFS head per tile: the smallest actor id at the minimal ready time
        head_ok = eligible & (ready == m1[rows[:, None], bindings])
        cand_vals = np.where(
            np.take_along_axis(head_ok, order2d, axis=1).ravel(),
            np.take_along_axis(actor_ids, order2d, axis=1).ravel(),
            n,
        )
        cand = np.full(n_b * n_tiles, n, dtype=np.int64)
        cand[seg_keys] = np.minimum.reduceat(cand_vals, seg_pos)
        cand = cand.reshape(n_b, n_tiles)

        s = np.maximum(tile_clock, m1)
        s_min = np.where(valid_t, s, np.inf).min(axis=1)
        tau_min = np.where(unfired, tau[None, :], np.inf).min(axis=1)
        commit = valid_t & (m1 < (s_min + tau_min)[:, None])
        # progress guarantee (tau == 0 corner): always commit the row's
        # globally-earliest firing, which is safe by the wavefront argument
        t_star = np.where(valid_t, s, np.inf).argmin(axis=1)
        any_valid = valid_t.any(axis=1)
        commit[rows[any_valid], t_star[any_valid]] = True

        bidx, tidx = np.nonzero(commit)
        actors = cand[bidx, tidx]
        s_c = s[bidx, tidx]
        fin = s_c + tau[actors]
        start[bidx, actors] = s_c
        unfired[bidx, actors] = False
        tile_clock[bidx, tidx] = fin

        # token arrivals: one vectorized scatter over the commits' gating
        # out-edges updates deficits and running ready maxima
        lens = out_counts[actors]
        tot = int(lens.sum())
        if tot:
            seg_off = np.concatenate([[0], np.cumsum(lens)[:-1]])
            e_flat = (
                np.repeat(out_starts[actors] - seg_off, lens) + np.arange(tot)
            )
            e_idx = out_order[e_flat]
            rep_b = np.repeat(bidx, lens)
            avail = np.repeat(fin, lens) + g_delay[rep_b, e_idx]
            keys = rep_b * n + g_dst[e_idx]
            np.maximum.at(rmax, keys, avail)
            np.add.at(defc, keys, -1)
            touched = np.unique(keys)
            ready.ravel()[touched] = np.where(
                defc[touched] == 0, rmax[touched], np.inf
            )

    # per-tile orders = actors sorted by start time (strictly increasing
    # within a tile: each firing advances the tile clock by tau > 0)
    orders: list[list[list[int]]] = []
    for b in range(n_b):
        fire_seq = np.argsort(start[b], kind="stable")
        per_tile: list[list[int]] = [[] for _ in range(n_tiles)]
        row_binding = bindings[b]
        for a in fire_seq:
            if np.isfinite(start[b, a]):
                per_tile[row_binding[a]].append(int(a))
        orders.append(per_tile)
    return orders


def measured_throughput(
    app: SDFG,
    binding: np.ndarray,
    hw: HardwareConfig,
    orders: Optional[Sequence[Sequence[int]]],
    *,
    iterations: int = 30,
) -> float:
    """Operational throughput from self-timed execution."""
    return SelfTimedExecutor(app, binding, hw, orders=orders).run(
        iterations=iterations
    ).throughput
