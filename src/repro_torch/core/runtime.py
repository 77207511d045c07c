"""Run-time resource management (paper §5): multi-app admission control.

Design time:  build ONE single-tile static-order schedule (all actors bound
to tile 0, FCFS self-timed execution records the total order); discard exact
timings, keep the order.

Run time:  when an application is admitted, (1) bind clusters to the tiles
currently available (§4.2 load balancing restricted to free tiles), then
(2) *project* the single-tile order onto each tile — Lemma 1 guarantees the
resulting multi-tile schedule is deadlock-free — and execute self-timed.
No per-tile schedule is constructed from scratch, which is where ~75% of
compilation time goes (§7.3), so admission is fast (Table 3).

The :class:`AdmissionController` makes this multi-tenant: persistent
tile-occupancy state across applications, an ``admit`` / ``finish`` /
``evict`` lifecycle with an event trajectory, a design-time artifact cache
keyed on ``(app, hardware)`` so re-admission skips clustering and order
construction entirely, and batched scoring of candidate free-tile bindings
through the array-native engine (:mod:`repro_torch.core.engine`).  The
module-level :func:`runtime_admit` remains the single-admission primitive
the controller drives.

This slice of the port implements ``placement="isolated"``: every app is
admitted on its own free tiles and never revisited.  Joint and
region-scoped placement, the fault/drift runtime (``inject_fault``,
``inject_drift``, ``heal``, ``remap``) and deferred rebalancing are later
slices (see ``ROADMAP.md``); their entry points raise
``NotImplementedError``.  Batched scoring runs on the controller's
``device`` with its analysis ``backend``; the final admitted throughput
is Howard's exact MCR on the host, as in the reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np

from .binding import BindingResult, LoadWeights, bind_ours
from ..device import resolve
from .engine import CompileCacheStats, batch_execute, record_cache_stats
from .hardware import ChipState, HardwareConfig
from .partition import ClusteredSNN, partition_greedy
from .schedule import (
    analyze_throughput,
    build_static_orders,
    build_static_orders_batch,
)
from .sdfg import SDFG, sdfg_from_clusters
from .snn import SNN


@dataclasses.dataclass
class CompileReport:
    """One compiled application: binding + schedules + predicted throughput.

    ``binding`` is (n_clusters,) int tile ids; ``orders[t]`` is tile t's
    static firing order (cluster ids); ``throughput`` is iterations per
    microsecond of model time (1 / steady-state period); the ``*_time_s``
    fields are wall-clock seconds of the compilation steps.
    """

    app: str
    binding: np.ndarray          # (n_clusters,) int64 tile ids
    orders: list[list[int]]      # per-tile static orders (cluster ids)
    throughput: float            # iterations / microsecond of model time
    bind_time_s: float
    schedule_time_s: float

    @property
    def compile_time_s(self) -> float:
        """Total wall-clock compile seconds (binding + scheduling)."""
        return self.bind_time_s + self.schedule_time_s


# ======================================================================
# design-time flow (§4): bind -> per-tile static orders -> analysis
# ======================================================================
def design_time_compile(
    clustered: ClusteredSNN,
    hw: HardwareConfig,
    *,
    binder=bind_ours,
    weights: LoadWeights = LoadWeights(),
    sim_iterations: int = 12,
    order_method: str = "batch",
) -> CompileReport:
    """Full §4 design-time flow: bind, build per-tile static orders, and
    analyze throughput.

    ``binder`` is any :data:`~repro_torch.core.explore.BINDERS`-style strategy
    (``(clustered, hw, **kw) -> BindingResult``).  ``order_method``
    selects the §4.4 step-2 constructor: ``"batch"`` (default, the dense
    FCFS simulator :func:`~repro_torch.core.schedule.build_static_orders_batch`)
    or ``"heapq"`` (the discrete-event oracle; ``sim_iterations`` is its
    FCFS self-timed horizon and is IGNORED under ``"batch"``).  Returns a
    :class:`CompileReport` (binding (n_clusters,), per-tile orders,
    throughput in iterations per microsecond).
    """
    app = sdfg_from_clusters(clustered, hw=hw)
    try:
        bres: BindingResult = binder(clustered, hw, weights=weights)
    except TypeError:  # binders with no `weights` kw (spinemap)
        bres = binder(clustered, hw)
    if order_method == "batch":
        t0 = time.perf_counter()
        orders = build_static_orders_batch(app, bres.binding, hw)[0]
        t_sched = time.perf_counter() - t0
    elif order_method == "heapq":
        orders, t_sched = build_static_orders(
            app, bres.binding, hw, iterations=sim_iterations
        )
    else:
        raise ValueError(f"unknown order_method {order_method!r}")
    thr = analyze_throughput(app, bres.binding, hw, orders)
    return CompileReport(
        app=clustered.snn.name,
        binding=bres.binding,
        orders=orders,
        throughput=thr,
        bind_time_s=bres.bind_time_s,
        schedule_time_s=t_sched,
    )


# ======================================================================
# single-tile schedule (design time, once per application)
# ======================================================================
def single_tile_order(
    clustered: ClusteredSNN,
    hw: HardwareConfig,
    *,
    sim_iterations: int = 8,
    method: str = "batch",
) -> tuple[list[int], float]:
    """Total actor order from a 1-tile execution of the application.

    Returns ``(order, wall_s)``: the (n_clusters,) design-time firing
    order and its construction wall-clock seconds.  ``method="batch"``
    (default) uses the dense FCFS simulator
    (:func:`~repro_torch.core.schedule.build_static_orders_batch`, ~100x faster
    on the large Table-1 apps); ``"heapq"`` replays the discrete-event
    oracle with ``sim_iterations`` FCFS iterations.  ``sim_iterations``
    applies to the heapq path only (the dense constructor simulates the
    one firing per actor that defines the order); longer heapq horizons
    can record a different — equally valid — schedule when repeat firings
    contend for tiles.
    """
    t0 = time.perf_counter()
    one_tile = dataclasses.replace(hw, n_tiles=1)
    app = sdfg_from_clusters(clustered, hw=one_tile)
    binding = np.zeros(clustered.n_clusters, dtype=np.int64)
    if method == "batch":
        orders = build_static_orders_batch(app, binding, one_tile)[0]
    elif method == "heapq":
        orders, _ = build_static_orders(app, binding, one_tile,
                                        iterations=sim_iterations)
    else:
        raise ValueError(f"unknown single-tile order method {method!r}")
    return orders[0], time.perf_counter() - t0


def project_order(
    order: list[int], binding: np.ndarray, n_tiles: int
) -> list[list[int]]:
    """Lemma 1: per-tile orders = the single-tile order filtered per tile.

    Keeping the relative firing order unchanged preserves deadlock freedom
    (Blazewicz 1976 via [12]); Fig. 12 illustrates exactly this projection.
    """
    binding = np.asarray(binding)
    per_tile = [[a for a in order if binding[a] == t] for t in range(n_tiles)]
    # any actor missing from the order (defensive) is appended at the end
    seen = {a for o in per_tile for a in o}
    for a in range(len(binding)):
        if a not in seen:
            per_tile[int(binding[a])].append(a)
    return per_tile


# ======================================================================
# run-time admission (§5, Fig. 11)
# ======================================================================
class AdmissionError(RuntimeError):
    """Raised when an application cannot be admitted on the free tiles."""


@dataclasses.dataclass
class HardwareState:
    """Tracks which tiles are currently allocated to running applications.

    ``chip`` optionally points at the chip's mutable degradation state
    (:class:`~repro_torch.core.hardware.ChipState`): when set, dead tiles are
    never reported free, so every admission and re-placement path that
    draws from :meth:`free_tiles` is dead-tile-safe without further
    checks.
    """

    hw: HardwareConfig
    allocated: dict[str, list[int]] = dataclasses.field(default_factory=dict)
    chip: Optional[ChipState] = None

    def free_tiles(self) -> list[int]:
        """Sorted physical tile ids not allocated to any running app
        (excluding dead tiles when a :class:`ChipState` is attached)."""
        mask = np.ones(self.hw.n_tiles, dtype=bool)
        if self.chip is not None:
            mask &= ~self.chip.dead
        for tiles in self.allocated.values():
            if tiles:
                mask[np.asarray(tiles, dtype=np.int64)] = False
        return [int(t) for t in np.flatnonzero(mask)]

    def release(self, app: str) -> None:
        """Free ``app``'s tiles (no-op when the app is not running)."""
        self.allocated.pop(app, None)


def runtime_admit(
    clustered: ClusteredSNN,
    state: HardwareState,
    single_order: list[int],
    *,
    n_tiles_request: Optional[int] = None,
    weights: LoadWeights = LoadWeights(),
    tile_selection: str = "batched",
    optimize_budget: Optional[tuple[int, int]] = None,
    chip_state: Optional[ChipState] = None,
    rate_scale: float = 1.0,
    backend: str = "auto",
    device=None,
) -> CompileReport:
    """Admit an application onto the currently-free tiles (Fig. 11).

    Binding runs on the free-tile subset; per-tile schedules are *projected*
    from the design-time single-tile order (no construction from scratch).
    Returns a :class:`CompileReport` whose ``binding`` is (n_clusters,)
    physical tile ids and whose ``throughput`` is 1/period (per
    microsecond of model time).

    When ``n_tiles_request`` asks for fewer tiles than are free, the
    candidate k-subsets of the free tiles are scored in one batched
    Max-Plus call (``tile_selection="batched"``, via
    :func:`repro_torch.core.explore.score_free_tile_subsets`) and the
    best-throughput subset wins; ``tile_selection="first"`` keeps the old
    first-k-free behaviour.  Requesting more tiles than are free raises
    :class:`AdmissionError` instead of silently binding to fewer.

    ``optimize_budget`` is the admission-time quality/latency knob: a
    ``(generations, population)`` pair that refines the heuristic binding
    with the throughput-in-the-loop optimizer
    (:func:`repro_torch.core.optimize.optimize_binding`) on the chosen tile
    subset before projection.  The heuristic binding is one of the
    optimizer's seeds, so the refined admission is never worse; cost grows
    roughly linearly with ``generations x population``.  ``None`` (the
    default) keeps the plain heuristic path.

    ``chip_state``/``rate_scale`` admit onto a DEGRADED chip: candidate
    subsets and the final report score under the chip's throttled routes
    and this app's drift multiplier (``state.free_tiles()`` already
    excludes dead tiles when ``state.chip`` is attached).  On a pristine
    chip with unit drift the path — and the report — is bit-identical to
    the undegraded one.

    ``backend``/``device`` select where the batched scoring runs (see
    :func:`~repro_torch.core.engine.batch_execute`; ``device=None`` is
    CUDA and raises when there is none).
    """
    dev = resolve(device)
    free = state.free_tiles()
    if not free:
        raise AdmissionError(
            f"admission rejected for {clustered.snn.name!r}: no free tiles "
            f"({state.hw.n_tiles} total, all allocated)"
        )
    if n_tiles_request is not None:
        if n_tiles_request < 1:
            raise ValueError(f"n_tiles_request must be >= 1, got {n_tiles_request}")
        if len(free) < n_tiles_request:
            raise AdmissionError(
                f"admission rejected for {clustered.snn.name!r}: requested "
                f"{n_tiles_request} tiles but only {len(free)} free "
                f"(free tiles: {free})"
            )

    t0 = time.perf_counter()
    scores = None
    if n_tiles_request is not None and n_tiles_request < len(free):
        if tile_selection == "batched":
            from .explore import score_free_tile_subsets

            scores = score_free_tile_subsets(
                clustered, state.hw, free, n_tiles_request, single_order,
                binder_kwargs={"weights": weights},
                chip_state=chip_state, rate_scale=rate_scale,
                backend=backend, device=dev,
            )
            free = list(scores.best)
        elif tile_selection == "first":
            free = free[:n_tiles_request]
        else:
            raise ValueError(f"unknown tile_selection {tile_selection!r}")

    # bind on a virtual hardware with |free| tiles, then relabel to real
    # ids; subset scoring already bound and projected — reuse its result
    if scores is not None:
        virt_binding = scores.binding
    else:
        sub_hw = dataclasses.replace(state.hw, n_tiles=len(free))
        virt_binding = bind_ours(clustered, sub_hw, weights=weights).binding
    refined = False
    if optimize_budget is not None:
        from .optimize import optimize_binding

        gens, pop = optimize_budget
        # optimize over the PHYSICAL free-tile ids (allowed_tiles), so the
        # search sees the subset's real NoC distances; the heuristic
        # binding — relabeled physically — seeds the final exact pool,
        # which makes the refined admission never worse than the plain one
        phys_seed = np.array([free[t] for t in virt_binding], dtype=np.int64)
        phys_opt = optimize_binding(
            clustered, state.hw,
            single_order=single_order,
            generations=gens, population=pop,
            weights=weights, allowed_tiles=free,
            extra_seeds=[phys_seed],
            chip_state=chip_state, rate_scale=rate_scale,
            backend=backend, device=dev,
        ).binding
        to_virt = {p: v for v, p in enumerate(free)}
        virt_binding = np.array(
            [to_virt[int(t)] for t in phys_opt], dtype=np.int64
        )
        refined = True
    t_bind = time.perf_counter() - t0

    t1 = time.perf_counter()
    if scores is not None and not refined:
        sub_orders = scores.virt_orders
    else:
        sub_orders = project_order(single_order, virt_binding, len(free))

    # relabel virtual tiles -> physical free tiles
    phys_binding = np.array([free[t] for t in virt_binding], dtype=np.int64)
    phys_orders: list[list[int]] = [[] for _ in range(state.hw.n_tiles)]
    for virt, phys in enumerate(free):
        phys_orders[phys] = sub_orders[virt]
    t_sched = time.perf_counter() - t1

    app = sdfg_from_clusters(clustered, hw=state.hw)
    if chip_state is not None and (not chip_state.pristine or rate_scale != 1.0):
        # degraded chip: the howard-solver path is chip-state-unaware, so
        # score the admitted configuration through the batched engine
        rep = batch_execute(
            app, phys_binding, state.hw, [phys_orders],
            chip_state=chip_state, rate_scale=rate_scale,
            backend=backend, device=dev,
        )
        thr = float(rep.throughputs[0])
    else:
        thr = analyze_throughput(app, phys_binding, state.hw, phys_orders)
    state.allocated[clustered.snn.name] = list(free)
    return CompileReport(
        app=clustered.snn.name,
        binding=phys_binding,
        orders=phys_orders,
        throughput=thr,
        bind_time_s=t_bind,
        schedule_time_s=t_sched,
    )


# ======================================================================
# multi-app admission controller (§5 made multi-tenant)
# ======================================================================
@dataclasses.dataclass
class DesignArtifact:
    """Cached design-time products of one (application, hardware) pair.

    Everything admission needs that does NOT depend on which tiles happen
    to be free: the clustering (Alg. 1), the single-tile static order
    (§5), and the application SDFG (``graph`` — reused by the chip-metric
    and joint-placement union builds, so per-event tracking never
    re-derives it from the clusters).  ``hits`` counts cache reuses — a
    re-admitted app pays neither clustering nor order construction again.
    """

    app: str
    clustered: ClusteredSNN
    single_order: list[int]
    design_time_s: float
    hits: int = 0
    graph: Optional[SDFG] = None


@dataclasses.dataclass
class AdmissionEvent:
    """One step of the controller's lifecycle trajectory.

    ``chip_throughput``/``chip_energy`` record the chip-level state after
    the event — 1/period of the union graph of all resident apps
    (iterations per microsecond; every resident app sustains at least this
    rate) and its energy per iteration (pJ) — when the controller tracks
    chip metrics (always under ``placement="joint"``); 0.0 otherwise or
    when the chip is empty.

    ``scope`` distinguishes rebalance flavours (``"full"`` re-optimized
    every resident, ``"region"`` only the ``region_apps`` apps of the
    affected placement region); ``app_throughputs`` maps each resident to
    its TRUE steady-state rate — 1 / max period over the graph components
    its actors touch — which is >= the conservative chip rate for any app
    off the chip's critical cycle.

    The fault/drift layer adds four kinds: ``"fault"``/``"drift"``/
    ``"heal"`` record a chip mutation (their ``chip_throughput`` shows the
    chip DEGRADED, before recovery), ``"remap"`` records the incremental
    recovery — its ``seed_throughput`` is the chip throughput of the
    minimally-repaired seed placement (dead-bound clusters migrated to
    the nearest alive candidate tile) that the region re-optimization
    started from, so ``chip_throughput >= seed_throughput`` is the
    per-event never-regress invariant.  A resident whose component has no
    alive candidate tile left is released with an explicit
    ``"displaced"`` event (never silently dropped).
    """

    kind: str   # admit | reject | finish | evict | rebalance | fault | drift | heal | remap | displaced
    app: str
    tiles: list[int]
    wall_s: float             # wall-clock cost of the operation
    throughput: float = 0.0
    cache_hit: bool = False
    chip_throughput: float = 0.0   # iterations / us of the union graph
    chip_energy: float = 0.0       # pJ / iteration of the union graph
    scope: str = ""                # rebalance events: "full" | "region"
    region_apps: int = 0           # apps re-optimized by a region rebalance
    app_throughputs: dict = dataclasses.field(default_factory=dict)
    seed_throughput: float = 0.0   # remap events: repaired-seed chip rate
    reason: str = ""               # reject events: "" (placement) | quota | cancelled
    factor: float = 0.0            # drift/throttle events: applied multiplier


def _same_application(app: Union[SNN, ClusteredSNN], art: DesignArtifact) -> bool:
    """Guard against a stale cache hit: same name, different network."""
    if isinstance(app, ClusteredSNN):
        return app is art.clustered or app.snn is art.clustered.snn
    cached = art.clustered.snn
    if app is cached:
        return True
    return (
        app.n_neurons == cached.n_neurons
        and np.array_equal(app.pre, cached.pre)
        and np.array_equal(app.post, cached.post)
        and np.array_equal(app.weight, cached.weight)
        and np.array_equal(app.spikes, cached.spikes)
    )


def _later_slice(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet: repro_torch implements isolated "
        f"placement only (see ROADMAP.md for the slices still to come)"
    )


class AdmissionController:
    """Multi-tenant run-time resource manager (§5, Fig. 11), isolated
    placement.

    Owns the persistent tile-occupancy state (:class:`HardwareState`), the
    design-time artifact cache, and the admission trajectory::

        ctl = AdmissionController(DYNAP_SE, device="cuda")
        ctl.register(snn)                      # design time, once per app
        rep = ctl.admit(snn.name, n_tiles_request=2)
        ctl.finish(snn.name)                   # app completed: tiles free
        rep2 = ctl.admit(snn.name)             # re-admission: cache hit

    ``admit`` scores every feasible free-tile binding in one batched
    engine call (see :func:`runtime_admit` with ``tile_selection=
    "batched"``); ``evict`` is the preemption variant of ``finish`` —
    same release mechanics, distinct trajectory event, returns the freed
    tiles so a caller can re-admit a displaced app.  ``cache_stats`` holds
    shape-bucket counters scoped to THIS controller.

    ``device`` (``None``: CUDA, raising when there is none) and
    ``backend`` (``"auto"`` = the exact device search ``"csr"``, or
    ``"edges"``/``"dense"``) select where batched scoring runs.
    ``placement`` must be ``"isolated"``; ``"joint"`` and the fault/drift
    runtime are later slices of the port and raise ``NotImplementedError``.
    """

    def __init__(
        self,
        hw: HardwareConfig,
        *,
        weights: LoadWeights = LoadWeights(),
        tile_selection: str = "batched",
        sim_iterations: int = 8,
        optimize_budget: Optional[tuple[int, int]] = None,
        placement: str = "isolated",
        backend: str = "auto",
        device=None,
    ):
        if placement == "joint":
            _later_slice('placement="joint"')
        if placement != "isolated":
            raise ValueError(
                f"unknown placement {placement!r}; have ('isolated', 'joint')"
            )
        self.device = resolve(device)
        self.backend = backend
        self.hw = hw
        # mutable chip degradation state; pristine until the fault runtime
        # is ported, and every score the controller takes goes through it
        self.chip = ChipState(hw)
        self.state = HardwareState(hw, chip=self.chip)
        self.weights = weights
        self.tile_selection = tile_selection
        self.sim_iterations = sim_iterations
        # (generations, population) for throughput-in-the-loop refinement
        # of every admission's binding; None = heuristic-only (fastest)
        self.optimize_budget = optimize_budget
        self.placement = placement
        self.cache_stats = CompileCacheStats()
        self.artifacts: dict[tuple[str, HardwareConfig], DesignArtifact] = {}
        self.reports: dict[str, CompileReport] = {}
        self.events: list[AdmissionEvent] = []

    # -- design time ----------------------------------------------------
    def register(self, app: Union[SNN, ClusteredSNN]) -> DesignArtifact:
        """Run (or fetch) the design-time flow for ``app`` on this hardware.

        Accepts a raw :class:`SNN` (clustered here) or a pre-clustered
        application.  Idempotent: a second registration of the same name is
        a cache hit and does no work.
        """
        name = app.snn.name if isinstance(app, ClusteredSNN) else app.name
        key = (name, self.hw)
        if key in self.artifacts:
            art = self.artifacts[key]
            if not _same_application(app, art):
                raise ValueError(
                    f"app {name!r} is already registered with different "
                    f"contents on this hardware; use a distinct name"
                )
            art.hits += 1
            return art
        t0 = time.perf_counter()
        clustered = (
            app if isinstance(app, ClusteredSNN)
            else partition_greedy(app, self.hw)
        )
        order, _ = single_tile_order(
            clustered, self.hw, sim_iterations=self.sim_iterations
        )
        art = DesignArtifact(
            app=name,
            clustered=clustered,
            single_order=order,
            design_time_s=time.perf_counter() - t0,
            graph=sdfg_from_clusters(clustered, hw=self.hw),
        )
        self.artifacts[key] = art
        return art

    def _artifact(self, app: Union[str, SNN, ClusteredSNN]) -> tuple[DesignArtifact, bool]:
        if isinstance(app, str):
            key = (app, self.hw)
            if key not in self.artifacts:
                raise KeyError(
                    f"app {app!r} was never registered with this controller; "
                    f"known apps: {sorted(k for k, _ in self.artifacts)}"
                )
            art = self.artifacts[key]
            art.hits += 1
            return art, True
        key = ((app.snn.name if isinstance(app, ClusteredSNN) else app.name),
               self.hw)
        cached = key in self.artifacts
        return self.register(app), cached

    # -- run time -------------------------------------------------------
    def admit(
        self,
        app: Union[str, SNN, ClusteredSNN],
        *,
        n_tiles_request: Optional[int] = None,
    ) -> CompileReport:
        """Admit ``app`` onto the currently-free tiles (Fig. 11).

        Raises :class:`AdmissionError` when the app is already running or
        cannot be placed; rejections are recorded in the trajectory too.
        """
        art, cache_hit = self._artifact(app)
        if art.app in self.state.allocated:
            self.events.append(AdmissionEvent(
                kind="reject", app=art.app, tiles=[], wall_s=0.0,
                cache_hit=cache_hit,
            ))
            raise AdmissionError(
                f"app {art.app!r} is already running on tiles "
                f"{self.state.allocated[art.app]}; finish() or evict() first"
            )
        t0 = time.perf_counter()
        try:
            with record_cache_stats(self.cache_stats):
                report = runtime_admit(
                    art.clustered,
                    self.state,
                    art.single_order,
                    n_tiles_request=n_tiles_request,
                    weights=self.weights,
                    tile_selection=self.tile_selection,
                    optimize_budget=self.optimize_budget,
                    chip_state=self.chip,
                    rate_scale=self.chip.drift.get(art.app, 1.0),
                    backend=self.backend,
                    device=self.device,
                )
        except AdmissionError:
            self.events.append(AdmissionEvent(
                kind="reject", app=art.app, tiles=[],
                wall_s=time.perf_counter() - t0, cache_hit=cache_hit,
            ))
            raise
        self.reports[art.app] = report
        event = AdmissionEvent(
            kind="admit",
            app=art.app,
            tiles=sorted(self.state.allocated[art.app]),
            wall_s=time.perf_counter() - t0,
            throughput=report.throughput,
            cache_hit=cache_hit,
        )
        self.events.append(event)
        return report

    def record_rejection(self, app: str, reason: str) -> "AdmissionEvent":
        """Stamp a front-end rejection on the trajectory.

        The serving queue refuses some tickets before they ever reach
        :meth:`admit` — per-tenant quota breaches, cancellations of
        queued work.  Those decisions still belong on the admission
        trajectory (the paper's Fig.-11 flow audits EVERY outcome), so
        the front end records them here with an explicit ``reason``;
        placement rejections raised by :meth:`admit` itself stamp their
        events with an empty reason as before.
        """
        event = AdmissionEvent(
            kind="reject", app=app, tiles=[], wall_s=0.0, reason=reason,
        )
        self.events.append(event)
        return event

    def _release(self, app: str, kind: str) -> list[int]:
        if app not in self.state.allocated:
            raise KeyError(
                f"app {app!r} is not running; running: {sorted(self.state.allocated)}"
            )
        tiles = sorted(self.state.allocated[app])
        self.state.release(app)
        self.reports.pop(app, None)
        self.events.append(
            AdmissionEvent(kind=kind, app=app, tiles=tiles, wall_s=0.0)
        )
        return tiles

    def finish(self, app: str) -> list[int]:
        """App completed normally: free its tiles."""
        return self._release(app, "finish")

    def evict(self, app: str) -> list[int]:
        """Forcibly preempt a running app (the Fig.-11 displacement case).

        Same release as :meth:`finish`, recorded as a distinct event.
        """
        return self._release(app, "evict")

    # -- later slices ---------------------------------------------------
    def inject_fault(self, *args, **kwargs):
        """Fault runtime: a later slice of the port."""
        _later_slice("inject_fault")

    def inject_drift(self, *args, **kwargs):
        """Drift runtime: a later slice of the port."""
        _later_slice("inject_drift")

    def heal(self, *args, **kwargs):
        """Fault runtime: a later slice of the port."""
        _later_slice("heal")

    def remap(self, *args, **kwargs):
        """Fault runtime: a later slice of the port."""
        _later_slice("remap")

    def defer_rebalances(self):
        """Deferred (joint) rebalancing: a later slice of the port."""
        _later_slice("defer_rebalances")

    # -- introspection --------------------------------------------------
    def running(self) -> dict[str, list[int]]:
        """Currently-admitted apps -> sorted physical tile ids they hold."""
        return {a: sorted(t) for a, t in self.state.allocated.items()}

    def free_tiles(self) -> list[int]:
        """Sorted physical tile ids currently available for admission."""
        return self.state.free_tiles()

    def trajectory(self) -> list[dict]:
        """JSON-ready event log (consumed by ``benchmarks/admission.py``)."""
        return [dataclasses.asdict(e) for e in self.events]
