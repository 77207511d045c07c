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

With ``placement="joint"`` the controller goes beyond per-admission
isolation: every admit/evict re-optimizes the bindings of ALL resident
applications together, as one disjoint-union graph
(:func:`~repro_torch.core.sdfg.disjoint_union`) whose per-app order cycles come
from the Lemma-1 projection of the concatenated single-tile orders — one
union EdgeStack per optimizer generation, scored on the chip-level
objective (period, chip energy, or their Pareto front) by
:func:`~repro_torch.core.optimize.optimize_binding_graph`.  The current
(isolated) placement is always a seed of that search, so joint placement
is never worse on the scored objective by construction; the trajectory
records chip throughput and chip energy alongside every event.

At chip scale (hundreds of tiles, dozens of tenants) re-optimizing the
WHOLE chip per event is wasteful: an admit or evict only perturbs the
placement near its own tiles.  ``region_scope=True`` (the joint-placement
default) therefore partitions the residents into *placement regions* —
tile-sharing components grown over mesh adjacency — and re-optimizes only
the affected region as a sub-union EdgeStack, holding every other app's
binding fixed.  The slowest component OUTSIDE the region enters the search
as a ``period_floor`` (a cheap stand-in for the rest of the chip: no
region improvement below that floor can move the chip period, so the
optimizer breaks floor-ties toward lower energy), and the region's
candidate tiles are its own footprint plus nearby FREE tiles ranked by
hop distance with a boundary penalty — never another app's tiles, so no
new cross-region coupling can appear and the floor stays valid.  The
current binding seeds the region search, so the chip period never
regresses vs. the pre-event binding by construction (the seeding
invariant of the full path, now per region).  Every ``full_rebalance_every``-th rebalance
— or any event whose region would cover the whole chip or exceed
``region_max_apps`` — falls back to the exact full-union re-optimization,
so long churns cannot drift away from the jointly-optimal placement.

Chip metrics are cached per tile-sharing component (keyed on the
residents' binding epochs): components untouched by an event are combined
from cache instead of rebuilt, so per-event tracking cost scales with the
event's region, not with the number of resident tenants.

Batched scoring — admission, every rebalance generation, component
metrics — runs on the controller's ``device`` with its analysis
``backend`` (``"auto"``: the exact float64 λ-search ``"csr"``, kernel K1
on the card); the final admitted throughput is Howard's exact MCR on the
host, as in the reference.  The sharded scoring mesh (``mesh=``) is not
ported yet and must be ``None``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np

from .binding import BindingResult, LoadWeights, bind_ours
from ..device import no_mesh, resolve
from .engine import (
    CompileCacheStats,
    batch_execute,
    project_order_batch,
    record_cache_stats,
    union_component_periods,
)
from .hardware import ChipState, HardwareConfig
from .partition import ClusteredSNN, partition_greedy
from .schedule import (
    SelfTimedExecutor,
    analyze_throughput,
    build_static_orders,
    build_static_orders_batch,
)
from .sdfg import SDFG, disjoint_union, sdfg_from_clusters
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


class AdmissionController:
    """Multi-tenant run-time resource manager (§5, Fig. 11).

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
    tiles so a caller can re-admit a displaced app.

    ``placement="joint"`` re-optimizes the bindings of ALL resident apps
    after every admit and evict (see :meth:`chip_metrics` and the module
    docstring): one union EdgeStack per optimizer generation over the
    apps' combined tile footprint, with the isolated placement as a seed
    — never worse on the chip ``objective`` (``"period"``/``"energy"``/
    ``"pareto"``) by construction.  ``joint_budget`` is its
    (generations, population) search budget.  ``cache_stats`` holds
    shape-bucket compile-cache counters scoped to THIS controller
    (recorded via :func:`~repro_torch.core.engine.record_cache_stats`, so two
    controllers never leak counters into each other).

    ``region_scope`` (default: on exactly under ``placement="joint"``)
    makes every rebalance *incremental*: only the placement region an
    event touches is re-optimized, the rest of the chip is summarized by
    a period floor (see the module docstring).  ``region_max_apps`` caps
    a region's size (a larger affected region degrades the cover and
    falls back to full), ``region_radius`` is the mesh-hop adjacency that
    grows a region across tile-sharing components, and
    ``full_rebalance_every=K`` forces the K-th rebalance to be a full
    exact re-optimization (0 disables the periodic fallback).

    ``device`` (``None``: CUDA, raising when there is none) and
    ``backend`` (``"auto"`` = the exact device search ``"csr"``, or
    ``"edges"``/``"dense"``) select where every batched score of the
    controller runs: admissions, rebalance generations, component
    metrics.  ``mesh`` (the sharded scoring mesh) is not ported yet and
    must be ``None``.
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
        joint_budget: tuple[int, int] = (2, 16),
        objective: str = "period",
        track_chip_metrics: Optional[bool] = None,
        region_scope: Optional[bool] = None,
        region_max_apps: int = 6,
        full_rebalance_every: int = 8,
        region_radius: int = 1,
        fused_scoring: bool = True,
        mesh=None,
        backend: str = "auto",
        device=None,
    ):
        if placement not in ("isolated", "joint"):
            raise ValueError(
                f"unknown placement {placement!r}; have ('isolated', 'joint')"
            )
        if objective not in ("period", "energy", "pareto"):
            raise ValueError(
                f"unknown objective {objective!r}; "
                f"have ('period', 'energy', 'pareto')"
            )
        no_mesh(mesh, "AdmissionController(mesh=)")
        self.device = resolve(device)
        self.backend = backend
        self.hw = hw
        # mutable chip degradation state (dead tiles, link throttles,
        # per-app drift); every score the controller takes goes through it
        self.chip = ChipState(hw)
        self.state = HardwareState(hw, chip=self.chip)
        self.weights = weights
        self.tile_selection = tile_selection
        self.sim_iterations = sim_iterations
        # (generations, population) for throughput-in-the-loop refinement
        # of every admission's binding; None = heuristic-only (fastest)
        self.optimize_budget = optimize_budget
        # chip-level placement policy: "isolated" admits each app on its
        # own and never revisits it; "joint" re-optimizes all resident
        # bindings together on every admit/evict (union EdgeStack)
        self.placement = placement
        self.joint_budget = joint_budget
        self.objective = objective
        # chip-metric tracking costs one B=1 union analysis per event;
        # default on exactly when joint placement needs the numbers anyway
        self.track_chip_metrics = (
            placement == "joint" if track_chip_metrics is None
            else track_chip_metrics
        )
        # region-scoped incremental rebalancing (joint placement only):
        # defaults on under "joint", irrelevant (but harmless) otherwise
        self.region_scope = (
            placement == "joint" if region_scope is None
            else bool(region_scope)
        )
        self.region_max_apps = int(region_max_apps)
        self.full_rebalance_every = int(full_rebalance_every)
        self.region_radius = int(region_radius)
        # fused cross-component scoring: a multi-component region runs
        # its component searches in lockstep, one fused EdgeStack
        # analysis per generation (see _optimize_region)
        self.fused_scoring = bool(fused_scoring)
        # rebalance deferral (the serving burst path): while a deferral
        # is active, _rebalance only records the event; flush_rebalances
        # merges all pending events into ONE region rebalance
        self._defer_rebalance = False
        self._pending_event_apps: set[str] = set()
        self._pending_freed: set[int] = set()
        self._deferred_events = 0
        # per-app binding epochs key the component-metric cache: any write
        # to an app's binding invalidates exactly the components it touches
        self._binding_epoch: dict[str, int] = {}
        self._epoch_counter = 0
        self._comp_cache: dict[tuple, dict] = {}
        self._rebalance_count = 0
        # last stamped per-app rates: the staleness detector compares a
        # fresh re-score under the CURRENT chip state against this
        self._app_rate_snapshot: dict[str, float] = {}
        # tiles whose neighborhood skipped opportunistic re-optimization
        # during a latency-critical fault remap; consumed (as extra
        # region seeds) by the next growing rebalance or heal remap
        self._pending_consolidation: set[int] = set()
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
        self._bump_epoch(art.app)
        event = AdmissionEvent(
            kind="admit",
            app=art.app,
            tiles=sorted(self.state.allocated[art.app]),
            wall_s=time.perf_counter() - t0,
            throughput=report.throughput,
            cache_hit=cache_hit,
        )
        self.events.append(event)
        self._stamp_chip_metrics(event)
        if self.placement == "joint":
            self._rebalance(event_app=art.app)
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
        self._binding_epoch.pop(app, None)
        event = AdmissionEvent(kind=kind, app=app, tiles=tiles, wall_s=0.0)
        self.events.append(event)
        self._stamp_chip_metrics(event)
        return tiles

    def finish(self, app: str) -> list[int]:
        """App completed normally: free its tiles."""
        return self._release(app, "finish")

    def evict(self, app: str) -> list[int]:
        """Forcibly preempt a running app (the Fig.-11 displacement case).

        Under ``placement="joint"`` the remaining residents are re-placed
        jointly right after the release (the freed tiles may be reclaimed
        by the survivors); ``finish`` deliberately does not re-place.
        """
        tiles = self._release(app, "evict")
        if self.placement == "joint":
            self._rebalance(freed_tiles=tiles)
        return tiles

    # -- fault & drift runtime ------------------------------------------
    def stale_apps(self) -> list[str]:
        """Residents whose last-stamped rate no longer holds on this chip.

        Re-scores every resident component under the CURRENT chip state
        (the component cache keys on the chip's degradation epoch, so any
        mutation forces fresh engine calls) and returns the apps whose
        true steady-state rate moved relative to the snapshot stamped at
        the last trajectory event.  Empty when the chip is pristine, when
        the degradation touches no resident, or when the controller does
        not track chip metrics (no snapshot to compare against).
        """
        if not self.state.allocated:
            return []
        m = self.chip_metrics()
        if m is None:
            return []
        return sorted(
            n for n, thr in m["app_throughputs"].items()
            if not np.isclose(
                thr,
                self._app_rate_snapshot.get(n, thr),
                rtol=1e-6, atol=0.0,
            )
        )

    def _refresh_rate_snapshot(self) -> None:
        m = self.chip_metrics()
        self._app_rate_snapshot = (
            dict(m["app_throughputs"]) if m is not None else {}
        )

    def inject_fault(
        self,
        tiles: Optional[list[int]] = None,
        *,
        links: Optional[list[tuple[int, int]]] = None,
        throttle: float = 4.0,
        remap: bool = True,
    ) -> list[str]:
        """Fail tiles and/or throttle links, then recover incrementally.

        Marks ``tiles`` dead (their rows become infeasible for every
        binding) and multiplies the per-hop link time of each adjacent
        ``links`` pair by ``throttle`` (a wormhole route crossing several
        throttled links is gated by the slowest), re-scores the resident
        set under the degraded chip, records a ``"fault"`` trajectory
        event whose chip metrics show the chip DEGRADED (before
        recovery), and — unless ``remap=False`` — runs :meth:`remap`.
        Returns the names of apps displaced during recovery (empty when
        every resident survived, always empty with ``remap=False``).
        """
        if not tiles and not links:
            raise ValueError("inject_fault needs tiles and/or links")
        t0 = time.perf_counter()
        if tiles:
            self.chip.fail_tiles(tiles)
        for a, b in links or []:
            self.chip.throttle_link(a, b, throttle)
        stale = self.stale_apps()
        event = AdmissionEvent(
            kind="fault", app="*",
            tiles=sorted(int(t) for t in tiles or []),
            wall_s=time.perf_counter() - t0,
            factor=float(throttle) if links else 0.0,
        )
        self._stamp_chip_metrics(event)
        self._refresh_rate_snapshot()
        self.events.append(event)
        if not remap:
            return []
        return self.remap(
            failed_tiles=sorted(int(t) for t in tiles or []),
            stale=stale,
        )

    def inject_drift(
        self, app: str, factor: float, *, remap: bool = True
    ) -> list[str]:
        """Scale ``app``'s observed spike rates by ``factor`` (workload
        drift: the network fires more or less than its design-time
        profile said).  NoC delays and dynamic-energy accumulators see
        the drifted rates; buffer back-edges and the intra-tile
        time-constant stay design-time.  Records a ``"drift"`` event and
        — unless ``remap=False`` — re-places the affected region.
        Returns any displaced app names (normally empty: drift never
        makes a placement infeasible).
        """
        t0 = time.perf_counter()
        self.chip.set_drift(app, factor)
        stale = self.stale_apps()
        event = AdmissionEvent(
            kind="drift", app=app, tiles=[],
            wall_s=time.perf_counter() - t0,
            factor=float(factor),
        )
        self._stamp_chip_metrics(event)
        self._refresh_rate_snapshot()
        self.events.append(event)
        if not remap:
            return []
        return self.remap(stale=stale)

    def heal(
        self,
        tiles: Optional[list[int]] = None,
        *,
        links: Optional[list[tuple[int, int]]] = None,
        drift_apps: Optional[list[str]] = None,
        remap: bool = True,
    ) -> list[str]:
        """Undo degradation: revive tiles, restore links, clear drift.

        Records a ``"heal"`` event, then — unless ``remap=False`` —
        re-places the region around the recovered tiles so residents can
        reclaim them.  Returns any displaced app names (always empty:
        healing only ever widens the feasible set).
        """
        if not tiles and not links and not drift_apps:
            raise ValueError("heal needs tiles, links and/or drift_apps")
        t0 = time.perf_counter()
        if tiles:
            self.chip.heal_tiles(tiles)
        for a, b in links or []:
            self.chip.heal_link(a, b)
        for a in drift_apps or []:
            self.chip.clear_drift(a)
        stale = self.stale_apps()
        event = AdmissionEvent(
            kind="heal", app="*",
            tiles=sorted(int(t) for t in tiles or []),
            wall_s=time.perf_counter() - t0,
        )
        self._stamp_chip_metrics(event)
        self._refresh_rate_snapshot()
        self.events.append(event)
        if not remap:
            return []
        return self.remap(
            healed_tiles=sorted(int(t) for t in tiles or []),
            stale=stale,
        )

    def remap(
        self,
        *,
        failed_tiles: Optional[list[int]] = None,
        healed_tiles: Optional[list[int]] = None,
        stale: Optional[list[str]] = None,
    ) -> list[str]:
        """Incrementally recover the placement after a chip mutation.

        Never a from-scratch re-placement: (1) residents bound to dead
        tiles are found; components with NO alive candidate tile left are
        released with explicit ``"displaced"`` events (never silently
        dropped); (2) the surviving dead-bound clusters are migrated to
        the nearest alive candidate tile (seed repair — the cheapest
        feasible post-fault placement) and the repaired seed's chip
        throughput is stamped; (3) the affected region — the tile-sharing
        components of the broken/``stale`` apps plus components within
        ``region_radius`` of the failed/healed tiles — is re-optimized
        per component with the region floor machinery, seeded from the
        repaired binding.  The final ``"remap"`` event records
        ``seed_throughput``; ``chip_throughput >= seed_throughput`` holds
        by construction (the seed is always in the candidate pool), so
        recovery never lands below the best repaired placement and
        untouched tenants are never disturbed.  Returns displaced names.
        """
        t0 = time.perf_counter()
        displaced: list[str] = []
        if not self.state.allocated:
            return displaced
        broken = [
            n for n in sorted(self.state.allocated)
            if self.chip.dead[self.reports[n].binding].any()
        ]
        if broken:
            broken_set = set(broken)
            doomed: list[list[str]] = [
                sorted(c) for c in self._tile_components()
                if broken_set & set(c) and not self._component_allowed(sorted(c))
            ]
            for comp in doomed:
                for n in comp:
                    self._release(n, "displaced")
                    displaced.append(n)
            broken = [n for n in broken if n in self.state.allocated]
        if broken:
            # seed repair: minimally migrate dead-bound clusters so the
            # state itself is feasible before any optimization runs
            broken_set = set(broken)
            for comp in [sorted(c) for c in self._tile_components()]:
                if not (broken_set & set(comp)):
                    continue
                arts, union, order, binding, offsets = self._sub_union(comp)
                binding = self._repair_binding(
                    binding, self._component_allowed(comp)
                )
                union_orders = project_order(order, binding, self.hw.n_tiles)
                for k, name in enumerate(comp):
                    lo, hi = int(offsets[k]), int(offsets[k + 1])
                    b_app = binding[lo:hi].copy()
                    self.state.allocated[name] = sorted(
                        {int(t) for t in b_app}
                    )
                    old = self.reports[name]
                    self.reports[name] = CompileReport(
                        app=name,
                        binding=b_app,
                        orders=[
                            [a - lo for a in tile_order if lo <= a < hi]
                            for tile_order in union_orders
                        ],
                        throughput=old.throughput,
                        bind_time_s=old.bind_time_s,
                        schedule_time_s=old.schedule_time_s,
                    )
                    self._bump_epoch(name)
        if not self.state.allocated:
            return displaced
        # the repaired seed IS a feasible placement under the current
        # chip state: its rate is the never-regress floor of this remap
        m_seed = self.chip_metrics()
        seed_thr = (
            m_seed["chip_throughput"] if m_seed is not None else 0.0
        )
        event_apps = (
            set(broken) | set(stale or [])
        ) & set(self.state.allocated)
        if healed_tiles and m_seed is not None:
            # a heal is the cheap moment to attack the CHIP bottleneck:
            # the slowest component's own chip state never changes when
            # capacity returns elsewhere, so it is never rate-stale and
            # no incremental event would ever re-seed it — each heal
            # re-optimizes it (with growth) and walks the incremental
            # placement back toward the full re-optimization's quality
            slowest = min(
                m_seed["app_throughputs"].values(), default=float("inf")
            )
            event_apps |= {
                n for n, r in m_seed["app_throughputs"].items()
                if r <= slowest * (1 + 1e-9)
            }
        event_apps = sorted(event_apps)
        # fault remaps stay latency-critical: only HEALED tiles are
        # immediate placement opportunities for neighbors (dead tiles
        # attract nobody, and every app a failure can affect — dead-bound
        # or rate-stale — is already in event_apps).  The failed tiles'
        # neighborhood is queued instead and consolidated by the next
        # growing rebalance (churn or heal), off the recovery path.
        if failed_tiles:
            self._pending_consolidation.update(int(t) for t in failed_tiles)
        freed = set(healed_tiles or [])
        if freed and self._pending_consolidation:
            freed |= self._pending_consolidation
            self._pending_consolidation.clear()
        freed = sorted(freed)
        region = self._affected_region(
            event_apps=event_apps or None,
            freed_tiles=freed or None,
            grow=bool(healed_tiles),
        ) or []
        if not region and not broken and not displaced:
            return displaced   # mutation touched nothing resident
        if region:
            self._optimize_region(region)
        m = self.chip_metrics()
        thr = m["chip_throughput"] if m is not None else 0.0
        for name in region:
            self.reports[name].throughput = thr
        event = AdmissionEvent(
            kind="remap", app="*",
            tiles=sorted(
                {int(t) for n in region for t in self.state.allocated[n]}
            ),
            wall_s=time.perf_counter() - t0,
            throughput=thr,
            scope="region", region_apps=len(region),
            seed_throughput=seed_thr,
        )
        if self.track_chip_metrics and m is not None:
            event.chip_throughput = thr
            event.chip_energy = m["chip_energy"]
            event.app_throughputs = dict(m["app_throughputs"])
            self._app_rate_snapshot = dict(m["app_throughputs"])
        self.events.append(event)
        return displaced

    # -- chip-level placement (the union-graph objective layer) ---------
    def _resident_union(self):
        """Union view of all resident apps: graph, order, binding, offsets.

        Returns ``(names, arts, union, union_order, union_binding,
        offsets)`` — the disjoint-union SDFG of the resident apps (actors
        offset per app, ``offsets[k]`` is app k's first actor), the
        concatenated single-tile orders (a valid total order of the union:
        no cross-app edges exist) and the concatenated current physical
        bindings.
        """
        names = sorted(self.state.allocated)
        arts = [self.artifacts[(n, self.hw)] for n in names]
        graphs = [
            a.graph if a.graph is not None
            else sdfg_from_clusters(a.clustered, hw=self.hw)
            for a in arts
        ]
        offsets = np.cumsum([0] + [g.n_actors for g in graphs])
        union = disjoint_union(graphs, name="chip-union")
        union_order: list[int] = []
        for art, off in zip(arts, offsets[:-1]):
            union_order.extend(int(a) + int(off) for a in art.single_order)
        union_binding = np.concatenate(
            [self.reports[n].binding for n in names]
        )
        return names, arts, union, union_order, union_binding, offsets

    def _sub_union(self, names: list[str]):
        """Union view of a SUBSET of residents (same layout as
        :meth:`_resident_union`, minus the names echo): ``(arts, union,
        order, binding, offsets)``.  Cost scales with the subset — never
        with the number of resident tenants."""
        arts = [self.artifacts[(n, self.hw)] for n in names]
        graphs = [
            a.graph if a.graph is not None
            else sdfg_from_clusters(a.clustered, hw=self.hw)
            for a in arts
        ]
        offsets = np.cumsum([0] + [g.n_actors for g in graphs])
        union = disjoint_union(graphs, name="sub-union")
        order: list[int] = []
        for art, off in zip(arts, offsets[:-1]):
            order.extend(int(a) + int(off) for a in art.single_order)
        binding = np.concatenate([self.reports[n].binding for n in names])
        return arts, union, order, binding, offsets

    def _bump_epoch(self, app: str) -> None:
        """Mark ``app``'s binding as rewritten (invalidates cached comps)."""
        self._epoch_counter += 1
        self._binding_epoch[app] = self._epoch_counter

    def _union_rate_scale(self, arts) -> Optional[np.ndarray]:
        """Per-flow-edge drift multipliers of a union over ``arts``.

        The union's flow (data) edges are the per-app channel tables
        concatenated in app order (:func:`~repro_torch.core.sdfg.disjoint_union`
        preserves table order; :func:`~repro_torch.core.sdfg.hardware_static_parts`
        drops only self-edges), so each app's scalar drift factor repeats
        over its own channel count.  None when no member app drifts.
        """
        if not self.chip.drift:
            return None
        parts = [
            np.full(
                a.clustered.channel_src.size,
                self.chip.drift.get(a.app, 1.0),
                dtype=np.float64,
            )
            for a in arts
        ]
        if not parts:
            return None
        out = np.concatenate(parts)
        return None if np.all(out == 1.0) else out

    def _tile_components(self) -> list[list[str]]:
        """Tile-sharing components of the residents (deterministic order).

        Two apps are joined iff they share a physical tile; components are
        exactly the units whose TDMA serialization couples — re-optimizing
        any strict subset of a component could silently change an outside
        app's tile cycles, so regions are always unions of whole
        components.  Names inside a component and the component list are
        sorted for reproducibility.
        """
        names = sorted(self.state.allocated)
        parent = list(range(len(names)))

        def find(i: int) -> int:
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        owner: dict[int, int] = {}
        for k, n in enumerate(names):
            for t in self.state.allocated[n]:
                t = int(t)
                if t in owner:
                    ra, rb = find(owner[t]), find(k)
                    if ra != rb:
                        parent[rb] = ra
                else:
                    owner[t] = k
        groups: dict[int, list[str]] = {}
        for k, n in enumerate(names):
            groups.setdefault(find(k), []).append(n)
        return [groups[r] for r in sorted(groups)]

    def _component_record(self, comp: list[str]) -> dict:
        """Steady-state record of ONE tile-sharing component (cached).

        Keyed on each member's binding epoch AND the slice of chip
        degradation the component can SEE (its dead tiles, its
        route-scale submatrix, its members' drift factors —
        :meth:`ChipState.component_signature`): any rebalance or
        admission that rewrites a member's binding invalidates exactly
        this record and no other, and a chip mutation invalidates only
        the components it actually touches — a fault re-scores its blast
        radius, not every resident, and a cached period can never be
        combined across chip states it depends on.  Stores the component
        period (max over its graph sub-components), its dynamic energy,
        occupied tiles, NoC cut, and every member app's TRUE per-app
        period.
        """
        foot = sorted(
            {int(t) for n in comp for t in self.state.allocated[n]}
        )
        key = (self.chip.component_signature(foot, comp),) + tuple(
            (n, self._binding_epoch.get(n, -1)) for n in comp
        )
        rec = self._comp_cache.get(key)
        if rec is not None:
            return rec
        arts, union, order, binding, offsets = self._sub_union(comp)
        labels, sub_periods, metrics = union_component_periods(
            union, binding, self.hw,
            project_order_batch(order, binding[None, :]),
            with_metrics=True,
            chip_state=self.chip,
            rate_scale=self._union_rate_scale(arts),
            backend=self.backend,
            device=self.device,
        )
        period = (
            float(sub_periods.max()) if sub_periods.size else float("inf")
        )
        # same decomposition as HardwareConfig.chip_energy: dynamic terms
        # are per-component sums, only the idle term needs the CHIP period
        dyn = (
            self.hw.e_spike_read * metrics.read_charge
            + self.hw.e_packet_encode * float(metrics.cut_traffic[0])
            + self.hw.e_link_hop * float(metrics.spike_hops[0])
        )
        app_periods: dict[str, float] = {}
        for k, n in enumerate(comp):
            lo, hi = int(offsets[k]), int(offsets[k + 1])
            ls = np.unique(labels[lo:hi])
            app_periods[n] = (
                float(sub_periods[ls].max()) if ls.size else float("inf")
            )
        rec = {
            "key": key,
            "names": tuple(comp),
            "period": period,
            "dyn": dyn,
            "tiles": int(metrics.tiles_used[0]),
            "cut": float(metrics.cut_traffic[0]),
            "app_periods": app_periods,
        }
        self._comp_cache[key] = rec
        return rec

    def chip_metrics(self, *, exact: bool = False) -> Optional[dict]:
        """Chip-level steady state of the current placement, or None.

        Default: combine the cached per-component records — tile-sharing
        components are tile-disjoint AND graph-disjoint, so the chip
        period is the max of component periods and the chip energy is the
        sum of component dynamic energies plus idle leakage of all
        occupied tiles at the chip period; only components whose members'
        bindings changed since the last call are rebuilt.  ``exact=True``
        forces the single full-union engine call instead (one B=1
        ``batch_execute`` over every resident — the full-union path, used as an
        independent cross-check of the cached combine).

        Returns ``{"chip_period", "chip_throughput", "chip_energy",
        "chip_noc_traffic", "n_resident", "n_components",
        "app_throughputs"}`` — period in microseconds (every resident app
        sustains at least 1/period iterations per microsecond), energy in
        pJ per iteration, traffic in inter-tile spikes per iteration, and
        each app's TRUE steady-state rate (1 / max period over the graph
        components its actors touch) — or None when no app is resident.
        """
        if not self.state.allocated:
            return None
        comps = self._tile_components()
        if exact:
            names, arts, union, order, binding, offsets = self._resident_union()
            rs = self._union_rate_scale(arts)
            with record_cache_stats(self.cache_stats):
                ob = project_order_batch(order, binding[None, :])
                rep = batch_execute(
                    union, binding, self.hw, ob, with_energy=True,
                    chip_state=self.chip, rate_scale=rs,
                    backend=self.backend, device=self.device,
                )
                labels, sub_periods = union_component_periods(
                    union, binding, self.hw, ob,
                    chip_state=self.chip, rate_scale=rs,
                    backend=self.backend, device=self.device,
                )
            period = float(rep.periods[0])
            energy = float(rep.energies[0])
            cut = float(rep.metrics.cut_traffic[0])
            app_thr: dict[str, float] = {}
            for k, n in enumerate(names):
                lo, hi = int(offsets[k]), int(offsets[k + 1])
                ls = np.unique(labels[lo:hi])
                p = float(sub_periods[ls].max()) if ls.size else float("inf")
                app_thr[n] = 1.0 / p if np.isfinite(p) and p > 0 else 0.0
        else:
            with record_cache_stats(self.cache_stats):
                recs = [self._component_record(c) for c in comps]
            # prune records of dead configurations (evicted apps, stale
            # epochs) so the cache tracks the resident set, not history
            live = {r["key"] for r in recs}
            self._comp_cache = {
                k: v for k, v in self._comp_cache.items() if k in live
            }
            period = max(r["period"] for r in recs)
            dyn = sum(r["dyn"] for r in recs)
            tiles = sum(r["tiles"] for r in recs)
            cut = sum(r["cut"] for r in recs)
            energy = (
                dyn + self.hw.p_tile_idle * tiles * period
                if np.isfinite(period) else float("inf")
            )
            app_thr = {}
            for r in recs:
                for n, p in r["app_periods"].items():
                    app_thr[n] = (
                        1.0 / p if np.isfinite(p) and p > 0 else 0.0
                    )
        alive = np.isfinite(period) and period > 0
        return {
            "chip_period": period,
            "chip_throughput": 1.0 / period if alive else 0.0,
            "chip_energy": energy,
            "chip_noc_traffic": cut,
            "n_resident": len(self.state.allocated),
            "n_components": len(comps),
            "app_throughputs": app_thr,
        }

    def _stamp_chip_metrics(self, event: AdmissionEvent) -> None:
        """Record the post-event chip state onto ``event`` (when tracking).

        Also refreshes the per-app rate snapshot the staleness detector
        (:meth:`stale_apps`) compares against.
        """
        if not self.track_chip_metrics:
            return
        m = self.chip_metrics()
        if m is not None:
            event.chip_throughput = m["chip_throughput"]
            event.chip_energy = m["chip_energy"]
            event.app_throughputs = dict(m["app_throughputs"])
            self._app_rate_snapshot = dict(m["app_throughputs"])
        else:
            self._app_rate_snapshot = {}

    def defer_rebalances(self):
        """Context manager: coalesce rebalances for a burst of events.

        While active, admits and evicts apply their placement changes
        but skip the per-event joint rebalance — `_rebalance` only
        records the event's (apps, freed tiles).  On exit (or an
        explicit :meth:`flush_rebalances` inside the window) all pending
        events merge into ONE rebalance whose affected region seeds from
        every recorded app and freed tile at once — the serving loop's
        batching lever: K churn events cost one region re-optimization
        (with fused per-component scoring) instead of K.
        """
        import contextlib

        @contextlib.contextmanager
        def _guard():
            self._defer_rebalance = True
            try:
                yield self
            finally:
                self._defer_rebalance = False
                self.flush_rebalances()

        return _guard()

    def flush_rebalances(self) -> int:
        """Run the single merged rebalance for all deferred events.

        Returns the number of events coalesced into this flush (0 when
        nothing is pending).  Safe to call mid-window: pending state is
        consumed and the deferral stays active for subsequent events.
        """
        n = self._deferred_events
        if n == 0:
            return 0
        event_apps = sorted(
            a for a in self._pending_event_apps
            if a in self.state.allocated
        )
        freed = sorted(self._pending_freed)
        self._pending_event_apps.clear()
        self._pending_freed.clear()
        self._deferred_events = 0
        was_deferred, self._defer_rebalance = self._defer_rebalance, False
        try:
            self._rebalance(
                event_apps=event_apps or None,
                freed_tiles=freed or None,
            )
        finally:
            self._defer_rebalance = was_deferred
        return n

    def _rebalance(
        self,
        *,
        event_app: Optional[str] = None,
        event_apps: Optional[list[str]] = None,
        freed_tiles: Optional[list[int]] = None,
    ) -> None:
        """Re-place residents after an event (``placement="joint"``).

        Dispatch: without ``region_scope`` — or every
        ``full_rebalance_every``-th call, or when the affected region
        covers all residents — run the exact full-union re-optimization
        (:meth:`_rebalance_full`, the full-union path).  An eviction whose
        freed tiles border no resident component is a no-op (nothing can
        move, and losing a component only lowers the chip period).
        Otherwise re-optimize only the placement region the event
        touches (:meth:`_rebalance_region`): the tile-sharing
        component(s) of ``event_app`` on admit, the components within
        ``region_radius`` mesh hops of ``freed_tiles`` on evict, grown
        over component adjacency up to the cap.
        """
        if self._defer_rebalance:
            # burst window (defer_rebalances): record, rebalance later
            if event_app is not None:
                self._pending_event_apps.add(event_app)
            self._pending_event_apps.update(event_apps or [])
            self._pending_freed.update(
                int(t) for t in (freed_tiles or [])
            )
            self._deferred_events += 1
            return
        if len(self.state.allocated) < 2:
            return
        self._rebalance_count += 1
        if not self.region_scope:
            self._rebalance_full()
            return
        if (
            self.full_rebalance_every
            and self._rebalance_count % self.full_rebalance_every == 0
        ):
            self._rebalance_full()
            return
        event_apps = list(event_apps or [])
        if event_app is not None and event_app not in event_apps:
            event_apps.append(event_app)
        if self._pending_consolidation:
            # fold the deferred fault neighborhoods into this event's
            # region seed: consolidation rides a non-recovery event
            freed_tiles = sorted(
                set(freed_tiles or []) | self._pending_consolidation
            )
            self._pending_consolidation.clear()
        if not self.chip.pristine:
            # while the chip is degraded, churn events double as
            # consolidation opportunities: also re-seed the CHIP
            # bottleneck component, which is never rate-stale itself and
            # would otherwise keep the post-fault placement pinned below
            # what a full re-optimization reaches.  A pristine chip takes
            # the exact pristine region path, bit for bit.
            m = self.chip_metrics()
            if m is not None and m["app_throughputs"]:
                slowest = min(m["app_throughputs"].values())
                event_apps = sorted(
                    set(event_apps) | {
                        n for n, r in m["app_throughputs"].items()
                        if r <= slowest * (1 + 1e-9)
                    }
                )
        region = self._affected_region(
            event_apps=event_apps or None,
            freed_tiles=freed_tiles,
        )
        if not region:
            # an isolated eviction: the freed tiles border no resident
            # component, so no placement can change — and dropping a
            # component can only LOWER the chip period (max over fewer
            # components).  Nothing to re-optimize.
            if region is not None and freed_tiles:
                return
            self._rebalance_full()
        elif len(region) >= len(self.state.allocated):
            self._rebalance_full()
        else:
            self._rebalance_region(region)

    def _affected_region(
        self,
        *,
        event_apps: Optional[list[str]] = None,
        freed_tiles: Optional[list[int]] = None,
        grow: bool = True,
    ) -> Optional[list[str]]:
        """Resident apps whose placement the event may affect.

        Seeds from the tile-sharing component(s) the event touches —
        every component containing any of ``event_apps`` (an admitted
        app, or the broken/stale apps of a remap), plus components within
        ``region_radius`` mesh hops of ``freed_tiles`` (an eviction's
        released tiles, or a fault's failed / a heal's recovered tiles) —
        then grows across components whose tile footprints sit within
        ``region_radius`` mesh hops of each other (deterministically, in
        sorted component order) while the region stays within
        ``region_max_apps``.  A seed above the cap is trimmed to the
        nearest whole components; every distance-0 component (one that
        CONTAINS an event app) is always kept even above the cap — a
        remap must cover all broken residents, and any union of whole
        components is a sound region.  An empty list means no resident
        is affected.  Returns the sorted app names.
        """
        comps = self._tile_components()
        if not comps:
            return []
        foots = [
            np.asarray(
                sorted({int(t) for n in c for t in self.state.allocated[n]}),
                dtype=np.int64,
            )
            for c in comps
        ]
        seed: set[int] = set()
        seed_dist: dict[int, float] = {}
        for event_app in event_apps or []:
            for i, c in enumerate(comps):
                if event_app in c:
                    seed.add(i)
                    seed_dist[i] = 0.0
        if freed_tiles:
            ft = np.asarray(sorted(freed_tiles), dtype=np.int64)
            for i, f in enumerate(foots):
                if f.size:
                    d = int(
                        self.hw.hops_array(ft[:, None], f[None, :]).min()
                    )
                    if d <= self.region_radius:
                        seed.add(i)
                        seed_dist.setdefault(i, float(d))
        if not seed:
            return []
        if sum(len(comps[i]) for i in seed) > self.region_max_apps:
            # over-cap seed (many components bordering the freed tiles,
            # or a component snowballed by a past full rebalance): trim
            # to the nearest whole components.  Distance-0 components —
            # the ones CONTAINING an event app — are all kept even above
            # the cap (a remap must cover every broken resident); nearby
            # (distance > 0) components are added only while they fit.
            # Dropping the rest only narrows the re-optimization, never
            # breaks it.
            picked: list[int] = []
            total = 0
            for i in sorted(seed, key=lambda i: (seed_dist[i], i)):
                if (
                    seed_dist[i] > 0.0
                    and picked
                    and total + len(comps[i]) > self.region_max_apps
                ):
                    break
                picked.append(i)
                total += len(comps[i])
            seed = set(picked)
            if total > self.region_max_apps:
                return sorted({n for i in seed for n in comps[i]})
        region = set(seed)
        # fault remaps pass grow=False: adjacency growth co-optimizes
        # NEIGHBORS as an opportunity heuristic, which is worth the wall
        # time on churn events but pure recovery latency on a fault —
        # a neighbor component's optimum provably did not move unless it
        # is broken or rate-stale, and those are already in the seed
        grew = grow
        while grew:
            grew = False
            for i in sorted(region):
                for j, f in enumerate(foots):
                    if j in region or not f.size or not foots[i].size:
                        continue
                    near = int(
                        self.hw.hops_array(
                            foots[i][:, None], f[None, :]
                        ).min()
                    ) <= self.region_radius
                    fits = (
                        sum(len(comps[k]) for k in region) + len(comps[j])
                        <= self.region_max_apps
                    )
                    if near and fits:
                        region.add(j)
                        grew = True
        return sorted({n for i in region for n in comps[i]})

    def _rebalance_full(self) -> None:
        """Jointly re-place ALL resident apps (the exact full-union path).

        Runs :func:`~repro_torch.core.optimize.optimize_binding_graph` on the
        disjoint-union graph over the residents' combined tile footprint
        (free tiles are NOT consumed — joint placement redistributes, and
        may even shrink, the existing allocation).  The current
        placement seeds the search, so the chip objective never
        regresses; shared-tile serialization is modeled exactly by the
        union order cycles the projection produces.  Per-app reports are
        updated with the (conservative) union throughput and each app's
        slice of the union schedule; the trajectory records a
        ``"rebalance"`` event with the new chip throughput and energy.
        """
        from .optimize import optimize_binding_graph

        t0 = time.perf_counter()
        names, arts, union, order, binding, offsets = self._resident_union()
        footprint = sorted(
            {
                int(t)
                for ts in self.state.allocated.values()
                for t in ts
                if not self.chip.dead[int(t)]
            }
        )
        if not footprint:
            # every resident tile is dead — nothing to optimize over;
            # remap() handles displacement, a plain rebalance cannot
            return
        # a degraded chip may leave the current binding on dead tiles;
        # repair the seed (nearest alive footprint tile) before searching
        binding = self._repair_binding(binding, footprint)
        gens, pop = self.joint_budget
        ch_src = np.concatenate([
            a.clustered.channel_src + off
            for a, off in zip(arts, offsets[:-1])
        ])
        ch_dst = np.concatenate([
            a.clustered.channel_dst + off
            for a, off in zip(arts, offsets[:-1])
        ])
        ch_rate = np.concatenate(
            [a.clustered.channel_rate for a in arts]
        )
        with record_cache_stats(self.cache_stats):
            rep = optimize_binding_graph(
                union, self.hw, order,
                seed_bindings={"isolated": binding},
                channel_src=ch_src, channel_dst=ch_dst, channel_rate=ch_rate,
                population=pop, generations=gens, rng_seed=0,
                allowed_tiles=footprint, objective=self.objective,
                chip_state=self.chip,
                rate_scale=self._union_rate_scale(arts),
                backend=self.backend,
                device=self.device,
            )
        union_orders = project_order(order, rep.binding, self.hw.n_tiles)
        thr = (
            1.0 / rep.period
            if np.isfinite(rep.period) and rep.period > 0 else 0.0
        )
        for k, name in enumerate(names):
            lo, hi = int(offsets[k]), int(offsets[k + 1])
            b_app = rep.binding[lo:hi].copy()
            self.state.allocated[name] = sorted(
                {int(t) for t in b_app}
            )
            self.reports[name] = CompileReport(
                app=name,
                binding=b_app,
                orders=[
                    [a - lo for a in tile_order if lo <= a < hi]
                    for tile_order in union_orders
                ],
                throughput=thr,
                bind_time_s=rep.opt_time_s / len(names),
                schedule_time_s=0.0,
            )
            self._bump_epoch(name)
        event = AdmissionEvent(
            kind="rebalance", app="*", tiles=footprint,
            wall_s=time.perf_counter() - t0, throughput=thr,
            scope="full", region_apps=len(names),
        )
        if self.track_chip_metrics:
            event.chip_throughput = thr
            event.chip_energy = rep.energy
            m = self.chip_metrics()
            if m is not None:
                event.app_throughputs = dict(m["app_throughputs"])
                self._app_rate_snapshot = dict(m["app_throughputs"])
        self.events.append(event)

    def _rebalance_region(self, names: list[str]) -> None:
        """Re-place ONLY the apps of one affected placement region.

        The region is processed one tile-sharing COMPONENT at a time:
        each component's sub-union is optimized over its own footprint
        plus nearby FREE tiles — ranked by mesh-hop distance to the
        component with a penalty for tiles bordering an outside app (the
        cheap region-boundary traffic term) and never including another
        app's tiles (sibling components included, since the state is
        written back between components), so no new cross-component
        coupling can appear and components never MERGE during region
        rebalances — region cost stays bounded by component size instead
        of snowballing as the optimizer compacts tenants together.
        Cross-component co-location (a global, occasionally-worthwhile
        move) remains available to the periodic full fallback.

        Everything OUTSIDE the component under optimization enters as
        ``period_floor``: candidates are ranked on ``max(component
        period, floor)`` and floor-ties break toward lower energy,
        because no local improvement below the floor can move the chip
        period.  The current binding seeds each search, so the chip
        period never regresses vs. the pre-event binding by construction
        (the floor handed to each component never exceeds the pre-event
        chip period).
        """
        t0 = time.perf_counter()
        self._optimize_region(names)
        m = self.chip_metrics()
        thr = m["chip_throughput"] if m is not None else 0.0
        for name in names:
            self.reports[name].throughput = thr
        event = AdmissionEvent(
            kind="rebalance", app="*",
            tiles=sorted(
                {int(t) for n in names for t in self.state.allocated[n]}
            ),
            wall_s=time.perf_counter() - t0, throughput=thr,
            scope="region", region_apps=len(names),
        )
        if self.track_chip_metrics and m is not None:
            event.chip_throughput = thr
            event.chip_energy = m["chip_energy"]
            event.app_throughputs = dict(m["app_throughputs"])
            self._app_rate_snapshot = dict(m["app_throughputs"])
        self.events.append(event)

    def _optimize_region(self, names: list[str]) -> None:
        """Optimize every tile-sharing component touching ``names``, each
        against the floor set by everything else on the chip (outside
        components AND the other region components' periods).  Shared by
        region rebalances and fault remaps.

        With ``fused_scoring`` (the default) a multi-component region
        runs all component searches in LOCKSTEP through
        :func:`~repro_torch.core.optimize.optimize_binding_graphs_fused`: one
        fused EdgeStack analysis per optimizer generation for the whole
        region instead of one per component per generation.  Floors are
        taken from the PRE-event component periods — each is then at
        most the pre-event chip period, so the never-regress argument is
        unchanged (every search seeds from the current binding and ranks
        on ``max(period, floor)``; the post-event chip period is at most
        ``max_k max(seed_k, floor_k)`` = the pre-event chip period).
        The free tiles offered to the sibling searches are PARTITIONED
        up front (:meth:`_component_allowed` with a shrinking pool), so
        two components can never claim the same free tile and the
        no-merge invariant of sequential processing is preserved.
        """
        region = set(names)
        comps = [
            sorted(c) for c in self._tile_components() if region & set(c)
        ]
        out_periods = [
            self._component_record(c)["period"]
            for c in self._tile_components()
            if not region & set(c)
        ]
        # current period of every region component (cached records)
        comp_periods = [
            self._component_record(c)["period"] for c in comps
        ]
        if len(comps) > 1 and self.fused_scoring:
            self._optimize_components_fused(comps, out_periods, comp_periods)
            return
        for k, comp in enumerate(comps):
            floor = max(
                out_periods + comp_periods[:k] + comp_periods[k + 1:],
                default=float("-inf"),
            )
            comp_periods[k] = self._optimize_component(comp, floor)

    def _component_task(
        self, comp: list[str], floor: float,
        free_pool: Optional[list[int]] = None,
    ) -> tuple[dict, tuple]:
        """One component's fused-search task (kwargs for
        :func:`~repro_torch.core.optimize.optimize_binding_graphs_fused`) plus
        the write-back context ``(names, order, offsets)``.  Mirrors
        :meth:`_optimize_component`'s setup exactly."""
        arts, union, order, binding, offsets = self._sub_union(comp)
        allowed = self._component_allowed(comp, free_pool=free_pool)
        binding = self._repair_binding(binding, allowed)
        gens, pop = self.joint_budget
        if len(comp) > self.region_max_apps:
            gens = 1
            pop = max(2, (pop * self.region_max_apps) // len(comp))
        ch_src = np.concatenate([
            a.clustered.channel_src + off
            for a, off in zip(arts, offsets[:-1])
        ])
        ch_dst = np.concatenate([
            a.clustered.channel_dst + off
            for a, off in zip(arts, offsets[:-1])
        ])
        ch_rate = np.concatenate(
            [a.clustered.channel_rate for a in arts]
        )
        task = dict(
            app=union, hw=self.hw, single_order=order,
            seed_bindings={"current": binding},
            channel_src=ch_src, channel_dst=ch_dst, channel_rate=ch_rate,
            population=pop, generations=gens, rng_seed=0,
            allowed_tiles=allowed, objective=self.objective,
            period_floor=floor,
            chip_state=self.chip,
            rate_scale=self._union_rate_scale(arts),
        )
        return task, (comp, order, offsets)

    def _apply_component_result(
        self, names: list[str], order, offsets, rep
    ) -> None:
        """Write one component's optimized binding back into the chip
        state (allocations, per-app reports, binding epochs)."""
        union_orders = project_order(order, rep.binding, self.hw.n_tiles)
        for k, name in enumerate(names):
            lo, hi = int(offsets[k]), int(offsets[k + 1])
            b_app = rep.binding[lo:hi].copy()
            self.state.allocated[name] = sorted(
                {int(t) for t in b_app}
            )
            self.reports[name] = CompileReport(
                app=name,
                binding=b_app,
                orders=[
                    [a - lo for a in tile_order if lo <= a < hi]
                    for tile_order in union_orders
                ],
                throughput=0.0,   # patched to the chip rate by the caller
                bind_time_s=rep.opt_time_s / len(names),
                schedule_time_s=0.0,
            )
            self._bump_epoch(name)

    def _optimize_components_fused(
        self,
        comps: list[list[str]],
        out_periods: list[float],
        comp_periods: list[float],
    ) -> None:
        """Fused lockstep re-optimization of a region's components."""
        from .optimize import optimize_binding_graphs_fused

        tasks, contexts = [], []
        free = self.state.free_tiles()
        for k, comp in enumerate(comps):
            floor = max(
                out_periods + comp_periods[:k] + comp_periods[k + 1:],
                default=float("-inf"),
            )
            task, ctx = self._component_task(comp, floor, free_pool=free)
            # tiles offered to this component leave the sibling pool:
            # siblings can never bind them, so components cannot merge
            offered = set(task["allowed_tiles"])
            free = [t for t in free if t not in offered]
            tasks.append(task)
            contexts.append(ctx)
        with record_cache_stats(self.cache_stats):
            reps = optimize_binding_graphs_fused(
                tasks, backend=self.backend, device=self.device,
            )
        for (comp, order, offsets), rep in zip(contexts, reps):
            self._apply_component_result(comp, order, offsets, rep)

    def _component_allowed(
        self, names: list[str],
        free_pool: Optional[list[int]] = None,
    ) -> list[int]:
        """Candidate tiles of one component's region search (alive only).

        The component's own (alive) footprint plus the closest free tiles
        — ranked by mesh-hop distance to the footprint with a penalty for
        tiles bordering an outside app (the cheap region-boundary traffic
        term) and never including another app's tiles.  Dead tiles are
        excluded on both sides (``free_tiles`` masks them, the footprint
        is filtered here); a fully-dead footprint still anchors the
        distance ranking so replacement tiles stay near the component's
        original location.  ``free_pool`` overrides the live free-tile
        set — the fused region path partitions one pool among sibling
        components so their offered tiles never overlap.  On a DEGRADED
        chip the free-tile pool is
        widened (2x the footprint instead of matching it): a drifted or
        throttled component recovers chip throughput by spreading over
        free tiles, and the region search can only use tiles it is
        offered — cross-component tile stealing stays reserved for the
        full fallback either way.  An EMPTY result means the component
        has no alive candidate tile at all — the displacement case.
        """
        footprint = sorted(
            {int(t) for n in names for t in self.state.allocated[n]}
        )
        alive_fp = [t for t in footprint if not self.chip.dead[t]]
        allowed = list(alive_fp)
        free = np.asarray(
            self.state.free_tiles() if free_pool is None
            else sorted(free_pool),
            dtype=np.int64,
        )
        if free.size and footprint:
            anchor = np.asarray(
                alive_fp if alive_fp else footprint, dtype=np.int64
            )
            dist = self.hw.hops_array(
                free[:, None], anchor[None, :]
            ).min(axis=1)
            outside = sorted({
                int(t)
                for n, ts in self.state.allocated.items()
                if n not in names
                for t in ts
            })
            penalty = np.zeros(free.size)
            if outside:
                ot = np.asarray(outside, dtype=np.int64)
                d_out = self.hw.hops_array(
                    free[:, None], ot[None, :]
                ).min(axis=1)
                penalty = np.where(d_out <= 1, 2.0, 0.0)
            rank = np.argsort(dist + penalty, kind="stable")
            n_extra = (
                max(4, len(footprint)) if self.chip.pristine
                else max(8, 2 * len(footprint))
            )
            allowed = sorted(
                set(alive_fp) | {int(t) for t in free[rank[:n_extra]]}
            )
        return allowed

    def _repair_binding(self, binding: np.ndarray, allowed: list[int]) -> np.ndarray:
        """Minimal migration of dead-bound actors onto ``allowed`` tiles.

        Every actor on a dead tile moves to the allowed tile nearest its
        original position (deterministic: mesh-hop distance, ties to the
        lowest tile id); actors on alive tiles stay put.  This is the
        remap seed — the cheapest feasible post-fault placement — which
        the region optimizer then only improves on.
        """
        binding = np.asarray(binding, dtype=np.int64).copy()
        bad = self.chip.dead[binding]
        if not bad.any():
            return binding
        assert allowed, "cannot repair a binding with no alive candidate tile"
        al = np.asarray(sorted(allowed), dtype=np.int64)
        d = self.hw.hops_array(binding[bad][:, None], al[None, :])
        binding[bad] = al[np.argmin(d, axis=1)]
        return binding

    def _optimize_component(self, names: list[str], floor: float) -> float:
        """Re-optimize ONE tile-sharing component against ``floor``.

        Seeds from the current binding (repaired off dead tiles first),
        searches the component footprint plus a few ranked free tiles
        (:meth:`_component_allowed`), writes the result back (bindings,
        allocations, projected orders, epochs) and returns the
        component's new (floor-clamped) period.  Oversized components —
        possible only after a full rebalance co-located many tenants —
        get a reduced search budget so per-event latency stays bounded.
        """
        from .optimize import optimize_binding_graph

        task, (_, order, offsets) = self._component_task(names, floor)
        app = task.pop("app")
        hw = task.pop("hw")
        single_order = task.pop("single_order")
        with record_cache_stats(self.cache_stats):
            rep = optimize_binding_graph(
                app, hw, single_order, backend=self.backend,
                device=self.device, **task
            )
        self._apply_component_result(names, order, offsets, rep)
        return max(float(rep.period), floor)

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


def verify_deadlock_free(
    clustered: ClusteredSNN,
    hw: HardwareConfig,
    report: CompileReport,
    *,
    iterations: int = 6,
) -> bool:
    """Operational Lemma-1 check: the projected schedule must complete."""
    app = sdfg_from_clusters(clustered, hw=hw)
    trace = SelfTimedExecutor(
        app, report.binding, hw, orders=report.orders
    ).run(iterations=iterations)
    return trace.period > 0
