"""Design-space exploration over the array-native IR.

The paper evaluates one binding per (application, hardware) pair; real
deployments ask the opposite question — *which* crossbar size / tile count /
binder / tile subset should this SNN get?  Answering it multiplies the
number of hardware-aware SDFGs to analyze (SpiNeMap-style baselines double
it again), which is exactly what the batched Max-Plus layer is for: build
all candidate graphs, stack their edge arrays (:func:`~.maxplus.stack_graphs`),
and bisect every candidate's maximum cycle ratio together in one
:func:`~.maxplus.mcr_batch` call on a device.

Two entry points:

  * :func:`sweep` — full factorial sweep ``apps x crossbar_sizes x
    tile_counts x binders`` -> :class:`SweepReport` (what the sweep
    benchmark and the design-space example drive).
  * :func:`score_free_tile_subsets` — run-time admission helper: score all
    candidate k-subsets of the currently-free tiles in one batched call
    (used by :func:`repro_torch.core.runtime.runtime_admit`).

Candidate construction (partition, binding, static orders, graph build)
is host numpy, as in the reference; the analysis runs on ``device``
(``None``: CUDA, raising when there is none).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np

from .binding import bind_ours, bind_pycarl, bind_spinemap, cut_spikes_batch
from .engine import batch_execute, project_order_batch
from .hardware import DYNAP_SE, CrossbarConfig, HardwareConfig
from .maxplus import mcr_binary_search, mcr_howard, throughput_batch
from .optimize import bind_optimized
from .partition import ClusteredSNN, partition_greedy
from .runtime import project_order
from .schedule import build_static_orders, build_static_orders_batch
from .sdfg import SDFG, hardware_aware_sdfg, sdfg_from_clusters
from .snn import SNN

#: Binding strategies by name: the paper's three §4.2/§6.3 heuristics plus
#: the throughput-in-the-loop optimizer (:mod:`repro_torch.core.optimize`).
#: All share the ``(clustered, hw, **kwargs) -> BindingResult`` signature,
#: so :func:`sweep` / :func:`build_candidates` / admission treat them alike.
BINDERS: dict[str, Callable] = {
    "ours": bind_ours,
    "pycarl": bind_pycarl,
    "spinemap": bind_spinemap,
    "optimized": bind_optimized,
}


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One evaluated candidate configuration.

    ``throughput`` is iterations per microsecond (1/period);
    ``cut_spikes`` the inter-tile spikes per iteration (SpiNeMap's
    objective) and ``spike_hops`` the rate-weighted NoC hop count — both
    from one batched :func:`~repro_torch.core.binding.cut_spikes_batch`-style
    pass per binder group.  ``energy`` is the chip energy (pJ per
    iteration, :meth:`~repro_torch.core.hardware.HardwareConfig.chip_energy`,
    filled in after analysis — it needs the period for the idle term), so
    (throughput, energy) Pareto fronts over a sweep come for free.
    """

    app: str
    crossbar: int        # crossbar inputs (= outputs; crosspoints = n^2)
    n_tiles: int
    binder: str
    n_clusters: int
    throughput: float
    cut_spikes: float
    spike_hops: float = 0.0     # rate-weighted NoC hops / iteration
    energy: float = 0.0         # pJ / iteration (0.0 until analyzed)


@dataclasses.dataclass
class SweepReport:
    """Result of one design-space sweep.

    ``build_time_s`` covers candidate construction (partition / bind /
    schedule / graph build); ``analysis_time_s`` is the Max-Plus evaluation
    of all candidates — the part the batched layer accelerates.
    """

    points: list[SweepPoint]
    build_time_s: float
    analysis_time_s: float
    method: str

    @property
    def n_candidates(self) -> int:
        """Number of evaluated (app, crossbar, tiles, binder) points."""
        return len(self.points)

    def best(self, app: str) -> SweepPoint:
        """Highest-throughput sweep point of ``app`` (throughput in
        iterations per microsecond of model time)."""
        mine = [p for p in self.points if p.app == app]
        if not mine:
            raise KeyError(f"no sweep points for app {app!r}")
        return max(mine, key=lambda p: p.throughput)

    def rows(self) -> list[tuple]:
        """CSV-ready rows (header + one tuple per sweep point)."""
        out: list[tuple] = [
            ("app", "crossbar", "tiles", "binder", "clusters",
             "throughput", "cut_spikes", "spike_hops", "energy_pj")
        ]
        for p in self.points:
            out.append((
                p.app, p.crossbar, p.n_tiles, p.binder, p.n_clusters,
                f"{p.throughput:.6e}", f"{p.cut_spikes:.1f}",
                f"{p.spike_hops:.1f}", f"{p.energy:.1f}",
            ))
        return out

    def pareto_front(self, app: str) -> list[SweepPoint]:
        """Non-dominated (period, energy) sweep points of ``app``.

        Points sorted by descending throughput; a point survives iff no
        other point of the same app has both higher-or-equal throughput
        and strictly lower energy (the ascending-energy tiebreak makes a
        throughput tie keep only its cheapest point).  Dead points (zero
        throughput) never qualify.
        """
        mine = sorted(
            (p for p in self.points if p.app == app and p.throughput > 0),
            key=lambda p: (-p.throughput, p.energy),
        )
        front: list[SweepPoint] = []
        best_e = np.inf
        for p in mine:
            if p.energy < best_e:
                front.append(p)
                best_e = p.energy
        return front


def _hw_for(base: HardwareConfig, crossbar: int, n_tiles: int) -> HardwareConfig:
    tile = dataclasses.replace(
        base.tile,
        crossbar=CrossbarConfig(crossbar, crossbar, crossbar * crossbar),
    )
    return dataclasses.replace(base, n_tiles=n_tiles, tile=tile)


def build_candidates(
    apps: Sequence[Union[str, SNN]],
    *,
    crossbar_sizes: Sequence[int] = (128,),
    tile_counts: Sequence[int] = (4,),
    binders: Sequence[str] = ("ours",),
    hw_base: HardwareConfig = DYNAP_SE,
    with_orders: bool = True,
    sim_iterations: int = 12,
    order_method: str = "batch",
    device=None,
) -> tuple[list[SweepPoint], list[SDFG], float, dict]:
    """Construct every candidate's hardware-aware SDFG for a factorial sweep.

    ``apps`` mixes Table-1 app names and prebuilt :class:`SNN` objects.
    Partitioning (Alg. 1) runs once per (app, crossbar); binding per
    candidate; static orders per (app, crossbar, tiles) GROUP — all
    binders' bindings go through one
    :func:`~repro_torch.core.schedule.build_static_orders_batch` call
    (``order_method="heapq"`` restores the per-candidate discrete-event
    loop with ``sim_iterations`` FCFS iterations; ``sim_iterations`` is
    IGNORED under the default ``"batch"`` constructor).  Returns
    ``(points, graphs, build_time_s, energy_aux)`` with throughputs still
    zero — analysis is a separate (batchable) step.  Traffic metrics
    (``cut_spikes``, ``spike_hops``) are scored per binder GROUP in one
    :func:`~repro_torch.core.binding.cut_spikes_batch`-style vectorized
    pass; ``energy_aux`` carries the period-independent energy pieces
    (``dyn_energy`` pJ and ``idle_per_us`` pJ/us arrays, one entry per
    point) that :func:`sweep` combines with the analyzed periods.

    Everything here is host numpy but the ``"optimized"`` binder, whose
    search scores its populations on ``device`` (``None``: CUDA).
    """
    from .apps import build_app

    t_build0 = time.perf_counter()
    snns: list[SNN] = [
        build_app(a) if isinstance(a, str) else a for a in apps
    ]

    def bind(binder, cl, hw):
        if binder == "optimized":
            return BINDERS[binder](cl, hw, device=device)
        return BINDERS[binder](cl, hw)

    clustered: dict[tuple[str, int], ClusteredSNN] = {}
    metas: list[SweepPoint] = []
    graphs: list[SDFG] = []
    for snn, xb in itertools.product(snns, crossbar_sizes):
        key = (snn.name, xb)
        if key not in clustered:
            clustered[key] = partition_greedy(snn, _hw_for(hw_base, xb, 1))
    dyn_energy: list[float] = []
    idle_per_us: list[float] = []
    for snn, xb, n_tiles in itertools.product(
        snns, crossbar_sizes, tile_counts
    ):
        cl = clustered[(snn.name, xb)]
        hw = _hw_for(hw_base, xb, n_tiles)
        app_g = sdfg_from_clusters(cl, hw=hw)
        bres_list = [bind(binder, cl, hw) for binder in binders]
        bind_mat = np.stack([b.binding for b in bres_list])
        # one vectorized traffic/energy pass for the whole binder group
        cuts = cut_spikes_batch(cl, bind_mat)
        hops = hw.hops_array(
            bind_mat[:, cl.channel_src], bind_mat[:, cl.channel_dst]
        )
        s_hops = (cl.channel_rate[None, :] * hops).sum(axis=1)
        # crossbar read charge: delivered spikes weighted by the target
        # cluster's mean OxRAM row length (matches ChipMetrics.read_charge)
        row_len = cl.synapses_used / np.maximum(cl.inputs_used, 1)
        read_charge = float(
            (cl.channel_rate * row_len[cl.channel_dst]).sum()
        )
        dyn = (
            hw.e_spike_read * read_charge
            + hw.e_packet_encode * cuts
            + hw.e_link_hop * s_hops
        )
        orders_group: Optional[list] = None
        if with_orders and order_method == "batch":
            orders_group = build_static_orders_batch(app_g, bind_mat, hw)
        for k, (binder, bres) in enumerate(zip(binders, bres_list)):
            orders = None
            if with_orders:
                if orders_group is not None:
                    orders = orders_group[k]
                else:
                    orders, _ = build_static_orders(
                        app_g, bres.binding, hw, iterations=sim_iterations
                    )
            graphs.append(hardware_aware_sdfg(app_g, bres.binding, hw, orders))
            dyn_energy.append(float(dyn[k]))
            idle_per_us.append(
                hw.p_tile_idle * len(set(bres.binding.tolist()))
            )
            metas.append(SweepPoint(
                app=snn.name,
                crossbar=xb,
                n_tiles=n_tiles,
                binder=binder,
                n_clusters=cl.n_clusters,
                throughput=0.0,
                cut_spikes=float(cuts[k]),
                spike_hops=float(s_hops[k]),
            ))
    aux = {
        "dyn_energy": np.asarray(dyn_energy),
        "idle_per_us": np.asarray(idle_per_us),
    }
    return metas, graphs, time.perf_counter() - t_build0, aux


def analyze_candidates(
    graphs: Sequence[SDFG],
    *,
    method: str = "batched",
    backend: str = "auto",
    rel_tol: float = 1e-8,
    device=None,
) -> np.ndarray:
    """Throughput of every candidate graph.

    ``method``: ``"batched"`` (default, one
    :func:`~repro_torch.core.maxplus.throughput_batch` over the stacked edge
    arrays, with ``backend`` on ``device``) or ``"howard-loop"`` /
    ``"binary-loop"`` — the per-graph host loops, kept as the benchmark
    baselines the batched layer is measured against.
    """
    if method == "batched":
        return throughput_batch(
            graphs, backend=backend, rel_tol=rel_tol, device=device
        )
    if method in ("howard-loop", "binary-loop"):
        fn = mcr_howard if method == "howard-loop" else mcr_binary_search
        rhos = np.array([fn(g) for g in graphs])
        return np.where(
            np.isfinite(rhos) & (rhos > 0), 1.0 / np.maximum(rhos, 1e-300), 0.0
        )
    raise ValueError(f"unknown sweep method {method!r}")


def sweep(
    apps: Sequence[Union[str, SNN]],
    *,
    crossbar_sizes: Sequence[int] = (128,),
    tile_counts: Sequence[int] = (4,),
    binders: Sequence[str] = ("ours",),
    hw_base: HardwareConfig = DYNAP_SE,
    with_orders: bool = True,
    sim_iterations: int = 12,
    order_method: str = "batch",
    method: str = "batched",
    backend: str = "auto",
    rel_tol: float = 1e-8,
    device=None,
) -> SweepReport:
    """Factorial design-space sweep, analyzed in one batched Max-Plus call.

    Composition of :func:`build_candidates` and :func:`analyze_candidates`;
    see those for the knobs (``device`` reaches both).  Every point reports
    the chip metrics — throughput, cut spikes, spike-hops and total energy
    (pJ/iteration, idle term from the analyzed period) — so
    :meth:`SweepReport.pareto_front` yields DSE Pareto fronts without a
    second pass.
    """
    metas, graphs, build_time, aux = build_candidates(
        apps,
        crossbar_sizes=crossbar_sizes,
        tile_counts=tile_counts,
        binders=binders,
        hw_base=hw_base,
        with_orders=with_orders,
        sim_iterations=sim_iterations,
        order_method=order_method,
        device=device,
    )
    t_an0 = time.perf_counter()
    thrs = analyze_candidates(
        graphs, method=method, backend=backend, rel_tol=rel_tol, device=device
    )
    analysis_time = time.perf_counter() - t_an0

    periods = np.where(
        np.asarray(thrs) > 0, 1.0 / np.maximum(thrs, 1e-300), np.inf
    )
    energies = np.where(
        np.isfinite(periods),
        aux["dyn_energy"] + aux["idle_per_us"] * periods,
        np.inf,
    )
    points = [
        dataclasses.replace(p, throughput=float(t), energy=float(e))
        for p, t, e in zip(metas, thrs, energies)
    ]
    return SweepReport(
        points=points,
        build_time_s=build_time,
        analysis_time_s=analysis_time,
        method=method,
    )


# ======================================================================
# run-time admission: batched scoring of candidate free-tile subsets
# ======================================================================
def candidate_subsets(
    free: Sequence[int], k: int, *, max_candidates: int = 64, seed: int = 0
) -> list[tuple[int, ...]]:
    """k-subsets of the free tiles to score (exhaustive when small).

    Falls back to contiguous windows plus random samples when the binomial
    count explodes — admission must stay fast (§5, Table 3).  The windows
    themselves are strided down to 3/4 of the budget when the chip is
    large (a 32x32 mesh with ~900 free tiles would otherwise emit ~900
    window candidates and swamp the batched scorer); small chips keep
    every window, bit-identical to the unstrided behaviour.
    """
    free = list(free)
    from math import comb

    if comb(len(free), k) <= max_candidates:
        return list(itertools.combinations(free, k))
    subsets: dict[tuple[int, ...], None] = {}
    n_windows = len(free) - k + 1                # contiguous = few NoC hops
    if n_windows > max_candidates:
        keep = max(1, (3 * max_candidates) // 4)
        starts = np.unique(np.linspace(0, n_windows - 1, keep).astype(int))
        for i in starts:
            subsets[tuple(free[int(i) : int(i) + k])] = None
    else:
        for i in range(n_windows):
            subsets[tuple(free[i : i + k])] = None
    rng = np.random.default_rng(seed)
    while len(subsets) < max_candidates:
        pick = tuple(sorted(rng.choice(len(free), size=k, replace=False)))
        subsets[tuple(free[i] for i in pick)] = None
    return list(subsets)


@dataclasses.dataclass
class SubsetScores:
    """Batched scoring of candidate tile subsets (admission helper).

    ``subsets[i]`` is a k-tuple of physical tile ids scored by
    ``throughputs[i]`` (iterations per microsecond; shape (len(subsets),))
    and ``energies[i]`` (chip energy, pJ per iteration — same batched
    engine call, ``inf`` for dead candidates).  ``binding``/
    ``virt_orders`` are the *virtual* (k-tile) binding ((n_clusters,) ids
    in [0, k)) and the Lemma-1 projected per-tile orders — computed once,
    reusable by the caller so admission doesn't bind or project twice.
    """

    subsets: list[tuple[int, ...]]
    throughputs: np.ndarray
    binding: np.ndarray              # (n_clusters,) virtual tile ids in [0, k)
    virt_orders: list[list[int]]
    energies: Optional[np.ndarray] = None   # (len(subsets),) pJ / iteration

    @property
    def best(self) -> tuple[int, ...]:
        """The physical tile ids of the highest-throughput subset."""
        return self.subsets[int(np.argmax(self.throughputs))]

    @property
    def best_energy(self) -> tuple[int, ...]:
        """The physical tile ids of the lowest-chip-energy subset."""
        assert self.energies is not None, "scored without energies"
        return self.subsets[int(np.argmin(self.energies))]


def score_free_tile_subsets(
    clustered: ClusteredSNN,
    hw: HardwareConfig,
    free: Sequence[int],
    k: int,
    single_order: Sequence[int],
    *,
    binder: Callable = bind_ours,
    binder_kwargs: Optional[dict] = None,
    max_candidates: int = 64,
    backend: str = "auto",
    chip_state=None,
    rate_scale=None,
    device=None,
) -> SubsetScores:
    """Score every candidate k-subset of the free tiles in ONE batched call.

    The virtual binding and the Lemma-1 projected per-tile orders depend
    only on ``k``, so they are computed once; candidates differ in which
    physical tiles the virtual tiles land on — i.e. purely in NoC delays —
    which is exactly a stack of edge-weight arrays over a shared topology.

    ``chip_state``/``rate_scale`` score the candidates under run-time
    degradation (throttled routes, drifted spike rates; see
    :func:`~repro_torch.core.engine.batch_execute`) — callers must already have
    excluded dead tiles from ``free``.  ``backend``/``device`` select the
    analysis (see :func:`~repro_torch.core.engine.batch_execute`).
    """
    subsets = candidate_subsets(free, k, max_candidates=max_candidates)
    sub_hw = dataclasses.replace(hw, n_tiles=k)
    kwargs = binder_kwargs or {}
    try:
        bres = binder(clustered, sub_hw, **kwargs)
    except TypeError:  # binders without the kwargs (spinemap)
        bres = binder(clustered, sub_hw)
    virt_orders = project_order(list(single_order), bres.binding, k)

    # one (B, n_clusters) binding matrix + ONE vectorized Lemma-1
    # projection (OrderBatch): the engine builds the candidate EdgeStack
    # directly — no per-candidate SDFG objects, no per-candidate order
    # lists, no per-candidate §4.4 transformation in Python.  Projecting
    # the single order under each candidate's physical binding yields
    # exactly the virtual per-tile sequences relabeled onto the subset.
    app_g = sdfg_from_clusters(clustered, hw=hw)
    phys_bindings = np.asarray(subsets, dtype=np.int64)[:, bres.binding]
    orders = project_order_batch(list(single_order), phys_bindings)
    rep = batch_execute(
        app_g, phys_bindings, hw, orders, backend=backend, with_energy=True,
        chip_state=chip_state, rate_scale=rate_scale, device=device,
    )
    return SubsetScores(
        subsets=subsets,
        throughputs=rep.throughputs,
        binding=bres.binding,
        virt_orders=virt_orders,
        energies=rep.energies,
    )
