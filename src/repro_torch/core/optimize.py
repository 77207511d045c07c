"""Throughput-in-the-loop binding optimization (closing the §4.2 loop).

The paper's binder balances the Eq.-7 load *proxy* and only afterwards
checks throughput; DFSynthesizer and SpiNeMap likewise optimize proxies
(load spread, cut traffic).  With the batched engine, the *real* objective
is cheap enough to sit inside the search loop: one
:func:`~repro_torch.core.engine.batch_execute` call scores a whole population of
candidate bindings — exact steady-state periods of every candidate's
order-augmented event graph — so cluster-to-tile assignment becomes a
population-based search over (B, n_clusters) binding matrices:

  * generation = ONE EdgeStack build + ONE batched lambda-search (no
    per-candidate SDFG objects, exactly like
    :func:`~repro_torch.core.explore.score_free_tile_subsets`),
  * proposals = the three §4.2/§6.3 heuristic binders as seeds, then
    vectorized pairwise swaps, single-cluster moves, uniform crossover,
    and two guided mutation families — bottleneck-tile moves (serialized
    compute) and comm-critical-path moves (co-locate the heaviest cut
    channel's endpoints, the NoC-bound counterpart),
  * schedules = ONE batched Lemma-1 projection of the design-time
    single-tile order (:func:`~repro_torch.core.engine.project_order_batch`),
    so every scored configuration is deadlock-free and no per-candidate
    Python runs between proposal and scoring,
  * the last build re-scores the elite archive TOGETHER WITH the heuristic
    seeds at exact tolerance and takes the argmin — the result is never
    worse than any seed *by construction*, not by luck.

:func:`bind_optimized` adapts the optimizer to the binders' common
``(clustered, hw) -> BindingResult`` signature (strategy ``"optimized"``).

The scoring path is the batched chip-objective layer: every generation's
single :func:`~repro_torch.core.engine.batch_execute` call returns per-candidate
(period, chip energy, NoC traffic) from the same stacked arrays
(``with_energy=True`` — the accumulators ride the EdgeStack build's own
hop pass).  ``objective`` selects what the search optimizes:

  * ``"period"`` — elites ranked by period;
  * ``"energy"`` — elites ranked by chip energy (pJ/iteration);
  * ``"pareto"`` — the breeding trajectory stays period-ranked (bit-for-bit
    the ``"period"`` trajectory, same rng stream), while an epsilon-Pareto
    archive additionally collects every generation's non-dominated
    (period, energy) rows.  Because the final exact re-score pool is then a
    SUPERSET of the ``"period"`` pool, the reported best period can only be
    equal or better at equal budget — the never-worse-on-period invariant
    holds by construction, and the exact Pareto front comes for free.

The search core, :func:`optimize_binding_graph`, is graph-level (any
:class:`~repro_torch.core.sdfg.SDFG` + explicit seeds).  Every generation's
scoring runs on ``device`` (``backend="auto"``: the exact ``"csr"``
search); the proposals stay numpy with the reference's ``default_rng``
stream, so a run that scores with ``backend="edges"`` reproduces the
reference's trajectory bit for bit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from .binding import (
    BindingResult,
    LoadWeights,
    bind_ours,
    bind_pycarl,
    bind_spinemap,
    lpt_assign,
)
from .engine import (
    batch_execute,
    batch_execute_fused,
    prepare_execution,
    project_order_batch,
)
from .hardware import ChipState, HardwareConfig
from .partition import ClusteredSNN
from .runtime import single_tile_order
from .sdfg import SDFG, sdfg_from_clusters

_SEED_BINDERS = {
    "ours": lambda c, hw, w: bind_ours(c, hw, weights=w),
    "pycarl": lambda c, hw, w: bind_pycarl(c, hw, weights=w),
    "spinemap": lambda c, hw, w: bind_spinemap(c, hw),
}


@dataclasses.dataclass(frozen=True)
class GenerationStat:
    """Progress of one optimizer generation.

    ``best_period``/``mean_period`` are steady-state iteration periods in
    the model's time unit (microseconds), ``best_energy``/``mean_energy``
    chip energies (pJ per iteration), all scored at the *search* tolerance
    (``score_rel_tol``); ``wall_s`` is the generation's wall-clock seconds
    (proposal + one batched scoring call).
    """

    generation: int
    best_period: float
    mean_period: float
    wall_s: float
    best_energy: float = float("nan")
    mean_energy: float = float("nan")


@dataclasses.dataclass(frozen=True)
class ParetoPoint:
    """One exact point of the (period, energy) Pareto front.

    ``binding`` is a (n_clusters,) int64 tile assignment; ``period`` its
    exact steady-state iteration period (microseconds) and ``energy`` its
    chip energy (pJ per iteration), both re-scored at ``final_rel_tol``.
    Fronts are sorted by ascending period (hence descending energy).
    """

    binding: np.ndarray
    period: float
    energy: float


@dataclasses.dataclass
class OptimizeReport:
    """Result of :func:`optimize_binding` / :func:`optimize_binding_graph`.

    ``binding`` is the best (n_clusters,) tile assignment found under
    ``objective`` — argmin period for ``"period"``/``"pareto"``, argmin
    chip energy for ``"energy"`` — with ``period`` (microseconds) and
    ``energy`` (pJ per iteration) its exact scores at ``final_rel_tol``.
    ``seed_periods``/``seed_energies`` hold the seeds' exact scores from
    the SAME final scoring batch, so the result is never worse than any
    seed on the objective metric by construction.  ``front`` is the exact
    (period, energy) Pareto front of the final scoring pool (non-empty
    for every objective; richest under ``"pareto"``, whose archive keeps
    each generation's epsilon-non-dominated rows).  ``history`` records
    per-generation progress; ``n_stack_builds`` counts EdgeStack builds
    (= generations + 1: one per generation plus the final exact
    re-score).
    """

    binding: np.ndarray                 # (n_clusters,) int64 tile ids
    period: float                       # microseconds
    seed_periods: dict[str, float]      # strategy -> exact period (us)
    history: list[GenerationStat]
    n_stack_builds: int
    opt_time_s: float
    population: int
    generations: int
    rng_seed: int
    objective: str = "period"
    energy: float = float("inf")        # pJ per iteration
    seed_energies: dict[str, float] = dataclasses.field(default_factory=dict)
    front: list[ParetoPoint] = dataclasses.field(default_factory=list)

    @property
    def throughput(self) -> float:
        """Iterations per microsecond (1 / period); 0.0 for a dead graph."""
        if self.period <= 0 or not np.isfinite(self.period):
            return 0.0
        return 1.0 / self.period

    @property
    def best_seed_period(self) -> float:
        """Exact period of the best heuristic seed (microseconds)."""
        return min(self.seed_periods.values())

    @property
    def best_seed_energy(self) -> float:
        """Exact chip energy of the most frugal seed (pJ per iteration)."""
        return min(self.seed_energies.values())

    @property
    def improvement(self) -> float:
        """Fractional period reduction vs the best heuristic seed.

        0.05 means the optimized binding's steady-state period is 5%
        shorter than the best of ours/pycarl/spinemap; >= 0 always for
        the ``"period"``/``"pareto"`` objectives.
        """
        best = self.best_seed_period
        if best <= 0 or not np.isfinite(best):
            return 0.0
        return (best - self.period) / best

    def as_binding_result(self) -> BindingResult:
        """Adapt to the :class:`~repro_torch.core.binding.BindingResult` API."""
        return BindingResult(self.binding, self.opt_time_s, "optimized")


def _mutate(pop: np.ndarray, rng, tiles: np.ndarray, *, swaps: int, moves: int) -> None:
    """In-place vectorized mutation of a (B, n) binding population.

    ``swaps`` rounds of pairwise assignment swaps (two random clusters per
    row exchange tiles — preserves per-tile counts) and ``moves`` rounds of
    single-cluster moves (one random cluster per row to a random tile
    drawn from ``tiles``, the allowed physical tile ids).
    """
    b, n = pop.shape
    rows = np.arange(b)
    for _ in range(swaps):
        i = rng.integers(0, n, size=b)
        j = rng.integers(0, n, size=b)
        pi = pop[rows, i].copy()
        pop[rows, i] = pop[rows, j]
        pop[rows, j] = pi
    for _ in range(moves):
        k = rng.integers(0, n, size=b)
        t = tiles[rng.integers(0, tiles.size, size=b)]
        pop[rows, k] = t


def _tile_tau_sums(pop: np.ndarray, tau: np.ndarray, n_tiles: int) -> np.ndarray:
    """(B, n_tiles) per-row serialized compute time per tile.

    Each tile's TDMA order cycle forces its actors to fire once per
    iteration back-to-back, so the row's period is at least the row's max
    tile sum — the bottleneck the guided mutations attack.
    """
    b, n = pop.shape
    sums = np.zeros((b, n_tiles))
    np.add.at(
        sums,
        (np.repeat(np.arange(b), n), pop.ravel()),
        np.broadcast_to(tau, (b, n)).ravel(),
    )
    return sums


def _pick_on_tile(pop: np.ndarray, tiles: np.ndarray, rng) -> np.ndarray:
    """(B,) one uniformly-random cluster index per row among those bound to
    ``tiles[row]``.  An empty tile yields an arbitrary cluster — callers
    must mask those rows out before acting on the pick."""
    keys = rng.random(pop.shape) + (pop != tiles[:, None]) * 10.0
    return keys.argmin(axis=1)


def _guided_mutate(
    pop: np.ndarray, tau: np.ndarray, n_tiles: int, tiles: np.ndarray, rng
) -> None:
    """In-place bottleneck-directed mutation of a (B, n) population.

    Per row: find the heaviest allowed tile (max serialized compute, the
    order cycle that lower-bounds the period) and either MOVE a random
    cluster from it to the lightest allowed tile, or SWAP random clusters
    between the heaviest and lightest tiles — hill-climbing steps on the
    dominant term of the objective that blind swaps rarely sample at
    large n.  The swap branch is skipped for rows whose lightest tile is
    empty (there is nothing to swap back, and the pick would land on the
    bottleneck).  ``tiles`` restricts the heavy/light search to the
    allowed physical tile ids.
    """
    b, n = pop.shape
    rows = np.arange(b)
    sums = _tile_tau_sums(pop, tau, n_tiles)[:, tiles]
    heavy = tiles[sums.argmax(axis=1)]
    light = tiles[sums.argmin(axis=1)]
    a = _pick_on_tile(pop, heavy, rng)
    do_swap = rng.random(b) < 0.5
    do_swap &= (pop == light[:, None]).any(axis=1)
    c = _pick_on_tile(pop, light, rng)
    pop[rows, a] = light
    swap_rows = rows[do_swap]
    pop[swap_rows, c[do_swap]] = heavy[do_swap]




def _comm_guided_mutate(
    pop: np.ndarray,
    ch_src: np.ndarray,
    ch_dst: np.ndarray,
    ch_rate: np.ndarray,
    hw: HardwareConfig,
    rng,
) -> None:
    """In-place comm-critical-path mutation of a (B, n) binding population.

    Per row: find the heaviest *cut* channel — spike rate x current NoC hop
    count, the dominant term of the Eq.-3 comm delay — and co-locate its
    endpoints by moving one endpoint's cluster onto the other endpoint's
    tile (direction chosen at random; the target tile already hosts a
    cluster of the row, so allowed-tile subsets are preserved).  This is
    the NoC-bound counterpart of :func:`_guided_mutate`: where that one
    attacks the serialized-compute order cycle, this one attacks the
    longest communication dependency.  Rows with every channel co-located
    are left untouched.
    """
    if ch_src.size == 0:
        return
    b = pop.shape[0]
    rows = np.arange(b)
    hops = hw.hops_array(pop[:, ch_src], pop[:, ch_dst])
    w = ch_rate[None, :] * hops
    j = w.argmax(axis=1)
    has = w[rows, j] > 0
    to_src = rng.random(b) < 0.5
    movers = np.where(to_src, ch_dst[j], ch_src[j])
    targets = pop[rows, np.where(to_src, ch_src[j], ch_dst[j])]
    pop[rows[has], movers[has]] = targets[has]


def _dedup_rows(rows: np.ndarray) -> np.ndarray:
    """Unique rows of a (B, n) int matrix, first occurrence kept, in order."""
    seen: set[bytes] = set()
    keep = []
    for r, row in enumerate(rows):
        key = row.tobytes()
        if key not in seen:
            seen.add(key)
            keep.append(r)
    return rows[np.asarray(keep)]


def _epsilon_front(
    periods: np.ndarray, energies: np.ndarray, eps: float = 1e-3
) -> np.ndarray:
    """Indices of the epsilon-non-dominated (period, energy) rows.

    Rows sorted by ascending (period, energy) are swept keeping those
    whose energy improves the running best by more than a relative
    ``eps`` (``eps=0`` gives the exact front: strictly lower energy at
    higher-or-equal period; the energy tiebreak ensures a period tie
    keeps only its minimum-energy row).  Dead rows (non-finite period or
    energy) never qualify.  Returns row indices in ascending-period
    order; epsilon thinning bounds the archive the pareto objective
    accumulates across generations.
    """
    periods = np.asarray(periods, dtype=np.float64)
    energies = np.asarray(energies, dtype=np.float64)
    keep: list[int] = []
    best_e = np.inf
    for i in np.lexsort((energies, periods)):
        p, e = periods[i], energies[i]
        if not (np.isfinite(p) and p > 0 and np.isfinite(e)):
            continue
        if not keep or e < best_e * (1.0 - eps):
            keep.append(int(i))
            best_e = e
    return np.asarray(keep, dtype=np.int64)


_OBJECTIVES = ("period", "energy", "pareto")


class _BindingSearch:
    """Stepwise engine of :func:`optimize_binding_graph` (ask/tell form).

    Holds the whole evolutionary state — population, elite archive, rng
    stream, history — and exposes it one *scoring request* at a time:
    :meth:`ask` returns the next (pop, rel_tol) batch to score,
    :meth:`tell` consumes the scores and breeds the next generation (or
    finalizes).  Driven by :func:`optimize_binding_graph` one search at a
    time, or by :func:`optimize_binding_graphs_fused` with MANY searches
    in lockstep so each tick's scoring requests fuse into a single
    analysis call.  The rng draw order and scoring batch contents are
    bit-for-bit the reference's, so a single-search drive reproduces
    :func:`optimize_binding_graph` exactly.
    """

    def __init__(
        self,
        app: SDFG,
        hw: HardwareConfig,
        single_order: Sequence[int],
        *,
        seed_bindings: dict[str, np.ndarray],
        channel_src: Optional[np.ndarray] = None,
        channel_dst: Optional[np.ndarray] = None,
        channel_rate: Optional[np.ndarray] = None,
        population: int = 64,
        generations: int = 8,
        elite: int = 8,
        rng_seed: int = 0,
        allowed_tiles: Optional[Sequence[int]] = None,
        objective: str = "period",
        period_floor: float = float("-inf"),
        score_rel_tol: float = 1e-4,
        final_rel_tol: float = 1e-8,
        chip_state: Optional[ChipState] = None,
        rate_scale=None,
    ):
        _validate_budget(population, generations, objective)
        self.app, self.hw = app, hw
        self.population, self.generations = population, generations
        self.elite = min(max(1, elite), population)
        self.rng_seed, self.objective = rng_seed, objective
        self.period_floor = period_floor
        self.score_rel_tol, self.final_rel_tol = score_rel_tol, final_rel_tol
        self.chip_state, self.rate_scale = chip_state, rate_scale
        n, n_tiles = app.n_actors, hw.n_tiles
        self.tiles = tiles = (
            np.arange(n_tiles, dtype=np.int64) if allowed_tiles is None
            else np.asarray(sorted(allowed_tiles), dtype=np.int64)
        )
        assert tiles.size >= 1 and tiles.min() >= 0 and tiles.max() < n_tiles, (
            f"allowed_tiles must be distinct ids in [0, {n_tiles}), got {tiles}"
        )
        assert seed_bindings, "need at least one seed binding"
        self.t0 = time.perf_counter()
        self.rng = rng = np.random.default_rng(rng_seed)
        self.single_order = list(single_order)
        self.ch_src = np.asarray(
            channel_src if channel_src is not None else [], dtype=np.int64
        )
        self.ch_dst = np.asarray(
            channel_dst if channel_dst is not None else [], dtype=np.int64
        )
        self.ch_rate = np.asarray(
            channel_rate if channel_rate is not None else [], dtype=np.float64
        )
        self.seed_bindings = seed_bindings
        for name, b in seed_bindings.items():
            assert np.isin(b, tiles).all(), (
                f"seed {name!r} uses tiles outside the allowed set"
            )
        self.seed_mat = seed_mat = np.stack(
            [np.asarray(b, dtype=np.int64) for b in seed_bindings.values()]
        )

        # -- generation 0: seeds + LPT start + mutated seeds + immigrants
        # tau-LPT balances serialized compute directly — a strong start
        # the Eq.-7 binders don't produce (their load mixes buffer/
        # bandwidth terms)
        tau_lpt = tiles[lpt_assign(app.exec_time, int(tiles.size))]
        starts = _dedup_rows(np.concatenate([seed_mat, tau_lpt[None, :]]))
        pop = np.empty((population, n), dtype=np.int64)
        n_start = min(starts.shape[0], population)
        pop[:n_start] = starts[:n_start]
        n_rand = max(0, (population - n_start) // 8)
        fill = population - n_start - n_rand
        if fill > 0:
            children = starts[
                rng.integers(0, starts.shape[0], size=fill)
            ].copy()
            half = fill // 2
            if half:
                blk = children[:half]
                _guided_mutate(blk, app.exec_time, n_tiles, tiles, rng)
                children[:half] = blk
            blk = children[half:]
            _mutate(blk, rng, tiles, swaps=1, moves=1)
            children[half:] = blk
            pop[n_start : n_start + fill] = children
        if n_rand > 0:
            pop[population - n_rand :] = tiles[
                rng.integers(0, tiles.size, size=(n_rand, n))
            ]
        self.pop = pop

        self.history: list[GenerationStat] = []
        # best-ever rows; re-ranked exactly at the end
        self.archive = seed_mat.copy()
        self.n_builds = 0
        self.gen = 0
        self.final_pool: Optional[np.ndarray] = None
        self._report: Optional[OptimizeReport] = None
        self._t_gen = 0.0

    @property
    def done(self) -> bool:
        """True once :meth:`report` is available."""
        return self._report is not None

    def ask(self) -> tuple[np.ndarray, float]:
        """The next binding batch to score and its period tolerance."""
        assert not self.done, "search already finalized"
        if self.final_pool is not None:
            return self.final_pool, self.final_rel_tol
        self._t_gen = time.perf_counter()
        return self.pop, self.score_rel_tol

    def tell(self, periods: np.ndarray, energies: np.ndarray) -> None:
        """Consume the scores of the last :meth:`ask` batch."""
        assert not self.done, "search already finalized"
        self.n_builds += 1
        if self.final_pool is not None:
            self._finalize(periods, energies)
            return
        pop, rng, elite = self.pop, self.rng, self.elite
        population, n = self.population, self.app.n_actors
        # breeding elites: ranked by energy for the energy objective,
        # by period otherwise — the pareto trajectory is bit-for-bit the
        # period trajectory (same elites, same rng stream); what differs
        # is the archive below.  A finite period_floor clamps the ranking
        # key (chip-wide, sub-floor periods are equivalent); the -inf
        # default leaves the ranking bit-for-bit unchanged.
        key = (
            energies if self.objective == "energy"
            else np.maximum(periods, self.period_floor)
        )
        rank = np.argsort(key, kind="stable")
        elites = pop[rank[:elite]]

        # fold this generation's elites into the best-ever archive; the
        # pareto objective additionally keeps the epsilon-non-dominated
        # rows, so minimum-energy and knee candidates survive into the
        # final exact re-score alongside the period-only elites
        self.archive = _dedup_rows(np.concatenate([self.archive, elites]))
        if self.objective == "pareto":
            front_rows = pop[_epsilon_front(periods, energies)]
            self.archive = _dedup_rows(
                np.concatenate([self.archive, front_rows])
            )
        finite_p = np.isfinite(periods)
        finite_e = np.isfinite(energies)
        self.history.append(GenerationStat(
            generation=self.gen,
            best_period=float(periods.min()),
            mean_period=float(np.mean(periods[finite_p])) if finite_p.any()
            else float("inf"),
            wall_s=time.perf_counter() - self._t_gen,
            best_energy=float(energies.min()),
            mean_energy=float(np.mean(energies[finite_e])) if finite_e.any()
            else float("inf"),
        ))

        if self.gen == self.generations - 1:
            # -- final exact re-score pool: archive U seeds ------------
            self.final_pool = _dedup_rows(
                np.concatenate([self.seed_mat, self.archive])
            )
            return
        # -- next generation: elitism + crossover + guided/comm/blind
        nxt = np.empty_like(pop)
        nxt[:elite] = elites
        n_children = population - elite
        pa = elites[rng.integers(0, elite, size=n_children)]
        pb = elites[rng.integers(0, elite, size=n_children)]
        cross = rng.random((n_children, n)) < 0.5
        children = np.where(cross, pa, pb)
        # children split three ways: climb the bottleneck tile (guided
        # compute), co-locate the heaviest cut channel (guided comm — the
        # NoC-bound operating points AND the dominant chip-energy term),
        # or explore blindly; a heavy-mutation slice keeps diversity up
        u = rng.random(n_children)
        guided = u < 0.4
        comm = (u >= 0.4) & (u < 0.6)
        if guided.any():
            block = children[guided]
            _guided_mutate(
                block, self.app.exec_time, self.hw.n_tiles, self.tiles, rng
            )
            children[guided] = block
        if comm.any():
            block = children[comm]
            _comm_guided_mutate(
                block, self.ch_src, self.ch_dst, self.ch_rate, self.hw, rng
            )
            children[comm] = block
        blind = u >= 0.6
        if blind.any():
            block = children[blind]
            _mutate(block, rng, self.tiles, swaps=1, moves=1)
            children[blind] = block
        heavy = rng.random(n_children) < 0.2
        if heavy.any():
            block = children[heavy]
            _mutate(block, rng, self.tiles, swaps=2, moves=2)
            children[heavy] = block
        nxt[elite:] = children
        self.pop = nxt
        self.gen += 1

    def _finalize(
        self, final_periods: np.ndarray, final_energies: np.ndarray
    ) -> None:
        final_pool = self.final_pool
        if self.objective == "energy":
            best_row = int(np.argmin(final_energies))
        elif np.isfinite(self.period_floor):
            # chip-wide ranking: clamp at the rest-of-chip floor, break
            # the (common) floor ties toward lower chip energy, then
            # pool order
            clamped = np.maximum(final_periods, self.period_floor)
            best_row = int(np.lexsort((final_energies, clamped))[0])
        else:
            best_row = int(np.argmin(final_periods))
        front = [
            ParetoPoint(
                binding=final_pool[i].copy(),
                period=float(final_periods[i]),
                energy=float(final_energies[i]),
            )
            for i in _epsilon_front(final_periods, final_energies, eps=0.0)
        ]

        # seed scores from the same exact batch (rows 0..n_seeds-1 of
        # the deduped pool ARE the seeds, first occurrence kept)
        seed_periods: dict[str, float] = {}
        seed_energies: dict[str, float] = {}
        pool_index = {row.tobytes(): r for r, row in enumerate(final_pool)}
        for name, b in self.seed_bindings.items():
            r = pool_index[np.asarray(b, dtype=np.int64).tobytes()]
            seed_periods[name] = float(final_periods[r])
            seed_energies[name] = float(final_energies[r])

        self._report = OptimizeReport(
            binding=final_pool[best_row].copy(),
            period=float(final_periods[best_row]),
            seed_periods=seed_periods,
            history=self.history,
            n_stack_builds=self.n_builds,
            opt_time_s=time.perf_counter() - self.t0,
            population=self.population,
            generations=self.generations,
            rng_seed=self.rng_seed,
            objective=self.objective,
            energy=float(final_energies[best_row]),
            seed_energies=seed_energies,
            front=front,
        )

    def report(self) -> OptimizeReport:
        """The finished search's report (only valid once :attr:`done`)."""
        assert self._report is not None, "search not finished"
        return self._report


def _validate_budget(population: int, generations: int, objective: str) -> None:
    """Raise ValueError on an unusable search budget or unknown objective."""
    if population < 2 or generations < 1:
        raise ValueError(
            f"optimize budget must be >= 1 generation of >= 2 candidates, "
            f"got generations={generations}, population={population}"
        )
    if objective not in _OBJECTIVES:
        raise ValueError(
            f"unknown objective {objective!r}; have {_OBJECTIVES}"
        )


def optimize_binding_graph(
    app: SDFG,
    hw: HardwareConfig,
    single_order: Sequence[int],
    *,
    seed_bindings: dict[str, np.ndarray],
    channel_src: Optional[np.ndarray] = None,
    channel_dst: Optional[np.ndarray] = None,
    channel_rate: Optional[np.ndarray] = None,
    population: int = 64,
    generations: int = 8,
    elite: int = 8,
    rng_seed: int = 0,
    allowed_tiles: Optional[Sequence[int]] = None,
    objective: str = "period",
    period_floor: float = float("-inf"),
    score_rel_tol: float = 1e-4,
    final_rel_tol: float = 1e-8,
    backend: str = "auto",
    chip_state: Optional[ChipState] = None,
    rate_scale=None,
    mesh=None,
    device=None,
) -> OptimizeReport:
    """Graph-level search core: optimize actor-to-tile bindings of ``app``.

    The engine room of :func:`optimize_binding`, for any live
    :class:`~repro_torch.core.sdfg.SDFG` plus an explicit ``seed_bindings`` dict
    (name -> (n_actors,) physical tile ids, all inside ``allowed_tiles``)
    and a design-time ``single_order`` (total actor firing order, Lemma-1
    projected per candidate).  ``channel_src``/``channel_dst``/
    ``channel_rate`` are the spike-traffic arrays the comm-guided mutation
    attacks (omit for graphs without them — the mutation then no-ops).

    Each generation proposes a (``population``, n_actors) binding matrix
    and ranks it with ONE :func:`~repro_torch.core.engine.batch_execute` call
    (``with_energy=True`` — periods and chip energies from the same
    stacked arrays); after ``generations`` rounds, the archive plus all
    seeds are re-scored once at ``final_rel_tol``.  ``objective`` picks
    the ranking metric (see the module docstring): ``"pareto"`` keeps the
    period-ranked trajectory (identical evaluations to ``"period"`` under
    one ``rng_seed``) and additionally archives every generation's
    epsilon-non-dominated (period, energy) rows, so its final pool is a
    superset — never worse on period at equal budget, with the exact
    front reported for free.  The result is never worse than any seed on
    the objective metric by construction.  Deterministic for a fixed
    ``rng_seed``; ``elite`` is clamped to the population size.

    ``period_floor`` is the region-scoped placement's cheap stand-in for
    the rest of the chip: when this graph is a sub-union of the resident
    apps, the chip period is ``max(region period, rest-of-chip period)``,
    so candidates are *ranked* (and the final argmin taken) on
    ``max(period, period_floor)`` — pushing the region below the floor
    buys nothing chip-wide, and floor-ties break toward lower chip
    energy.  The reported ``period``/``seed_periods`` stay the exact
    unclamped sub-union periods.  The default ``-inf`` floor is a no-op
    (bit-for-bit the unclamped ranking).

    ``chip_state``/``rate_scale`` score every candidate under the chip's
    run-time degradation (throttled routes, drifted spike rates — see
    :func:`~repro_torch.core.engine.stack_hardware_aware`); candidates binding a
    dead tile score ``inf`` and lose naturally, but callers searching a
    degraded chip should pass alive-only ``allowed_tiles`` (and repaired
    seeds) so the search budget is not wasted on infeasible rows.

    ``backend``/``device`` select where each generation is scored (see
    :func:`~repro_torch.core.engine.batch_execute`).  ``mesh`` shards every
    generation's population scoring across the mesh devices
    (:func:`~repro_torch.core.engine.batch_execute`'s ``mesh=`` path):
    the per-row λ-search is bit-identical across any device count, so the
    search trajectory — history, elite, final binding — is identical to
    the unsharded one at the same ``rng_seed``.
    """
    search = _BindingSearch(
        app, hw, single_order,
        seed_bindings=seed_bindings,
        channel_src=channel_src, channel_dst=channel_dst,
        channel_rate=channel_rate,
        population=population, generations=generations, elite=elite,
        rng_seed=rng_seed, allowed_tiles=allowed_tiles,
        objective=objective, period_floor=period_floor,
        score_rel_tol=score_rel_tol, final_rel_tol=final_rel_tol,
        chip_state=chip_state, rate_scale=rate_scale,
    )
    while not search.done:
        # one vectorized Lemma-1 projection for the whole population: the
        # engine consumes the OrderBatch directly, so no per-candidate
        # Python runs between proposal and scoring (and the stacked shape
        # is generation-invariant — every scoring call is a compile-cache
        # hit after the first).  Energies ride the same stack build.
        pop, rel_tol = search.ask()
        orders = project_order_batch(single_order, pop)
        rep = batch_execute(
            app, pop, hw, orders, backend=backend, rel_tol=rel_tol,
            with_energy=True, chip_state=chip_state, rate_scale=rate_scale,
            mesh=mesh, device=device,
        )
        search.tell(*_alive_scores(rep))
    return search.report()


def _alive_scores(rep) -> tuple[np.ndarray, np.ndarray]:
    """Mask dead/acyclic rows (cannot happen for live apps, but stay safe)."""
    alive = np.isfinite(rep.periods) & (rep.periods > 0)
    return (
        np.where(alive, rep.periods, np.inf),
        np.where(alive, rep.energies, np.inf),
    )


def optimize_binding_graphs_fused(
    tasks: Sequence[dict],
    *,
    backend: str = "auto",
    mesh=None,
    device=None,
) -> list[OptimizeReport]:
    """Run MANY independent binding searches with FUSED scoring.

    ``tasks`` is a sequence of keyword dicts, each exactly the signature
    of :func:`optimize_binding_graph` minus ``backend``/``device``
    (positional ``app``/``hw``/``single_order`` under those keys).  The
    searches run their generations in lockstep: every tick gathers one
    scoring batch per unfinished search, builds each batch's EdgeStack
    independently (:func:`~repro_torch.core.engine.prepare_execution`),
    and solves them all in ONE fused
    :func:`~repro_torch.core.engine.batch_execute_fused` call on
    ``device`` — one λ-search's launches and host syncs per tick instead
    of one per region component per generation.  Each search's rng
    stream, scoring batches, and ranking are bit-for-bit those of its
    standalone :func:`optimize_binding_graph` run; only the analysis
    tolerance can be TIGHTER (the fused solve takes the min over its
    members).  Requests are fused per (tick, tolerance) group — mixing
    tolerances would solve some members TIGHTER than their standalone
    run and could reorder near-tie elites, breaking reproducibility —
    so a tick where every search is in the same phase (the common case:
    equal generation counts) is exactly one call.  Reports come back in
    task order.  ``mesh`` shards each fused solve's batch axis over the
    mesh devices (bit-identical — see :func:`optimize_binding_graph`).
    """
    searches = [
        _BindingSearch(
            t["app"], t["hw"], t["single_order"],
            **{
                k: v for k, v in t.items()
                if k not in ("app", "hw", "single_order")
            },
        )
        for t in tasks
    ]
    while True:
        live = [s for s in searches if not s.done]
        if not live:
            break
        groups: dict[float, tuple[list[_BindingSearch], list]] = {}
        for s in live:
            pop, rel_tol = s.ask()
            orders = project_order_batch(s.single_order, pop)
            prep = prepare_execution(
                s.app, pop, s.hw, orders, rel_tol=rel_tol,
                with_energy=True, chip_state=s.chip_state,
                rate_scale=s.rate_scale,
            )
            groups.setdefault(rel_tol, ([], []))
            groups[rel_tol][0].append(s)
            groups[rel_tol][1].append(prep)
        for rel_tol, (members, preps) in groups.items():
            reports = batch_execute_fused(
                preps, backend=backend, mesh=mesh, device=device)
            for s, rep in zip(members, reports):
                s.tell(*_alive_scores(rep))
    return [s.report() for s in searches]


def optimize_binding(
    clustered: ClusteredSNN,
    hw: HardwareConfig,
    *,
    single_order: Optional[Sequence[int]] = None,
    population: int = 64,
    generations: int = 8,
    elite: int = 8,
    rng_seed: int = 0,
    weights: LoadWeights = LoadWeights(),
    seeds: Sequence[str] = ("ours", "pycarl", "spinemap"),
    extra_seeds: Optional[Sequence[np.ndarray]] = None,
    allowed_tiles: Optional[Sequence[int]] = None,
    objective: str = "period",
    score_rel_tol: float = 1e-4,
    final_rel_tol: float = 1e-8,
    backend: str = "auto",
    chip_state: Optional[ChipState] = None,
    rate_scale=None,
    device=None,
) -> OptimizeReport:
    """Search cluster-to-tile bindings with the exact batched chip
    objective in the loop (the §4.2 decision driven by the §4.4 analysis
    itself).

    Each generation proposes a (``population``, n_clusters) binding matrix
    — heuristic seeds, elites, crossover children, vectorized swap/move
    mutants — projects the design-time ``single_order`` per candidate
    (Lemma 1, deadlock-free) and ranks the WHOLE population with one
    :func:`~repro_torch.core.engine.batch_execute` call returning per-candidate
    (period, chip energy, NoC traffic).  After ``generations`` rounds the
    elite archive plus all heuristic seeds are re-scored once at
    ``final_rel_tol`` and the argmin on the objective metric wins, which
    guarantees the result is never worse than any seed.

    ``objective`` is ``"period"`` (default — minimize the steady-state
    iteration period), ``"energy"`` (minimize chip energy per iteration,
    pJ) or ``"pareto"`` (period-driven search whose archive keeps the
    epsilon-non-dominated (period, energy) rows: never worse on period
    than ``objective="period"`` at equal budget by construction, and
    ``report.front`` carries the exact Pareto front).

    ``generations`` x ``population`` is the quality/latency budget knob
    (also surfaced by :func:`~repro_torch.core.runtime.runtime_admit` as
    ``optimize_budget``).  ``score_rel_tol`` is the looser intra-search
    ranking tolerance; periods in the report are exact to
    ``final_rel_tol``.  Deterministic for a fixed ``rng_seed``.

    ``single_order`` (total actor firing order from the 1-tile design-time
    schedule) is computed on demand when not supplied; pass it when the
    caller (admission, benchmarks) already has it cached.

    ``allowed_tiles`` restricts every candidate to a subset of physical
    tile ids (run-time admission on the free tiles): heuristic seeds are
    bound on a virtual |subset|-tile chip and relabeled onto the subset,
    while *scoring and search* use the real physical tile positions — the
    NoC distances of the actual subset, not the virtual adjacency.
    ``extra_seeds`` must already use allowed tile ids.

    ``elite`` is clamped to the population size, so small admission-time
    budgets like ``(2, 4)`` are valid without tuning it.  ``backend``/
    ``device`` select where candidates are scored.
    """
    _validate_budget(population, generations, objective)
    n_tiles = hw.n_tiles
    tiles = (
        np.arange(n_tiles, dtype=np.int64) if allowed_tiles is None
        else np.asarray(sorted(allowed_tiles), dtype=np.int64)
    )
    t0 = time.perf_counter()
    app = sdfg_from_clusters(clustered, hw=hw)
    if single_order is None:
        single_order, _ = single_tile_order(clustered, hw)

    # -- heuristic seeds (always part of the final comparison); bound on
    # a virtual |tiles|-tile chip, relabeled onto the physical subset ---
    seed_hw = dataclasses.replace(hw, n_tiles=int(tiles.size))
    seed_bindings: dict[str, np.ndarray] = {}
    for name in seeds:
        virt = _SEED_BINDERS[name](clustered, seed_hw, weights).binding
        seed_bindings[name] = tiles[np.asarray(virt, dtype=np.int64)]
    for k, b in enumerate(extra_seeds or []):
        b = np.asarray(b, dtype=np.int64)
        assert np.isin(b, tiles).all(), (
            f"extra seed {k} uses tiles outside the allowed set"
        )
        seed_bindings[f"extra{k}"] = b

    rep = optimize_binding_graph(
        app, hw, single_order,
        seed_bindings=seed_bindings,
        channel_src=clustered.channel_src,
        channel_dst=clustered.channel_dst,
        channel_rate=clustered.channel_rate,
        population=population,
        generations=generations,
        elite=elite,
        rng_seed=rng_seed,
        allowed_tiles=allowed_tiles,
        objective=objective,
        score_rel_tol=score_rel_tol,
        final_rel_tol=final_rel_tol,
        backend=backend,
        chip_state=chip_state,
        rate_scale=rate_scale,
        device=device,
    )
    rep.opt_time_s = time.perf_counter() - t0   # include seed-binder time
    return rep


def bind_optimized(
    c: ClusteredSNN,
    hw: HardwareConfig,
    *,
    weights: LoadWeights = LoadWeights(),
    population: int = 64,
    generations: int = 8,
    rng_seed: int = 0,
    **kwargs,
) -> BindingResult:
    """Throughput-optimized binding, as a drop-in §4.2 strategy.

    Strategy ``"optimized"``: same ``(clustered, hw) -> BindingResult``
    signature as ``bind_ours``/``bind_pycarl``/``bind_spinemap``.  Extra ``kwargs`` forward to
    :func:`optimize_binding` (budget, tolerance, seeds).
    """
    rep = optimize_binding(
        c, hw, weights=weights, population=population,
        generations=generations, rng_seed=rng_seed, **kwargs,
    )
    return rep.as_binding_result()
