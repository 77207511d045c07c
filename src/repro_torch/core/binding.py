"""Cluster-to-tile binding strategies (paper §4.2, §6.3).

Three strategies are evaluated, mirroring the paper:

  * :func:`bind_ours`     — Eq. 7 weighted load + std-dev-reducing pairwise
    swaps (the paper's proposed load balancer).
  * :func:`bind_pycarl`   — PyCARL [5]: balance tile load greedily (largest
    load first onto least-loaded tile); random execution order downstream.
  * :func:`bind_spinemap` — SpiNeMap [8]: minimize inter-tile spike traffic
    with Kernighan-Lin-style swaps; ignores load balance.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .hardware import HardwareConfig
from .partition import ClusteredSNN


@dataclasses.dataclass(frozen=True)
class LoadWeights:
    """User constants (a, b, c, d) of Eq. 7."""

    crossbar: float = 1.0
    buffer: float = 1.0
    connection: float = 1.0
    bandwidth: float = 1.0


@dataclasses.dataclass
class BindingResult:
    binding: np.ndarray          # (n_clusters,) tile id
    bind_time_s: float
    strategy: str

    def clusters_per_tile(self, n_tiles: int) -> np.ndarray:
        return np.bincount(self.binding, minlength=n_tiles)


def _cluster_loads(c: ClusteredSNN, w: LoadWeights, hw: HardwareConfig) -> np.ndarray:
    """Scalar Eq.-7 load per cluster (normalized per-resource)."""
    xbar = hw.tile.crossbar
    conn = c.channel_degree().astype(np.float64)
    return (
        w.crossbar * (c.inputs_used + c.neurons_used) / (xbar.inputs + xbar.outputs)
        + w.buffer * c.out_spikes / hw.tile.output_buffer
        + w.connection * conn / max(conn.max(initial=1.0), 1.0)
        + w.bandwidth
        * (c.in_spikes + c.out_spikes)
        / max((c.in_spikes + c.out_spikes).max(initial=1.0), 1.0)
    )


def bind_ours(
    c: ClusteredSNN,
    hw: HardwareConfig,
    *,
    weights: LoadWeights = LoadWeights(),
    max_pass: int = 4,
    rng_seed: int = 0,
) -> BindingResult:
    """Eq. 7 load balancing with std-dev-reducing pairwise swaps.

    Swapping clusters i (tile ti, load li) and j (tile tj, load lj) changes
    the sum of squared tile loads by ``2 (lj - li) (a_i - a_j)`` where
    ``a_x = tile_load[t_x] - l_x`` is the residual load of x's tile — so
    one (n, n) outer-product evaluates every candidate swap at once.  Each
    round applies a greedy batch of improving swaps (deltas re-validated
    against the live tile loads before each application, preserving the
    sequential-sweep semantics); ``max_pass`` bounds the rounds.  For very
    large n the full matrix is replaced by a random pair sample, matching
    the old sampled-sweep bound.
    """
    t0 = time.perf_counter()
    loads = _cluster_loads(c, weights, hw)
    n_tiles = hw.n_tiles

    # even initial distribution (round-robin over load-sorted clusters)
    order = np.argsort(loads)[::-1]
    binding = np.empty(c.n_clusters, dtype=np.int64)
    binding[order] = np.arange(c.n_clusters) % n_tiles

    tile_load = np.bincount(binding, weights=loads, minlength=n_tiles)

    rng = np.random.default_rng(rng_seed)
    n = c.n_clusters
    for _ in range(max_pass):
        std = tile_load.std()
        resid = tile_load[binding] - loads          # (n,) a_x
        if n * n <= 4_000_000:
            delta = 2.0 * (loads[None, :] - loads[:, None]) * (
                resid[:, None] - resid[None, :]
            )
            delta[binding[:, None] == binding[None, :]] = 0.0
            delta = np.triu(delta, k=1)             # (i, j) once, i < j
            flat = delta.ravel()
            cand = np.flatnonzero(flat < -1e-12)
            if cand.size > 4 * n:                   # best 4n swaps per round
                cand = cand[np.argpartition(flat[cand], 4 * n)[: 4 * n]]
            cand = cand[np.argsort(flat[cand], kind="stable")]
            pairs = np.stack([cand // n, cand % n], axis=1)
        else:                                       # sampled-sweep bound
            idx = rng.integers(0, n, size=(250_000, 2))
            delta = 2.0 * (loads[idx[:, 1]] - loads[idx[:, 0]]) * (
                resid[idx[:, 0]] - resid[idx[:, 1]]
            )
            delta[binding[idx[:, 0]] == binding[idx[:, 1]]] = 0.0
            cand = np.flatnonzero(delta < -1e-12)
            pairs = idx[cand[np.argsort(delta[cand], kind="stable")]]
        improved = False
        for i, j in pairs:
            ti, tj = binding[i], binding[j]
            if ti == tj:
                continue
            li, lj = loads[i], loads[j]
            # re-validate against the live tile loads (stale deltas skip)
            if (lj - li) * (tile_load[ti] - li - tile_load[tj] + lj) < -1e-12:
                tile_load[ti] += lj - li
                tile_load[tj] += li - lj
                binding[i], binding[j] = tj, ti
                improved = True
        if not improved or std - tile_load.std() < 1e-12:
            break
    return BindingResult(binding, time.perf_counter() - t0, "ours")


def lpt_assign(loads: np.ndarray, n_tiles: int) -> np.ndarray:
    """Longest-processing-time greedy: heaviest load onto the least-loaded
    tile.  ``loads`` is (n,) per-cluster load (any unit); returns (n,)
    int64 tile ids.  Shared by :func:`bind_pycarl` (Eq.-7 loads) and the
    optimizer's tau-balanced start."""
    binding = np.empty(loads.size, dtype=np.int64)
    tile_load = np.zeros(n_tiles)
    for i in np.argsort(loads, kind="stable")[::-1]:
        t = int(np.argmin(tile_load))
        binding[i] = t
        tile_load[t] += loads[i]
    return binding


def bind_pycarl(
    c: ClusteredSNN,
    hw: HardwareConfig,
    *,
    weights: LoadWeights = LoadWeights(),
) -> BindingResult:
    """PyCARL: greedy load balance (LPT), random order downstream."""
    t0 = time.perf_counter()
    binding = lpt_assign(_cluster_loads(c, weights, hw), hw.n_tiles)
    return BindingResult(binding, time.perf_counter() - t0, "pycarl")


def bind_spinemap(
    c: ClusteredSNN,
    hw: HardwareConfig,
    *,
    max_pass: int = 4,
    rng_seed: int = 0,
    balance_factor: float = 1.5,
) -> BindingResult:
    """SpiNeMap: minimize inter-tile spikes (KL-style single moves).

    The affinity matrix ``W[x, t]`` (spike traffic between cluster x and
    the clusters currently bound to tile t, shape (n_clusters, n_tiles))
    makes every move gain a row lookup: moving x from its own tile to t
    changes the cut by ``W[x, own] - W[x, t]``.  W is built once per
    binding (one scatter-add over the channel arrays) and updated
    incrementally per accepted move (O(degree) scatter on x's neighbors),
    replacing the per-cluster O(E) channel scans — the sequential KL
    semantics are unchanged.

    Balance cap: a move onto tile t is admitted only while t's accumulated
    Eq.-7 *load* stays within ``balance_factor`` x the mean tile load
    (the previous cap bounded cluster *counts*, which let a few heavy
    clusters pile onto one tile).
    """
    t0 = time.perf_counter()
    n, n_tiles = c.n_clusters, hw.n_tiles
    rng = np.random.default_rng(rng_seed)

    # adjacency (symmetric spike traffic between cluster pairs)
    src, dst, spk = c.channel_src, c.channel_dst, c.channel_rate

    # seed: contiguous ranges (clusters are index-ordered along layers, so
    # this already groups communicating clusters together)
    binding = (np.arange(n) * n_tiles // max(n, 1)).astype(np.int64)

    # symmetric neighbor lists (both channel directions), CSR by cluster
    nbr_of = np.concatenate([src, dst])
    nbrs = np.concatenate([dst, src])
    wts = np.concatenate([spk, spk])
    order = np.argsort(nbr_of, kind="stable")
    nbr_of, nbrs, wts = nbr_of[order], nbrs[order], wts[order]
    starts = np.searchsorted(nbr_of, np.arange(n), side="left")
    ends = np.searchsorted(nbr_of, np.arange(n), side="right")

    # W[x, t] = spike traffic between x and tile t under `binding`
    aff = np.zeros((n, n_tiles))
    np.add.at(aff, (nbr_of, binding[nbrs]), wts)

    loads = _cluster_loads(c, LoadWeights(), hw)
    tile_load = np.bincount(binding, weights=loads, minlength=n_tiles)
    cap = balance_factor * loads.sum() / n_tiles   # Eq.-7 load cap
    for _ in range(max_pass):
        improved = False
        for x in rng.permutation(n)[: min(n, 2000)]:
            own = int(binding[x])
            gains = aff[x] - aff[x, own]           # cut reduction per tile
            gains[own] = 0.0
            t = int(np.argmax(gains))
            if gains[t] > 1e-9 and tile_load[t] + loads[x] <= cap:
                e = slice(starts[x], ends[x])
                np.add.at(aff, (nbrs[e], np.full(ends[x] - starts[x], own)),
                          -wts[e])
                np.add.at(aff, (nbrs[e], np.full(ends[x] - starts[x], t)),
                          wts[e])
                tile_load[own] -= loads[x]
                tile_load[t] += loads[x]
                binding[x] = t
                improved = True
        if not improved:
            break
    return BindingResult(binding, time.perf_counter() - t0, "spinemap")


def cut_spikes(c: ClusteredSNN, binding: np.ndarray) -> float:
    """Total inter-tile spike traffic of a binding (SpiNeMap's objective)."""
    binding = np.asarray(binding)
    cut = binding[c.channel_src] != binding[c.channel_dst]
    return float(c.channel_rate[cut].sum())


def cut_spikes_batch(c: ClusteredSNN, bindings) -> np.ndarray:
    """Inter-tile spike traffic of a whole (B, n_clusters) binding batch.

    Vectorized :func:`cut_spikes`: one (B, n_channels) gather over the
    clustered SNN's parallel channel arrays scores every row at once (a
    single (n_clusters,) binding is promoted to B=1).  Returns (B,)
    spikes crossing tile boundaries per application iteration — the
    SpiNeMap objective and the AER-encode term of the chip energy model.
    """
    bindings = np.asarray(bindings, dtype=np.int64)
    if bindings.ndim == 1:
        bindings = bindings[None, :]
    cut = bindings[:, c.channel_src] != bindings[:, c.channel_dst]
    return cut.astype(np.float64) @ c.channel_rate
