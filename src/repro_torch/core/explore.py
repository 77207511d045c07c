"""Run-time tile-subset scoring for admission (the slice of the
reference's design-space exploration that admission uses).

:func:`score_free_tile_subsets` scores every candidate k-subset of the
currently-free tiles in one batched engine call (used by
:func:`repro_torch.core.runtime.runtime_admit`).  The rest of the
reference's ``explore.py`` (``sweep``, ``build_candidates``) is not part of
this slice.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional, Sequence

import numpy as np

from .binding import bind_ours
from .engine import batch_execute, project_order_batch
from .hardware import HardwareConfig
from .partition import ClusteredSNN
from .runtime import project_order
from .sdfg import sdfg_from_clusters


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
