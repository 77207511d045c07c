"""Parameterized synthetic SNN workloads (chip-scale stress tenants).

The eight Table-1 applications (:mod:`repro_torch.core.apps`) are single data
points; stressing a 1024-tile chip needs *hundreds* of tenants with the
same statistical character.  This module fits the Table-1 population —
layer topologies, synapses-per-neuron (fan-in) and per-iteration
spikes-per-neuron (firing rate) — and samples arbitrarily many tenants
from those distributions:

  * the layer SHAPE is drawn from the Table-1 topology templates (relative
    widths jittered multiplicatively, then scaled to the drawn neuron
    total), so the conv-style window sharing that Alg.-1 bin-packing
    exploits is preserved;
  * synapses-per-neuron and spikes-per-neuron are drawn log-normally with
    the log-mean/log-std of the Table-1 apps (both quantities span more
    than an order of magnitude across the eight apps, so a normal fit
    would be badly wrong);
  * the recurrence probability equals the Table-1 frequency (1/8).

``scale`` shrinks the neuron-count range without touching the per-neuron
distributions: a ``scale=0.1`` tenant is a statistically faithful
miniature, sized so hundreds fit a mesh at a few tiles each.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

from .apps import APP_SPECS
from .snn import SNN, calibrate_spikes, feedforward

__all__ = [
    "WorkloadSpec",
    "TABLE1_FIT",
    "sample_workload",
    "workload_suite",
    "FaultEvent",
    "failure_storm",
]


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Distribution parameters of a synthetic tenant population.

    ``neurons_range`` is sampled log-uniformly (the Table-1 neuron counts
    span 980..24732); ``syn_per_neuron`` / ``spikes_per_neuron`` are
    (log-mean, log-std) of log-normal draws; ``templates`` holds the
    relative layer-width shapes the topology is drawn from;
    ``width_jitter`` is the multiplicative layer-width noise (log-uniform
    in [1/j, j]); ``recurrent_p`` the probability of a feedback edge.
    """

    neurons_range: tuple[int, int]
    syn_per_neuron: tuple[float, float]      # (mu, sigma) of log
    spikes_per_neuron: tuple[float, float]   # (mu, sigma) of log
    templates: tuple[tuple[int, ...], ...]
    width_jitter: float = 1.3
    recurrent_p: float = 0.125
    min_syn_per_neuron: float = 4.0
    max_syn_per_neuron: float = 512.0


def _fit_table1() -> WorkloadSpec:
    """Log-space moment fit of the Table-1 application population."""
    specs = list(APP_SPECS.values())
    spn = np.array([s.synapses / s.neurons for s in specs])
    rate = np.array(
        [s.spikes / s.recorded_iters / s.neurons for s in specs]
    )
    return WorkloadSpec(
        neurons_range=(
            min(s.neurons for s in specs), max(s.neurons for s in specs)
        ),
        syn_per_neuron=(
            float(np.mean(np.log(spn))), float(np.std(np.log(spn)))
        ),
        spikes_per_neuron=(
            float(np.mean(np.log(rate))), float(np.std(np.log(rate)))
        ),
        templates=tuple(tuple(s.layer_shape) for s in specs),
        recurrent_p=sum(s.recurrent for s in specs) / len(specs),
    )


#: The Table-1 population fit (computed once at import; APP_SPECS is
#: frozen, so this is deterministic).
TABLE1_FIT: WorkloadSpec = _fit_table1()


def _sample_layers(
    rng: np.random.Generator, spec: WorkloadSpec, n_neurons: int
) -> list[int]:
    """Draw a layer topology: jittered template scaled to ``n_neurons``."""
    shape = np.asarray(
        spec.templates[int(rng.integers(len(spec.templates)))],
        dtype=np.float64,
    )
    jitter = np.exp(
        rng.uniform(
            -np.log(spec.width_jitter), np.log(spec.width_jitter),
            size=shape.size,
        )
    )
    shape = shape * jitter
    raw = shape * (n_neurons / shape.sum())
    widths = np.maximum(np.floor(raw).astype(np.int64), 2)
    # largest-remainder top-up to the exact neuron total
    rem = n_neurons - int(widths.sum())
    if rem > 0:
        order = np.argsort(raw - widths)[::-1]
        widths[order[np.arange(rem) % widths.size]] += 1
    elif rem < 0:
        order = np.argsort(raw - widths)
        k = 0
        while rem < 0:
            i = order[k % widths.size]
            if widths[i] > 2:
                widths[i] -= 1
                rem += 1
            k += 1
    return [int(w) for w in widths]


def sample_workload(
    seed_or_rng: Union[int, np.random.Generator],
    *,
    spec: WorkloadSpec = TABLE1_FIT,
    scale: float = 1.0,
    name: Optional[str] = None,
) -> SNN:
    """Sample ONE synthetic tenant from the fitted population.

    ``scale`` multiplies the neuron-count range (per-neuron fan-in and
    firing-rate distributions are scale-free); ``name`` defaults to a
    draw-derived identifier.  Deterministic given the seed / generator
    state.
    """
    rng = (
        seed_or_rng
        if isinstance(seed_or_rng, np.random.Generator)
        else np.random.default_rng(seed_or_rng)
    )
    lo, hi = spec.neurons_range
    lo = max(8, int(round(lo * scale)))
    hi = max(lo + 1, int(round(hi * scale)))
    n_neurons = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
    n_neurons = int(np.clip(n_neurons, lo, hi))
    layers = _sample_layers(rng, spec, n_neurons)
    mu, sg = spec.syn_per_neuron
    spn = float(
        np.clip(
            np.exp(rng.normal(mu, sg)),
            spec.min_syn_per_neuron, spec.max_syn_per_neuron,
        )
    )
    # cap at the topology's connectivity capacity (the generator clamps
    # internally too, but an explicit cap keeps the EXACT-total invariant)
    cap = sum(a * b for a, b in zip(layers[:-1], layers[1:]))
    n_syn = int(np.clip(round(spn * n_neurons), n_neurons, max(cap, n_neurons)))
    recurrent = bool(rng.random() < spec.recurrent_p)
    gen_seed = int(rng.integers(2**31 - 1))
    snn = feedforward(
        layers, n_syn,
        seed=gen_seed,
        name=name or f"wl-{gen_seed:08x}",
        recurrent=recurrent,
    )
    mu_r, sg_r = spec.spikes_per_neuron
    rate = float(np.exp(rng.normal(mu_r, sg_r)))
    return calibrate_spikes(
        snn, max(1.0, rate * n_neurons), seed=gen_seed + 7
    )


def workload_suite(
    n: int,
    *,
    seed: int = 0,
    spec: WorkloadSpec = TABLE1_FIT,
    scale: float = 1.0,
    name_prefix: str = "tenant",
) -> list[SNN]:
    """Sample ``n`` distinct tenants from one generator stream.

    Names are ``{name_prefix}{i}`` — stable identifiers for admission
    controllers and trajectory logs.
    """
    rng = np.random.default_rng(seed)
    return [
        sample_workload(rng, spec=spec, scale=scale, name=f"{name_prefix}{i}")
        for i in range(n)
    ]


# -- failure storms ------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled chip mutation of a failure storm.

    ``t`` is the (dimensionless) arrival time used only for ordering and
    inter-arrival statistics; ``kind`` selects the controller call:
    ``"fail"`` carries ``tiles``, ``"throttle"`` carries a ``link``
    (adjacent tile pair) and a slow-down ``factor``, ``"drift"`` carries
    an ``app`` name and a rate ``factor``; ``"heal"`` carries either the
    ``tiles`` or the ``link`` being restored.
    """

    t: float
    kind: str                                   # fail | heal | throttle | drift
    tiles: tuple[int, ...] = ()
    link: Optional[tuple[int, int]] = None
    app: Optional[str] = None
    factor: float = 1.0


def failure_storm(
    n_faults: int,
    n_tiles: int,
    *,
    seed: int = 0,
    rate: float = 1.0,
    tiles_per_fault: int = 1,
    heal_after: Optional[float] = None,
    p_throttle: float = 0.0,
    p_drift: float = 0.0,
    drift_apps: Sequence[str] = (),
    drift_range: tuple[float, float] = (0.5, 3.0),
    throttle_range: tuple[float, float] = (2.0, 8.0),
    max_dead_frac: float = 0.25,
    mesh_side: Optional[int] = None,
) -> list[FaultEvent]:
    """Poisson failure storm: a deterministic, time-sorted event list.

    Arrivals are exponential with ``rate`` events per unit time.  Each
    arrival is a tile failure (``tiles_per_fault`` distinct uniform picks
    over the tiles still alive in the generator's own bookkeeping), a
    link throttle with probability ``p_throttle`` (a uniformly-picked
    mesh-adjacent pair, factor log-uniform over ``throttle_range``), or a
    spike-rate drift with probability ``p_drift`` (an app uniform over
    ``drift_apps``, factor log-uniform over ``drift_range``).  With
    ``heal_after`` every failed tile set is revived — and every throttled
    link restored — that much later, so degradation stays transient and
    the dead fraction stays bounded; independent of healing, no failure
    is emitted that would push the dead fraction above ``max_dead_frac``
    (the arrival is skipped, keeping the storm well-posed on small
    meshes; a storm whose remaining arrivals are ALL skippable ends
    early rather than spinning).  Same ``seed`` -> identical storm,
    always.
    """
    assert 0.0 <= p_throttle + p_drift <= 1.0
    side = mesh_side if mesh_side is not None else int(round(n_tiles ** 0.5))
    assert side * side == n_tiles, "failure_storm assumes a square mesh"
    rng = np.random.default_rng(seed)
    events: list[FaultEvent] = []
    dead: set[int] = set()
    t = 0.0
    made = 0
    stalled = 0
    while made < n_faults:
        if stalled > 100 + 10 * n_faults:
            break   # every remaining arrival is skippable (cap saturated)
        t += float(rng.exponential(1.0 / rate))
        u = float(rng.random())
        if u < p_throttle:
            a = int(rng.integers(n_tiles))
            x, y = a % side, a // side
            opts = []
            if x + 1 < side:
                opts.append(a + 1)
            if y + 1 < side:
                opts.append(a + side)
            if not opts:
                stalled += 1
                continue
            b = int(opts[int(rng.integers(len(opts)))])
            lo, hi = np.log(throttle_range[0]), np.log(throttle_range[1])
            f = float(np.exp(rng.uniform(lo, hi)))
            events.append(FaultEvent(t=t, kind="throttle", link=(a, b), factor=f))
            if heal_after is not None:
                events.append(
                    FaultEvent(t=t + float(heal_after), kind="heal", link=(a, b))
                )
        elif u < p_throttle + p_drift and drift_apps:
            app = str(drift_apps[int(rng.integers(len(drift_apps)))])
            lo, hi = np.log(drift_range[0]), np.log(drift_range[1])
            f = float(np.exp(rng.uniform(lo, hi)))
            events.append(FaultEvent(t=t, kind="drift", app=app, factor=f))
        else:
            alive = sorted(set(range(n_tiles)) - dead)
            k = min(tiles_per_fault, len(alive))
            if k == 0 or (len(dead) + k) / n_tiles > max_dead_frac:
                stalled += 1
                continue
            picks = tuple(
                int(alive[i])
                for i in sorted(rng.choice(len(alive), size=k, replace=False))
            )
            dead.update(picks)
            events.append(FaultEvent(t=t, kind="fail", tiles=picks))
            if heal_after is not None:
                events.append(
                    FaultEvent(t=t + float(heal_after), kind="heal", tiles=picks)
                )
        made += 1
        stalled = 0
    events.sort(key=lambda e: (e.t, e.kind))
    return events
