"""SNN graph IR.

A Spiking Neural Network is a directed graph of neurons connected by weighted
synapses.  For the compiler (partitioning + SDFG analysis) the only
information needed per neuron is its fan-in synapse list and its long-run
spike count per application iteration (recorded from simulation, §2.4); the
LIF dynamics themselves live in :mod:`repro_torch.core.lif` and
:mod:`repro_torch.kernels.lif_crossbar`.

Representation is flat numpy arrays (CSR-like) so multi-million-synapse
networks (Table 1) stay cheap to manipulate.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class SNN:
    """A spiking neural network.

    Attributes:
      n_neurons: total neuron count (inputs + hidden + outputs).
      pre, post: int32 arrays of synapse endpoints, shape ``(n_synapses,)``.
      weight: float32 synapse weights, shape ``(n_synapses,)``.
      spikes: float64 per-neuron spike count per application iteration
        (populated by simulation or calibration; see :func:`calibrate_spikes`).
      layer_of: int32 layer index per neuron (−1 when unknown); used only for
        reporting and for the LIF reference simulator.
      name: application name.
    """

    n_neurons: int
    pre: np.ndarray
    post: np.ndarray
    weight: np.ndarray
    spikes: np.ndarray
    layer_of: np.ndarray
    name: str = "snn"

    # ------------------------------------------------------------------
    @property
    def n_synapses(self) -> int:
        return int(self.pre.shape[0])

    def fanin(self) -> np.ndarray:
        """Fan-in synapse count per neuron."""
        return np.bincount(self.post, minlength=self.n_neurons)

    def fanout(self) -> np.ndarray:
        return np.bincount(self.pre, minlength=self.n_neurons)

    def validate(self) -> None:
        assert self.pre.shape == self.post.shape == self.weight.shape
        assert self.pre.min(initial=0) >= 0 and self.pre.max(initial=0) < self.n_neurons
        assert self.post.min(initial=0) >= 0 and self.post.max(initial=0) < self.n_neurons
        assert self.spikes.shape == (self.n_neurons,)
        assert np.all(self.spikes >= 0)

    # ------------------------------------------------------------------
    def split_high_fanin(self, max_fanin: int) -> "SNN":
        """Decompose neurons whose fan-in exceeds the crossbar row count.

        A neuron with fan-in F > max_fanin cannot be realized on a crossbar
        with ``max_fanin`` rows.  Standard practice (e.g. NEUTRAMS [41],
        SpiNeMap [8]) splits it into ``ceil(F/max_fanin)`` accumulator
        sub-neurons feeding one aggregator.  The aggregator keeps the original
        neuron id (and its spike count); sub-neurons are appended at the end
        with spike counts equal to the aggregate they forward.
        """
        fanin = self.fanin()
        heavy = np.flatnonzero(fanin > max_fanin)
        if heavy.size == 0:
            return self

        post = self.post.astype(np.int64)

        # every heavy neuron's synapses, sorted by (post, pre, synapse id):
        # slicing contiguous SOURCE ranges keeps each sub-neuron's receptive
        # field compact (packs into shared crossbar rows)
        key = post * np.int64(self.n_neurons) + self.pre
        order = np.argsort(key, kind="stable")
        post_sorted = post[order]
        starts = np.searchsorted(post_sorted, heavy, side="left")
        ends = np.searchsorted(post_sorted, heavy, side="right")
        counts = ends - starts                      # (H,) fan-in per heavy
        # balanced parts: 133 -> 67+66, not 128+5 — a near-cap part would
        # monopolize an entire crossbar's input rows by itself; the first
        # (count % n_parts) parts carry one extra synapse (np.array_split)
        n_parts = -(-counts // max_fanin)
        base = counts // n_parts
        rem = counts % n_parts

        total = int(counts.sum())
        seg_off = np.concatenate([[0], np.cumsum(counts)[:-1]])
        flat = np.repeat(starts - seg_off, counts) + np.arange(total)
        syn_idx = order[flat]                       # heavy synapses, in order
        pos = np.arange(total) - np.repeat(seg_off, counts)
        base_r = np.repeat(base, counts)
        big = np.repeat(rem, counts) * (base_r + 1)
        part = np.where(
            pos < big,
            pos // (base_r + 1),
            np.repeat(rem, counts) + (pos - big) // base_r,
        )
        part_off = np.concatenate([[0], np.cumsum(n_parts)[:-1]])
        # re-target each heavy synapse to its sub-neuron (ids in
        # (heavy neuron asc, part asc) order, appended after the originals)
        post[syn_idx] = self.n_neurons + np.repeat(part_off, counts) + part

        total_parts = int(n_parts.sum())
        # sub-neuron -> aggregator synapses (weight 1: relay); relay spikes
        # are a proportional share of the target's traffic
        new_pre = self.n_neurons + np.arange(total_parts)
        new_post = np.repeat(heavy, n_parts)
        out = SNN(
            n_neurons=self.n_neurons + total_parts,
            pre=np.concatenate([self.pre, new_pre]).astype(np.int32),
            post=np.concatenate([post, new_post]).astype(np.int32),
            weight=np.concatenate(
                [self.weight, np.ones(total_parts, dtype=np.float32)]
            ).astype(np.float32),
            spikes=np.concatenate(
                [self.spikes, np.repeat(self.spikes[heavy], n_parts)]
            ),
            layer_of=np.concatenate(
                [self.layer_of, np.repeat(self.layer_of[heavy], n_parts)]
            ).astype(np.int32),
            name=self.name,
        )
        out.validate()
        return out


# ----------------------------------------------------------------------
def feedforward(
    layer_sizes: Sequence[int],
    n_synapses: int,
    *,
    seed: int,
    name: str = "snn",
    recurrent: bool = False,
) -> SNN:
    """Generate a (sparse) layered SNN with an exact total synapse count.

    The paper's applications (Table 1) have far fewer synapses than dense
    layer connectivity would imply (conv-style local receptive fields), so we
    draw a deterministic sparse connectivity: synapses are distributed over
    consecutive layer pairs proportionally to ``fanin*fanout`` capacity and
    endpoints are drawn with locality (Gaussian around the aligned position),
    which produces the input-sharing structure bin-packing exploits.
    """
    rng = np.random.default_rng(seed)
    layer_sizes = list(layer_sizes)
    n_neurons = int(sum(layer_sizes))
    offsets = np.cumsum([0] + layer_sizes)
    layer_of = np.concatenate(
        [np.full(s, i, dtype=np.int32) for i, s in enumerate(layer_sizes)]
    )

    pairs = [(i, i + 1) for i in range(len(layer_sizes) - 1)]
    if recurrent:
        pairs += [(len(layer_sizes) - 1, 1)]  # output -> first hidden feedback

    caps = np.array(
        [layer_sizes[a] * layer_sizes[b] for a, b in pairs], dtype=np.float64
    )
    counts = np.floor(n_synapses * caps / caps.sum()).astype(np.int64)
    counts[-1] += n_synapses - counts.sum()  # make the total exact

    pres, posts = [], []
    for (a, b), cnt in zip(pairs, counts):
        sa, sb = layer_sizes[a], layer_sizes[b]
        cnt = int(min(cnt, sa * sb))
        # Conv-style connectivity: each target draws DISTINCT sources from a
        # contiguous window; window starts are quantized so that groups of
        # targets (the "feature maps" at one spatial site) share the exact
        # same window.  Shared windows are what let Alg. 1 co-locate neurons
        # on shared crossbar rows — scattered random connectivity degenerates
        # to one neuron per crossbar on real hardware too.  Synapses are
        # distinct (pre, post) pairs: one OxRAM crosspoint per synapse.
        base = cnt // sb
        fan = np.full(sb, base, dtype=np.int64)
        fan[: cnt - int(fan.sum())] += 1
        w = int(min(sa, max(8, np.ceil(1.25 * max(base, 1)))))
        step = max(1, w // 2)
        centers = (np.arange(sb) * (sa / sb)).astype(np.int64)
        starts_w = np.clip((centers // step) * step, 0, max(sa - w, 0))
        src_list = []
        dst_list = []
        for j in range(sb):
            f = int(fan[j])
            if f == 0:
                continue
            f = min(f, w)
            src_j = rng.choice(w, size=f, replace=False) + starts_w[j]
            src_list.append(src_j)
            dst_list.append(np.full(f, j, dtype=np.int64))
        src = np.concatenate(src_list)
        dst_local = np.concatenate(dst_list)
        pres.append(offsets[a] + src)
        posts.append(offsets[b] + dst_local)

    pre = np.concatenate(pres).astype(np.int32)
    post = np.concatenate(posts).astype(np.int32)
    # dedupe is NOT applied: parallel synapses are legal in SNNs (multapses)
    weight = rng.normal(0.0, 0.5, size=pre.size).astype(np.float32)
    snn = SNN(
        n_neurons=n_neurons,
        pre=pre,
        post=post,
        weight=weight,
        spikes=np.zeros(n_neurons),
        layer_of=layer_of,
        name=name,
    )
    snn.validate()
    return snn


def calibrate_spikes(snn: SNN, total_spikes: float, *, seed: int) -> SNN:
    """Assign deterministic per-neuron spike counts summing to ``total_spikes``.

    The paper records spikes with CARLsim driven by training inputs (§2.4) and
    reports per-application totals (Table 1 'Spikes').  We draw a log-normal
    activity profile (heavy-tailed, as observed in rate-coded SNNs) and scale
    it to the published total, keeping the compiler inputs faithful without
    shipping datasets.  :mod:`repro_torch.core.lif` can replace this with simulated
    counts (``examples/snn_compile.py --simulate``).
    """
    rng = np.random.default_rng(seed)
    profile = rng.lognormal(mean=0.0, sigma=1.0, size=snn.n_neurons)
    spikes = profile * (total_spikes / profile.sum())
    return dataclasses.replace(snn, spikes=spikes)
