"""Synchronous Dataflow Graph IR for clustered SNNs (paper §3, §4).

Because every spike produced on a channel is consumed by the destination
actor within one application iteration, the repetition vector of a clustered
SNN is all-ones (§3.1, Def. 3) — i.e. the SDFG is a *timed event graph*
(homogeneous SDFG).  We therefore represent channels directly with an
integer *marking* (initial tokens, in units of actor firings) and a real
*delay* (AER communication latency), which is exactly the structure Max-Plus
Algebra analyzes (§3.2).

The graph is stored array-native: a :class:`ChannelTable` holds one
struct-of-arrays record per channel (``src/dst/tokens/rate/delay/kind``),
so every analysis pass (liveness, Max-Plus, batched sweeps) consumes flat
numpy arrays with no per-edge Python objects on the hot path.  A thin
:class:`Channel` view plus ``__iter__`` keeps the old object-graph API
working for tests and incremental call sites.

The hardware-aware transformation (§4.4) adds:
  * back-edges with ``floor(buffer / rate)`` initial tokens  (Step 1),
  * TDMA static-order edges per tile                         (Step 2),
  * inter-tile channel delays from the NoC model             (Step 1/3).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional, Sequence, Union

import numpy as np

from .hardware import HardwareConfig
from .partition import ClusteredSNN

# channel kinds, encoded as int8 in ChannelTable.kind
KIND_DATA, KIND_BUFFER, KIND_ORDER, KIND_SELF = 0, 1, 2, 3
KIND_NAMES = ("data", "buffer", "order", "self")
KIND_CODES = {name: code for code, name in enumerate(KIND_NAMES)}


@dataclasses.dataclass(frozen=True)
class Channel:
    """One channel record — a *view* row of a :class:`ChannelTable`.

    Kept for construction convenience and backward compatibility; the graph
    itself never stores Channel objects.
    """

    src: int
    dst: int
    tokens: int          # initial marking (units: firings)
    rate: float          # spikes per firing on this channel (port rate)
    delay: float = 0.0   # communication latency added to the dependency
    kind: str = "data"   # data | buffer | order | self


@dataclasses.dataclass(frozen=True)
class ChannelTable:
    """Struct-of-arrays channel storage (the array-native edge IR).

    All arrays share length ``len(self)``.  ``kind`` uses the integer codes
    ``KIND_DATA/KIND_BUFFER/KIND_ORDER/KIND_SELF``; :meth:`kind_names`
    decodes.  The table is immutable — transformations build new tables via
    :meth:`from_arrays` / :meth:`concat` / :meth:`replace`.
    """

    src: np.ndarray      # (E,) int64
    dst: np.ndarray      # (E,) int64
    tokens: np.ndarray   # (E,) int64
    rate: np.ndarray     # (E,) float64
    delay: np.ndarray    # (E,) float64
    kind: np.ndarray     # (E,) int8

    # -- construction ---------------------------------------------------
    @classmethod
    def from_arrays(
        cls,
        src,
        dst,
        tokens,
        rate,
        delay=None,
        kind=None,
    ) -> "ChannelTable":
        src = np.asarray(src, dtype=np.int64)
        e = src.size
        if delay is None:
            delay = np.zeros(e)
        if kind is None:
            kind = np.full(e, KIND_DATA, dtype=np.int8)
        elif np.isscalar(kind):
            kind = np.full(e, int(kind), dtype=np.int8)
        return cls(
            src=src,
            dst=np.asarray(dst, dtype=np.int64),
            tokens=np.asarray(tokens, dtype=np.int64),
            rate=np.asarray(rate, dtype=np.float64),
            delay=np.asarray(delay, dtype=np.float64),
            kind=np.asarray(kind, dtype=np.int8),
        )

    @classmethod
    def from_channels(cls, channels: Iterable[Channel]) -> "ChannelTable":
        chans = list(channels)
        return cls.from_arrays(
            src=[c.src for c in chans],
            dst=[c.dst for c in chans],
            tokens=[c.tokens for c in chans],
            rate=[c.rate for c in chans],
            delay=[c.delay for c in chans],
            kind=[KIND_CODES[c.kind] for c in chans],
        )

    @classmethod
    def empty(cls) -> "ChannelTable":
        return cls.from_arrays([], [], [], [])

    @classmethod
    def concat(cls, tables: Sequence["ChannelTable"]) -> "ChannelTable":
        tables = [t for t in tables if len(t)]
        if not tables:
            return cls.empty()
        return cls(
            src=np.concatenate([t.src for t in tables]),
            dst=np.concatenate([t.dst for t in tables]),
            tokens=np.concatenate([t.tokens for t in tables]),
            rate=np.concatenate([t.rate for t in tables]),
            delay=np.concatenate([t.delay for t in tables]),
            kind=np.concatenate([t.kind for t in tables]),
        )

    # -- transforms -----------------------------------------------------
    def replace(self, **arrays) -> "ChannelTable":
        return dataclasses.replace(
            self, **{k: np.asarray(v) for k, v in arrays.items()}
        )

    def select(self, mask: np.ndarray) -> "ChannelTable":
        return ChannelTable(
            src=self.src[mask],
            dst=self.dst[mask],
            tokens=self.tokens[mask],
            rate=self.rate[mask],
            delay=self.delay[mask],
            kind=self.kind[mask],
        )

    # -- CSR helpers (per-node edge lists without Python adjacency) -----
    def csr_by(self, field: str, n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """CSR index over ``src`` or ``dst``: (edge_order, starts, ends).

        ``edge_order[starts[v]:ends[v]]`` are the edge ids with
        ``getattr(self, field)[e] == v``, for v in [0, n).
        """
        key = getattr(self, field)
        order = np.argsort(key, kind="stable")
        starts = np.searchsorted(key[order], np.arange(n), side="left")
        ends = np.searchsorted(key[order], np.arange(n), side="right")
        return order, starts, ends

    # -- compat / container protocol ------------------------------------
    def __len__(self) -> int:
        return int(self.src.size)

    def __getitem__(self, e: int) -> Channel:
        return Channel(
            src=int(self.src[e]),
            dst=int(self.dst[e]),
            tokens=int(self.tokens[e]),
            rate=float(self.rate[e]),
            delay=float(self.delay[e]),
            kind=KIND_NAMES[int(self.kind[e])],
        )

    def __iter__(self) -> Iterator[Channel]:
        for e in range(len(self)):
            yield self[e]

    def kind_names(self) -> list[str]:
        return [KIND_NAMES[int(k)] for k in self.kind]


ChannelsLike = Union[ChannelTable, Sequence[Channel], Iterable[Channel]]


def as_channel_table(channels: ChannelsLike) -> ChannelTable:
    if isinstance(channels, ChannelTable):
        return channels
    return ChannelTable.from_channels(channels)


@dataclasses.dataclass
class SDFG:
    """Timed event graph: actors with execution times + marked channels.

    ``channels`` is stored as a :class:`ChannelTable`; passing a
    ``list[Channel]`` to the constructor converts it once (compat path for
    tests and hand-built graphs).
    """

    n_actors: int
    exec_time: np.ndarray               # (n_actors,) tau_i
    channels: ChannelTable
    name: str = "sdfg"
    # (n_actors,) mean crossbar row length of each actor: OxRAM crosspoints
    # read per delivered spike (synapses / distinct input rows).  None means
    # "row length 1" — the flat per-spike read model of hand-built graphs.
    read_cost: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        if not isinstance(self.channels, ChannelTable):
            self.channels = as_channel_table(self.channels)
        if self.read_cost is not None:
            self.read_cost = np.asarray(self.read_cost, dtype=np.float64)
            assert self.read_cost.shape == (self.n_actors,)

    @property
    def table(self) -> ChannelTable:
        return self.channels

    @property
    def n_channels(self) -> int:
        return len(self.channels)

    def validate(self) -> None:
        assert self.exec_time.shape == (self.n_actors,)
        t = self.channels
        if len(t):
            assert t.src.min() >= 0 and t.src.max() < self.n_actors
            assert t.dst.min() >= 0 and t.dst.max() < self.n_actors
            assert t.tokens.min() >= 0

    # -- liveness: every cycle must carry >= 1 token --------------------
    def is_live(self) -> bool:
        t = self.channels
        zero = t.tokens == 0
        return _zero_token_subgraph_is_acyclic(
            self.n_actors, t.src[zero], t.dst[zero]
        )

    def edges_arrays(self):
        """(src, dst, weight, tokens) arrays; weight = tau[dst] + delay."""
        t = self.channels
        w = self.exec_time[t.dst] + t.delay
        return t.src, t.dst, w, t.tokens


def _zero_token_subgraph_is_acyclic(
    n: int, src: np.ndarray, dst: np.ndarray
) -> bool:
    """Kahn's algorithm on the zero-token edge arrays."""
    order = np.argsort(src, kind="stable")
    s_sorted = src[order]
    starts = np.searchsorted(s_sorted, np.arange(n), side="left")
    ends = np.searchsorted(s_sorted, np.arange(n), side="right")
    dst_sorted = dst[order]
    indeg = np.bincount(dst, minlength=n)
    stack = [i for i in range(n) if indeg[i] == 0]
    seen = 0
    while stack:
        u = stack.pop()
        seen += 1
        for v in dst_sorted[starts[u] : ends[u]]:
            indeg[v] -= 1
            if indeg[v] == 0:
                stack.append(int(v))
    return seen == n


# ----------------------------------------------------------------------
def sdfg_from_clusters(
    clustered: ClusteredSNN,
    exec_time: Optional[np.ndarray] = None,
    *,
    hw: Optional[HardwareConfig] = None,
) -> SDFG:
    """Build the application SDFG of a clustered SNN (§3, infinite resources).

    Channel directions follow spike flow; channels that point "backward" in
    layer order (created by partitioning, Fig. 6, or by recurrence) carry one
    initial token — the dependency they encode is on the *previous* iteration,
    which keeps RptV = [1..1] consistent and the graph live.  Every actor gets
    a one-token self-edge (Eq. 2: t_i(k) >= t_i(k-1) + tau_i).

    Fully vectorized: consumes the clustered SNN's parallel channel arrays
    and emits a :class:`ChannelTable` without materializing Channel objects.
    """
    n = clustered.n_clusters
    if exec_time is None:
        base = hw.t_fire if hw is not None else 4.0
        enc = hw.t_spike_encode if hw is not None else 0.01
        # firing cost = crossbar propagation + AER encode of produced spikes
        exec_time = base + enc * clustered.out_spikes
    exec_time = np.asarray(exec_time, dtype=np.float64)

    # topological rank of clusters: earliest layer of any member neuron
    rank = np.full(n, np.iinfo(np.int32).max, dtype=np.int64)
    np.minimum.at(
        rank, clustered.cluster_of, clustered.snn.layer_of.astype(np.int64)
    )
    # tie-break by cluster index so the 0-token subgraph is provably acyclic
    order_key = rank * (n + 1) + np.arange(n)

    actors = np.arange(n)
    self_edges = ChannelTable.from_arrays(
        src=actors,
        dst=actors,
        tokens=np.ones(n, dtype=np.int64),
        rate=np.ones(n),
        kind=KIND_SELF,
    )
    c_src, c_dst, c_rate = (
        clustered.channel_src,
        clustered.channel_dst,
        clustered.channel_rate,
    )
    data_edges = ChannelTable.from_arrays(
        src=c_src,
        dst=c_dst,
        tokens=(order_key[c_dst] <= order_key[c_src]).astype(np.int64),
        rate=np.maximum(c_rate, 1e-6),
        kind=KIND_DATA,
    )

    g = SDFG(
        n_actors=n,
        exec_time=exec_time,
        channels=ChannelTable.concat([self_edges, data_edges]),
        name=clustered.snn.name,
        # mean OxRAM row length per cluster: a spike delivered to cluster c
        # drives one row wire and reads every crosspoint on it, so its read
        # charge scales with synapses-per-input-row, not a flat unit
        read_cost=clustered.synapses_used
        / np.maximum(clustered.inputs_used, 1),
    )
    g.validate()
    assert g.is_live(), "clustered SDFG must be deadlock-free (Alg.1 line 13)"
    return g


# ----------------------------------------------------------------------
def hardware_static_parts(
    app: SDFG, hw: HardwareConfig
) -> tuple[ChannelTable, ChannelTable, ChannelTable]:
    """Binding-independent pieces of the §4.4 transformation.

    Returns ``(self_edges, flow, buffer_back_edges)``: the self-edges, the
    data/flow channels (delays still zero — they depend on the binding),
    and the Step-1 buffer back-edges with ``floor(buffer / rate)`` initial
    tokens (producing claims space, consuming releases it).  Everything a
    candidate binding does to this structure is (a) per-edge NoC delays on
    ``flow`` (:func:`flow_delays`) and (b) extra order edges — which is why
    a *batch* of candidates over one app shares these arrays row-for-row.
    """
    t = app.channels
    keep_self = t.select(t.kind == KIND_SELF)
    flow = t.select(t.kind != KIND_SELF)
    buf_tokens = np.maximum(
        1,
        (hw.tile.output_buffer // np.maximum(flow.rate, 1.0)).astype(np.int64),
    )
    back_edges = ChannelTable.from_arrays(
        src=flow.dst,
        dst=flow.src,
        tokens=buf_tokens,
        rate=flow.rate,
        kind=KIND_BUFFER,
    )
    return keep_self, flow, back_edges


def flow_delays(
    flow: ChannelTable, binding: np.ndarray, hw: HardwareConfig
) -> np.ndarray:
    """NoC delay per flow edge; ``binding`` may be (n,) or batched (B, n).

    Vectorized over the trailing edge axis, so a (B, n) binding matrix
    yields a (B, E_flow) delay matrix in one call — the per-candidate part
    of the §4.4 transformation used by the batched engine.
    """
    binding = np.asarray(binding, dtype=np.int64)
    src_t = np.take(binding, flow.src, axis=-1)
    dst_t = np.take(binding, flow.dst, axis=-1)
    return hw.comm_delay_array(flow.rate, src_t, dst_t)


def hardware_aware_sdfg(
    app: SDFG,
    binding: np.ndarray,
    hw: HardwareConfig,
    static_orders: Optional[Sequence[Sequence[int]]] = None,
) -> SDFG:
    """§4.4: fold resource constraints of the platform into the graph.

    Step 1 (buffers): each data channel (i→j) gets a back-edge (j→i) with
      ``floor(buffer / rate)`` initial tokens: producing claims space,
      consuming releases it.  Inter-tile channels also get their AER/NoC
      latency as edge delay.
    Step 2 (ordering): if per-tile static orders are given, add the TDMA
      order cycle a1→a2→…→ak→a1 (one token on the wrap-around edge), which
      serializes the tile exactly like the crossbar's atomic execution.

    The whole transformation is array-level on the :class:`ChannelTable` —
    no per-edge Python loop on the analysis hot path.
    """
    binding = np.asarray(binding, dtype=np.int64)
    assert binding.shape == (app.n_actors,)
    assert binding.max(initial=0) < hw.n_tiles

    keep_self, flow, back_edges = hardware_static_parts(app, hw)
    flow_delayed = flow.replace(delay=flow_delays(flow, binding, hw))

    parts = [keep_self, flow_delayed, back_edges]
    if static_orders is not None:
        parts.append(order_edges(static_orders, binding))

    g = SDFG(
        n_actors=app.n_actors,
        exec_time=app.exec_time,
        channels=ChannelTable.concat(parts),
        name=f"{app.name}@{hw.n_tiles}t",
    )
    g.validate()
    return g


def disjoint_union(graphs: Sequence[SDFG], name: str = "union") -> SDFG:
    """Disjoint union of SDFGs: one graph with actors offset per part.

    Part ``k``'s actors are relabeled by ``sum(n_actors of parts < k)``
    (offsets are ``np.cumsum`` of the actor counts, exclusive).  No edges
    are added between parts, so the union of live graphs is live and its
    maximum cycle ratio is the max over the parts — until a *binding*
    couples parts through shared-tile TDMA order cycles, which is exactly
    the multi-app joint-placement graph the runtime layer analyzes
    (:class:`repro_torch.core.runtime.AdmissionController` with
    ``placement="joint"``).
    """
    assert graphs, "need at least one graph"
    offsets = np.cumsum([0] + [g.n_actors for g in graphs])
    tables = [
        g.channels.replace(src=g.channels.src + off, dst=g.channels.dst + off)
        for g, off in zip(graphs, offsets[:-1])
    ]
    if any(g.read_cost is not None for g in graphs):
        read_cost = np.concatenate([
            g.read_cost if g.read_cost is not None else np.ones(g.n_actors)
            for g in graphs
        ])
    else:
        read_cost = None
    union = SDFG(
        n_actors=int(offsets[-1]),
        exec_time=np.concatenate([g.exec_time for g in graphs]),
        channels=ChannelTable.concat(tables),
        name=name,
        read_cost=read_cost,
    )
    union.validate()
    return union


def order_edges(
    static_orders: Sequence[Sequence[int]], binding: np.ndarray
) -> ChannelTable:
    """§4.4 step 2: the per-tile TDMA order cycles as a ChannelTable."""
    srcs: list[np.ndarray] = []
    dsts: list[np.ndarray] = []
    toks: list[np.ndarray] = []
    for tile, order in enumerate(static_orders):
        o = np.asarray([a for a in order if binding[a] == tile], dtype=np.int64)
        if o.size <= 1:
            continue
        srcs.append(o)
        dsts.append(np.roll(o, -1))
        tk = np.zeros(o.size, dtype=np.int64)
        tk[-1] = 1  # one token on the wrap-around edge keeps the cycle live
        toks.append(tk)
    if not srcs:
        return ChannelTable.empty()
    src = np.concatenate(srcs)
    return ChannelTable.from_arrays(
        src=src,
        dst=np.concatenate(dsts),
        tokens=np.concatenate(toks),
        rate=np.ones(src.size),
        kind=KIND_ORDER,
    )
