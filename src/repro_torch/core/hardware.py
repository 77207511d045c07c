"""Neuromorphic hardware model (DYNAP-SE-like tiled crossbar chip).

The paper (§4.1, §6.1) models DYNAP-SE [51]: a tiled array of crossbars
connected by a mesh NoC using the AER protocol.  Each tile has

  * one crossbar with ``crossbar_inputs`` row wires and ``crossbar_outputs``
    column wires (128x128 on DYNAP-SE, 65,536 OxRAM crosspoints),
  * an input buffer and an output buffer (spike packets),
  * a network interface serializing AER packets on the interconnect.

Timing constants are modeled from the paper's cited sources: the execution
time of a cluster firing is the current-propagation delay through an OxRAM
synapse array (Mallik et al. [49]; Garbin et al. [36] for HfO2 devices) and
the AER link serializes one spike packet per ``t_spike_link`` on the mesh.
Absolute scales are configurable; every benchmark reports *normalized*
throughput exactly like the paper, which is invariant to the absolute unit.

Energy constants follow the same sources plus the SpiNeMap energy argument
(Balaji et al.): inter-tile AER events dominate chip dynamic energy, so the
model charges a per-spike crossbar read (OxRAM read, [49]/[36]), a
per-packet AER encode at the source NI, a per-packet-per-hop mesh link
cost, and a per-tile idle/leakage power integrated over the iteration
period.  Units are picojoules (pJ) and microwatts (pJ/us); as with timing,
absolute scales are configurable and benchmarks compare *relative* energy.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class CrossbarConfig:
    """Resource constraints of a single crossbar (the bin in Alg. 1)."""

    inputs: int = 128          # row wires = max distinct pre-synaptic sources
    outputs: int = 128         # column wires = max neurons per cluster
    crosspoints: int = 128 * 128  # OxRAM cells = max synapses per cluster

    def fits(self, n_inputs: int, n_neurons: int, n_synapses: int) -> bool:
        return (
            n_inputs <= self.inputs
            and n_neurons <= self.outputs
            and n_synapses <= self.crosspoints
        )


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """A tile: crossbar + IO buffers + network interface."""

    crossbar: CrossbarConfig = CrossbarConfig()
    input_buffer: int = 4096    # spike packets
    output_buffer: int = 4096   # spike packets
    # NoC connections available per tile (mesh: N/E/S/W + local).
    connections: int = 4


@dataclasses.dataclass(frozen=True)
class HardwareConfig:
    """A tiled neuromorphic chip (Fig. 7)."""

    n_tiles: int = 4
    tile: TileConfig = TileConfig()

    # --- timing model (microseconds) ------------------------------------
    # Crossbar current-propagation delay per firing (OxRAM read, [49]).
    t_fire: float = 4.0
    # AER encode/serialize per spike packet at the source NI.  Calibrated so
    # the model reproduces the paper's measured regime (Table 2: 5-23%
    # bandwidth utilization — compute/TDMA-bound, not comm-bound).
    t_spike_encode: float = 0.001
    # Mesh link time per spike packet per hop (~500 Mevents/s/link).
    t_spike_link: float = 0.002
    # Fixed per-message NoC latency (route setup), per channel per firing.
    t_route: float = 0.05

    # --- energy model (picojoules; idle power in pJ/us = uW) -------------
    # OxRAM crossbar read + integrate per delivered spike ([49], [36]).
    e_spike_read: float = 2.0
    # AER encode/serialize per inter-tile spike packet at the source NI.
    e_packet_encode: float = 1.0
    # Mesh link traversal per spike packet per hop (SpiNeMap's dominant
    # term: inter-tile AER events on the interconnect).
    e_link_hop: float = 0.5
    # Idle/leakage power per occupied tile (pJ per microsecond of period).
    p_tile_idle: float = 0.25

    @property
    def mesh_shape(self) -> tuple[int, int]:
        """(n_cols, n_rows) of the 2D mesh NoC, ``n_cols * n_rows == n_tiles``.

        The most-square exact factorization with ``n_cols <= n_rows``:
        4 -> (2, 2), 8 -> (2, 4), 9 -> (3, 3), 12 -> (3, 4); a prime tile
        count degenerates to a (1, n) chain.  Tile ``t`` sits at column
        ``t % n_cols``, row ``t // n_cols`` — always inside the mesh, which
        the old square-only ``isqrt`` dimension did not guarantee for
        non-square ``n_tiles``.
        """
        n = self.n_tiles
        c = max(1, math.isqrt(n))
        while c > 1 and n % c:
            c -= 1
        return c, n // c

    @property
    def mesh_dim(self) -> int:
        """Mesh column count (compat alias; equals both dims on squares)."""
        return self.mesh_shape[0]

    def hops(self, src_tile: int, dst_tile: int) -> int:
        """Manhattan hop count on the 2D mesh NoC."""
        if src_tile == dst_tile:
            return 0
        d, _ = self.mesh_shape
        sx, sy = src_tile % d, src_tile // d
        dx, dy = dst_tile % d, dst_tile // d
        return abs(sx - dx) + abs(sy - dy)

    def comm_delay(self, n_spikes: float, src_tile: int, dst_tile: int) -> float:
        """Time to move ``n_spikes`` AER packets from src to dst tile."""
        if src_tile == dst_tile:
            return 0.0
        hops = self.hops(src_tile, dst_tile)
        # Pipelined wormhole: serialization dominates, one extra link time/hop.
        return (
            self.t_route
            + n_spikes * (self.t_spike_encode + self.t_spike_link)
            + (hops - 1) * self.t_spike_link
        )

    def hops_array(self, src_tiles: np.ndarray, dst_tiles: np.ndarray) -> np.ndarray:
        """Vectorized Manhattan hop counts (same-tile pairs report 0)."""
        d, _ = self.mesh_shape
        src_tiles = np.asarray(src_tiles, dtype=np.int64)
        dst_tiles = np.asarray(dst_tiles, dtype=np.int64)
        return np.abs(src_tiles % d - dst_tiles % d) + np.abs(
            src_tiles // d - dst_tiles // d
        )

    def comm_delay_from_hops(
        self, n_spikes: np.ndarray, hops: np.ndarray, link_scale=None
    ) -> np.ndarray:
        """Vectorized :meth:`comm_delay` from precomputed hop counts.

        ``hops == 0`` marks a same-tile pair (distinct tiles are always
        >= 1 hop apart on the mesh) and yields zero delay.  Shared by
        :meth:`comm_delay_array` and the batched engine, which derives
        delay AND energy from one hop computation.

        ``link_scale`` (broadcastable against ``hops``) multiplies the mesh
        link time — the per-route throttle factor from
        :meth:`ChipState.route_scale`.  Wormhole serialization is gated by
        the slowest link on the route, so one factor scales both the
        per-packet serialization term and the pipeline-fill term.
        """
        t_link = self.t_spike_link
        if link_scale is not None:
            t_link = t_link * np.asarray(link_scale, dtype=np.float64)
        delay = (
            self.t_route
            + np.asarray(n_spikes) * (self.t_spike_encode + t_link)
            + (hops - 1) * t_link
        )
        return np.where(hops == 0, 0.0, delay)

    def comm_delay_array(
        self, n_spikes: np.ndarray, src_tiles: np.ndarray, dst_tiles: np.ndarray
    ) -> np.ndarray:
        """Vectorized :meth:`comm_delay` over parallel channel arrays."""
        src_tiles = np.asarray(src_tiles, dtype=np.int64)
        dst_tiles = np.asarray(dst_tiles, dtype=np.int64)
        return self.comm_delay_from_hops(
            n_spikes, self.hops_array(src_tiles, dst_tiles)
        )

    def energy_from_hops(
        self, n_spikes: np.ndarray, hops: np.ndarray
    ) -> np.ndarray:
        """Dynamic NoC energy (pJ) per channel per iteration from hop counts.

        ``n_spikes`` AER packets each pay one encode at the source NI plus
        one link traversal per hop; same-tile channels (``hops == 0``) are
        free — their spikes never leave the crossbar.  Mirrors
        :meth:`comm_delay_from_hops` and broadcasts identically, so a
        (B, E) hop matrix yields (B, E) energies in one call.
        """
        n_spikes = np.asarray(n_spikes)
        return np.where(
            hops == 0,
            0.0,
            n_spikes * (self.e_packet_encode + self.e_link_hop * hops),
        )

    def energy_array(
        self, n_spikes: np.ndarray, src_tiles: np.ndarray, dst_tiles: np.ndarray
    ) -> np.ndarray:
        """Vectorized per-channel dynamic NoC energy (pJ per iteration).

        Mirrors :meth:`comm_delay_array`: parallel channel arrays of spike
        rates and endpoint tiles (leading batch dims broadcast) yield the
        AER encode + link energy of moving each channel's spikes, zero for
        co-located endpoints.
        """
        src_tiles = np.asarray(src_tiles, dtype=np.int64)
        dst_tiles = np.asarray(dst_tiles, dtype=np.int64)
        return self.energy_from_hops(
            n_spikes, self.hops_array(src_tiles, dst_tiles)
        )

    def chip_energy(
        self,
        periods: np.ndarray,
        cut_traffic: np.ndarray,
        spike_hops: np.ndarray,
        tiles_used: np.ndarray,
        read_charge: float,
    ) -> np.ndarray:
        """Total chip energy (pJ) per iteration for a batch of candidates.

        ``periods`` is (B,) steady-state iteration periods (us);
        ``cut_traffic`` is (B,) inter-tile spikes per iteration,
        ``spike_hops`` (B,) rate-weighted hop counts, ``tiles_used`` (B,)
        occupied-tile counts, and ``read_charge`` the binding-independent
        crossbar read charge per iteration in row-crosspoint units: each
        delivered spike drives one crossbar row wire and reads every OxRAM
        crosspoint on it, so a spike's charge scales with the destination
        cluster's fan-out row length (mean crosspoints per input row).
        Passing a plain delivered-spike count keeps the older flat
        per-spike model (row length 1).  Energy = crossbar reads + AER
        encode of the cut + link hops + idle leakage of the occupied tiles
        over one period; rows with a dead/acyclic period (non-finite or
        <= 0) report ``inf``.
        """
        periods = np.asarray(periods, dtype=np.float64)
        dyn = (
            self.e_spike_read * read_charge
            + self.e_packet_encode * np.asarray(cut_traffic)
            + self.e_link_hop * np.asarray(spike_hops)
        )
        ok = np.isfinite(periods) & (periods > 0)
        return np.where(
            ok,
            dyn + self.p_tile_idle * np.asarray(tiles_used) * np.where(ok, periods, 0.0),
            np.inf,
        )


class ChipState:
    """Mutable degradation state of one physical chip.

    :class:`HardwareConfig` is frozen and hashable — it is the *design-time*
    model and doubles as a compile-cache key, so run-time degradation lives
    here instead: dead tiles, per-link NoC throttle factors, and per-app
    spike-rate drift multipliers.  The engine consumes this state inside its
    one-pass hop traversal (``stack_hardware_aware``), so degraded candidate
    bindings score exactly in the same batched ``EdgeStack`` path as healthy
    ones — no second modeling path.

    Every mutation bumps :attr:`epoch`; callers that cache period analyses
    (the runtime's component-record cache) key on the epoch so stale results
    can never be combined with fresh ones.

    Link throttles use the mesh's XY (dimension-order) routing: a route
    first travels along the row to the destination column, then along the
    column.  Wormhole serialization is gated by the slowest link on the
    route, so a route's scale factor is the *max* throttle over the links it
    crosses, precomputed as an (n_tiles, n_tiles) matrix and gathered per
    (candidate, edge) pair in the batched path.
    """

    def __init__(self, hw: HardwareConfig):
        self.hw = hw
        self.dead = np.zeros(hw.n_tiles, dtype=bool)
        self.link_throttle: dict[tuple[int, int], float] = {}
        self.drift: dict[str, float] = {}
        self.epoch = 0
        self._scale_cache: np.ndarray | None = None
        self._sig_cache: dict[tuple, tuple[int, tuple]] = {}

    # --- introspection ---------------------------------------------------
    @property
    def pristine(self) -> bool:
        """True when no degradation is active (fast-path: skip all scaling)."""
        return not (self.dead.any() or self.link_throttle or self.drift)

    def alive_tiles(self) -> np.ndarray:
        return np.flatnonzero(~self.dead)

    @property
    def n_alive(self) -> int:
        return int((~self.dead).sum())

    def dead_rows(self, bindings: np.ndarray) -> np.ndarray:
        """(B,) mask of candidate bindings that touch any dead tile."""
        bindings = np.asarray(bindings, dtype=np.int64)
        return self.dead[bindings].any(axis=-1)

    # --- mutations (each bumps the epoch) --------------------------------
    def _bump(self, *, links: bool = False) -> None:
        self.epoch += 1
        if links:
            self._scale_cache = None

    def fail_tiles(self, tiles) -> None:
        tiles = np.asarray(tiles, dtype=np.int64).reshape(-1)
        if tiles.size and (tiles.min() < 0 or tiles.max() >= self.hw.n_tiles):
            raise ValueError(f"tile ids out of range for n_tiles={self.hw.n_tiles}")
        self.dead[tiles] = True
        self._bump()

    def heal_tiles(self, tiles) -> None:
        tiles = np.asarray(tiles, dtype=np.int64).reshape(-1)
        self.dead[tiles] = False
        self._bump()

    def throttle_link(self, a: int, b: int, factor: float) -> None:
        """Slow the mesh link between adjacent tiles ``a`` and ``b``.

        ``factor`` multiplies the link's serialization time (>= 1; 1 heals).
        """
        if self.hw.hops(int(a), int(b)) != 1:
            raise ValueError(f"tiles {a} and {b} are not mesh-adjacent")
        if not factor >= 1.0:
            raise ValueError("throttle factor must be >= 1.0")
        key = (min(int(a), int(b)), max(int(a), int(b)))
        if factor == 1.0:
            self.link_throttle.pop(key, None)
        else:
            self.link_throttle[key] = float(factor)
        self._bump(links=True)

    def heal_link(self, a: int, b: int) -> None:
        key = (min(int(a), int(b)), max(int(a), int(b)))
        self.link_throttle.pop(key, None)
        self._bump(links=True)

    def set_drift(self, app: str, factor: float) -> None:
        """Observed spike rates of ``app`` run at ``factor`` x the design profile."""
        if not factor > 0.0:
            raise ValueError("drift factor must be positive")
        if factor == 1.0:
            self.drift.pop(app, None)
        else:
            self.drift[app] = float(factor)
        self._bump()

    def clear_drift(self, app: str) -> None:
        self.drift.pop(app, None)
        self._bump()

    def component_signature(self, tiles, apps) -> tuple:
        """Hashable view of the degradation VISIBLE to one placement
        component: its dead tiles, the route-scale submatrix over its
        tile pairs (None when clean), and its member apps' drift factors.
        Everything chip-dependent in a component's steady-state score is
        a function of this tuple plus the bindings, so record caches
        keyed on it survive mutations that do not touch the component —
        a fault invalidates the components it hits, not the whole chip.

        Memoized per chip epoch: the route-scale submatrix extraction is
        the expensive part, and between mutations every caller asks for
        the same footprints again (cache combines re-derive the signature
        on every lookup).
        """
        key = (tuple(int(t) for t in tiles), tuple(apps))
        hit = self._sig_cache.get(key)
        if hit is not None and hit[0] == self.epoch:
            return hit[1]
        tiles = np.asarray(key[0], dtype=np.int64)
        dead_part = tuple(int(t) for t in tiles[self.dead[tiles]])
        link_part = None
        if self.link_throttle:
            sub = self.route_scale()[np.ix_(tiles, tiles)]
            if (sub != 1.0).any():
                link_part = sub.tobytes()
        drift_part = tuple(self.drift.get(a, 1.0) for a in apps)
        sig = (dead_part, link_part, drift_part)
        if len(self._sig_cache) > 4096:
            self._sig_cache.clear()
        self._sig_cache[key] = (self.epoch, sig)
        return sig

    # --- route throttle matrix -------------------------------------------
    def route_scale(self) -> np.ndarray | None:
        """(n_tiles, n_tiles) per-route link-time multiplier, or None if clean.

        Entry [s, d] is the max throttle factor over the links the XY route
        s -> d crosses (1.0 where the route is clean).  A horizontal link
        (x, y)-(x+1, y) is crossed iff the route's source row is ``y`` and
        ``min(sx, dx) <= x < max(sx, dx)``; a vertical link (x, y)-(x, y+1)
        iff the destination column is ``x`` and ``min(sy, dy) <= y <
        max(sy, dy)``.  Rebuilt lazily after link mutations.
        """
        if not self.link_throttle:
            return None
        if self._scale_cache is None:
            d, _ = self.hw.mesh_shape
            t = np.arange(self.hw.n_tiles, dtype=np.int64)
            x, y = t % d, t // d
            sx, sy = x[:, None], y[:, None]   # source coords (rows)
            dx, dy = x[None, :], y[None, :]   # destination coords (cols)
            scale = np.ones((self.hw.n_tiles, self.hw.n_tiles), dtype=np.float64)
            for (a, b), f in sorted(self.link_throttle.items()):
                ax, ay = a % d, a // d
                bx, by = b % d, b // d
                if ay == by:  # horizontal link (lx, ly)-(lx+1, ly)
                    lx, ly = min(ax, bx), ay
                    crossed = (
                        (sy == ly)
                        & (np.minimum(sx, dx) <= lx)
                        & (lx < np.maximum(sx, dx))
                    )
                else:  # vertical link (lx, ly)-(lx, ly+1)
                    lx, ly = ax, min(ay, by)
                    crossed = (
                        (dx == lx)
                        & (np.minimum(sy, dy) <= ly)
                        & (ly < np.maximum(sy, dy))
                    )
                scale = np.where(crossed, np.maximum(scale, f), scale)
            self._scale_cache = scale
        return self._scale_cache

    def route_scale_array(self, src_tiles, dst_tiles) -> np.ndarray | None:
        """Gather per-pair route scales; None when no link is throttled."""
        scale = self.route_scale()
        if scale is None:
            return None
        return scale[np.asarray(src_tiles, np.int64), np.asarray(dst_tiles, np.int64)]


# The three hardware models evaluated in the paper (§6.1, Fig. 16).
DYNAP_SE = HardwareConfig(n_tiles=4)
DYNAP_SE_9 = HardwareConfig(n_tiles=9)
DYNAP_SE_16 = HardwareConfig(n_tiles=16)
# Production-shape chip for the multi-tenant stress harness: a 32x32 mesh
# (1024 tiles), the scale at which region-scoped joint placement pays off.
DYNAP_SE_1024 = HardwareConfig(n_tiles=1024)


def hardware_by_name(name: str) -> HardwareConfig:
    table = {
        "dynap-se": DYNAP_SE,
        "dynap-se-9": DYNAP_SE_9,
        "dynap-se-16": DYNAP_SE_16,
        "dynap-se-1024": DYNAP_SE_1024,
    }
    try:
        return table[name.lower()]
    except KeyError:  # pragma: no cover - defensive
        raise ValueError(f"unknown hardware model {name!r}; have {sorted(table)}")
