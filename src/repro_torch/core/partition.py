"""Crossbar-aware SNN partitioning (paper §2.3, Algorithm 1).

Greedy bin-packing: neurons sorted ascending by fan-in are merged into the
first existing cluster (clusters kept sorted by descending utilization) whose
post-merge IO / crosspoint / buffer usage still fits a crossbar; otherwise a
new cluster is opened.  Output is the clustered SNN: a neuron→cluster map
plus the inter-cluster spike-rate matrix used as SDFG channel rates (§2.4).

Two implementations of Algorithm 1, cross-validated in tests:

  * :func:`partition_greedy` — the wave-based vectorized packer (default).
    Neurons are processed in fan-in-sorted *waves* of 128 (the lazy
    utilization re-sort cadence); each wave's feasibility and input-overlap
    against the open probe clusters is scored in vectorized blocks (one
    boolean gather + segment-sum over the wave's unique-source CSR), and
    only the O(1) conflict-resolution walk per neuron stays in Python.
    Decisions replicate the scalar path EXACTLY — identical probe order,
    identical overlap counts, identical re-sort points — so ``cluster_of``
    is bit-identical to the reference on every input.
  * :func:`partition_greedy_reference` — the scalar per-neuron loop (the
    original Algorithm-1 transcription), kept as the cross-validation
    oracle and readable specification.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from .hardware import CrossbarConfig, HardwareConfig
from .snn import SNN

#: Lazy utilization re-sort cadence of Algorithm 1 line 11 (merges between
#: re-sorts) — also the wave width of the vectorized packer, so both
#: implementations re-sort at identical points.
WAVE = 128

#: Column-block width of the wave packer's lazily computed feasibility
#: matrix (probe clusters scored 16 at a time, on demand).
_F_BLOCK = 16


@dataclasses.dataclass
class Cluster:
    """Mutable packing state of one cluster (one crossbar's worth of SNN).

    ``input_mask`` is a boolean membership vector over all neurons: the
    union-size probe of Alg. 1 (can neuron n merge?) is then a vectorized
    fancy-index count instead of a Python set union — the difference between
    O(minutes) and O(seconds) on the 24k-neuron applications.
    """

    index: int
    neurons: list[int]
    input_mask: np.ndarray    # (n_neurons,) bool: distinct pre sources
    n_inputs: int
    n_synapses: int
    out_spikes: float         # per-iteration output spike volume (buffer use)

    def utilization(self, xbar: CrossbarConfig) -> float:
        """Paper's sort key: IO and crosspoint utilization, combined."""
        io = (self.n_inputs + len(self.neurons)) / (xbar.inputs + xbar.outputs)
        xpoint = self.n_synapses / xbar.crosspoints
        return 0.5 * (io + xpoint)


@dataclasses.dataclass
class ClusteredSNN:
    """Result of Algorithm 1.

    Inter-cluster channels are stored as parallel arrays sorted by
    ``(src, dst)`` — the array-native IR consumed directly by the SDFG and
    binding layers.  ``channel_spikes`` remains available as a lazily-built
    dict view for incremental call sites and tests.
    """

    snn: SNN
    cluster_of: np.ndarray            # (n_neurons,) int32
    n_clusters: int
    # channel i->j spike rate per application iteration (parallel arrays,
    # sorted by (src, dst); one entry per directed cluster pair with traffic)
    channel_src: np.ndarray           # (n_channels,) int64
    channel_dst: np.ndarray           # (n_channels,) int64
    channel_rate: np.ndarray          # (n_channels,) float64
    # per-cluster stats
    inputs_used: np.ndarray           # (n_clusters,)
    neurons_used: np.ndarray
    synapses_used: np.ndarray
    out_spikes: np.ndarray            # per-iteration spike volume out
    in_spikes: np.ndarray
    partition_time_s: float = 0.0

    @property
    def n_channels(self) -> int:
        return int(self.channel_src.size)

    @property
    def channel_spikes(self) -> dict[tuple[int, int], float]:
        """Compat dict view of the channel arrays (built on demand)."""
        return {
            (int(i), int(j)): float(r)
            for i, j, r in zip(self.channel_src, self.channel_dst, self.channel_rate)
        }

    def channel_degree(self) -> np.ndarray:
        """Per-cluster count of incident channels (in + out)."""
        return np.bincount(
            self.channel_src, minlength=self.n_clusters
        ) + np.bincount(self.channel_dst, minlength=self.n_clusters)

    def utilization(self, xbar: CrossbarConfig) -> dict[str, float]:
        io = (self.inputs_used + self.neurons_used) / (xbar.inputs + xbar.outputs)
        return {
            "io": float(np.mean(io)),
            "crosspoint": float(np.mean(self.synapses_used / xbar.crosspoints)),
        }


def _channel_arrays(
    snn: SNN, cluster_of: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """AER spike traffic between cluster pairs, as (src, dst, rate) arrays
    sorted by (src, dst).

    The NoC multicasts ONE packet per source-neuron spike per destination
    cluster (the destination crossbar fans it out to all target synapses
    internally), so traffic is summed over distinct (pre-neuron, dst-cluster)
    pairs — not over individual cut synapses.
    """
    src = cluster_of[snn.pre]
    dst = cluster_of[snn.post]
    cut = src != dst
    empty = np.array([], dtype=np.int64)
    if not np.any(cut):
        return empty, empty, np.array([], dtype=np.float64)
    n = int(cluster_of.max() + 1)
    # dedupe (pre neuron, dst cluster): one packet per spike per dst cluster
    pair_key = snn.pre[cut].astype(np.int64) * n + dst[cut]
    uniq_pairs = np.unique(pair_key)
    pre_n = (uniq_pairs // n).astype(np.int64)
    dst_c = (uniq_pairs % n).astype(np.int64)
    src_c = cluster_of[pre_n].astype(np.int64)
    chan_key = src_c * n + dst_c
    uniq, inv = np.unique(chan_key, return_inverse=True)
    sums = np.bincount(inv, weights=snn.spikes[pre_n])
    # np.unique returns sorted keys -> arrays are (src, dst)-sorted already
    return (uniq // n).astype(np.int64), (uniq % n).astype(np.int64), sums


def _synapse_csr(work: SNN) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR of fan-in synapse lists: (edge_order, starts, ends) by post."""
    order = np.argsort(work.post, kind="stable")
    post_sorted = work.post[order]
    starts = np.searchsorted(post_sorted, np.arange(work.n_neurons), side="left")
    ends = np.searchsorted(post_sorted, np.arange(work.n_neurons), side="right")
    return order, starts, ends


def _neuron_order(
    work: SNN, order: np.ndarray, starts: np.ndarray, ends: np.ndarray,
    fanin: np.ndarray,
) -> np.ndarray:
    """Alg. 1 line 1: ascending fan-in, ties broken by receptive field.

    Ties (whole conv layers share one fan-in) are broken by the minimum
    pre-synaptic source id so that window-sharing neurons are processed
    consecutively and land in the probe window of the utilization-sorted
    cluster list.  The per-neuron minimum is one ``np.minimum.reduceat``
    over the CSR layout — no Python pass over the neurons.
    """
    min_pre = np.zeros(work.n_neurons, dtype=np.int64)
    nonempty = ends > starts
    if nonempty.any():
        pre_sorted = work.pre[order].astype(np.int64)
        min_pre[nonempty] = np.minimum.reduceat(pre_sorted, starts[nonempty])
    return np.lexsort((min_pre, fanin))


def _finalize(
    work: SNN,
    cluster_of: np.ndarray,
    inputs_used: np.ndarray,
    neurons_used: np.ndarray,
    synapses_used: np.ndarray,
    out_spikes: np.ndarray,
    xbar: CrossbarConfig,
    buffer_limit: float,
    t0: float,
) -> ClusteredSNN:
    """Shared Alg.-1 epilogue: channel arrays, stats, line-13 checks."""
    assert np.all(cluster_of >= 0)
    ch_src, ch_dst, ch_rate = _channel_arrays(work, cluster_of)
    n_clusters = int(inputs_used.size)
    in_spikes = np.bincount(ch_dst, weights=ch_rate, minlength=n_clusters)
    result = ClusteredSNN(
        snn=work,
        cluster_of=cluster_of,
        n_clusters=n_clusters,
        channel_src=ch_src,
        channel_dst=ch_dst,
        channel_rate=ch_rate,
        inputs_used=inputs_used,
        neurons_used=neurons_used,
        synapses_used=synapses_used,
        out_spikes=out_spikes,
        in_spikes=in_spikes,
        partition_time_s=time.perf_counter() - t0,
    )
    check_clustering(result, xbar, buffer_limit)
    return result


# ======================================================================
# scalar reference (the original Algorithm-1 transcription)
# ======================================================================
def partition_greedy_reference(
    snn: SNN,
    hw: HardwareConfig,
    *,
    buffer_limit: Optional[int] = None,
    max_probe: int = 96,
    split_fill: float = 0.75,
) -> ClusteredSNN:
    """Algorithm 1, scalar per-neuron loop (cross-validation oracle).

    ``max_probe`` bounds how many clusters (in utilization order) are probed
    per neuron before opening a new cluster — a linear-time guard for the
    10⁴-neuron applications; packing quality is unaffected in practice
    because the probe order is utilization-descending exactly as in line 11.

    ``split_fill``: neurons are pre-split to at most ``split_fill *
    crossbar.inputs`` fan-in so that several (sub-)neurons can share a
    crossbar's input rows; a neuron using 100+ of 128 rows alone would
    force one-cluster-per-neuron fragmentation.
    """
    t0 = time.perf_counter()
    xbar = hw.tile.crossbar
    buffer_limit = buffer_limit or hw.tile.output_buffer

    work = snn.split_high_fanin(max(1, int(xbar.inputs * split_fill)))
    fanin = work.fanin()
    order, starts, ends = _synapse_csr(work)
    neuron_order = _neuron_order(work, order, starts, ends, fanin)

    clusters: list[Cluster] = []
    by_util: list[Cluster] = []  # maintained descending by utilization
    cluster_of = np.full(work.n_neurons, -1, dtype=np.int32)
    merges = 0

    for n in neuron_order:
        syn_idx = order[starts[n] : ends[n]]
        pre_arr = np.unique(work.pre[syn_idx])
        n_pre = int(pre_arr.size)
        n_syn = int(syn_idx.size)
        out_rate = float(work.spikes[n])

        placed = None
        # probe set: highest-utilization clusters (paper line 11) plus the
        # most recently opened ones — neurons arrive sorted by receptive
        # field, so the freshest clusters are the window-compatible ones
        # (they start at the tail of the utilization ordering otherwise).
        probes = by_util[:max_probe]
        if len(clusters) > max_probe:
            probes = clusters[-16:][::-1] + probes
        for c in probes:
            # cheap rejects before the vectorized union-size probe
            if (
                len(c.neurons) + 1 > xbar.outputs
                or c.n_synapses + n_syn > xbar.crosspoints
                or c.out_spikes + out_rate > buffer_limit
                or max(c.n_inputs, n_pre) > xbar.inputs
            ):
                continue
            if c.n_inputs + n_pre <= xbar.inputs:
                placed = c  # fits even with zero overlap
                break
            new_inputs = c.n_inputs + int(
                np.count_nonzero(~c.input_mask[pre_arr])
            )
            if new_inputs <= xbar.inputs:
                placed = c
                break
        if placed is None:
            placed = Cluster(
                len(clusters), [], np.zeros(work.n_neurons, dtype=bool), 0, 0, 0.0
            )
            clusters.append(placed)
            by_util.append(placed)
        placed.neurons.append(int(n))
        placed.n_inputs += int(np.count_nonzero(~placed.input_mask[pre_arr]))
        placed.input_mask[pre_arr] = True
        placed.n_synapses += n_syn
        placed.out_spikes += out_rate
        cluster_of[n] = placed.index
        # line 11: keep clusters utilization-descending (single float key —
        # cheap enough to re-sort lazily every 128 merges; counting merges
        # gives a fixed cadence regardless of which neuron ids are visited).
        merges += 1
        if len(by_util) > 1 and merges % WAVE == 0:
            by_util.sort(key=lambda c: -c.utilization(xbar))

    return _finalize(
        work,
        cluster_of,
        np.array([c.n_inputs for c in clusters]),
        np.array([len(c.neurons) for c in clusters]),
        np.array([c.n_synapses for c in clusters]),
        np.array([c.out_spikes for c in clusters]),
        xbar,
        buffer_limit,
        t0,
    )


# ======================================================================
# wave-based vectorized packer (default)
# ======================================================================
def partition_greedy(
    snn: SNN,
    hw: HardwareConfig,
    *,
    buffer_limit: Optional[int] = None,
    max_probe: int = 96,
    split_fill: float = 0.75,
) -> ClusteredSNN:
    """Algorithm 1 as a wave-based vectorized packer.

    Neurons are processed in fan-in-sorted waves of :data:`WAVE` (= the
    lazy utilization re-sort cadence, so probe order is frozen within a
    wave exactly as in the scalar path).  Per wave:

      * the wave's distinct pre-synaptic sources come from one global
        unique-(post, pre) CSR built once up front (no per-neuron
        ``np.unique``);
      * feasibility of every (wave neuron, probe cluster) pair is scored in
        vectorized column blocks, computed lazily as the probe walk first
        reaches a block: the capacity checks are one broadcast compare and
        the input-union sizes come from a single boolean gather over the
        input-membership matrix + ``np.add.reduceat`` per neuron segment;
      * placements are applied by a conflict-resolving walk: clusters
        untouched since the wave started use the precomputed block entries
        (O(1) per probe), clusters modified mid-wave are re-probed exactly
        against live state (O(fan-in), the same count the scalar path pays).

    Produces bit-identical ``cluster_of`` to
    :func:`partition_greedy_reference` on every input — the cross-validation
    suite asserts equality — at a fraction of the interpreter cost.
    ``max_probe`` / ``split_fill`` / ``buffer_limit`` as in the reference.
    """
    t0 = time.perf_counter()
    xbar = hw.tile.crossbar
    inputs_cap, outputs_cap, xpoints_cap = (
        xbar.inputs, xbar.outputs, xbar.crosspoints,
    )
    buffer_limit = buffer_limit or hw.tile.output_buffer

    work = snn.split_high_fanin(max(1, int(xbar.inputs * split_fill)))
    n = work.n_neurons
    fanin = work.fanin()
    order, starts, ends = _synapse_csr(work)
    neuron_order = _neuron_order(work, order, starts, ends, fanin)

    # global unique-(post, pre) CSR: per-neuron distinct sources, sorted
    pair_key = work.post.astype(np.int64) * n + work.pre
    upairs = np.unique(pair_key)
    upost = upairs // n
    upre_all = upairs % n
    ustarts = np.searchsorted(upost, np.arange(n), side="left")
    uends = np.searchsorted(upost, np.arange(n), side="right")
    n_pre_all = uends - ustarts

    # -- growable cluster-state arrays (id = creation order) ------------
    cap = 256
    mask_t = np.zeros((cap, n), dtype=bool)       # input membership, by row
    cl_inputs = np.zeros(cap, dtype=np.int64)
    cl_nneur = np.zeros(cap, dtype=np.int64)
    cl_nsyn = np.zeros(cap, dtype=np.int64)
    cl_out = np.zeros(cap, dtype=np.float64)
    cl_lo = np.full(cap, n, dtype=np.int64)       # input-id range (receptive
    cl_hi = np.full(cap, -1, dtype=np.int64)      # field); no overlap outside
    touch_stamp = np.full(cap, -1, dtype=np.int64)   # last wave that modified
    col_stamp = np.full(cap, -1, dtype=np.int64)     # wave of the F column
    col_idx = np.zeros(cap, dtype=np.int64)          # column in this wave's F

    by_util: list[int] = []      # cluster ids, utilization-descending
    cluster_of = np.full(n, -1, dtype=np.int32)
    n_clusters = 0
    spikes = work.spikes

    def _grow() -> None:
        nonlocal cap, mask_t, cl_inputs, cl_nneur, cl_nsyn, cl_out
        nonlocal cl_lo, cl_hi, touch_stamp, col_stamp, col_idx
        extra = cap
        mask_t = np.vstack([mask_t, np.zeros((extra, n), dtype=bool)])
        cl_inputs = np.concatenate([cl_inputs, np.zeros(extra, np.int64)])
        cl_nneur = np.concatenate([cl_nneur, np.zeros(extra, np.int64)])
        cl_nsyn = np.concatenate([cl_nsyn, np.zeros(extra, np.int64)])
        cl_out = np.concatenate([cl_out, np.zeros(extra)])
        cl_lo = np.concatenate([cl_lo, np.full(extra, n, np.int64)])
        cl_hi = np.concatenate([cl_hi, np.full(extra, -1, np.int64)])
        touch_stamp = np.concatenate([touch_stamp, np.full(extra, -1, np.int64)])
        col_stamp = np.concatenate([col_stamp, np.full(extra, -1, np.int64)])
        col_idx = np.concatenate([col_idx, np.zeros(extra, np.int64)])
        cap += extra

    n_waves = (n + WAVE - 1) // WAVE
    for wave_no in range(n_waves):
        wave_ids = neuron_order[wave_no * WAVE : (wave_no + 1) * WAVE]
        w_count = wave_ids.size

        # -- wave snapshot: probe universe (newest 16 first so the common
        # case touches only block 0) + unique-source concatenation -------
        univ: list[int] = []
        if n_clusters > max_probe:
            for cid in range(n_clusters - 1, max(n_clusters - 17, -1), -1):
                if col_stamp[cid] != wave_no:
                    col_stamp[cid] = wave_no
                    col_idx[cid] = len(univ)
                    univ.append(cid)
        for cid in by_util[:max_probe]:
            if col_stamp[cid] != wave_no:
                col_stamp[cid] = wave_no
                col_idx[cid] = len(univ)
                univ.append(cid)
        univ_arr = np.asarray(univ, dtype=np.int64)

        n_pre_w = n_pre_all[wave_ids]
        n_syn_w = fanin[wave_ids].astype(np.int64)
        rate_w = spikes[wave_ids]
        seg_lens = n_pre_w
        seg_starts = np.concatenate([[0], np.cumsum(seg_lens)[:-1]])
        tot = int(seg_lens.sum())
        if tot:
            flat = (
                np.repeat(ustarts[wave_ids] - seg_starts, seg_lens)
                + np.arange(tot)
            )
            wave_pres = upre_all[flat]
            safe_s = np.minimum(ustarts[wave_ids], upre_all.size - 1)
            lo_w = np.where(seg_lens > 0, upre_all[safe_s], 0)
            hi_w = np.where(
                seg_lens > 0, upre_all[np.maximum(uends[wave_ids] - 1, 0)], -1
            )
        else:
            wave_pres = np.array([], dtype=np.int64)
            lo_w = np.zeros(w_count, dtype=np.int64)
            hi_w = np.full(w_count, -1, dtype=np.int64)
        nonempty = seg_lens > 0

        # -- identical-window runs: neuron i chains onto neuron i-1's run
        # when their unique-pre segments and synapse counts are equal (the
        # conv-style generators emit long stretches of these).  A follower
        # whose rate is not below its run head's can then be committed to
        # the head's cluster without walking: it rejects every cluster the
        # head rejected (all checks are shared except the buffer check,
        # which is monotone in the rate), and it adds zero new inputs to
        # the head's cluster — so only the output/crosspoint/buffer
        # capacity cumsums decide how much of the run fits.
        same_prev = np.zeros(w_count, dtype=bool)
        if w_count > 1:
            eq = (
                (seg_lens[1:] == seg_lens[:-1])
                & (n_syn_w[1:] == n_syn_w[:-1])
                & (lo_w[1:] == lo_w[:-1])
                & (hi_w[1:] == hi_w[:-1])
            )
            for p in np.flatnonzero(eq):
                same_prev[p + 1] = bool(np.array_equal(
                    wave_pres[seg_starts[p]:seg_starts[p] + seg_lens[p]],
                    wave_pres[
                        seg_starts[p + 1]:seg_starts[p + 1] + seg_lens[p + 1]
                    ],
                ))
        same_prev_l = same_prev.tolist()

        n_blocks = (len(univ) + _F_BLOCK - 1) // _F_BLOCK
        fit = np.zeros((w_count, n_blocks * _F_BLOCK), dtype=bool)
        blk_done = np.zeros(max(n_blocks, 1), dtype=bool)

        def _compute_block(blk: int) -> None:
            """Feasibility of the whole wave vs one 16-column probe block.

            Valid only for columns untouched since the wave started — the
            probe walk never consults touched columns here.  Input-union
            sizes (the expensive part) are gathered only for columns whose
            input-id range intersects a wave neuron's receptive field —
            disjoint ranges mean zero overlap, which cannot rescue a pair
            that already failed the zero-overlap fit.
            """
            cols = univ_arr[blk * _F_BLOCK : (blk + 1) * _F_BLOCK]
            ci = cl_inputs[cols][None, :]
            cheap = (
                (cl_nneur[cols][None, :] + 1 <= outputs_cap)
                & (cl_nsyn[cols][None, :] + n_syn_w[:, None] <= xpoints_cap)
                & (cl_out[cols][None, :] + rate_w[:, None] <= buffer_limit)
                & (np.maximum(ci, n_pre_w[:, None]) <= inputs_cap)
            )
            zerofit = ci + n_pre_w[:, None] <= inputs_cap
            blk_fit = cheap & zerofit
            need = (
                cheap
                & ~zerofit
                & (cl_lo[cols][None, :] <= hi_w[:, None])
                & (cl_hi[cols][None, :] >= lo_w[:, None])
            )
            col_sel = need.any(axis=0)
            if col_sel.any() and tot:
                cols_g = cols[col_sel]
                vals = mask_t[np.ix_(cols_g, wave_pres)]
                red = np.add.reduceat(vals, seg_starts[nonempty], axis=1)
                ov = np.zeros((cols_g.size, w_count), dtype=np.int64)
                ov[:, nonempty] = red
                fits_ov = (
                    cl_inputs[cols_g][None, :] + n_pre_w[:, None] - ov.T
                    <= inputs_cap
                )
                sub = blk_fit[:, col_sel]
                blk_fit[:, col_sel] = sub | (need[:, col_sel] & fits_ov)
            fit[:, blk * _F_BLOCK : blk * _F_BLOCK + cols.size] = blk_fit
            blk_done[blk] = True

        def _fits_live(
            cid: int, npre: int, nsyn: int, rate: float, upre_seg: np.ndarray
        ) -> bool:
            """Exact live probe of one (possibly mid-wave-modified) cluster
            — the same checks and overlap count the scalar path performs."""
            if (
                cl_nneur[cid] + 1 > outputs_cap
                or cl_nsyn[cid] + nsyn > xpoints_cap
                or cl_out[cid] + rate > buffer_limit
                or max(cl_inputs[cid], npre) > inputs_cap
            ):
                return False
            if cl_inputs[cid] + npre <= inputs_cap:
                return True
            if npre == 0 or cl_hi[cid] < upre_seg[0] or cl_lo[cid] > upre_seg[-1]:
                return False  # disjoint ranges: zero overlap cannot fit
            ov = int(np.count_nonzero(mask_t[cid, upre_seg]))
            return cl_inputs[cid] + npre - ov <= inputs_cap

        # Python-list mirrors of the per-probe lookups: the walk below reads
        # them once per probe, and list indexing is several times cheaper
        # than numpy scalar indexing at this granularity.
        touched_l = (touch_stamp[:n_clusters] == wave_no).tolist()
        col_l = np.where(
            col_stamp[:n_clusters] == wave_no, col_idx[:n_clusters], -1
        ).tolist()
        npre_l = n_pre_w.tolist()
        nsyn_l = n_syn_w.tolist()
        rate_l = rate_w.tolist()
        wave_ids_l = wave_ids.tolist()

        # -- conflict-resolving placement walk (exact scalar semantics,
        # identical-window runs bulk-committed behind each walked head) -
        i = 0
        while i < w_count:
            nid = wave_ids_l[i]
            npre = npre_l[i]
            nsyn = nsyn_l[i]
            rate = rate_l[i]
            upre_seg = upre_all[ustarts[nid] : uends[nid]]

            placed = -1
            if n_clusters > max_probe:
                for cid in range(n_clusters - 1, n_clusters - 17, -1):
                    j = -1 if touched_l[cid] else col_l[cid]
                    if j >= 0:
                        blk = j // _F_BLOCK
                        if not blk_done[blk]:
                            _compute_block(blk)
                        if fit[i, j]:
                            placed = cid
                            break
                    elif _fits_live(cid, npre, nsyn, rate, upre_seg):
                        placed = cid
                        break
            if placed < 0:
                for cid in by_util[:max_probe]:
                    j = -1 if touched_l[cid] else col_l[cid]
                    if j >= 0:
                        blk = j // _F_BLOCK
                        if not blk_done[blk]:
                            _compute_block(blk)
                        if fit[i, j]:
                            placed = cid
                            break
                    elif _fits_live(cid, npre, nsyn, rate, upre_seg):
                        placed = cid
                        break
            if placed < 0:
                if n_clusters == cap:
                    _grow()
                placed = n_clusters
                n_clusters += 1
                by_util.append(placed)
                touched_l.append(True)
                col_l.append(-1)

            row = mask_t[placed]
            cl_inputs[placed] += npre - int(
                np.count_nonzero(row[upre_seg])
            )
            row[upre_seg] = True
            cl_nneur[placed] += 1
            cl_nsyn[placed] += nsyn
            cl_out[placed] += rate
            if npre:
                if upre_seg[0] < cl_lo[placed]:
                    cl_lo[placed] = upre_seg[0]
                if upre_seg[-1] > cl_hi[placed]:
                    cl_hi[placed] = upre_seg[-1]
            cluster_of[nid] = placed
            touched_l[placed] = True
            touch_stamp[placed] = wave_no

            # bulk-commit the identical-window run behind this head: the
            # run extends while each follower chains (same window + nsyn)
            # and its rate is not below the HEAD's (the neuron whose walk
            # rejections the run reuses); capacity decides how many fit.
            i += 1
            run_end = i
            while (
                run_end < w_count
                and same_prev_l[run_end]
                and rate_l[run_end] >= rate
            ):
                run_end += 1
            if run_end > i:
                m = run_end - i
                m = min(m, outputs_cap - int(cl_nneur[placed]))
                if nsyn > 0:
                    m = min(
                        m, (xpoints_cap - int(cl_nsyn[placed])) // nsyn
                    )
                if m > 0:
                    # buffer check accumulates in the scalar loop's exact
                    # float order, so the cutoff is bit-identical
                    out = float(cl_out[placed])
                    take = 0
                    for r in rate_l[i : i + m]:
                        if out + r > buffer_limit:
                            break
                        out += r
                        take += 1
                    m = take
                if m > 0:
                    cluster_of[wave_ids[i : i + m]] = placed
                    cl_nneur[placed] += m
                    cl_nsyn[placed] += m * nsyn
                    cl_out[placed] = out
                    i += m

        # line 11 re-sort at the exact scalar cadence (every WAVE merges);
        # np.argsort(stable) over the negated key == list.sort(key=-util)
        if w_count == WAVE and len(by_util) > 1:
            util = 0.5 * (
                (cl_inputs[:n_clusters] + cl_nneur[:n_clusters])
                / (inputs_cap + outputs_cap)
                + cl_nsyn[:n_clusters] / xpoints_cap
            )
            ids = np.asarray(by_util, dtype=np.int64)
            by_util = ids[np.argsort(-util[ids], kind="stable")].tolist()

    return _finalize(
        work,
        cluster_of,
        cl_inputs[:n_clusters].copy(),
        cl_nneur[:n_clusters].copy(),
        cl_nsyn[:n_clusters].copy(),
        cl_out[:n_clusters].copy(),
        xbar,
        buffer_limit,
        t0,
    )


def check_clustering(
    c: ClusteredSNN, xbar: CrossbarConfig, buffer_limit: float
) -> None:
    """Consistency, connectivity and capacity checks (Alg. 1 line 13)."""
    assert c.inputs_used.max(initial=0) <= xbar.inputs, "input-port overflow"
    assert c.neurons_used.max(initial=0) <= xbar.outputs, "output-port overflow"
    assert c.synapses_used.max(initial=0) <= xbar.crosspoints, "crosspoint overflow"
    assert c.out_spikes.max(initial=0.0) <= buffer_limit + 1e-9, "buffer overflow"
    # every neuron mapped exactly once
    counts = np.bincount(c.cluster_of, minlength=c.n_clusters)
    assert counts.sum() == c.snn.n_neurons
    # deadlock-freedom of the clustered graph is guaranteed by construction:
    # every channel's production is consumed within one iteration (RptV = 1);
    # the SDFG layer re-verifies with an explicit liveness check.
