"""The port's design-space sweep against the JAX reference, on
tests/test_explore.py's ``test_sweep_report_matches_per_graph_loop``
setup: ``"edges"`` bit-identical in every SweepPoint field, ``rows()``
and ``pareto_front``; ``"csr"`` within ``rtol 1e-8``; the per-graph loops
equal.  Also ``BINDERS`` and ``schedule.random_orders``."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as rc

import repro_torch.core as tc

GRID = dict(crossbar_sizes=(64, 128), tile_counts=(1, 4), binders=("ours", "spinemap"))


@pytest.fixture(scope="module")
def snns():
    return rc.small_app(260, 3200, seed=31), tc.small_app(260, 3200, seed=31)


@pytest.fixture(scope="module")
def ref_sweep(snns):
    return rc.sweep([snns[0]], **GRID)          # "auto" is "edges" on the host


def _fields(points):
    return [dataclasses.astuple(p) for p in points]


@pytest.mark.parametrize("order_method", ["batch", "heapq"])
def test_sweep_edges_bit_identical_to_reference(snns, ref_sweep, order_method):
    want = ref_sweep if order_method == "batch" else rc.sweep(
        [snns[0]], order_method=order_method, **GRID)
    got = tc.sweep([snns[1]], order_method=order_method, backend="edges",
                   device="cpu", **GRID)
    assert got.n_candidates == want.n_candidates == 8
    assert _fields(got.points) == _fields(want.points)
    assert got.rows() == want.rows()
    assert _fields(got.pareto_front(snns[1].name)) == _fields(want.pareto_front(snns[0].name))
    assert got.best(snns[1].name) == tc.SweepPoint(*dataclasses.astuple(
        want.best(snns[0].name)))
    assert got.method == "batched" and got.build_time_s > 0
    with pytest.raises(KeyError):
        got.best("nope")


def test_sweep_csr_within_1e8_of_reference(snns, ref_sweep):
    got = tc.sweep([snns[1]], backend="csr", device="cpu", **GRID)
    for g, w in zip(got.points, ref_sweep.points):
        assert (g.app, g.crossbar, g.n_tiles, g.binder, g.n_clusters, g.cut_spikes,
                g.spike_hops) == (w.app, w.crossbar, w.n_tiles, w.binder, w.n_clusters,
                                  w.cut_spikes, w.spike_hops)
        assert g.throughput == pytest.approx(w.throughput, rel=1e-8)
        assert g.energy == pytest.approx(w.energy, rel=1e-8)


@pytest.mark.parametrize("method", ["howard-loop", "binary-loop"])
def test_sweep_loops_equal_reference(snns, method):
    got = tc.sweep([snns[1]], method=method, device="cpu", **GRID)
    want = rc.sweep([snns[0]], method=method, **GRID)
    assert _fields(got.points) == _fields(want.points)
    assert got.method == method


def test_analyze_candidates_dense_and_unknown_method(snns):
    metas, graphs, _, aux = tc.build_candidates([snns[1]], **GRID)
    assert len(metas) == len(graphs) == 8 and aux["dyn_energy"].shape == (8,)
    exact = tc.analyze_candidates(graphs, backend="edges", device="cpu")
    dense = tc.analyze_candidates(graphs, backend="dense", device="cpu")
    # the dense backend's contract against the exact search (the reference's 5e-4)
    np.testing.assert_allclose(dense, exact, rtol=5e-4)
    with pytest.raises(ValueError):
        tc.analyze_candidates(graphs, method="nope", device="cpu")


def test_sweep_runs_on_the_card_unless_asked(snns, monkeypatch):
    """The analysis (and only the "optimized" binder's search while
    building) goes to ``device``: None is CUDA and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.sweep([snns[1]], tile_counts=(4,))
    # the heuristic binders build on the host whatever the device
    metas, _, _, _ = tc.build_candidates([snns[1]], tile_counts=(4,),
                                         binders=("ours", "pycarl", "spinemap"))
    assert [m.binder for m in metas] == ["ours", "pycarl", "spinemap"]
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.build_candidates([snns[1]], tile_counts=(4,), binders=("optimized",))
    rep = tc.sweep([snns[1]], tile_counts=(4,), binders=("ours", "optimized"), device="cpu")
    opt, ours = rep.points[1], rep.points[0]
    assert opt.binder == "optimized" and opt.throughput >= ours.throughput * (1 - 1e-8)


def test_binders_match_reference():
    assert list(tc.BINDERS) == list(rc.BINDERS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_orders_match_reference(snns, seed):
    r_cl = rc.partition_greedy(snns[0], rc.DYNAP_SE)
    t_cl = tc.partition_greedy(snns[1], tc.DYNAP_SE)
    r_app = rc.sdfg_from_clusters(r_cl, hw=rc.DYNAP_SE)
    t_app = tc.sdfg_from_clusters(t_cl, hw=tc.DYNAP_SE)
    binding = np.random.default_rng(seed).integers(0, rc.DYNAP_SE.n_tiles, r_app.n_actors)
    want = rc.random_orders(r_app, binding, rc.DYNAP_SE, seed=seed)
    assert tc.random_orders(t_app, binding, tc.DYNAP_SE, seed=seed) == want
