"""Joint and region placement in the port against the JAX reference: the
fused engine and search, the component periods, the joint controller,
the synthetic workloads and the deadlock check."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as rc

import repro_torch.core as tc
from repro_torch.launch.sharding import Mesh

HW64 = dataclasses.replace(rc.DYNAP_SE, n_tiles=64)
THW64 = dataclasses.replace(tc.DYNAP_SE, n_tiles=64)
BUDGET = (2, 8)


def _compiled(mod, seed, neurons=170, synapses=2100):
    snn = mod.small_app(neurons, synapses, seed=seed)
    cl = mod.partition_greedy(snn, mod.DYNAP_SE)
    app = mod.sdfg_from_clusters(cl, hw=mod.DYNAP_SE)
    order, _ = mod.single_tile_order(cl, mod.DYNAP_SE)
    return app, order


def _bindings(n_actors, n_rows, seed, n_tiles=4):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n_tiles, size=n_actors) for _ in range(n_rows)])


def _preps(mod, with_energy=False):
    """Three prepared batches of ragged shapes (actors, edges and rows)."""
    preps = []
    for seed, rows, neurons in ((1, 3, 170), (2, 5, 120), (3, 2, 240)):
        app, order = _compiled(mod, seed, neurons=neurons)
        b = _bindings(app.n_actors, rows, seed)
        ob = mod.project_order_batch(order, b)
        preps.append(mod.prepare_execution(app, b, mod.DYNAP_SE, ob,
                                           with_energy=with_energy))
    return preps


# -- maxplus / engine ------------------------------------------------------
@pytest.mark.parametrize("method", ["howard", "binary", "power"])
def test_throughput_matches_reference(method):
    for seed in (4, 5):
        r_app, _ = _compiled(rc, seed)
        t_app, _ = _compiled(tc, seed)
        kw = {"device": "cpu"} if method == "power" else {}
        got = tc.throughput(t_app, method=method, **kw)
        want = rc.throughput(r_app, method=method)
        if method == "power":      # float32 iteration on either side
            assert got == pytest.approx(want, rel=1e-5)
        else:
            assert got == want
    with pytest.raises(ValueError):
        tc.throughput(t_app, method="nope")


def test_batch_throughputs_matches_reference():
    r_app, order = _compiled(rc, 6)
    t_app, _ = _compiled(tc, 6)
    b = _bindings(r_app.n_actors, 6, 6)
    want = rc.batch_throughputs(r_app, b, rc.DYNAP_SE, rc.project_order_batch(order, b))
    ob = tc.project_order_batch(order, b)
    got = tc.batch_throughputs(t_app, b, tc.DYNAP_SE, ob, backend="edges", device="cpu")
    np.testing.assert_array_equal(got, want)
    got = tc.batch_throughputs(t_app, b, tc.DYNAP_SE, ob, backend="csr", device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-8)


def _union(mod, seeds=(7, 8, 9)):
    graphs, orders = zip(*(_compiled(mod, s) for s in seeds))
    offsets = np.cumsum([0] + [g.n_actors for g in graphs])
    union = mod.disjoint_union(list(graphs))
    order = [int(a) + int(off) for o, off in zip(orders, offsets[:-1]) for a in o]
    # apps 0 and 1 share tiles 0-3, app 2 sits alone on 8-11
    binding = np.concatenate([
        np.arange(graphs[0].n_actors) % 4, np.arange(graphs[1].n_actors) % 4,
        8 + np.arange(graphs[2].n_actors) % 4,
    ])
    return union, order, binding


def test_weak_components_and_component_periods_match_reference():
    r_union, order, binding = _union(rc)
    t_union, _, _ = _union(tc)
    r_ob = rc.project_order_batch(order, binding[None, :])
    t_ob = tc.project_order_batch(order, binding[None, :])
    st = rc.stack_hardware_aware(r_union, binding, rc.DYNAP_SE_16, r_ob)
    live = np.isfinite(st.weights[0])
    np.testing.assert_array_equal(
        tc.weak_components(r_union.n_actors, st.src[0][live], st.dst[0][live]),
        rc.weak_components(r_union.n_actors, st.src[0][live], st.dst[0][live]),
    )
    cs_r, cs_t = rc.ChipState(rc.DYNAP_SE_16), tc.ChipState(tc.DYNAP_SE_16)
    for cs in (cs_r, cs_t):
        cs.throttle_link(8, 9, 3.0)
    rl, rp, rm = rc.union_component_periods(
        r_union, binding, rc.DYNAP_SE_16, r_ob, with_metrics=True, chip_state=cs_r)
    for backend in ("edges", "csr"):
        tl, tp, tm = tc.union_component_periods(
            t_union, binding, tc.DYNAP_SE_16, t_ob, with_metrics=True, chip_state=cs_t,
            backend=backend, device="cpu")
        np.testing.assert_array_equal(tl, rl)
        assert tp.shape == rp.shape == (2,)
        if backend == "edges":
            np.testing.assert_array_equal(tp, rp)
        else:
            np.testing.assert_allclose(tp, rp, rtol=1e-8)
        for f in ("cut_traffic", "spike_hops", "tiles_used"):
            np.testing.assert_array_equal(getattr(tm, f), getattr(rm, f))
    # a dead tile under app 2 makes its component's period inf
    cs_r.fail_tiles([8])
    cs_t.fail_tiles([8])
    _, rp = rc.union_component_periods(r_union, binding, rc.DYNAP_SE_16, r_ob, chip_state=cs_r)
    _, tp = tc.union_component_periods(t_union, binding, tc.DYNAP_SE_16, t_ob, chip_state=cs_t,
                                       backend="edges", device="cpu")
    np.testing.assert_array_equal(tp, rp)
    assert np.isinf(tp).sum() == 1


def test_fuse_stacks_matches_reference_and_rows_solve_alone():
    r_preps, t_preps = _preps(rc), _preps(tc)
    r_fused, r_slices = rc.fuse_stacks([p.stack for p in r_preps])
    t_fused, t_slices = tc.fuse_stacks([p.stack for p in t_preps])
    assert t_slices == r_slices and t_fused.n_actors == r_fused.n_actors
    for f in ("src", "dst", "tokens", "weights"):
        np.testing.assert_array_equal(getattr(t_fused, f), getattr(r_fused, f))
    assert np.isneginf(t_fused.weights).any()      # ragged members are padded
    # "edges" is the reference's, bit for bit, fused or not
    np.testing.assert_array_equal(tc.mcr_batch(t_fused, backend="edges", device="cpu"),
                                  rc.mcr_batch(r_fused, backend="edges"))
    got = tc.mcr_batch(t_fused, backend="csr", device="cpu")
    for p, s in zip(t_preps, t_slices):
        np.testing.assert_array_equal(got[s], tc.mcr_batch(p.stack, backend="csr", device="cpu"))
        np.testing.assert_allclose(got[s], rc.mcr_batch(p.stack, backend="edges"), rtol=1e-8)
    one, sl = tc.fuse_stacks([t_preps[0].stack])
    assert one is t_preps[0].stack and sl == [slice(0, t_preps[0].n_rows)]


def _ring_stack(seed, b, n, extra):
    """``b`` rows of an ``n``-actor ring (one token) plus ``extra`` random
    edges, with weights that are not dyadic."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.tile(np.arange(n), (b, 1)), rng.integers(0, n, (b, extra))], 1)
    dst = np.concatenate([np.tile((np.arange(n) + 1) % n, (b, 1)),
                          rng.integers(0, n, (b, extra))], 1)
    tok = np.concatenate([np.zeros((b, n), int), rng.integers(0, 3, (b, extra))], 1)
    tok[:, 0] = 1
    w = rng.uniform(0.1, 9.0, size=src.shape)
    return tc.EdgeStack(n_actors=n, src=src, dst=dst, tokens=tok, weights=w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csr_rows_solve_alone_whatever_the_padding(seed):
    """An 11-actor member padded to 40 actors: numpy's pairwise sum of the
    path bound groups its terms by the row's length, which moves the
    reference's "edges" fused rows by an ulp on these seeds; "csr" sums the
    bound left to right, so its fused rows are each member's own."""
    small, big = _ring_stack(seed, 3, 11, 6), _ring_stack(100 + seed, 2, 40, 30)
    fused, slices = tc.fuse_stacks([small, big])
    padded, _ = tc.pad_stack_to_buckets(small)
    for stack, rows in ((fused, slices[0]), (padded, slice(0, small.n_graphs))):
        got = tc.mcr_batch(stack, backend="csr", device="cpu")[rows]
        own = tc.mcr_batch(small, backend="csr", device="cpu")
        np.testing.assert_array_equal(got, own)
        np.testing.assert_allclose(own, tc.mcr_batch(small, backend="edges", device="cpu"),
                                   rtol=1e-8)


def test_batch_execute_fused_matches_reference():
    r_preps, t_preps = _preps(rc, True), _preps(tc, True)
    want = rc.batch_execute_fused(r_preps, backend="edges")
    mesh = Mesh((torch.device("cpu"),) * 2)
    for backend in ("edges", "csr"):
        got = tc.batch_execute_fused(t_preps, backend=backend, device="cpu")
        # a mesh shards "csr" bit-identically and is dropped by "edges"
        meshed = tc.batch_execute_fused(t_preps, backend=backend, mesh=mesh, device="cpu")
        for g, m, w, p in zip(got, meshed, want, t_preps):
            np.testing.assert_array_equal(m.periods, g.periods)
            np.testing.assert_array_equal(m.energies, g.energies)
            assert g.periods.shape == (p.n_rows,)
            if backend == "edges":
                np.testing.assert_array_equal(g.periods, w.periods)
                np.testing.assert_array_equal(g.energies, w.energies)
            else:
                np.testing.assert_allclose(g.periods, w.periods, rtol=1e-8)
                np.testing.assert_allclose(g.energies, w.energies, rtol=1e-8)


# -- optimizer -------------------------------------------------------------
def _task(mod, seed, *, generations, population=10):
    app, order = _compiled(mod, seed)
    seed_b = (np.arange(app.n_actors) + seed) % mod.DYNAP_SE.n_tiles
    return dict(
        app=app, hw=mod.DYNAP_SE, single_order=order,
        seed_bindings={"seed": seed_b},
        population=population, generations=generations, elite=4,
        rng_seed=seed,
    )


@pytest.mark.parametrize("gens", [(2, 2), (1, 3)], ids=["lockstep", "mixed"])
def test_fused_binding_search_matches_reference(gens):
    seeds = (7, 8) if gens == (2, 2) else (9, 10)
    want = rc.optimize_binding_graphs_fused(
        [_task(rc, s, generations=g) for s, g in zip(seeds, gens)])
    for backend in ("edges", "csr"):
        tasks = [_task(tc, s, generations=g) for s, g in zip(seeds, gens)]
        got = tc.optimize_binding_graphs_fused(tasks, backend=backend, device="cpu")
        alone = [
            tc.optimize_binding_graph(
                t["app"], t["hw"], t["single_order"], backend=backend, device="cpu",
                **{k: v for k, v in t.items() if k not in ("app", "hw", "single_order")})
            for t in tasks
        ]
        for g, w, a in zip(got, want, alone):
            # the fused search is its standalone run, bit for bit
            np.testing.assert_array_equal(g.binding, a.binding)
            assert g.period == a.period and g.energy == a.energy
            assert [h.best_period for h in g.history] == [h.best_period for h in a.history]
            assert g.n_stack_builds == w.n_stack_builds
            if backend == "edges":
                np.testing.assert_array_equal(g.binding, w.binding)
                assert g.period == w.period and g.energy == w.energy
                assert [h.best_period for h in g.history] == \
                    [h.best_period for h in w.history]
            else:
                # "csr" is exact to rel_tol: where two candidates' periods
                # agree within it (seed 8: 28.4929681 and 28.4929680), it
                # may keep the other one, so only the period is held
                assert g.period == pytest.approx(w.period, rel=1e-8)


# -- the joint controller --------------------------------------------------
def _apps(mod, n, seed0=90, prefix="r"):
    apps = []
    for i in range(n):
        snn = mod.small_app(150, 1800, seed=seed0 + i)
        snn.name = f"{prefix}{i}"
        apps.append(snn)
    return apps


def _drive(ctl, mod):
    """tests/test_regions.py's fixed admit/evict/finish churn."""
    apps = _apps(mod, 6)
    for a in apps:
        ctl.register(a)
    for a in apps[:5]:
        ctl.admit(a.name, n_tiles_request=3)
    ctl.evict(apps[1].name)
    ctl.admit(apps[5].name, n_tiles_request=3)
    ctl.finish(apps[2].name)
    ctl.admit(apps[1].name, n_tiles_request=2)
    return ctl


def _strip_wall(traj):
    return [{k: v for k, v in e.items() if k != "wall_s"} for e in traj]


@pytest.mark.parametrize("region_scope", [True, False], ids=["region", "unscoped"])
def test_joint_controller_matches_reference(region_scope):
    ref = _drive(rc.AdmissionController(
        HW64, placement="joint", joint_budget=BUDGET, region_scope=region_scope), rc)
    ref_traj = _strip_wall(ref.trajectory())
    kinds = {e["kind"] for e in ref_traj}
    assert "rebalance" in kinds
    for backend in ("edges", "csr"):
        ctl = _drive(tc.AdmissionController(
            THW64, placement="joint", joint_budget=BUDGET, region_scope=region_scope,
            backend=backend, device="cpu"), tc)
        traj = _strip_wall(ctl.trajectory())
        assert sorted(ctl.reports) == sorted(ref.reports)
        if backend == "edges":
            assert traj == ref_traj
            assert ctl.chip_metrics() == ref.chip_metrics()
            for n in ref.reports:
                np.testing.assert_array_equal(ctl.reports[n].binding, ref.reports[n].binding)
                assert ctl.reports[n].orders == ref.reports[n].orders
        else:
            # every event's tiles are the reference's; within them "csr"
            # may keep another binding where the chip periods tie within
            # rel_tol (unscoped: r0 on tiles 5-6 for 6-7, chip throughput
            # 0.034245139773 against 0.034245139796)
            np.testing.assert_allclose(ctl.chip_metrics(exact=True)["chip_throughput"],
                                       ref.chip_metrics(exact=True)["chip_throughput"],
                                       rtol=1e-8)
            assert [(e["kind"], e["app"], e["tiles"], e["scope"], e["region_apps"])
                    for e in traj] == [(e["kind"], e["app"], e["tiles"], e["scope"],
                                        e["region_apps"]) for e in ref_traj]
            # (energy is not the objective here: a tie-flipped binding
            # keeps the chip period and may change the chip energy)
            for key in ("throughput", "chip_throughput"):
                np.testing.assert_allclose([e[key] for e in traj],
                                           [e[key] for e in ref_traj], rtol=1e-8)
        mc, me = ctl.chip_metrics(), ctl.chip_metrics(exact=True)
        assert mc["chip_throughput"] == pytest.approx(me["chip_throughput"], rel=1e-6)


def test_joint_controller_objectives_match_reference():
    for objective in ("energy", "pareto"):
        ref = _drive(rc.AdmissionController(
            HW64, placement="joint", joint_budget=(1, 6), objective=objective), rc)
        ctl = _drive(tc.AdmissionController(
            THW64, placement="joint", joint_budget=(1, 6), objective=objective,
            backend="edges", device="cpu"), tc)
        assert _strip_wall(ctl.trajectory()) == _strip_wall(ref.trajectory())
        assert ctl.chip_metrics(exact=True) == ref.chip_metrics(exact=True)


def test_joint_controller_arguments():
    mesh = Mesh((torch.device("cpu"),) * 2)
    assert tc.AdmissionController(THW64, placement="joint", mesh=mesh, device="cpu").mesh is mesh
    with pytest.raises(ValueError):
        tc.AdmissionController(THW64, placement="joint", objective="x", device="cpu")
    ctl = tc.AdmissionController(THW64, placement="joint", device="cpu")
    assert ctl.region_scope and ctl.track_chip_metrics and ctl.chip_metrics() is None


# -- workloads -------------------------------------------------------------
def _same_snn(a, b):
    assert a.name == b.name and a.n_neurons == b.n_neurons
    for f in ("pre", "post", "weight", "spikes"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_workloads_match_reference():
    assert dataclasses.asdict(tc.TABLE1_FIT) == dataclasses.asdict(rc.TABLE1_FIT)
    for a, b in zip(tc.workload_suite(6, seed=3, scale=0.06),
                    rc.workload_suite(6, seed=3, scale=0.06)):
        _same_snn(a, b)
    _same_snn(tc.sample_workload(11, scale=0.1), rc.sample_workload(11, scale=0.1))
    _same_snn(tc.sample_workload(np.random.default_rng(5), scale=0.05, name="x"),
              rc.sample_workload(np.random.default_rng(5), scale=0.05, name="x"))
    for kw in (dict(seed=5, heal_after=2.0, p_throttle=0.2, p_drift=0.2,
                    drift_apps=["a", "b"], max_dead_frac=0.25),
               dict(seed=2, tiles_per_fault=2, heal_after=4.0, p_throttle=0.15,
                    p_drift=0.15, max_dead_frac=0.10, drift_apps=["t0", "t1", "t2"])):
        got = tc.failure_storm(25, 64, **kw)
        want = rc.failure_storm(25, 64, **kw)
        assert [dataclasses.asdict(e) for e in got] == [dataclasses.asdict(e) for e in want]


# -- Lemma 1 ---------------------------------------------------------------
def test_verify_deadlock_free_on_admitted_report():
    snn = tc.small_app(150, 1800, seed=91)
    ctl = tc.AdmissionController(THW64, placement="joint", backend="edges", device="cpu")
    rep = ctl.admit(snn, n_tiles_request=3)
    art = ctl.artifacts[(snn.name, THW64)]
    assert tc.verify_deadlock_free(art.clustered, THW64, rep)
    r_snn = rc.small_app(150, 1800, seed=91)
    r_rep = rc.AdmissionController(HW64, placement="joint").admit(r_snn, n_tiles_request=3)
    np.testing.assert_array_equal(rep.binding, r_rep.binding)
    assert rc.verify_deadlock_free(
        rc.partition_greedy(r_snn, HW64), HW64, r_rep) is True
