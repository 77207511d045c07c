"""The port's serving layer against the JAX reference: the ServingQueue
drain, rebalance deferral, the PrecompilePool and the front end's quota,
cancel and skip paths, on tests/test_serving.py's schedules.  Counts and
trajectories are compared, never wall-clock times."""

import dataclasses

import numpy as np
import pytest

import repro.core as rc

import repro_torch.core as tc

HW64 = dataclasses.replace(rc.DYNAP_SE, n_tiles=64)
THW64 = dataclasses.replace(tc.DYNAP_SE, n_tiles=64)
TIME_KEYS = ("admit_latency_p50_s", "admit_latency_p99_s", "queue_wait_p50_s",
             "queue_wait_p99_s", "service_p50_s", "service_p99_s")


def _kw(mod, backend):
    return {} if mod is rc else dict(backend=backend, device="cpu")


def _registered(mod, backend="edges", n_apps=6, seed0=300):
    """tests/test_serving.py's ``_registered_controller``."""
    hw = HW64 if mod is rc else THW64
    ctl = mod.AdmissionController(hw, placement="joint", joint_budget=(1, 4),
                                  **_kw(mod, backend))
    names = []
    for i in range(n_apps):
        snn = mod.small_app(150, 1800, seed=seed0 + i)
        snn.name = f"sv{i}"
        ctl.register(snn)
        names.append(snn.name)
    return ctl, names


def _strip_wall(traj):
    return [{k: v for k, v in e.items() if k != "wall_s"} for e in traj]


def _counts(stats):
    return {k: v for k, v in stats.items() if k not in TIME_KEYS}


def _drain(mod, backend="edges"):
    stream = ["sv0", "sv1", "sv2", "sv0", "sv3", "sv4", "sv1", "sv5"]
    ctl, _ = _registered(mod, backend)
    q = mod.ServingQueue(ctl, coalesce_window=4)
    resident = set()
    for n in stream:
        if n in resident:
            q.submit_evict(n)
            resident.discard(n)
        else:
            q.submit_admit(n, n_tiles_request=3)
            resident.add(n)
    return ctl, q, q.drain()


@pytest.mark.parametrize("backend", ["edges", "csr"])
def test_serving_queue_drain_matches_reference(backend):
    ref, _, ref_stats = _drain(rc)
    ctl, q, stats = _drain(tc, backend)
    assert q.pending == 0 and _counts(stats) == _counts(ref_stats)
    assert stats["processed"] == 8 and stats["flushes"] == 2
    for key in TIME_KEYS:
        assert stats[key] >= 0.0
    assert stats["queue_wait_p99_s"] >= stats["queue_wait_p50_s"]
    for t in q.tickets:
        assert t.latency_s == pytest.approx(t.wait_s + t.service_s)
    traj, ref_traj = _strip_wall(ctl.trajectory()), _strip_wall(ref.trajectory())
    if backend == "edges":
        assert traj == ref_traj
        for n in ref.reports:
            np.testing.assert_array_equal(ctl.reports[n].binding, ref.reports[n].binding)
    else:
        assert [(e["kind"], e["app"], e["tiles"]) for e in traj] == \
            [(e["kind"], e["app"], e["tiles"]) for e in ref_traj]
        np.testing.assert_allclose([e["chip_throughput"] for e in traj],
                                   [e["chip_throughput"] for e in ref_traj], rtol=1e-8)


def test_defer_and_flush_rebalances_match_reference():
    out = []
    for mod in (rc, tc):
        ctl, names = _registered(mod)
        for n in names[:2]:
            ctl.admit(n, n_tiles_request=3)
        before = sum(e.kind == "rebalance" for e in ctl.events)
        with ctl.defer_rebalances():
            for n in names[2:5]:
                ctl.admit(n, n_tiles_request=3)
            assert sum(e.kind == "rebalance" for e in ctl.events) == before
            ctl.evict(names[0])
            assert ctl.flush_rebalances() == 4       # mid-window flush
            ctl.admit(names[5], n_tiles_request=3)
        assert sum(e.kind == "rebalance" for e in ctl.events) == before + 2
        assert ctl.flush_rebalances() == 0
        out.append(_strip_wall(ctl.trajectory()))
    assert out[0] == out[1]


def test_precompile_pool_matches_reference():
    out = []
    for mod in (rc, tc):
        hw = HW64 if mod is rc else THW64
        ctl = mod.AdmissionController(hw, placement="joint", joint_budget=(1, 4),
                                      **_kw(mod, "edges"))
        apps = {}
        for i in range(3):
            snn = mod.small_app(150, 1800, seed=400 + i)
            snn.name = f"pc{i}"
            apps[snn.name] = snn
        pool = mod.PrecompilePool(ctl, source=apps, top_k=2, decay=0.9)
        for name in ("pc0", "pc0", "pc1", "pc0"):
            pool.observe(name)
        predicted = pool.predict()
        warmed = pool.warm()
        hits = [pool.ensure("pc0"), pool.ensure("pc2")]
        q = mod.ServingQueue(ctl, coalesce_window=2, precompile=pool)
        q.submit_admit("pc1", n_tiles_request=3)
        q.submit_admit("pc2", n_tiles_request=3)
        stats = q.drain()
        ghost = mod.PrecompilePool(ctl, top_k=1)
        ghost.observe("ghost")
        out.append((predicted, warmed, hits, pool.stats(), _counts(stats),
                    ghost.warm(), ctl.cache_stats.as_dict(),
                    _strip_wall(ctl.trajectory())))
    assert out[0] == out[1]
    assert out[1][1] == ["pc0", "pc1"] and out[1][2] == [True, False]
    assert out[1][4]["precompile"]["hits"] >= 2


def test_front_end_paths_match_reference():
    """Cancellation, quotas (explicit and implicit) and skipped evictions."""
    out = []
    for mod in (rc, tc):
        ctl, names = _registered(mod, n_apps=3)
        art = ctl.artifacts[(names[2], ctl.hw)]
        q = mod.ServingQueue(ctl, coalesce_window=2, quotas={
            names[1]: 2, names[2]: art.clustered.n_clusters - 1})
        t0 = q.submit_admit(names[0], n_tiles_request=3)
        q.submit_admit(names[1], n_tiles_request=3)      # over quota
        q.submit_admit(names[2])                         # implicit footprint
        q.submit_evict("never-admitted")
        assert q.cancel(t0) and not q.cancel(t0)
        q.submit_admit(names[0], n_tiles_request=3)
        stats = q.drain()
        q.set_quota(names[1], 8)
        q.submit_admit(names[1], n_tiles_request=3)
        stats2 = q.drain()
        out.append(([t.status for t in q.tickets], [t.error for t in q.tickets],
                    _counts(stats), _counts(stats2), _strip_wall(ctl.trajectory())))
    assert out[0] == out[1]
    assert out[1][0] == ["cancelled", "rejected", "rejected", "skipped", "ok", "ok"]
    with pytest.raises(ValueError):
        tc.ServingQueue(_registered(tc, n_apps=1)[0], coalesce_window=0)
