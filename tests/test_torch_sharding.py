"""The port's sharded λ-search against its unsharded solve and the JAX
reference: ``launch.sharding``'s mesh helpers, ``mcr_batch(devices=)``,
``batch_execute(mesh=)``, the optimizer and the joint controller under a
mesh.  Meshes repeat the CPU device: the chunking is driven by the device
count, and the card's streams are held in tests/test_torch_cuda.py.

The reference's own sharded tests run its csr-jit backend, which this
JAX cannot run; so the sharded results are held bit for bit against the
port's unsharded ``"csr"`` and within ``rtol 1e-8`` of the reference's
``"edges"``."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core.maxplus import EdgeStack as REdgeStack
from repro.launch import sharding as rsharding

import repro_torch.core as tc
from repro_torch.core import maxplus as tmp
from repro_torch.kernels import maxplus_bellman as kbell
from repro_torch.launch import sharding as tsharding

CPU = torch.device("cpu")
THW64 = dataclasses.replace(tc.DYNAP_SE, n_tiles=64)


def _mesh(k):
    return tsharding.Mesh((CPU,) * k)


# -- launch/sharding -------------------------------------------------------
@pytest.mark.parametrize("n_rows", [0, 1, 3, 7, 13, 64])
def test_row_chunks_match_reference(n_rows):
    for n_parts in range(1, 10):
        assert tsharding.row_chunks(n_rows, n_parts) == rsharding.row_chunks(n_rows, n_parts)


def test_mesh_devices_and_the_ambient_mesh_per_thread():
    mesh = tsharding.Mesh(("cpu", CPU, torch.device("cpu")))
    assert mesh.devices == (CPU,) * 3 and mesh.axis_names == ("data",)
    assert tsharding.mesh_devices(mesh) == [CPU] * 3
    assert tsharding.mesh_devices(None) == []
    with pytest.raises(ValueError):
        tsharding.Mesh(())
    with pytest.raises(ValueError):
        tsharding.Mesh((CPU,), ("data", "model"))
    seen = {}
    assert tsharding.current_mesh() is None
    with tsharding.use_mesh(mesh):
        assert tsharding.current_mesh() is mesh
        th = threading.Thread(target=lambda: seen.update(mesh=tsharding.current_mesh()))
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
    assert seen == {"mesh": None} and tsharding.current_mesh() is None


def test_host_mesh_clamps_to_the_visible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsharding.host_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tsharding.host_mesh().devices == tuple(torch.device("cuda", i) for i in range(4))
    assert len(tsharding.host_mesh(2).devices) == 2
    assert len(tsharding.host_mesh(9).devices) == 4
    with pytest.raises(ValueError):
        tsharding.host_mesh(0)


# -- mcr_batch(devices=) ---------------------------------------------------
def _live_arrays(b, seed, n=6, e=18):
    """tests/test_serving.py's ``_live_stack`` arrays."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=(b, e))
    dst = rng.integers(0, n, size=(b, e))
    tok = rng.integers(0, 3, size=(b, e))
    w = rng.uniform(0.1, 5.0, size=(b, e))
    src[:, 0] = dst[:, 0] = 0
    tok[:, 0] = 1                       # token-carrying self loop: live
    return dict(n_actors=n, src=src, dst=dst, tokens=tok, weights=w)


@pytest.mark.parametrize("b", [3, 13, 64])
def test_mcr_batch_sharded_chunks_bit_identical(b):
    """Row chunks over repeated devices (k dividing B or not, and more
    chunks than rows) equal the unsharded solve bit for bit, with and
    without the deadlock probe and the caller's lower bounds."""
    arrays = _live_arrays(b, seed=b)
    stack = tmp.EdgeStack(**arrays)
    want = rc.mcr_batch(REdgeStack(**arrays), backend="edges")
    lo0 = np.where(np.arange(b) % 2 == 0, 0.05, -np.inf)   # sound: self loops >= 0.1
    ref = tmp.mcr_batch(stack, backend="csr", device="cpu")
    ref_dd = tmp.mcr_batch(stack, backend="csr", device="cpu", detect_deadlock=True)
    ref_lo = tmp.mcr_batch(stack, backend="csr", device="cpu", lo0=lo0)
    np.testing.assert_allclose(ref, want, rtol=1e-8)
    for k in (2, 3, 4, 7):
        devices = [CPU] * k
        kbell.reset_counts()
        got = tmp.mcr_batch(stack, backend="csr", devices=devices, device="cpu")
        assert kbell.COUNTS["syncs"] > 0
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(tmp.mcr_batch(
            stack, devices=devices, device="cpu", detect_deadlock=True), ref_dd)
        np.testing.assert_array_equal(tmp.mcr_batch(
            stack, devices=devices, device="cpu", lo0=lo0), ref_lo)
    # a single device pins the unsharded solve to it
    np.testing.assert_array_equal(tmp.mcr_batch(stack, devices=[CPU], device="cpu"), ref)


def test_sharded_chunks_of_padding_rows_stay_neg_inf():
    """A chunk holding only all--inf rows (bucket padding) is not solved;
    its rows report -inf, the other chunks' rows equal the unsharded."""
    arrays = _live_arrays(5, seed=2)
    for key, fill in (("src", 0), ("dst", 0), ("tokens", 1), ("weights", -np.inf)):
        arrays[key] = np.concatenate([arrays[key], np.full((5, 18), fill, arrays[key].dtype)])
    stack = tmp.EdgeStack(**arrays)
    ref = tmp.mcr_batch(stack, backend="csr", device="cpu")
    assert np.isneginf(ref[5:]).all() and np.isfinite(ref[:5]).all()
    for k in (2, 4):
        np.testing.assert_array_equal(
            tmp.mcr_batch(stack, devices=[CPU] * k, device="cpu"), ref)
    empty = tmp.EdgeStack(**{**arrays, "weights": np.full((10, 18), -np.inf)})
    assert np.isneginf(tmp.mcr_batch(empty, devices=[CPU] * 3, device="cpu")).all()


@pytest.mark.parametrize("backend", ["edges", "dense"])
def test_mcr_batch_devices_requires_csr(backend):
    stack = tmp.EdgeStack(**_live_arrays(4, seed=1))
    with pytest.raises(ValueError, match="csr"):
        tmp.mcr_batch(stack, backend=backend, devices=[CPU] * 2, device="cpu")


# -- engine, optimizer and controller under a mesh --------------------------
def _compiled(mod, seed, neurons=170, synapses=2100):
    snn = mod.small_app(neurons, synapses, seed=seed)
    cl = mod.partition_greedy(snn, mod.DYNAP_SE)
    app = mod.sdfg_from_clusters(cl, hw=mod.DYNAP_SE)
    order, _ = mod.single_tile_order(cl, mod.DYNAP_SE)
    return app, order


def _bindings(app, n_rows, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 4, size=app.n_actors) for _ in range(n_rows)])


def test_batch_execute_mesh_matches_unsharded():
    r_app, order = _compiled(rc, 11)
    t_app, _ = _compiled(tc, 11)
    b = _bindings(r_app, 7, 11)
    want = rc.batch_execute(r_app, b, rc.DYNAP_SE, rc.project_order_batch(order, b),
                            backend="edges", with_energy=True)
    ob = tc.project_order_batch(order, b)
    ref = tc.batch_execute(t_app, b, tc.DYNAP_SE, ob, backend="csr", with_energy=True,
                           device="cpu")
    for k in (3, 4):
        got = tc.batch_execute(t_app, b, tc.DYNAP_SE, ob, mesh=_mesh(k), with_energy=True,
                               device="cpu")
        np.testing.assert_array_equal(got.periods, ref.periods)
        np.testing.assert_array_equal(got.energies, ref.energies)
        with tsharding.use_mesh(_mesh(k)):
            ambient = tc.batch_execute(t_app, b, tc.DYNAP_SE, ob, with_energy=True,
                                       device="cpu")
        np.testing.assert_array_equal(ambient.periods, ref.periods)
    np.testing.assert_allclose(ref.periods, want.periods, rtol=1e-8)
    # another backend drops the mesh: "edges" stays the reference's bit for bit
    edges = tc.batch_execute(t_app, b, tc.DYNAP_SE, ob, backend="edges", mesh=_mesh(3),
                             with_energy=True, device="cpu")
    np.testing.assert_array_equal(edges.periods, want.periods)
    np.testing.assert_array_equal(edges.energies, want.energies)


def test_batch_execute_fused_mesh_matches_unsharded():
    preps = []
    for seed, rows in ((1, 3), (2, 5), (3, 2)):
        app, order = _compiled(tc, seed)
        b = _bindings(app, rows, seed)
        preps.append(tc.prepare_execution(app, b, tc.DYNAP_SE,
                                          tc.project_order_batch(order, b), with_energy=True))
    ref = tc.batch_execute_fused(preps, backend="csr", device="cpu")
    for k in (2, 7):
        got = tc.batch_execute_fused(preps, mesh=_mesh(k), device="cpu")
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.periods, r.periods)
            np.testing.assert_array_equal(g.energies, r.energies)


def _task(mod, seed, *, generations, population=10):
    """tests/test_serving.py's ``_task``."""
    app, order = _compiled(mod, seed)
    seed_b = (np.arange(app.n_actors) + seed) % mod.DYNAP_SE.n_tiles
    return dict(app=app, hw=mod.DYNAP_SE, single_order=order,
                seed_bindings={"seed": seed_b}, population=population,
                generations=generations, elite=4, rng_seed=seed)


def _split(t):
    return t["app"], t["hw"], t["single_order"], {
        k: v for k, v in t.items() if k not in ("app", "hw", "single_order")}


def test_optimize_mesh_trajectory_bit_identical():
    """mesh= sharded search == unsharded "csr" search: same per-generation
    history, elite, final binding and period; the reference's "edges"
    search within rtol 1e-8."""
    app, hw, order, kw = _split(_task(tc, 21, generations=3))
    ref = tc.optimize_binding_graph(app, hw, order, backend="csr", device="cpu", **kw)
    got = tc.optimize_binding_graph(app, hw, order, mesh=_mesh(4), device="cpu", **kw)
    np.testing.assert_array_equal(got.binding, ref.binding)
    assert got.period == ref.period and got.energy == ref.energy
    assert [g.best_period for g in got.history] == [g.best_period for g in ref.history]
    r_app, r_hw, r_order, r_kw = _split(_task(rc, 21, generations=3))
    want = rc.optimize_binding_graph(r_app, r_hw, r_order, **r_kw)
    assert got.period == pytest.approx(want.period, rel=1e-8)

    tasks = [_task(tc, 22, generations=2), _task(tc, 23, generations=1)]
    fused_ref = tc.optimize_binding_graphs_fused(tasks, backend="csr", device="cpu")
    fused_got = tc.optimize_binding_graphs_fused(tasks, mesh=_mesh(3), device="cpu")
    for g, r in zip(fused_got, fused_ref):
        np.testing.assert_array_equal(g.binding, r.binding)
        assert g.period == r.period
        assert [h.best_period for h in g.history] == [h.best_period for h in r.history]


def _drive(ctl):
    """tests/test_regions.py's fixed admit/evict/finish churn."""
    apps = []
    for i in range(6):
        snn = tc.small_app(150, 1800, seed=90 + i)
        snn.name = f"r{i}"
        apps.append(snn)
        ctl.register(snn)
    for a in apps[:5]:
        ctl.admit(a.name, n_tiles_request=3)
    ctl.evict(apps[1].name)
    ctl.admit(apps[5].name, n_tiles_request=3)
    ctl.finish(apps[2].name)
    ctl.admit(apps[1].name, n_tiles_request=2)
    return ctl


def _strip_wall(traj):
    return [{k: v for k, v in e.items() if k != "wall_s"} for e in traj]


def test_joint_controller_mesh_matches_unsharded(monkeypatch):
    """A joint controller on a 64-tile chip scoring under a mesh: the
    trajectory, every binding and order and the chip metrics equal the
    unsharded run's; the rebalances ran sharded solves."""
    ref = _drive(tc.AdmissionController(THW64, placement="joint", joint_budget=(2, 8),
                                        backend="csr", device="cpu"))
    mesh = _mesh(2)
    sharded = []
    solve = kbell.mcr_bisect_device_sharded

    def spy(chunks, devices, **kw):
        sharded.append(len(chunks))
        return solve(chunks, devices, **kw)

    monkeypatch.setattr(kbell, "mcr_bisect_device_sharded", spy)
    ctl = _drive(tc.AdmissionController(THW64, placement="joint", joint_budget=(2, 8),
                                        mesh=mesh, device="cpu"))
    assert ctl.mesh is mesh and sharded and set(sharded) == {2}
    traj = _strip_wall(ctl.trajectory())
    assert "rebalance" in {e["kind"] for e in traj}
    assert traj == _strip_wall(ref.trajectory())
    assert sorted(ctl.reports) == sorted(ref.reports)
    for n in ref.reports:
        np.testing.assert_array_equal(ctl.reports[n].binding, ref.reports[n].binding)
        assert ctl.reports[n].orders == ref.reports[n].orders
    assert ctl.chip_metrics() == ref.chip_metrics()
    assert ctl.chip_metrics(exact=True) == ref.chip_metrics(exact=True)
