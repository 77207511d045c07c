"""The port's fault runtime against the JAX reference: a fixed
inject / drift / heal / remap sequence on tests/test_faults.py's
controller gives the reference's trajectory, chip state and stale apps."""

import dataclasses

import numpy as np
import pytest

import repro.core as rc

import repro_torch.core as tc

HW64 = dataclasses.replace(rc.DYNAP_SE, n_tiles=64)
THW64 = dataclasses.replace(tc.DYNAP_SE, n_tiles=64)


def _controller(mod, hw, n_apps=4, seed0=300, prefix="f", request=3, **kw):
    """tests/test_faults.py's ``_controller``."""
    ctl = mod.AdmissionController(hw, placement="joint", region_scope=True, **kw)
    for i in range(n_apps):
        snn = mod.small_app(150, 1800, seed=seed0 + i)
        snn.name = f"{prefix}{i}"
        ctl.admit(snn, n_tiles_request=request)
    return ctl


def _bound_tiles(ctl):
    return sorted({int(t) for ts in ctl.running().values() for t in ts})


def _storm(ctl):
    """A fixed fault / throttle / drift / heal / churn sequence; returns the
    stale apps and chip states seen along it."""
    seen = []

    def look():
        cs = ctl.chip
        seen.append((cs.dead.copy(), dict(cs.link_throttle), dict(cs.drift), cs.epoch,
                     ctl.stale_apps(), sorted(ctl.running())))

    victims = _bound_tiles(ctl)[:2]
    link = (victims[0], victims[0] + 1)
    ctl.inject_fault([victims[0]])
    look()
    ctl.inject_fault(links=[link], throttle=3.0)
    look()
    ctl.inject_drift("f2", 1.7)
    look()
    ctl.inject_fault([victims[1]], remap=False)
    look()                                    # stale until the remap
    ctl.remap(failed_tiles=[victims[1]], stale=ctl.stale_apps())
    look()
    ctl.evict("f1")
    victims.append(_bound_tiles(ctl)[-1])
    ctl.chip.fail_tiles(victims[-1:])         # a change with no event
    look()
    ctl.remap(failed_tiles=victims[-1:], stale=ctl.stale_apps())
    look()
    ctl.heal(victims, drift_apps=["f2"])
    ctl.heal(links=[link])
    look()
    return seen


def _strip_wall(traj):
    return [{k: v for k, v in e.items() if k != "wall_s"} for e in traj]


@pytest.fixture(scope="module")
def reference_storm():
    ctl = _controller(rc, HW64)
    return ctl, _storm(ctl)


@pytest.mark.parametrize("backend", ["edges", "csr"])
def test_fault_runtime_matches_reference(reference_storm, backend):
    ref, ref_seen = reference_storm
    ctl = _controller(tc, THW64, backend=backend, device="cpu")
    seen = _storm(ctl)
    kinds = [e.kind for e in ctl.events]
    assert {"fault", "drift", "heal", "remap"} <= set(kinds)
    for (d, lt, dr, ep, stale, res), (rd, rlt, rdr, rep, rstale, rres) in zip(seen, ref_seen):
        np.testing.assert_array_equal(d, rd)
        assert (lt, dr, ep, stale, res) == (rlt, rdr, rep, rstale, rres)
    assert any(s[4] for s in seen)            # some step saw stale apps
    traj, ref_traj = _strip_wall(ctl.trajectory()), _strip_wall(ref.trajectory())
    if backend == "edges":
        assert traj == ref_traj
        for n in ref.reports:
            np.testing.assert_array_equal(ctl.reports[n].binding, ref.reports[n].binding)
        assert ctl.chip_metrics(exact=True) == ref.chip_metrics(exact=True)
    else:
        assert [(e["kind"], e["app"], e["tiles"], e["scope"], e["region_apps"])
                for e in traj] == [(e["kind"], e["app"], e["tiles"], e["scope"],
                                    e["region_apps"]) for e in ref_traj]
        for key in ("throughput", "chip_throughput", "seed_throughput"):
            np.testing.assert_allclose([e[key] for e in traj], [e[key] for e in ref_traj],
                                       rtol=1e-8)
    mc, me = ctl.chip_metrics(), ctl.chip_metrics(exact=True)
    assert mc["chip_throughput"] == pytest.approx(me["chip_throughput"], rel=1e-6)
    for e in ctl.events:
        if e.kind == "remap" and e.seed_throughput > 0:
            assert e.chip_throughput >= e.seed_throughput * (1 - 1e-6)


def test_displacement_matches_reference():
    """tests/test_faults.py's displacement schedule: every tile dies."""
    out = []
    for mod, hw, kw in ((rc, rc.DYNAP_SE, {}),
                        (tc, tc.DYNAP_SE, dict(backend="edges", device="cpu"))):
        ctl = _controller(mod, hw, n_apps=2, prefix="x", request=2, **kw)
        displaced = ctl.inject_fault(list(range(hw.n_tiles)))
        assert sorted(displaced) == ["x0", "x1"] and ctl.running() == {}
        ctl.heal(list(range(hw.n_tiles)))
        assert ctl.chip.pristine
        ctl.admit("x0", n_tiles_request=2)
        out.append(_strip_wall(ctl.trajectory()))
    assert out[0] == out[1]
    assert [e["kind"] for e in out[1]].count("displaced") == 2


def test_fault_entry_points_validate():
    ctl = _controller(tc, THW64, n_apps=1, backend="edges", device="cpu")
    with pytest.raises(ValueError):
        ctl.inject_fault()
    with pytest.raises(ValueError):
        ctl.heal()
    assert ctl.inject_fault([63], remap=False) == []
    assert ctl.events[-1].kind == "fault"
