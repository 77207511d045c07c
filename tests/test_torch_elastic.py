"""``launch/elastic.py``: the reference's own cases
(tests/test_substrates.py), run against both packages."""

import pytest

from repro.launch import elastic as relastic

from repro_torch.launch import elastic as telastic

PACKAGES = {"reference": relastic, "port": telastic}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_heartbeat_failure_detection(pkg):
    mod = PACKAGES[pkg]
    clock = [0.0]
    tr = mod.HeartbeatTracker(4, timeout=10.0, clock=lambda: clock[0])
    clock[0] = 5.0
    for h in (0, 1, 2):
        tr.beat(h)
    clock[0] = 14.0  # host 3 silent for 14s > timeout; 0-2 beat 9s ago
    dead = tr.sweep()
    assert dead == [3]
    assert tr.alive_hosts() == [0, 1, 2]
    assert tr.sweep() == []              # a dead host is reported once


@pytest.mark.parametrize("pkg", PACKAGES)
def test_elastic_mesh_planning(pkg):
    mod = PACKAGES[pkg]
    assert mod.plan_elastic_mesh(256, model_parallel=16) == (16, 16)
    assert mod.plan_elastic_mesh(255, model_parallel=16) == (15, 16)
    assert mod.plan_elastic_mesh(15, model_parallel=16) is None


@pytest.mark.parametrize("pkg", PACKAGES)
def test_straggler_becomes_failure(pkg):
    mod = PACKAGES[pkg]
    ctrl = mod.ElasticController(4, chips_per_host=64, model_parallel=16,
                                 straggler=mod.StragglerPolicy(deadline_s=1.0, patience=2))
    assert ctrl.step({0: 0.5, 1: 0.5, 2: 0.5, 3: 5.0}) is None  # 1 miss
    new = ctrl.step({0: 0.5, 1: 0.5, 2: 0.5, 3: 5.0})           # 2nd miss
    assert new == (12, 16)  # 3 hosts x 64 chips = 192 = 12 x 16
