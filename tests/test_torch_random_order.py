"""``core/schedule.random_order_throughput`` (the SpiNeMap/PyCARL
random-priority baseline) against the reference bit for bit, on the tests'
SDFG fixtures: tests/test_schedule_runtime.py's compiled small app under
each binder, and its four-actor ring on dedicated tiles."""

import dataclasses

import numpy as np
import pytest

import repro.core as rc
from repro.core import schedule as rschedule
from repro.core.sdfg import SDFG as RSDFG
from repro.core.sdfg import Channel as RChannel

import repro_torch.core as tc
from repro_torch.core import schedule as tschedule
from repro_torch.core.sdfg import SDFG as TSDFG
from repro_torch.core.sdfg import Channel as TChannel


def _compiled(mod):
    snn = mod.small_app(220, 2600, seed=11)
    cl = mod.partition_greedy(snn, mod.DYNAP_SE)
    return cl, mod.sdfg_from_clusters(cl, hw=mod.DYNAP_SE)


@pytest.mark.parametrize("binder", ["bind_ours", "bind_spinemap", "bind_pycarl"])
def test_random_order_throughput_matches_the_reference(binder):
    r_cl, r_app = _compiled(rc)
    t_cl, t_app = _compiled(tc)
    r_b = getattr(rc, binder)(r_cl, rc.DYNAP_SE).binding
    t_b = getattr(tc, binder)(t_cl, tc.DYNAP_SE).binding
    np.testing.assert_array_equal(t_b, r_b)
    want = rschedule.random_order_throughput(r_app, r_b, rc.DYNAP_SE)
    got = tschedule.random_order_throughput(t_app, t_b, tc.DYNAP_SE)
    assert got == want and want > 0
    assert tschedule.random_order_throughput(t_app, t_b, tc.DYNAP_SE, seeds=(5,), iterations=8) \
        == rschedule.random_order_throughput(r_app, r_b, rc.DYNAP_SE, seeds=(5,), iterations=8)


def test_random_order_throughput_on_a_ring_of_dedicated_tiles():
    tau = [2.0, 3.0, 1.0, 4.0]
    out = []
    for mod, sdfg, channel in ((rc, RSDFG, RChannel), (tc, TSDFG, TChannel)):
        chans = [channel(i, i, 1, 1.0, kind="self") for i in range(4)]
        chans += [channel(i, (i + 1) % 4, 1 if i == 3 else 0, 1.0) for i in range(4)]
        g = sdfg(n_actors=4, exec_time=np.array(tau), channels=chans)
        hw = dataclasses.replace(mod.DYNAP_SE, n_tiles=4)
        sched = rschedule if mod is rc else tschedule
        out.append(sched.random_order_throughput(g, np.arange(4), hw))
    assert out[1] == out[0] > 0
