"""The port's host front end against the JAX reference, bit for bit:
applications, clustering, SDFG arrays, the three binders, static orders
and Howard's MCR, on the same inputs."""

import dataclasses

import numpy as np
import pytest

import repro.core as rc
from repro.core import schedule as rsched

from repro_torch import convert
from repro_torch.core import apps as tapps
from repro_torch.core import binding as tbind
from repro_torch.core import hardware as thw
from repro_torch.core import partition as tpart
from repro_torch.core import schedule as tsched
from repro_torch.core import sdfg as tsdfg
from repro_torch.core.maxplus import mcr_howard

APPS = ["MLP-MNIST", "CNN-MNIST", "small"]


def _pair(name):
    if name == "small":
        return rc.small_app(220, 2600, seed=11), tapps.small_app(220, 2600, seed=11)
    return rc.build_app(name), tapps.build_app(name)


def _assert_same_fields(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name.endswith("time_s"):
            continue
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif dataclasses.is_dataclass(x):
            _assert_same_fields(x, y)
        else:
            assert x == y, f.name


@pytest.fixture(scope="module", params=APPS)
def compiled(request):
    r_snn, t_snn = _pair(request.param)
    r_cl = rc.partition_greedy(r_snn, rc.DYNAP_SE)
    t_cl = tpart.partition_greedy(t_snn, thw.DYNAP_SE)
    return r_snn, t_snn, r_cl, t_cl


def test_apps_and_clustering_bit_identical(compiled):
    r_snn, t_snn, r_cl, t_cl = compiled
    _assert_same_fields(r_snn, t_snn)
    _assert_same_fields(r_cl, t_cl)
    # the scalar reference partitioner agrees with the wave packer
    if r_snn.n_neurons < 1000:
        np.testing.assert_array_equal(
            tpart.partition_greedy_reference(t_snn, thw.DYNAP_SE).cluster_of,
            t_cl.cluster_of,
        )


def test_sdfg_arrays_bit_identical(compiled):
    _, _, r_cl, t_cl = compiled
    for hw_r, hw_t in ((rc.DYNAP_SE, thw.DYNAP_SE), (rc.DYNAP_SE_16, thw.DYNAP_SE_16)):
        r_g = rc.sdfg_from_clusters(r_cl, hw=hw_r)
        t_g = tsdfg.sdfg_from_clusters(t_cl, hw=hw_t)
        _assert_same_fields(r_g, t_g)
        for a, b in zip(rc.sdfg.hardware_static_parts(r_g, hw_r),
                        tsdfg.hardware_static_parts(t_g, hw_t)):
            _assert_same_fields(a, b)


@pytest.mark.parametrize("binder", ["bind_ours", "bind_pycarl", "bind_spinemap"])
def test_binders_bit_identical(compiled, binder):
    _, _, r_cl, t_cl = compiled
    for hw_r, hw_t in ((rc.DYNAP_SE, thw.DYNAP_SE), (rc.DYNAP_SE_9, thw.DYNAP_SE_9)):
        r = getattr(rc, binder)(r_cl, hw_r).binding
        t = getattr(tbind, binder)(t_cl, hw_t).binding
        np.testing.assert_array_equal(r, t)


def test_static_orders_and_howard_bit_identical(compiled):
    _, _, r_cl, t_cl = compiled
    r_g = rc.sdfg_from_clusters(r_cl, hw=rc.DYNAP_SE)
    t_g = tsdfg.sdfg_from_clusters(t_cl, hw=thw.DYNAP_SE)
    rng = np.random.default_rng(3)
    bindings = rng.integers(0, 4, size=(5, r_g.n_actors))
    r_orders = rsched.build_static_orders_batch(r_g, bindings, rc.DYNAP_SE)
    t_orders = tsched.build_static_orders_batch(t_g, bindings, thw.DYNAP_SE)
    assert r_orders == t_orders
    r_thr = rsched.analyze_throughput(r_g, bindings[0], rc.DYNAP_SE, r_orders[0])
    t_thr = tsched.analyze_throughput(t_g, bindings[0], thw.DYNAP_SE, t_orders[0])
    assert r_thr == t_thr
    r_aware = rc.hardware_aware_sdfg(r_g, bindings[1], rc.DYNAP_SE, r_orders[1])
    assert mcr_howard(convert.convert(r_aware)) == rc.mcr_howard(r_aware)


def test_chip_model_bit_identical():
    for r_hw, t_hw in ((rc.DYNAP_SE, thw.DYNAP_SE), (rc.DYNAP_SE_1024, thw.DYNAP_SE_1024)):
        assert convert.convert(r_hw) == t_hw
        rng = np.random.default_rng(0)
        a, b = rng.integers(0, r_hw.n_tiles, (2, 50))
        np.testing.assert_array_equal(r_hw.hops_array(a, b), t_hw.hops_array(a, b))
        rate = rng.uniform(0, 10, 50)
        np.testing.assert_array_equal(r_hw.comm_delay_array(rate, a, b),
                                      t_hw.comm_delay_array(rate, a, b))
    r_cs, t_cs = rc.ChipState(rc.DYNAP_SE_16), thw.ChipState(thw.DYNAP_SE_16)
    for cs in (r_cs, t_cs):
        cs.fail_tiles([3])
        cs.throttle_link(0, 1, 2.5)
        cs.set_drift("x", 1.5)
    np.testing.assert_array_equal(r_cs.route_scale(), t_cs.route_scale())
    np.testing.assert_array_equal(convert.convert(r_cs).route_scale(), t_cs.route_scale())
    assert convert.convert(r_cs).pristine is False
