"""The port's batched engine against the JAX reference: stacked edge
arrays and order batches bit for bit, periods and energies exact on
``"edges"`` and to ``rtol 1e-8`` on ``"csr"``, start vectors to 1e-4."""

import numpy as np
import pytest

import repro.core as rc
from repro.core import engine as rengine

from repro_torch import convert
from repro_torch.core import engine as tengine

CPU = "cpu"


@pytest.fixture(scope="module", params=["CNN-MNIST", "small"])
def setup(request):
    snn = (rc.small_app(220, 2600, seed=11) if request.param == "small"
           else rc.build_app(request.param))
    hw = rc.DYNAP_SE_16
    cl = rc.partition_greedy(snn, hw)
    app = rc.sdfg_from_clusters(cl, hw=hw)
    order, _ = rc.single_tile_order(cl, hw)
    rng = np.random.default_rng(7)
    bindings = rng.integers(0, hw.n_tiles, size=(6, app.n_actors))
    return app, hw, order, bindings


def _same_stack(a, b):
    assert a.n_actors == b.n_actors
    for f in ("src", "dst", "tokens", "weights"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_order_batch_and_stack_bit_identical(setup):
    app, hw, order, bindings = setup
    r_ob = rengine.project_order_batch(order, bindings)
    t_ob = tengine.project_order_batch(order, bindings)
    for f in ("src", "dst", "tokens"):
        np.testing.assert_array_equal(getattr(r_ob, f), getattr(t_ob, f))
    t_app, t_hw = convert.convert(app), convert.convert(hw)
    for shortcuts in (False, True):
        r_st, r_m = rengine.stack_hardware_aware(
            app, bindings, hw, r_ob, relax_shortcuts=shortcuts, with_metrics=True)
        t_st, t_m = tengine.stack_hardware_aware(
            t_app, bindings, t_hw, t_ob, relax_shortcuts=shortcuts, with_metrics=True)
        _same_stack(r_st, t_st)
        for f in ("cut_traffic", "spike_hops", "tiles_used"):
            np.testing.assert_array_equal(getattr(r_m, f), getattr(t_m, f))
    np.testing.assert_array_equal(
        rengine.order_cycle_lower_bounds(app.exec_time, bindings, r_ob),
        tengine.order_cycle_lower_bounds(t_app.exec_time, bindings, t_ob))
    r_pad, r_lo = rengine.pad_stack_to_buckets(r_st, np.arange(6.0))
    t_pad, t_lo = tengine.pad_stack_to_buckets(t_st, np.arange(6.0))
    _same_stack(r_pad, t_pad)
    np.testing.assert_array_equal(r_lo, t_lo)


@pytest.mark.parametrize("backend", ["edges", "csr"])
def test_batch_execute_periods_and_energies(setup, backend):
    app, hw, order, bindings = setup
    ref = rengine.batch_execute(app, bindings, hw,
                                rengine.project_order_batch(order, bindings),
                                backend="edges", with_energy=True)
    t_app, t_hw = convert.convert(app), convert.convert(hw)
    ours = tengine.batch_execute(t_app, bindings, t_hw,
                                 tengine.project_order_batch(order, bindings),
                                 backend=backend, with_energy=True, device=CPU)
    if backend == "edges":
        np.testing.assert_array_equal(ours.periods, ref.periods)
        np.testing.assert_array_equal(ours.energies, ref.energies)
    else:
        np.testing.assert_allclose(ours.periods, ref.periods, rtol=1e-8)
        np.testing.assert_allclose(ours.energies, ref.energies, rtol=1e-8)
    # list-form orders go through the per-row path and agree too
    lists = [rc.project_order(order, b, hw.n_tiles) for b in bindings[:2]]
    ref_l = rengine.batch_execute(app, bindings[:2], hw, lists, backend="edges")
    ours_l = tengine.batch_execute(t_app, bindings[:2], t_hw, lists,
                                   backend=backend, device=CPU)
    np.testing.assert_allclose(ours_l.periods, ref_l.periods, rtol=1e-8)


def test_batch_execute_starts_match_reference(setup):
    app, hw, order, bindings = setup
    ref = rengine.batch_execute(app, bindings[:3], hw,
                                rengine.project_order_batch(order, bindings[:3]),
                                backend="edges", with_starts=True)
    ours = tengine.batch_execute(convert.convert(app), bindings[:3],
                                 convert.convert(hw),
                                 tengine.project_order_batch(order, bindings[:3]),
                                 with_starts=True, device=CPU)
    np.testing.assert_allclose(ours.periods, ref.periods, rtol=1e-8)
    assert ours.starts.shape == ref.starts.shape
    np.testing.assert_allclose(ours.starts, ref.starts, rtol=1e-4, atol=1e-4)


def test_cache_stats_count_bucketed_shapes(setup):
    app, hw, order, bindings = setup
    t_app, t_hw = convert.convert(app), convert.convert(hw)
    stats = tengine.CompileCacheStats()
    with tengine.record_cache_stats(stats):
        for b in (bindings[:5], bindings[:6], bindings[:6]):
            tengine.batch_execute(t_app, b, t_hw, tengine.project_order_batch(order, b),
                                  device=CPU)
    # B = 5 and 6 share the bucket 6 on the device backend
    assert (stats.hits, stats.misses) == (2, 1)
