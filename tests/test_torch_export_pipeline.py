"""The port's ``core/export.py`` and ``core/pipeline.py`` against the JAX
reference: export text equal character for character and the JSON round
trip; stage plans, pipeline SDFGs and reports equal for the ten
architectures with the reference's device constants patched in; and the
reference's tests/test_pipeline_lm.py properties under the port's H100
constants."""

import numpy as np
import pytest

import repro.core as rc
from repro.configs import ARCH_NAMES as R_ARCHS
from repro.configs import get_arch as r_arch
from repro.core import export as rexport
from repro.core import pipeline as rpipe

import repro_torch.core as tc
from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.core import export as texport
from repro_torch.core import pipeline as tpipe


def _graphs(mod, seed):
    """An app's SDFG, and its hardware-aware graph under a binding with
    static orders (order and buffer channels, tokens, delays)."""
    snn = mod.small_app(150, 2000, seed=seed)
    cl = mod.partition_greedy(snn, mod.DYNAP_SE)
    g = mod.sdfg_from_clusters(cl, hw=mod.DYNAP_SE)
    binding = np.arange(g.n_actors) % mod.DYNAP_SE.n_tiles
    orders, _ = mod.build_static_orders(g, binding, mod.DYNAP_SE, iterations=8)
    return g, mod.hardware_aware_sdfg(g, binding, mod.DYNAP_SE, orders)


@pytest.mark.parametrize("seed", [9, 10])
def test_export_text_equals_reference(seed):
    for r_g, t_g in zip(_graphs(rc, seed), _graphs(tc, seed)):
        assert texport.to_json(t_g) == rexport.to_json(r_g)
        assert texport.to_dot(t_g) == rexport.to_dot(r_g)
        assert texport.to_dot(t_g, max_actors=5) == rexport.to_dot(r_g, max_actors=5)
        back = texport.from_json(texport.to_json(t_g))
        assert texport.to_json(back) == texport.to_json(t_g)
        assert tc.mcr_howard(back) == tc.mcr_howard(t_g)
        assert back.n_actors == t_g.n_actors and back.name == t_g.name


@pytest.fixture
def reference_constants(monkeypatch):
    """The reference's device constants in the port's module."""
    monkeypatch.setattr(tpipe, "PEAK_FLOPS", rpipe.PEAK_FLOPS)
    monkeypatch.setattr(tpipe, "LINK_BW", rpipe.ICI_BW)
    return 16e9                                   # the reference's hbm_budget


def test_the_ten_architectures_are_the_references():
    assert ARCH_NAMES == R_ARCHS and len(ARCH_NAMES) == 10


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_pipeline_equals_reference(arch, reference_constants):
    cfg, rcfg = get_arch(arch), r_arch(arch)
    assert tpipe.layer_costs(cfg, micro_tokens=2048) == rpipe.layer_costs(
        rcfg, micro_tokens=2048)
    for stages in (2, 4, 8):
        plan = tpipe.plan_stages(cfg, stages, micro_tokens=4096)
        rplan = rpipe.plan_stages(rcfg, stages, micro_tokens=4096)
        assert plan == tpipe.StagePlan(*(getattr(rplan, f) for f in (
            "boundaries", "stage_flops", "stage_bytes", "act_bytes")))
        g = tpipe.pipeline_sdfg(plan, n_microbatches=16, in_flight=2)
        assert texport.to_json(g) == rexport.to_json(
            rpipe.pipeline_sdfg(rplan, n_microbatches=16, in_flight=2))
        got = tpipe.analyze_pipeline(cfg, n_stages=stages, n_microbatches=16,
                                     micro_tokens=4096, hbm_budget=reference_constants)
        want = rpipe.analyze_pipeline(rcfg, n_stages=stages, n_microbatches=16,
                                      micro_tokens=4096)
        assert tuple(vars(got).values()) == tuple(vars(want).values())


# -- tests/test_pipeline_lm.py's properties under the H100 constants ------
def test_h100_constants():
    assert (tpipe.PEAK_FLOPS, tpipe.LINK_BW, tpipe.HBM_BYTES) == (989e12, 450e9, 80e9)


def test_stage_plan_balances_flops():
    plan = tpipe.plan_stages(get_arch("qwen1.5-110b"), 8, micro_tokens=4096)
    f = np.array(plan.stage_flops)
    assert f.min() > 0
    assert f.max() / f.min() < 1.6  # roughly balanced


def test_pipeline_period_equals_bottleneck_stage():
    plan = tpipe.plan_stages(get_arch("qwen2-1.5b"), 4, micro_tokens=2048)
    g = tpipe.pipeline_sdfg(plan, n_microbatches=16)
    period = tc.mcr_howard(g)
    s = len(plan.stage_flops)
    per_stage = [g.exec_time[i] + g.exec_time[2 * s - 1 - i] for i in range(s)]
    assert period >= max(per_stage) - 1e-12
    assert period <= 1.5 * max(per_stage)


def test_more_microbatches_reduce_bubble():
    cfg = get_arch("codeqwen1.5-7b")
    b8 = tpipe.analyze_pipeline(cfg, n_stages=4, n_microbatches=8,
                                micro_tokens=2048).bubble_frac
    b64 = tpipe.analyze_pipeline(cfg, n_stages=4, n_microbatches=64,
                                 micro_tokens=2048).bubble_frac
    assert b64 < b8


def test_matches_classic_bubble_formula():
    s, m = 4, 16
    rep = tpipe.analyze_pipeline(get_arch("qwen2-1.5b"), n_stages=s, n_microbatches=m,
                                 micro_tokens=2048)
    assert rep.bubble_frac == pytest.approx((s - 1) / (m + s - 1), rel=0.6)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "jamba-v0.1-52b"])
def test_hbm_gate_detects_oversized_stages(arch):
    cfg = get_arch(arch)
    small = tpipe.analyze_pipeline(cfg, n_stages=2, n_microbatches=8, micro_tokens=4096)
    big = tpipe.analyze_pipeline(cfg, n_stages=32, n_microbatches=8, micro_tokens=4096)
    # over 2 stages neither fits an 80 GB card; over 32 each stage parks less
    assert not small.hbm_fit
    assert big.tokens_per_s > 0
