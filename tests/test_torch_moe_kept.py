"""The MoE's kept-row route on the CPU: ``gather``'s experts computed on the
kept choices' rows alone (``ops.moe_gate_up``, ``ops.moe_down``, their
plain versions here) against the padded (E, C, D) route it replaces.

Outputs and aux agree within ``ref.MOE_TOL`` (both float32; the rows are
summed by GEMMs of other shapes) at E/k 16/2 and 64/8, T from 1 to 32,
capacities that drop and dropless, routing skewed to one expert, experts
with no choice and tied router scores.  The route is taken at decode's
mean choices an expert and refused at prefill's, under a recorded
gradient and for weights of another type; on it the counters read as
on the padded route.  On ``meta`` the pair returns its shapes and is charged
its work, as the dry run counts it.
"""

import dataclasses

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import ops, ref, work
from repro_torch.models import moe as moe_mod

D_MODEL, D_FF = 64, 32


def _cfg(e, k, capacity):
    cap = e / k if capacity == "dropless" else capacity
    return dataclasses.replace(reduced(get_arch("deepseek-v3-671b")), d_model=D_MODEL,
                               moe_d_ff=D_FF, moe_experts=e, moe_top_k=k, moe_shared=0,
                               moe_capacity=cap, moe_dispatch="gather")


def _layer(cfg, router, t, seed=0):
    """The layer's params and x (1, t, D): ``router`` "skewed" puts expert 0
    first for every token (a feature of 1 that only its score weighs),
    "ties" ties every score (the lowest ids win), "random" as drawn."""
    gen = torch.Generator().manual_seed(seed)
    p = moe_mod.init_moe(gen, cfg)
    x = torch.randn((1, t, D_MODEL), generator=gen)
    if router == "skewed":
        x[..., 0] = 1.0
        p["router"][0] = 0.0
        p["router"][0, 0] = 50.0
    elif router == "ties":
        p["router"].zero_()
    return p, x


@pytest.fixture(autouse=True)
def fresh_record():
    obs.reset()
    yield
    obs.reset()


def _padded(monkeypatch):
    monkeypatch.setattr(moe_mod, "_kept_rows", lambda *a: False)


# name: (E, k, T, capacity, router, some choice dropped, some expert unhit)
CASES = {
    "e16k2_t1": (16, 2, 1, "dropless", "random", False, True),
    "e16k2_t7_skewed_drops": (16, 2, 7, 1.0, "skewed", True, True),
    "e16k2_t32": (16, 2, 32, "dropless", "random", False, False),
    "e16k2_t32_drops": (16, 2, 32, 1.25, "random", True, False),
    "e16k2_t32_one_expert_takes_all": (16, 2, 32, "dropless", "skewed", False, True),
    "e16k2_t32_skewed_drops": (16, 2, 32, 1.25, "skewed", True, True),
    "e16k2_t16_ties": (16, 2, 16, "dropless", "ties", False, True),
    "e64k8_t1": (64, 8, 1, "dropless", "random", False, True),
    "e64k8_t5_skewed_drops": (64, 8, 5, 1.0, "skewed", True, True),
    "e64k8_t32": (64, 8, 32, "dropless", "random", False, False),
    "e64k8_t32_drops": (64, 8, 32, 1.0, "random", True, False),
    "e64k8_t32_ties_drops": (64, 8, 32, 1.25, "ties", True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kept_rows_match_the_padded_route(case, monkeypatch):
    e, k, t, capacity, router, drops, unhit = CASES[case]
    cfg = _cfg(e, k, capacity)
    p, x = _layer(cfg, router, t)
    calls = []
    gate_up = ops.moe_gate_up
    monkeypatch.setattr(ops, "moe_gate_up", lambda *a, **kw: (calls.append(1), gate_up(*a, **kw))[1])
    with torch.no_grad():
        got, got_aux = moe_mod.moe_forward(p, x, cfg)
        assert calls == [1]
        _padded(monkeypatch)
        want, want_aux = moe_mod.moe_forward(p, x, cfg)
    assert calls == [1]
    assert torch.equal(got_aux, want_aux)
    assert ref.moe_excess(got.reshape(t, -1), want.reshape(t, -1)) <= 1.0
    # the case holds what it is named for
    _, idx, _ = moe_mod._routing(p, x.reshape(t, -1), cfg)
    pos = moe_mod._positions(idx.reshape(-1), e)
    assert bool((pos >= moe_mod._capacity(cfg, t)).any()) == drops
    assert (len(torch.unique(idx)) < e) == unhit
    if router == "skewed":
        assert bool((idx[:, 0] == 0).all())


@pytest.mark.parametrize("capacity", [1.0, "dropless"])
def test_the_plain_pair_computes_each_kept_choice_alone(capacity):
    """Row by row: a kept choice's row is the SwiGLU of its token through its
    expert, a dropped one's is 0."""
    e, k, t = 16, 2, 24
    cfg = _cfg(e, k, capacity)
    p, x = _layer(cfg, "skewed", t, seed=3)
    x = x[0]
    _, idx, _ = moe_mod._routing(p, x, cfg)
    c = moe_mod._capacity(cfg, t)
    ex = p["experts"]
    h = ops.moe_gate_up(x, idx, ex["w_gate"], ex["w_up"], capacity=c)
    out = ops.moe_down(h, idx, ex["w_down"], capacity=c)
    load = [0] * e
    for choice, expert in enumerate(idx.reshape(-1).tolist()):
        if load[expert] < c:
            want_h = torch.nn.functional.silu(x[choice // k] @ ex["w_gate"][expert]) \
                * (x[choice // k] @ ex["w_up"][expert])
            assert ref.moe_excess(h[choice][None], want_h[None]) <= 1.0
            assert ref.moe_excess(out[choice][None], (h[choice] @ ex["w_down"][expert])[None]) <= 1.0
        else:
            assert not h[choice].any() and not out[choice].any()
        load[expert] += 1
    assert (max(load) > c) == (capacity == 1.0)


def _meta_x(t):
    return torch.empty((t, D_MODEL), device="meta")


@pytest.mark.parametrize("e,k", [(16, 2), (256, 8)])
def test_the_route_is_taken_up_to_r_max_choices_an_expert(e, k):
    """Decode's mean choices an expert (256 experts top-8 at 32 tokens: 1;
    16 top-2: 4) take the route up to R_MAX; prefill's do not."""
    cfg = _cfg(e, k, "dropless")
    ex = {n: torch.empty((e, 4, 4), device="meta") for n in ("w_gate", "w_up", "w_down")}
    at_most = moe_mod.R_MAX * e // k
    assert moe_mod._kept_rows(_meta_x(32), ex, cfg)
    assert moe_mod._kept_rows(_meta_x(at_most), ex, cfg)
    assert not moe_mod._kept_rows(_meta_x(at_most + 1), ex, cfg)
    assert not moe_mod._kept_rows(_meta_x(4096), ex, cfg)
    assert not moe_mod._kept_rows(_meta_x(32768), ex, cfg)


def test_a_recorded_gradient_or_another_type_keeps_the_padded_route(monkeypatch):
    cfg = _cfg(16, 2, "dropless")
    p, x = _layer(cfg, "random", 8)
    calls = []
    gate_up = ops.moe_gate_up
    monkeypatch.setattr(ops, "moe_gate_up", lambda *a, **kw: (calls.append(1), gate_up(*a, **kw))[1])
    x_grad = x.clone().requires_grad_()
    p_grad = {**p, "experts": {n: w.clone().requires_grad_() for n, w in p["experts"].items()}}
    p_bf16 = {**p, "experts": {n: w.bfloat16() for n, w in p["experts"].items()}}
    moe_mod.moe_forward(p, x_grad, cfg)
    moe_mod.moe_forward(p_grad, x, cfg)
    moe_mod.moe_forward(p_bf16, x, cfg)
    moe_mod.moe_forward(p, x.bfloat16(), cfg)
    assert calls == []
    with torch.no_grad():                  # no gradient is recorded
        moe_mod.moe_forward(p_grad, x_grad, cfg)
    moe_mod.moe_forward(p, x, cfg)         # nothing requires one
    assert calls == [1, 1]


@pytest.mark.parametrize("capacity", [1.0, "dropless"])
def test_the_counters_on_the_kept_row_route(capacity, monkeypatch):
    """Every counter reads as on the padded route: rows E x C on both
    (what the benchmark's row use divides by), kept and experts hit the
    same choices."""
    e, k, t = 16, 2, 32
    cfg = _cfg(e, k, capacity)
    p, x = _layer(cfg, "skewed", t, seed=5)
    with torch.no_grad():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            moe_mod.moe_forward(p, x, cfg)
        kept_route = obs.snapshot()["counters"]
        obs.reset()
        _padded(monkeypatch)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            moe_mod.moe_forward(p, x, cfg)
        padded = obs.snapshot()["counters"]
    c = moe_mod._capacity(cfg, t)
    assert {n: kept_route[n] for n in ("moe.choices", "moe.rows", "moe.kept",
                                       "moe.experts_hit")} == padded
    assert padded["moe.rows"] == e * c
    assert (kept_route["moe.kept"] < t * k) == (capacity == 1.0)


def test_a_window_of_both_routes_adds_the_rows_of_each(monkeypatch):
    """One forward on each route in one window: rows count E x C for each,
    the choices and kept choices twice the one forward's."""
    cfg = _cfg(16, 2, "dropless")
    p, x = _layer(cfg, "random", 8)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            moe_mod.moe_forward(p, x, cfg)
        moe_mod.moe_forward(p, x.clone().requires_grad_(), cfg)
    counters = obs.snapshot()["counters"]
    assert counters["moe.rows"] == 2 * 16 * moe_mod._capacity(cfg, 8)
    assert counters["moe.choices"] == counters["moe.kept"] == 2 * 8 * 2


def test_meta_operands_give_shapes_and_are_charged():
    t, k, e = 32, 8, 256
    x = torch.empty((t, D_MODEL), device="meta")
    idx = torch.empty((t, k), dtype=torch.int64, device="meta")
    wg = torch.empty((e, D_MODEL, D_FF), device="meta")
    wd = torch.empty((e, D_FF, D_MODEL), device="meta")
    charged = []

    def hook(name, cost, run):
        charged.append((name, cost))
        return run()

    ops.CHARGE_HOOKS.append(hook)
    try:
        h = ops.moe_gate_up(x, idx, wg, wg, capacity=t)
        out = ops.moe_down(h, idx, wd, capacity=t)
    finally:
        ops.CHARGE_HOOKS.remove(hook)
    assert h.is_meta and h.shape == (t * k, D_FF) and out.shape == (t * k, D_MODEL)
    assert charged == [("moe_gate_up", work.moe_rows_work(x, idx, wg, mats=2)),
                       ("moe_down", work.moe_rows_work(h, idx, wd, mats=1))]
    # every choice kept, 256 experts hit: the most the shapes allow
    assert charged[0][1] == (8 * 256 + 4 * (t * D_MODEL + 2 * e * D_MODEL * D_FF + 256 * D_FF),
                             2 * 2 * 256 * D_MODEL * D_FF)


def test_the_wrappers_reject_mismatched_shapes():
    x, idx = torch.zeros((4, 8)), torch.zeros((4, 2), dtype=torch.int64)
    w = torch.zeros((3, 8, 12))
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.moe_gate_up(x, idx, w, w[:, :, :8], capacity=4)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.moe_gate_up(x[:3], idx, w, w, capacity=4)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.moe_down(torch.zeros((8, 12)), idx, torch.zeros((3, 8, 8)), capacity=4)
