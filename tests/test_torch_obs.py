"""The port's spans and counters (``repro_torch.obs``) on the CPU, on reduced
jamba and deepseek-v3.

Off (no profiler collecting), the record stays empty and a prefill and two
decode steps run the same aten ops, in the same order, as with ``obs``
stubbed out, entering no ``record_function`` and making no CUDA event; the
logits are bit-identical.  On (under ``torch.profiler``), each step is one
``step.*`` span whose children are the layers' spans in order, each MoE's
sub-spans sit under its ``ffn.moe`` with the step's id, the profiler's own
events carry the names, and the logits are still bit-identical.  The MoE's
counters equal a plain Python count of the same routing, with and without
drops.  ``ops.LAUNCHES`` is the module's ``launches`` family.  A fake CUDA event
shows the card's timing: no wait while on, events reused once the device
has passed them, each span's device and self seconds.
"""

import contextlib
import dataclasses
import types

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import obs
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tf

ARCHS = ["jamba-v0.1-52b", "deepseek-v3-671b"]
BATCH, PROMPT, MAX_LEN = 2, 12, 16
LAUNCH_NAMES = {"relax_round", "relax_round_witness", "maxplus_bmm", "maxplus_bmv",
                "maxplus_matmul", "flash_attention", "lif_crossbar_step", "mamba_chunk_scan",
                "mamba_chunk_states", "mamba_chunk_combine", "mamba_scan_route", "spike_input",
                "lif_record", "moe_gate_up", "moe_down"}


@pytest.fixture(autouse=True)
def fresh_record():
    obs.reset()
    yield
    obs.reset()


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = reduced(get_arch(request.param))
    params = tf.init_params(cfg, torch.Generator().manual_seed(7))
    tokens = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=torch.Generator().manual_seed(3))
    return cfg, params, tokens


def _run(cfg, params, tokens):
    """A prefill of ``tokens`` and two decode steps after it: the logits."""
    out = [steps.make_prefill_step(cfg)(params, {"tokens": tokens})]
    cache = tf.init_cache(cfg, BATCH, MAX_LEN, dtype=torch.float32, device="cpu")
    serve = steps.make_serve_step(cfg)
    for i in range(2):
        logits, cache = serve(params, cache, tokens[:, i:i + 1], i)
        out.append(logits)
    return out


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _refuse(*args, **kwargs):
    raise AssertionError("called with no profiler collecting")


def test_off_records_nothing_and_runs_the_same_ops(model, monkeypatch):
    cfg, params, tokens = model
    assert not obs.enabled()
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", _refuse)
        m.setattr(torch._C._profiler, "_RecordFunctionFast", _refuse)
        m.setattr(torch.cuda, "Event", _refuse)
        with _Ops() as live:
            got = _run(cfg, params, tokens)
    assert obs.entries() == [] and obs.snapshot() == {"spans": {}, "counters": {}}
    with monkeypatch.context() as m:
        m.setattr(obs, "span", lambda name, at=None: contextlib.nullcontext())
        m.setattr(obs, "count", lambda name, n: None)
        m.setattr(obs, "enabled", lambda: False)
        with _Ops() as stubbed:
            want = _run(cfg, params, tokens)
    assert live.ops == stubbed.ops and len(live.ops) > 100
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _children(entries, i):
    return [j for j, e in enumerate(entries) if e[1] == i]


def test_on_each_step_holds_its_layers_in_order(model):
    cfg, params, tokens = model
    off = _run(cfg, params, tokens)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = _run(cfg, params, tokens)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    entries = obs.entries()
    tops = [i for i, e in enumerate(entries) if e[1] is None]
    assert [entries[i][0] for i in tops] == ["step.prefill", "step.decode", "step.decode"]
    assert [entries[i][2] for i in tops] == [1, 2, 3]
    layers = [s for r, specs in cfg.stacks for _ in range(r) for s in specs]
    want = ["embed"] + [n for s in layers for n in (f"mixer.{s.mixer}", f"ffn.{s.ffn}")] + ["head"]
    sub = ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
    sub += ["moe.shared"] if cfg.moe_shared else []
    for step in tops:
        kids = _children(entries, step)
        assert [entries[i][0] for i in kids] == want
        for i in kids:
            inner = _children(entries, i)
            if entries[i][0] == "ffn.moe":
                assert [entries[j][0] for j in inner] == sub
            elif entries[i][0] == "mixer.mla" and entries[step][0] == "step.prefill":
                assert [entries[j][0] for j in inner] == ["mla.sdpa"]
            else:
                assert inner == []
        # every span under the step carries its id, the MoE's sub-spans too
        under = [j for j, e in enumerate(entries) if e[2] == entries[step][2]]
        assert len(under) == 1 + len(kids) + sum(len(_children(entries, i)) for i in kids)
    names = {e.name for e in prof.events()}
    assert {obs.PREFIX + e[0] for e in entries} <= names
    assert obs.PREFIX + "moe.dispatch" in names
    snap = obs.snapshot()
    assert snap["spans"]["step.decode"]["count"] == 2
    # no card: host time only
    assert all(s["device_s"] is None and s["self_device_s"] is None and s["host_s"] > 0
               for s in snap["spans"].values())
    assert obs.snapshot() == snap


@pytest.mark.parametrize("dispatch", ["gather", "onehot"])
def test_off_a_moe_layer_runs_the_same_ops(dispatch, monkeypatch):
    cfg = dataclasses.replace(reduced(get_arch("deepseek-v3-671b")), moe_dispatch=dispatch)
    gen = torch.Generator().manual_seed(5)
    p = moe_mod.init_moe(gen, cfg)
    x = torch.randn((2, 8, cfg.d_model), generator=gen)
    with _Ops() as live:
        got = moe_mod.moe_forward(p, x, cfg)
    monkeypatch.setattr(obs, "span", lambda name, at=None: contextlib.nullcontext())
    monkeypatch.setattr(moe_mod, "_count_routing", lambda *a: None)
    with _Ops() as stubbed:
        want = moe_mod.moe_forward(p, x, cfg)
    assert live.ops == stubbed.ops and obs.entries() == []
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _plain_count(idx, e, c):
    load, kept, hit = [0] * e, 0, set()
    for x in idx.reshape(-1).tolist():
        if load[x] < c:
            kept += 1
            hit.add(x)
        load[x] += 1
    return kept, len(hit)


@pytest.mark.parametrize("dispatch", ["gather", "onehot"])
@pytest.mark.parametrize("capacity", [1.25, "dropless"])
def test_the_moe_counters_equal_a_plain_count(dispatch, capacity):
    cfg = reduced(get_arch("deepseek-v3-671b"))
    cap = cfg.moe_experts / cfg.moe_top_k if capacity == "dropless" else capacity
    cfg = dataclasses.replace(cfg, moe_capacity=cap, moe_dispatch=dispatch)
    gen = torch.Generator().manual_seed(11)
    p = moe_mod.init_moe(gen, cfg)
    # a router that crowds a few experts, so that capacity 1.25 drops choices
    p["router"] = p["router"] * torch.linspace(4.0, 0.0, cfg.moe_experts)
    x = torch.randn((2, 24, cfg.d_model), generator=gen)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        moe_mod.moe_forward(p, x, cfg)
    t, k, e = 48, cfg.moe_top_k, cfg.moe_experts
    c = moe_mod._capacity(cfg, t)
    _, idx, _ = moe_mod._routing(p, x.reshape(t, -1), cfg)
    kept, hit = _plain_count(idx, e, c)
    assert obs.snapshot()["counters"] == {"moe.choices": t * k, "moe.rows": e * c,
                                          "moe.kept": kept, "moe.experts_hit": hit}
    assert (kept < t * k) == (capacity == 1.25)


def test_launches_are_the_modules_family():
    assert ops.LAUNCHES is obs.LAUNCHES and set(ops.LAUNCHES) == LAUNCH_NAMES
    before = dict(ops.LAUNCHES)
    try:
        ops.reset_launches()
        assert set(ops.LAUNCHES.values()) == {0}
        q = torch.randn((1, 2, 8, 64))
        ops.flash_attention(q, q, q)           # the CPU's plain version: no launch
        assert set(ops.LAUNCHES.values()) == {0}
        ops.LAUNCHES["flash_attention"] += 3
        assert obs.snapshot()["counters"] == {"launches.flash_attention": 3}
    finally:
        ops.LAUNCHES.update(before)


def test_reset_clears_the_record(model):
    cfg, params, tokens = model
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _run(cfg, params, tokens)
    assert obs.entries() and obs.snapshot()["spans"]
    obs.reset()
    assert obs.entries() == [] and obs.snapshot() == {"spans": {}, "counters": {}}


class _FakeEvent:
    """A CUDA event on a device clock that advances 1 ms a record; the
    device passes an event when the test says so."""
    clock = 0
    made = 0
    waits = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t, self.done = None, False

    def record(self, stream=None):
        _FakeEvent.clock += 1
        self.t, self.done = _FakeEvent.clock, False

    def query(self):
        return self.done

    def synchronize(self):
        _FakeEvent.waits += 1
        self.done = True

    def elapsed_time(self, end):
        assert self.done or end.done
        return float(end.t - self.t)


def test_on_a_card_events_are_reused_without_a_wait(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(obs, "enabled", lambda: True)
    monkeypatch.setattr(obs, "_FREE", {})
    for k in ("clock", "made", "waits"):
        monkeypatch.setattr(_FakeEvent, k, 0)
    at = types.SimpleNamespace(is_cuda=True, device=torch.device("cuda", 0))
    made = []
    for _ in range(4):
        # the device has passed everything recorded before this step
        for e in list(obs._REC.pending):
            for ev in (e.ev0, e.ev1):
                ev.done = True
        with obs.span("step.decode", at):
            with obs.span("mixer.mamba", at):
                pass
            with obs.span("ffn.moe", at):
                with obs.span("moe.experts", at):
                    pass
        made.append(_FakeEvent.made)
    assert made == [8, 8, 8, 8] and _FakeEvent.waits == 0
    snap = obs.snapshot()["spans"]
    # each step: 8 records 1 ms apart; the step 7 ms, ffn.moe 3, the rest 1
    assert snap["step.decode"] == {"count": 4, "device_s": 0.028, "host_s": snap["step.decode"][
        "host_s"], "self_device_s": pytest.approx(0.012)}
    assert snap["ffn.moe"]["device_s"] == 0.012
    assert snap["ffn.moe"]["self_device_s"] == pytest.approx(0.008)
    assert snap["moe.experts"]["self_device_s"] == snap["mixer.mamba"]["device_s"] == 0.004
    assert _FakeEvent.waits == 4      # the snapshot waits for the last step's four spans
