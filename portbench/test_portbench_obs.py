"""The per-layer metrics that read the program's own spans and counters
(``repro_torch.obs``), on the CPU: on ``fixture_root``'s tiny cells, with a
record made up to the card's form, and on a program without the module."""

from __future__ import annotations

import sys
import types

import pytest
import torch
from torch.autograd import DeviceType

from portbench import decode_bytes, fixture_root, harness, spans, spec, work
from portbench.spec import ROOT

CPU = torch.device("cpu")
SEED = 2**31 + 77
SECONDS = 0.3
NEW = {"moe_dispatch_pct.prefill": ("program_span", ["jamba.prefill32k", "deepseek.prefill4k"]),
       "sdpa_pct.prefill": ("program_span", ["deepseek.prefill4k"]),
       "moe_experts_pct.decode": ("program_span", ["deepseek.decode", "jamba.decode"]),
       "moe_row_use.decode": ("program_counter", ["deepseek.decode", "jamba.decode"]),
       "hbm_pct.decode": ("program_span", ["deepseek.decode", "jamba.decode"])}
SHARES = [n for n in NEW if n != "moe_row_use.decode"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return fixture_root.make(tmp_path_factory.mktemp("portbench_obs_root"))


@pytest.fixture
def obs():
    from repro_torch import obs
    obs.reset()
    yield obs
    obs.reset()


def _reader(name):
    return spec.Bench().reader(name)


def test_the_new_entries_are_the_five_spans_and_counters_metrics():
    per_layer = spec.Bench().data["per_layer"]
    assert [m["name"] for m in per_layer[-5:]] == list(NEW)
    for m in per_layer[-5:]:
        assert (m["source"], m["workloads"]) == NEW[m["name"]]
        kind = "prefill" if "prefill" in m["name"] else "decode"
        assert "roofline" not in m["name"] and m["moves"] == f"{kind}_tokens_per_s"
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", [c[0] for c in fixture_root.CELLS])
def test_traced_on_the_cpu_only_the_count_reads(root, obs, cell):
    res, _ = harness.run_cell(root, cell, SEED, SECONDS, True, CPU)
    assert res["correct"] is True
    # no card: every device share reads None
    assert set(res["metrics"]) == ({"moe_row_use.decode"} if cell.endswith("decode") else set())
    if cell.endswith("decode"):
        m = fixture_root.JAMBA if "jamba" in cell else fixture_root.DEEPSEEK
        o = m["port"]["overrides"]
        traffic = spec.Bench(root).traffic("tiny-decode")
        cfg = types.SimpleNamespace(moe_top_k=o["moe_top_k"], moe_experts=o["moe_experts"],
                                    moe_capacity=o["moe_experts"] / o["moe_top_k"])
        from repro_torch.models.moe import _capacity
        sessions = traffic["sessions"]
        rows = o["moe_experts"] * _capacity(cfg, sessions)
        want = 100.0 * (sessions * o["moe_top_k"]) / rows
        assert res["metrics"]["moe_row_use.decode"]["value"] == want


class _OnTheCard:
    """A host event of the CPU's trace seen as a device op over the same
    interval, as the card's kernel under it would run."""

    def __init__(self, e):
        self.e = e

    def name(self):
        return self.e.name()

    def device_type(self):
        return DeviceType.CUDA

    def start_ns(self):
        return self.e.start_ns()

    def end_ns(self):
        return self.e.end_ns()

    def is_user_annotation(self):
        return False


def test_a_traced_decode_names_the_span_open_in_each_idle_gap(root, obs, monkeypatch):
    """Each aten op mirrored as a device op: the gaps between them are the
    host's time between ops, which the spans now name."""
    real = harness.trace_mod.read

    def read(prof, window_s):
        events = prof.profiler.kineto_results.events()
        ops = [_OnTheCard(e) for e in events
               if e.device_type() == DeviceType.CPU and e.name().startswith("aten::")]
        kr = types.SimpleNamespace(events=lambda: list(events) + ops)
        return real(types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=kr)),
                    window_s)

    monkeypatch.setattr(harness.trace_mod, "read", read)
    res, _ = harness.run_cell(root, "tiny-jamba.decode", SEED, SECONDS, True, CPU)
    gaps = [name for name, _ in res["breakdown"]["idle_gaps"]]
    assert any(g.startswith("host: repro_torch.") for g in gaps), gaps


def _ctx(model, traffic, stats, cuda=True):
    return types.SimpleNamespace(cuda=cuda, trace=object(), model=model, kinds={},
                                 traffic=traffic, stats=stats, window_peak_bytes=0)


def _record(step, device):
    """A snapshot of the program's record with each span's device seconds."""
    return {"spans": {n: {"count": step if n.startswith("step.") else 2 * step, "device_s": s,
                          "host_s": s, "self_device_s": s} for n, s in device.items()},
            "counters": {"moe.choices": 256 * step, "moe.rows": 8192 * step,
                         "moe.kept": 256 * step, "moe.experts_hit": 163 * step}}


DEEPSEEK = spec.Bench().config("deepseek-v3-671b.cut2")["model"]
DECODE = spec.Bench().traffic("decode")


def test_the_shares_read_the_record_on_a_card(monkeypatch):
    snap = _record(10, {"step.prefill": 2.0, "moe.dispatch": 0.25, "mla.sdpa": 1.25,
                        "step.decode": 0.272, "moe.experts": 0.204})
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    ctx = _ctx(DEEPSEEK, DECODE, {"processed": 320, "pairs": 32 * 1000})
    assert _reader("moe_dispatch_pct.prefill")(ctx) == 12.5
    assert _reader("sdpa_pct.prefill")(ctx) == 62.5
    assert _reader("moe_experts_pct.decode")(ctx) == pytest.approx(75.0)
    assert _reader("moe_row_use.decode")(ctx) == 3.125
    # ten steps of 32 sessions at 27.2 ms: about 35.8 GB a step
    nbytes = decode_bytes.window_bytes(DEEPSEEK, DECODE, 10, 320, 32 * 1000, 1630)
    assert nbytes / 10 == pytest.approx(35.8e9, rel=0.01)
    assert _reader("hbm_pct.decode")(ctx) == pytest.approx(
        100.0 * nbytes / (0.272 * work.HBM_BYTES_PER_S))
    assert 35 < _reader("hbm_pct.decode")(ctx) < 45
    # without a card, or a span, a share reads None; the count still reads
    assert all(_reader(n)(_ctx(DEEPSEEK, DECODE, {}, cuda=False)) is None for n in SHARES)
    assert _reader("moe_row_use.decode")(_ctx(DEEPSEEK, DECODE, {}, cuda=False)) == 3.125
    monkeypatch.setattr(spans, "snapshot", lambda: {"spans": {}, "counters": {}})
    assert all(_reader(n)(ctx) is None for n in NEW)


def test_a_program_without_the_module_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)     # import raises
    ctx = _ctx(DEEPSEEK, DECODE, {"processed": 32, "pairs": 32})
    assert spans.snapshot() is None
    assert all(_reader(n)(ctx) is None for n in NEW)


@pytest.mark.parametrize("config", [fixture_root.JAMBA, fixture_root.DEEPSEEK],
                         ids=["tiny-jamba", "tiny-deepseek"])
def test_dense_params_are_the_ports_params_but_embedding_and_routed_experts(config):
    port = harness.import_port(ROOT)
    traffic = spec.Bench().traffic("decode")
    cfg = harness.port_config(port, config, traffic)
    params = port.tf.init_params(cfg, port.blocks.SHAPE_ONLY)
    total = 0
    for path, leaf in _leaves(params):
        if path[0] != "embed" and "experts" not in path:
            total += leaf.numel()
    assert decode_bytes.dense_params(config["model"]) == total


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_window_bytes_by_hand():
    m = {"d_model": 2, "vocab": 3, "n_heads": 1, "n_kv_heads": 1, "head_dim": 2, "d_ff": 4,
         "moe_experts": 4, "moe_top_k": 1, "moe_shared": 0, "moe_d_ff": 1, "mamba_d_inner": 4,
         "mamba_dt_rank": 1, "mamba_d_state": 2, "mamba_d_conv": 3,
         "layers": [["gqa", "moe"], ["mamba", "swiglu"]]}
    gqa = 2 * 2 * 2 + 2 * 2 * 2                       # wq, wo; wk, wv
    mamba = 2 * 8 + 3 * 4 + 4 * 5 + 4 + 4 * 2 + 4 + 4 * 2
    dense = 2 * 3 + 2 + (2 + gqa + 2 + 2 * 4) + (2 + mamba + 2 + 3 * 2 * 4)
    assert decode_bytes.dense_params(m) == dense
    traffic = {"params_dtype": "float32", "cache_dtype": "bfloat16"}
    # 3 steps of 2 tokens, 9 pairs, 5 experts hit
    assert decode_bytes.window_bytes(m, traffic, 3, 6, 9, 5) \
        == (3 * dense + 5 * 3 * 2 * 1 + 6 * 2) * 4 + 9 * 2 * 1 * 2 * 2 + 6 * 2 * 4 * (2 + 2) * 4
