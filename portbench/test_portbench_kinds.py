"""A layer kind the benchmark does not know, added as new files only: a
tiny configuration of the port's StarCoder2 GELU FFN whose plain reference,
counts and initialisation come from its own module under
``portbench/reference/``, run through the harness on the CPU; and the
existing configurations' counts, draws and reference pinned as they were
before a configuration could bring its own."""

from __future__ import annotations

import hashlib
import json

import pytest
import torch

from portbench import check, control, decode_bytes, fixture_root, harness, spans, spec, weights, \
    work
from portbench.spec import ROOT

CPU = torch.device("cpu")
SEED = 2**31 + 1234
SECONDS = 0.3
STEM = "tiny_gelu"

#: the reference module of the new kind, written into the root as a new file
MODULE = '''"""A plain float32 decoder of ``model.py``'s layers and StarCoder2's
two-layer GELU FFN, ``down(gelu_tanh(x up + b_up)) + b_down``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import model as base


def gelu(p, x, prec):
    h = F.gelu(prec.mm(x, p["w_up"]) + p["b_up"].float(), approximate="tanh")
    return prec.mm(h, p["w_down"]) + p["b_down"].float()


def layer(p, kinds, x, m, prec, capacity, margins=None):
    mixer, ffn = kinds
    if ffn != "gelu":
        return base.layer(p, kinds, x, m, prec, capacity, margins)
    x = x + base.MIXERS[mixer](p["mixer"], base.rms_norm(p["norm1"], x, m["norm_eps"]), m, prec)
    return x + gelu(p["ffn"], base.rms_norm(p["norm2"], x, m["norm_eps"]), prec)


@torch.no_grad()
def logits_at(head, layers, model, tokens, at, *, capacity=None, precision="fp32", margins=None):
    prec = base.Precision(precision)
    x = head["embed"][tokens].float()
    for p, kinds in zip(layers, model["layers"]):
        x = layer(p, kinds, x, model, prec, capacity, margins)
    x = torch.gather(x, 1, at[..., None].expand(-1, -1, x.shape[-1]))
    return prec.mm(base.rms_norm(head["final_norm"], x, model["norm_eps"]), head["lm_head"])


KINDS = {"gelu": {
    "matmul_params": lambda m: 2 * m["d_model"] * m["d_ff"],
    "pair_flops": lambda m: 0,
    "dense_params": lambda m: 2 * m["d_model"] * m["d_ff"] + m["d_ff"] + m["d_model"],
    "window_bytes": lambda m, tokens, pairs, cache_bytes: 0,
}}


def bias_ramp(view, generator):
    view.copy_(torch.linspace(-0.05, 0.05, view.shape[-1]).expand(view.shape))


INIT = {"b_up": ("uniform", 0.1), "b_down": ("fill", "bias_ramp")}
'''

STARCODER2 = {
    "port": {"arch": "starcoder2-3b", "repeats": [2], "overrides": {
        "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128, "vocab": 256, "norm": "rms",
        "window": 0}},
    "reference": STEM,
    "initializer_range": 0.02,
    "model": {"layers": [["gqa", "gelu"], ["gqa", "gelu"]], "d_model": 64, "vocab": 256,
              "norm_eps": 1e-6, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
              "rope_theta": 100000.0, "d_ff": 128},
}
CELLS = {"prefill": "tiny-starcoder2.prefill", "decode": "tiny-starcoder2.decode"}
BARE = "tiny-starcoder2-bare.prefill"
#: the metrics the new cells report beside ``setup_s``
METRICS = {"prefill": ("prefill_tokens_per_s", "mfu.prefill", "peak_mem_gib.prefill",
                       "device_idle_pct.prefill"),
           "decode": ("decode_tokens_per_s", "tbt_ms.p95", "mfu.decode", "hbm_pct.decode",
                      "peak_mem_gib.decode", "device_idle_pct.decode")}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """``fixture_root``'s root and, as new files and entries, the new kind's
    configuration, module and cells, and the same configuration without its
    module; the cells run the root's two tiny traffic mixes."""
    root = fixture_root.make(tmp_path_factory.mktemp("portbench_kinds_root"))
    pb = root / "portbench"
    (pb / "reference" / f"{STEM}.py").write_text(MODULE)
    bare = {k: v for k, v in STARCODER2.items() if k != "reference"}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, config in (("tiny-starcoder2", STARCODER2), ("tiny-starcoder2-bare", bare)):
        (pb / "configs" / f"{name}.json").write_text(json.dumps(config))
        bench["configs"].append({"name": name, "file": f"portbench/configs/{name}.json"})
    cells = [(CELLS["prefill"], "tiny-starcoder2", "prefill"),
             (CELLS["decode"], "tiny-starcoder2", "decode"),
             (BARE, "tiny-starcoder2-bare", "prefill")]
    for name, config, kind in cells:
        bench["workloads"].append({"name": name, "config": config, "traffic": f"tiny-{kind}",
                                   "chips": 1})
        (pb / "cells" / f"{name}.json").write_text(json.dumps(fixture_root.CHECKS[kind]))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in METRICS[kind]:
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="module")
def module(root):
    return spec.Bench(root).reference(STARCODER2)


def test_the_module_s_sibling_is_the_root_s_model_py(root, module):
    model = root / "portbench" / "reference" / "model.py"
    assert module.__file__ == str(model.with_name(f"{STEM}.py"))
    assert module.base.__file__ == str(model)


def test_the_new_kind_is_known_only_to_its_module(module):
    assert "gelu" not in work.MIXERS + work.FFNS
    assert work.unknown_kinds(STARCODER2["model"], {}) == ["gelu"]
    assert work.unknown_kinds(STARCODER2["model"], module.KINDS) == []
    for count in (work.matmul_params_per_token, work.attention_flops_per_pair,
                  decode_bytes.dense_params):
        with pytest.raises(ValueError, match="'gelu'"):
            count(STARCODER2["model"])


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_a_new_kind_runs_and_checks_end_to_end(root, kind):
    res, _ = harness.run_cell(root, CELLS[kind], SEED, SECONDS, False, CPU)
    assert res["correct"] is True, res["checks"]
    e2e = {n for n in METRICS[kind] if n.endswith(("_s", "p95"))}
    assert set(res["metrics"]) == {"setup_s", *e2e}
    assert all(m["value"] > 0 for m in res["metrics"].values())


D, F, V = 64, 128, 256
#: wq, wo (4 heads of 16); wk, wv (2 heads)
GQA = 2 * D * 4 * 16 + 2 * D * 2 * 16
#: by hand: the LM head and two layers of GQA and the GELU FFN; 4 head_dim a
#: head and pair in each GQA layer
PER_TOKEN = D * V + 2 * (GQA + 2 * D * F)
PER_PAIR = 2 * 4 * 16 * 4


class _OnACard:
    """A traced run's readers as on a card: the context says so, and each
    span's device seconds are its host seconds."""

    def __init__(self, monkeypatch):
        self.ctx = None
        context, snapshot = harness.Run.context, spans.snapshot

        def on_card(run, *args):
            self.ctx = context(run, *args)
            self.ctx.cuda = True
            return self.ctx

        def timed():
            snap = snapshot()
            for s in snap["spans"].values():
                s["device_s"] = s["host_s"]
            return snap

        monkeypatch.setattr(harness.Run, "context", on_card)
        monkeypatch.setattr(spans, "snapshot", timed)


def test_a_traced_prefill_reads_the_new_kinds_flops(root, monkeypatch):
    card = _OnACard(monkeypatch)
    res, _ = harness.run_cell(root, CELLS["prefill"], SEED, SECONDS, True, CPU)
    assert res["correct"] is True
    stats = card.ctx.stats
    flops = 2 * PER_TOKEN * stats["processed"] + PER_PAIR * stats["pairs"]
    assert res["metrics"]["mfu.prefill"]["value"] == pytest.approx(
        100.0 * flops / (stats["window_s"] * work.BF16_FLOPS_PER_S), rel=1e-12)


def test_a_traced_decode_reads_the_new_kinds_flops_and_bytes(root, monkeypatch):
    from repro_torch import obs
    obs.reset()
    card = _OnACard(monkeypatch)
    res, _ = harness.run_cell(root, CELLS["decode"], SEED, SECONDS, True, CPU)
    assert res["correct"] is True
    stats = card.ctx.stats
    flops = 2 * PER_TOKEN * stats["processed"] + PER_PAIR * stats["pairs"]
    assert res["metrics"]["mfu.decode"]["value"] == pytest.approx(
        100.0 * flops / (stats["window_s"] * work.FP32_FLOPS_PER_S), rel=1e-12)
    step = spans.snapshot()["spans"]["step.decode"]
    dense = D * V + D + 2 * (D + GQA + D + 2 * D * F + F + D)
    nbytes = (step["count"] * dense + stats["processed"] * D) * 4 \
        + 2 * stats["pairs"] * 2 * 2 * 16 * 4
    assert res["metrics"]["hbm_pct.decode"]["value"] == pytest.approx(
        100.0 * nbytes / (step["device_s"] * work.HBM_BYTES_PER_S), rel=1e-12)
    obs.reset()


def test_the_new_kinds_dense_params_are_the_ports_params_but_the_embedding(module):
    port = harness.import_port(ROOT)
    cfg = harness.port_config(port, STARCODER2, spec.Bench().traffic("decode"))
    params = port.tf.init_params(cfg, port.blocks.SHAPE_ONLY)
    total = sum(t.numel() for path, t in weights.leaves(params) if path != "embed")
    assert decode_bytes.dense_params(STARCODER2["model"], module.KINDS) == total


def test_the_modules_init_draws_the_leaves_it_names(root):
    run = harness.Run(root, CELLS["decode"], SEED, CPU)
    ffn = run.params["stack0"]["l0"]["ffn"]
    b_up = ffn["b_up"].float()
    assert 0 < float(b_up.abs().max()) <= 0.1 and float(b_up.std()) > 0.03
    assert torch.equal(ffn["b_down"], torch.linspace(-0.05, 0.05, 64).expand_as(ffn["b_down"]))
    # the leaves it does not name keep the benchmark's rules
    assert float(ffn["w_up"].float().std()) == pytest.approx(0.02, rel=0.1)
    assert torch.equal(run.params["stack0"]["l0"]["norm2"],
                       torch.ones_like(run.params["stack0"]["l0"]["norm2"]))


def test_the_control_fails_where_the_program_passes_on_the_new_kind(root):
    r = control.readings(root, CELLS["prefill"], SEED, SECONDS, CPU)
    limits = spec.Bench(root).limits(CELLS["prefill"])
    assert check.verdict(r["program"], limits)[0]
    assert not check.verdict(r["control_reading"], limits)[0]


def test_without_its_module_set_up_fails_naming_the_kind_before_any_draw(root, monkeypatch):
    def no_draw(*args, **kwargs):
        raise AssertionError("weights drawn")

    monkeypatch.setattr(weights, "draw", no_draw)
    with pytest.raises(ValueError, match=r"\['gelu'\].*reference/model\.py"):
        harness.Run(root, BARE, SEED, CPU)


# -- the existing configurations, as they were before a configuration could
# bring its own module

TINY = {"tiny-jamba": fixture_root.JAMBA["model"], "tiny-deepseek": fixture_root.DEEPSEEK["model"]}
#: (model_flops(m, 1000, 123456), window_bytes(m, decode, 7, 224, 123456, 50))
PINNED_COUNTS = {"jamba-v0.1-52b.cut8": (6322838831104, 87266705408),
                 "deepseek-v3-671b.cut2": (4211123159040, 58191892480),
                 "tiny-jamba": (914292736, 74789120),
                 "tiny-deepseek": (272547840, 43166464)}
#: sha256 over each leaf's path and bytes of ``weights.draw`` at seed 2**31 + 4097
PINNED_DRAWS = {
    ("JAMBA", "float32"): "f010e612d59e96d8c6bbfd91211ed979bf071a9d59558bde54a1b766ac0ee867",
    ("JAMBA", "bfloat16"): "62bfa293b6cd4cbc96604c2529b3360b09e5249b2c4360adbc1461571908dc1a",
    ("DEEPSEEK", "float32"): "91c95d0b483d82bfe0be52b2d8c12e1a3874208818e3c19c82b2295cde002c05",
    ("DEEPSEEK", "bfloat16"): "5df263455e7329228c239878f4a97ecfc36db5628253f180975ec1b4015cd1cf",
}


@pytest.mark.parametrize("name", list(PINNED_COUNTS))
def test_the_existing_counts_are_pinned(name):
    m = TINY[name] if name in TINY else spec.Bench().config(name)["model"]
    decode = spec.Bench().traffic("decode")
    assert (work.model_flops(m, 1000, 123456),
            decode_bytes.window_bytes(m, decode, 7, 224, 123456, 50)) == PINNED_COUNTS[name]
    assert work.unknown_kinds(m, {}) == []


@pytest.mark.parametrize("name,dtype", list(PINNED_DRAWS))
def test_the_existing_draws_are_pinned(name, dtype):
    config = getattr(fixture_root, name)
    port = harness.import_port(ROOT)
    cfg = harness.port_config(port, config, {"activation_dtype": dtype, "moe_capacity": "config"})
    meta = port.tf.init_params(cfg, port.blocks.SHAPE_ONLY, dtype=getattr(torch, dtype))
    module = spec.Bench().reference(config)
    h = hashlib.sha256()
    for path, t in weights.leaves(weights.draw(meta, 2**31 + 4097, CPU, 0.02, module)):
        h.update(path.encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == PINNED_DRAWS[name, dtype]


@pytest.mark.parametrize("name", ["jamba-v0.1-52b.cut8", "deepseek-v3-671b.cut2"])
def test_a_configuration_without_reference_resolves_to_model_py(name):
    bench = spec.Bench()
    config = bench.config(name)
    assert "reference" not in config
    path = ROOT / "portbench" / "reference" / "model.py"
    assert bench.reference_path(config) == path
    module = bench.reference(config)
    assert module.__file__ == str(path) and callable(module.logits_at)
    assert not hasattr(module, "KINDS") and not hasattr(module, "INIT")


def test_a_run_of_an_existing_cell_takes_model_py(tmp_path):
    root = fixture_root.make(tmp_path)
    run = harness.Run(root, "tiny-jamba.prefill", SEED, CPU)
    assert run.reference.__file__ == str(root / "portbench" / "reference" / "model.py")
    assert run.kinds == {}
