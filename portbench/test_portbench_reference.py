"""The plain reference against the port at small sizes on the CPU, both in
float32 so that they part only by rounding: jamba's hybrid and
deepseek-v3's MLA and MoE, with capacity drops; and the controls'
rounding."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import fixture_root, harness, weights
from portbench.reference import model as ref
from portbench.spec import ROOT

CPU = torch.device("cpu")


def _port_and_weights(config, seed, capacity):
    port = harness.import_port(ROOT)
    traffic = {"activation_dtype": "float32", "moe_capacity": capacity}
    cfg = harness.port_config(port, config, traffic)
    meta = port.tf.init_params(cfg, port.blocks.SHAPE_ONLY, dtype=torch.float32)
    params = weights.draw(meta, seed, CPU, 0.02)
    return port, cfg, params


@pytest.mark.parametrize("name", ["JAMBA", "DEEPSEEK"])
@pytest.mark.parametrize("capacity", [1.0, "dropless"])
def test_the_reference_follows_the_port(name, capacity):
    config = getattr(fixture_root, name)
    port, cfg, params = _port_and_weights(config, 11, capacity)
    tokens = torch.randint(0, cfg.vocab, (1, 40), generator=torch.Generator().manual_seed(3))
    got = port.steps.make_prefill_step(cfg)(params, {"tokens": tokens})
    head, layers = weights.per_layer(params, config["port"]["repeats"],
                                     [len(s) for _, s in cfg.stacks])
    at = torch.arange(40)[None]
    want = ref.logits_at(head, layers, config["model"], tokens, at,
                         capacity=None if capacity == "dropless" else cfg.moe_capacity)
    assert got.shape == want.shape
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-5, err


def test_capacity_keeps_choices_in_token_then_choice_order():
    idx = torch.tensor([[0, 1], [1, 0], [0, 2], [0, 1]])
    keep = ref.capacity_keep(idx, 3, 2)
    # expert 0: tokens 0, 1 kept, 2 and 3 dropped; expert 1: tokens 0, 1 kept, 3 dropped
    assert keep.tolist() == [[True, True], [True, True], [False, True], [False, False]]


def test_the_controls_round_as_the_tensor_cores_take_their_operands():
    tf32 = ref.Precision("tf32")
    one_up = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 2.0**-11)])
    assert tf32.cast(one_up).tolist() == [1.0 + 2.0**-10, 1.0, -(1.0 + 2.0**-10)]
    fp8 = ref.Precision("fp8")
    assert fp8.cast(torch.tensor([448.0, 1.0625, 1.1875])).tolist() == [448.0, 1.0, 1.25]
    assert ref.Precision("fp32").cast(one_up).tolist() == one_up.tolist()
    with pytest.raises(ValueError):
        ref.Precision("int4")


def test_the_published_configurations_hold_the_port_widths():
    port = harness.import_port(ROOT)
    for name in ("jamba-v0.1-52b.cut8", "deepseek-v3-671b.cut2"):
        config = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
        for dtype, cap in (("bfloat16", "config"), ("float32", "dropless")):
            cfg = harness.port_config(port, config, {"activation_dtype": dtype, "moe_capacity": cap})
            assert cfg.d_model == config["hidden_size"] and cfg.vocab == config["vocab_size"]
            assert cfg.n_layers == config["num_hidden_layers"]
            assert cfg.n_heads == config["num_attention_heads"]
            assert cfg.moe_top_k == config["num_experts_per_tok"]
        with pytest.raises(ValueError):
            harness.port_config(port, dict(config, model=dict(config["model"], d_model=1)),
                                {"activation_dtype": "float32", "moe_capacity": "config"})
