"""The harness end to end on the CPU, on a root of tiny cells that exist
only as new files and entries (``fixture_root``): each traffic mix runs and
checks, a traced run reads its trace, the timed path broken underneath
comes out not correct, the control fails the limits the program meets, and
no run loads JAX or the JAX package."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import check, control, fixture_root, harness, loops, spec
from portbench.spec import ROOT

CPU = torch.device("cpu")
SEED = 2**31 + 4097          # above what 32 signed bits hold
SECONDS = 0.3
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return fixture_root.make(tmp_path_factory.mktemp("portbench_root"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark's cells run only on the card")


@pytest.mark.parametrize("cell", [c[0] for c in fixture_root.CELLS])
def test_a_cell_runs_and_checks_end_to_end(root, cell):
    res, lines = harness.run_cell(root, cell, SEED, SECONDS, False, CPU)
    assert list(res) == KEYS
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {m["name"] for m in spec.Bench(root).end_to_end(cell)}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    # each number compared beside its limit closes standard error
    assert lines[-len(res["checks"]):] == [f"check {k} {v['value']!r} limit {v['limit']!r}"
                                          for k, v in res["checks"].items()]
    json.dumps(res)


def test_a_traced_run_reads_its_trace(root):
    res, _ = harness.run_cell(root, "tiny-jamba.prefill", SEED, SECONDS, True, CPU)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert res["correct"] is True
    assert res["device"]["window_s"] >= SECONDS and res["device"]["busy_s"] == 0.0
    # no device on the CPU: every per-layer reader finds nothing to read
    assert res["metrics"] == {}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(res["breakdown"]["idle_gaps"]) <= 10


def test_the_same_seed_makes_the_same_inputs(root):
    a, b = (harness.Run(root, "tiny-deepseek.decode", SEED, CPU) for _ in range(2))
    c = harness.Run(root, "tiny-deepseek.decode", SEED + 1, CPU)
    wa, wb, wc = (r.params["stack1"]["l0"]["ffn"]["experts"]["w_up"] for r in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert torch.equal(a.loop.prompts, b.loop.prompts)
    assert not torch.equal(a.loop.prompts, c.loop.prompts)
    assert a.loop.prompts.shape == c.loop.prompts.shape


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _state_unchanged(step):
    def broken(params, cache, tokens, length):
        return step(params, _clone(cache), tokens, length)[0], cache
    return broken


def _half_batch(step):
    def broken(params, cache, tokens, length):
        logits, cache = step(params, cache, tokens, length)
        half = logits.shape[0] // 2
        return torch.cat([logits[:half], logits[:half].mean(0, keepdim=True)
                          .expand(logits.shape[0] - half, -1, -1)]), cache
    return broken


def _token_altered(step):
    def broken(params, cache, tokens, length):
        logits, cache = step(params, cache, tokens, length)
        return torch.roll(logits, 1, dims=-1), cache
    return broken


def _argmax_lowered(step):
    """The best logit of each row put under the second: the row is right
    but for one column, and the token served is the second best."""
    def broken(params, cache, tokens, length):
        logits, cache = step(params, cache, tokens, length)
        top = logits.topk(2, dim=-1)
        return logits.scatter(-1, top.indices[..., :1], top.values[..., 1:] - 0.5), cache
    return broken


def _late_state_lost(step):
    """From a late slot on, each step starts from an empty state: the
    slots before it are right."""
    late = fixture_root.DECODE_MAX_LEN * 5 // 6

    def broken(params, cache, tokens, length):
        if length >= late:
            cache = {g: {n: {k: torch.zeros_like(t) for k, t in layer.items()}
                         for n, layer in group.items()} for g, group in cache.items()}
        return step(params, cache, tokens, length)
    return broken


def _answer_altered(step):
    def broken(params, batch):
        return torch.roll(step(params, batch), 1, dims=-1)
    return broken


def _late_answer_altered(step):
    """The logits of the last quarter of the positions altered: the first
    three quarters are right."""
    def broken(params, batch):
        logits = step(params, batch)
        late = logits.shape[1] * 3 // 4
        return torch.cat([logits[:, :late], torch.roll(logits[:, late:], 1, dims=-1)], dim=1)
    return broken


FAULTS = {
    "decode_state_unchanged": ("make_serve_step", _state_unchanged),
    "decode_half_batch_left_out": ("make_serve_step", _half_batch),
    "decode_token_altered": ("make_serve_step", _token_altered),
    "decode_argmax_lowered": ("make_serve_step", _argmax_lowered),
    "decode_late_state_lost": ("make_serve_step", _late_state_lost),
    "prefill_answer_altered": ("make_prefill_step", _answer_altered),
    "prefill_late_answer_altered": ("make_prefill_step", _late_answer_altered),
}
#: the number each fault has to fail, where the median alone would not see it
TAIL = {"decode_argmax_lowered": "served_gap", "decode_late_state_lost": "logit_err_p95",
        "prefill_late_answer_altered": "logit_err_share"}


def _broken_run(root, monkeypatch, arch, fault):
    maker, wrap = FAULTS[fault]
    steps = harness.import_port(root).steps
    real = getattr(steps, maker)
    monkeypatch.setattr(steps, maker, lambda cfg: wrap(real(cfg)))
    cell = f"{arch}.{fault.split('_')[0]}"
    if "late" not in fault:
        return harness.run_cell(root, cell, SEED, SECONDS, False, CPU)[0]
    # a late fault needs a window that reaches a batch's late slots: one
    # thread a test keeps the steps short beside other tests
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(root, cell, SEED, 2.0, False, CPU)[0]
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", ["tiny-jamba", "tiny-deepseek"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, arch, fault):
    res = _broken_run(root, monkeypatch, arch, fault)
    assert res["correct"] is False, res["checks"]
    if fault in TAIL:
        checks = res["checks"]
        assert checks[TAIL[fault]]["value"] > checks[TAIL[fault]]["limit"], checks
        assert checks["logit_err_p50"]["value"] <= checks["logit_err_p50"]["limit"], checks


def test_positions_after_a_near_tie_are_left_out_of_the_widest_numbers():
    err = torch.tensor([1e-7, 2e-7, 5.0, 5.0])
    tie = check.ties([torch.tensor([[1.0, 1.0, 1e-6, 1.0, 1.0]])], torch.tensor([[1, 2, 3, 4]]))
    assert tie[0].tolist() == pytest.approx([1.0, 1e-6, 1e-6, 1e-6])
    one = {"err": err, "gap": torch.tensor([0.0, 0.0, 3.0, 3.0]), "tie": torch.tensor(
        [1.0, 1.0, 1e-6, 1e-6])}
    gone = {"err": err, "gap": err, "tie": torch.full((4,), 1e-6)}
    kept = check.numbers([one, gone], near_tie=1e-4, share_over=1.0)
    assert kept["logit_err_max"] == pytest.approx(2e-7) and kept["served_gap"] == 0.0
    assert kept["left_out"] == 6 / 8
    # the quantiles and the share read the same positions
    assert kept["logit_err_p50"] == pytest.approx(1.5e-7) and kept["logit_err_share"] == 0.0
    everywhere = check.numbers([one], share_over=1.0)
    assert everywhere["logit_err_max"] == 5.0 and everywhere["logit_err_p50"] == pytest.approx(2.5)
    assert everywhere["logit_err_share"] == 0.5
    alone = check.numbers([gone], near_tie=1e-4)
    assert alone["left_out"] == 1.0 and "served_gap" not in alone
    assert "logit_err_p50" not in alone and not check.verdict(alone, {"logit_err_p50": 1.0})[0]
    assert not check.verdict(alone, {"served_gap": 1.0})[0]


@pytest.mark.parametrize("change", [{"loop": "open"}, {"clients": 4}])
def test_a_loop_the_generator_does_not_run_is_refused(root, change):
    bench = spec.Bench(root)
    traffic = dict(bench.traffic("tiny-prefill"), **change)
    with pytest.raises(ValueError, match="closed loop of one client"):
        loops.make(traffic, None, None, 0, CPU, None, None)


@pytest.mark.parametrize("cell", ["tiny-jamba.prefill", "tiny-deepseek.decode"])
def test_the_control_fails_where_the_program_passes(root, cell):
    r = control.readings(root, cell, SEED, SECONDS, CPU)
    limits = spec.Bench(root).limits(cell)
    assert check.verdict(r["program"], limits)[0]
    assert not check.verdict(r["control_reading"], limits)[0]
    assert r["control"] == ("fp8" if cell.endswith("prefill") else "tf32")


def test_a_run_loads_neither_jax_nor_the_jax_package(root):
    code = ("import sys, torch; sys.path.insert(0, %r); from portbench import harness; "
            "harness.run_cell(%r, 'tiny-jamba.prefill', 5, 0.3, False, torch.device('cpu')); "
            "print(harness.forbidden_modules())" % (str(ROOT), str(root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          "deepseek.prefill4k", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_a_cell_runs_on_the_card(card):
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          "deepseek.prefill4k", "--seed", str(SEED), "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
