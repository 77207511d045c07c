"""The port's training path on one device against the JAX reference, on the
CPU: cross-entropy and ``loss_fn`` with their gradients, AdamW (float32,
bf16 and int8 moments), gradient compression, the schedule, the token
stream, checkpoints read across the two packages, three train steps, a
restart and the driver.

Inputs come from numpy with a seed and go through both packages; the
parameters are the reference's, redrawn from a seeded numpy stream
(``test_torch_lm._random_params``) and converted by ``convert.lm_params``.
The reference differentiates its plain attention and chunked scan (off the
TPU it reaches no Pallas kernel); the port differentiates through
``ops.FlashAttentionFn`` and ``ops.MambaScanFn``, whose backward is the
gradient of the plain versions recomputed.  Tolerances, stated per test:

* gradients: per leaf, the largest difference over the leaf's root mean
  square (``GRAD_TOL``): float32 1e-4 for the dense model (measured
  2.6e-5), 5e-4 for jamba's first four layers (measured 8.8e-5: the two
  packages' chunked scans sum in other orders), 2e-4 for deepseek-v3
  (measured 5.9e-5), 2e-3 for xlstm's first four layers (measured 7.3e-4:
  the mLSTM's normaliser amplifies a rounding, see ``LOSS_CASES``), 3e-2
  for bf16 activations (measured 1.3e-2: a bf16 rounding step is 2^-8);
* losses: 1e-5 relative (float32);
* AdamW: parameters and float32 moments within 1e-6 of themselves plus
  1e-6 of their leaf's rms (the clip's global norm sums in another order,
  an ulp); bf16 moments one bf16 rounding step; the int8 codec bit for bit
  on the same input, and after an update a q at most 1 apart in at most
  one value in a thousand;
* train steps: losses 1e-5 relative, parameters after three steps 1e-5
  absolute (each step moves a parameter by about the learning rate, 1e-3).
"""

import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as rckpt
from repro.data import pipeline as rdata
from repro.launch import steps as rsteps
from repro.models import attention as rattn
from repro.models import blocks as rblocks
from repro.models import mamba as rmam
from repro.models import transformer as rtf
from repro.optim import adamw as radamw
from repro.optim import compression as rcomp
from repro.optim import schedule as rsched
from repro_torch import convert
from repro_torch.checkpoint import manager as tckpt
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import blocks as tblocks
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp
from repro_torch.optim import schedule as tsched
from repro_torch.tree import tree_leaves

from test_torch_lm import _cfgs, _random_params, _t

F32 = np.float32
GRAD_TOL = {"qwen2": 1e-4, "qwen2_remat": 1e-4, "qwen2_bf16": 3e-2, "jamba": 5e-4,
            "deepseek_v3": 2e-4, "xlstm": 2e-3}
#: cases run on the first layers of the reduced model's first block
FIRST_LAYERS = {"jamba": 4, "xlstm": 4}
LOSS_RTOL = 1e-5


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, F32)


def _batch(vocab, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"tokens": _t(toks[:, :-1]), "labels": _t(toks[:, 1:])})


def _compiled(fn, params, batch, cfg):
    """``fn(params, batch, cfg)`` jitted without XLA's excess precision, so
    that each bf16 value is rounded, as op by op (and in the port)."""
    return jax.jit(fn, static_argnums=2).lower(params, batch, cfg).compile(
        {"xla_allow_excess_precision": False})(params, batch)


def _paths(tree):
    return [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_leaves_close(ref_tree, port_tree, tol, what, rtol=0.0):
    """Every element of every leaf within ``tol`` of its reference leaf's
    rms plus ``rtol`` of itself, in the reference's leaf order (the port's
    tree flattens in the same order)."""
    ref, port = jax.tree.leaves(ref_tree), tree_leaves(port_tree)
    assert len(ref) == len(port)
    for path, r, p in zip(_paths(ref_tree), ref, port):
        r, p = np.asarray(r, F32), _np(p)
        assert r.shape == p.shape, path
        assert np.isfinite(p).all(), path
        rms = float(np.sqrt(np.mean(r.astype(np.float64) ** 2)))
        excess = np.abs(r - p) - rtol * np.abs(r)
        assert excess.max() <= tol * rms, f"{what} {path}: {excess.max()} > {tol} x rms {rms}"


# ======================================================================
# 1. cross-entropy, the loss and its gradient
# ======================================================================
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_cross_entropy_matches_the_reference(dtype):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 7, 300))).astype(F32)
    labels = rng.integers(0, 300, (2, 7))
    ref = rblocks.cross_entropy(jnp.asarray(logits, dtype), jnp.asarray(labels))
    t = _t(logits).to(torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32)
    port = tblocks.cross_entropy(t, _t(labels))
    assert port.dtype == torch.float32
    np.testing.assert_allclose(float(port), float(ref), rtol=LOSS_RTOL)
    # the gold logit is the gathered one
    gold = t.float().gather(-1, _t(labels)[..., None])[..., 0]
    np.testing.assert_allclose(
        float(port), float((torch.logsumexp(t.float(), -1) - gold).mean()), rtol=1e-7)


LOSS_CASES = {
    # name: (arch, config overrides)
    "qwen2": ("qwen2-1.5b", {}),
    # the reference's jax.checkpoint per layer group against the port's
    # torch.utils.checkpoint: the same values
    "qwen2_remat": ("qwen2-1.5b", {"remat": "full"}),
    # bf16 activations over float32 weights (the reference unrolls its
    # layers: its scan refuses a carry that changes type)
    "qwen2_bf16": ("qwen2-1.5b", {"dtype": "bfloat16", "layer_unroll": True}),
    # the first 4 layers of one of the reduced model's 8-layer blocks:
    # attention, Mamba (two chunks of 32 at 64 tokens: the states pass, the
    # combine and the scan) and MoE with its aux loss
    "jamba": ("jamba-v0.1-52b", {}),
    # MLA in a dense-prefix layer and two MoE layers
    "deepseek_v3": ("deepseek-v3-671b", {}),
    # the sLSTM and the first 3 mLSTMs (four 16-token chunks).  The mLSTM
    # divides by max(|q.n|, exp(-m)): where |q.n| is small a float32
    # rounding grows, about 4x a layer here (measured 6.6e-5, 1.7e-4 and
    # 7.3e-4 of a leaf's rms at 2, 3 and 4 layers), and at the reduced
    # model's 16 layers two float32 runs part by 0.3-0.5 of it, each
    # package's against the other's and against a run with float64 weights
    "xlstm": ("xlstm-350m", {}),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_and_grads_match_the_reference(case):
    name, kw = LOSS_CASES[case]
    cfg, tcfg = _cfgs(name, **kw)
    if case in FIRST_LAYERS:
        cfg, tcfg = (dataclasses.replace(c, stacks=((1, c.stacks[0][1][:FIRST_LAYERS[case]]),))
                     for c in (cfg, tcfg))
    params = _random_params(cfg, 13)
    tp = convert.lm_params(params, "cpu")
    batch, tbatch = _batch(cfg.vocab, 2, 64, seed=3)
    ref_loss, ref_grads = _compiled(jax.value_and_grad(rtf.loss_fn), params, batch, cfg)
    logits, aux = _compiled(rtf.forward, params, batch, cfg)
    loss, grads = tsteps.loss_and_grads(tp, tbatch, tcfg)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        float(loss), float(rblocks.cross_entropy(logits, batch["labels"]) + cfg.aux_loss_weight * aux),
        rtol=LOSS_RTOL)
    if case in ("jamba", "deepseek_v3"):
        assert float(aux) > 0
    _assert_leaves_close(ref_grads, grads, GRAD_TOL[case], case)


def test_attention_and_scan_gradients_reach_every_input():
    """``loss.backward()`` through ``ops.flash_attention`` and
    ``ops.mamba_scan`` reaches q, k and v and x, dt, a, b and c (the
    Functions' backward), equal to the reference's ``jax.grad`` of its
    plain attention and chunked scan within 1e-5 of each gradient's rms."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 4, 40, 64)).astype(F32)
    kv = [rng.standard_normal((2, 2, 40, 64)).astype(F32) for _ in range(2)]
    ts = [_t(a).requires_grad_() for a in (q, *kv)]
    out = ops.flash_attention(*ts, causal=True, window=16)
    assert isinstance(out.grad_fn, ops.FlashAttentionFn._backward_cls)
    w = rng.standard_normal(out.shape).astype(F32)
    (out * _t(w)).sum().backward()
    ref = jax.jit(jax.grad(lambda q, k, v: jnp.sum(
        rattn._grouped(q, k, v, causal=True, window=16) * w), argnums=(0, 1, 2)))(q, *kv)
    for r, t in zip(ref, ts):
        rms = float(np.sqrt(np.mean(np.square(r))))
        assert t.grad is not None and float((t.grad - _t(np.asarray(r))).abs().max()) <= 1e-5 * rms

    b, length, d, n, chunk = 2, 80, 16, 8, 32
    x = rng.standard_normal((b, length, d)).astype(F32)
    dt = (0.01 + 0.1 * rng.random((b, length, d))).astype(F32)
    a_log = rng.standard_normal((d, n)).astype(F32)
    bm, cm = (rng.standard_normal((b, length, n)).astype(F32) for _ in range(2))
    leaves = [_t(v).requires_grad_() for v in (x, dt, a_log, bm, cm)]
    tx, tdt, ta_log, tb, tc = leaves
    y, h = ops.mamba_scan(tx, tdt, -torch.exp(ta_log), tb, tc, chunk=chunk)
    assert isinstance(y.grad_fn, ops.MambaScanFn._backward_cls)
    wy = rng.standard_normal(y.shape).astype(F32)
    wh = rng.standard_normal(h.shape).astype(F32)
    ((y * _t(wy)).sum() + (h * _t(wh)).sum()).backward()

    def ref_loss(x, dt, a_log, bm, cm):
        y, h = rmam._chunked_scan(x, dt, -jnp.exp(a_log), bm, cm, chunk)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    ref = jax.jit(jax.grad(ref_loss, argnums=(0, 1, 2, 3, 4)))(x, dt, a_log, bm, cm)
    for r, t in zip(ref, leaves):
        rms = float(np.sqrt(np.mean(np.square(r))))
        assert t.grad is not None and float((t.grad - _t(np.asarray(r))).abs().max()) <= 1e-5 * rms


# ======================================================================
# 2. AdamW, compression, the schedule
# ======================================================================
def _ref_update(cfg):
    return jax.jit(lambda p, g, s, lr_scale: radamw.adamw_update(p, g, s, cfg, lr_scale))


def _opt_case(seed, state_dtype):
    """(reference params, grads, state after one update; the port's copies),
    a few leaves with ragged last axes and one 1-D leaf (no weight decay)."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (3, 300), "b": (130,), "stack": {"a": (2, 5, 129), "z": (4, 128)}}

    def draw(scale):
        return jax.tree.map(lambda s: jnp.asarray((scale * rng.standard_normal(s)).astype(F32)),
                            shapes, is_leaf=lambda x: isinstance(x, tuple))

    params, grads, grads2 = draw(1.0), draw(0.1), draw(0.1)
    cfg = radamw.AdamWConfig(state_dtype=state_dtype, lr=1e-2)
    state = radamw.adamw_init(params, cfg)
    # one update first, so the state holds moments that are not zeros
    params, state = _ref_update(cfg)(params, grads, state, 1.0)
    tcfg = tadamw.AdamWConfig(state_dtype=state_dtype, lr=1e-2)
    port = convert.lm_params({"p": params, "g": grads2, "m": state["m"], "v": state["v"]}, "cpu")
    tstate = {"step": torch.tensor(int(state["step"]), dtype=torch.int32),
              "m": port["m"], "v": port["v"]}
    return (params, grads2, state, cfg), (port["p"], port["g"], tstate, tcfg)


def _ties():
    """Values whose int8 codes are exact ties (k + 1/2 of the block scale,
    the block's absmax 127): round half to even decides them."""
    return np.array([127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 126.5, -126.5] * 25, F32)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_update_matches_the_reference(state_dtype):
    (params, grads, state, cfg), (tp, tg, tstate, tcfg) = _opt_case(5, state_dtype)
    tinit = tadamw.adamw_init(tp, tcfg)
    rinit = radamw.adamw_init(params, cfg)
    for r, t in zip(jax.tree.leaves(rinit), tree_leaves(tinit)):
        np.testing.assert_array_equal(_np(t), np.asarray(r, F32))
    lr_scale = rsched.cosine_schedule(jnp.int32(7))
    new_p, new_s = _ref_update(cfg)(params, grads, state, lr_scale)
    tnew_p, tnew_s = tadamw.adamw_update(tp, tg, tstate, tcfg, tsched.cosine_schedule(7))
    assert int(tnew_s["step"]) == int(new_s["step"]) == 2
    _assert_leaves_close(new_p, tnew_p, 1e-6, "params", rtol=1e-6)
    moments = (new_s["m"], new_s["v"]), (tnew_s["m"], tnew_s["v"])
    if state_dtype == "float32":
        _assert_leaves_close(*moments, 1e-6, "moments", rtol=1e-6)
        return
    if state_dtype == "bfloat16":     # at most one bf16 rounding step apart
        for r, t in zip(jax.tree.leaves(moments[0]), tree_leaves(moments[1])):
            assert t.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(t), np.asarray(r, F32), rtol=2**-7, atol=0)
        return
    # int8: the codec is the reference's bit for bit on the same input
    # (ties round to even); after an update whose float32 arithmetic may
    # differ by an ulp, the scales agree within 2e-6 and a q differs by at
    # most 1, in at most one value in a thousand (where the value it rounds
    # lies within an ulp of a boundary)
    x = np.concatenate([_ties(), np.random.default_rng(9).standard_normal(700)]).astype(F32)
    x = x.reshape(3, 300)
    q, scale = radamw._quantize(jnp.asarray(x), 128)
    tq, tscale = tadamw._quantize(_t(x), 128)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(scale))
    for kind in ("m", "v"):
        for path, r, t in zip(_paths(new_s[kind]), jax.tree.leaves(new_s[kind]),
                              tree_leaves(tnew_s[kind])):
            r = np.asarray(r)
            if "'q'" in path:
                assert t.dtype == torch.int8
                diff = np.abs(r.astype(np.int32) - t.numpy().astype(np.int32))
                assert diff.max() <= 1 and diff.mean() <= 1e-3, f"{kind} {path}"
            else:
                np.testing.assert_allclose(t.numpy(), r, rtol=2e-6, atol=0)


def test_compression_and_schedule_match_the_reference():
    rng = np.random.default_rng(6)
    grads = {"w": (rng.standard_normal((5, 300)) * 0.01).astype(F32),
             "b": rng.standard_normal((7,)).astype(F32), "zero": np.zeros((3, 4), F32)}
    q, scale = rcomp.compress_int8(jnp.asarray(grads["w"]))
    tq, tscale = tcomp.compress_int8(_t(grads["w"]))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(scale))
    np.testing.assert_array_equal(
        tcomp.decompress_int8(tq, tscale, (5, 300)).numpy(),
        np.asarray(rcomp.decompress_int8(q, scale, (5, 300))))
    rerr, terr = None, None
    for _ in range(2):     # the second call carries the first one's residual
        rc, rerr = rcomp.ef_compress_gradients(jax.tree.map(jnp.asarray, grads), rerr)
        tc, terr = tcomp.ef_compress_gradients({k: _t(v) for k, v in grads.items()}, terr)
        for k in grads:
            np.testing.assert_array_equal(tc[k][0].numpy(), np.asarray(rc[k][0]))
            np.testing.assert_array_equal(tc[k][1].numpy(), np.asarray(rc[k][1]))
            np.testing.assert_array_equal(terr[k].numpy(), np.asarray(rerr[k]))
    steps = np.arange(0, 401)
    ref = np.asarray(rsched.cosine_schedule(jnp.asarray(steps), warmup=50, total=300))
    port = tsched.cosine_schedule(torch.as_tensor(steps), warmup=50, total=300).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0)
    assert float(tsched.cosine_schedule(0)) == float(rsched.cosine_schedule(0)) > 0


# ======================================================================
# 3. data and checkpoints
# ======================================================================
def test_token_streams_are_the_references_bit_for_bit(tmp_path):
    cfg = dict(vocab=700, seq_len=24, global_batch=4, seed=3)
    for shard in ((0, 1), (1, 2)):
        ref = rdata.TokenStream(rdata.DataConfig(**cfg), shard_id=shard[0], num_shards=shard[1])
        port = tdata.TokenStream(tdata.DataConfig(**cfg), shard_id=shard[0], num_shards=shard[1])
        for step in (0, 5):
            r, p = ref.batch(step), port.batch(step)
            for k in ("tokens", "labels"):
                assert p[k].dtype == r[k].dtype and np.array_equal(p[k], r[k])
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(np.uint16).tofile(path)
    mm = dict(cfg, path=str(path), token_dtype="uint16")
    ref = rdata.TokenStream(rdata.DataConfig(**mm), shard_id=1, num_shards=2)
    port = tdata.TokenStream(tdata.DataConfig(**mm), shard_id=1, num_shards=2)
    for step in (0, 9):
        assert all(np.array_equal(port.batch(step)[k], ref.batch(step)[k])
                   for k in ("tokens", "labels"))
    # the prefetching iterator from a given step, and its thread stops
    threads = threading.active_count()
    batches = tdata.make_batches(port, start=9)
    assert np.array_equal(next(batches)["tokens"], ref.batch(9)["tokens"])
    assert np.array_equal(next(batches)["tokens"], ref.batch(10)["tokens"])
    batches.close()
    deadline = time.monotonic() + 5.0
    while threading.active_count() > threads and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == threads


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_checkpoints_cross_between_the_packages(tmp_path, state_dtype):
    """A checkpoint the port writes is read by the reference's
    ``load_checkpoint`` into its own tree, and the reverse, bit for bit,
    with the same manifest."""
    (params, _, state, _), (tp, _, tstate, _) = _opt_case(8, state_dtype)
    tree, ttree = (params, state), (tp, tstate)
    tckpt.save_checkpoint(tmp_path / "port", 4, ttree, extra={"data_step": 4})
    rckpt.save_checkpoint(tmp_path / "ref", 4, tree, extra={"data_step": 4})
    got, extra = rckpt.load_checkpoint(tmp_path / "port", 4, tree)
    assert extra == {"data_step": 4}
    for r, g in zip(jax.tree.leaves(tree), jax.tree.leaves(got)):
        assert np.asarray(g).dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    tgot, extra = tckpt.load_checkpoint(tmp_path / "ref", 4, ttree)
    assert extra == {"data_step": 4} and tckpt.latest_step(tmp_path / "ref") == 4
    for r, g in zip(jax.tree.leaves(tree), tree_leaves(tgot)):
        assert g.numpy().dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    mr, mp = (json.loads((tmp_path / d / "step_00000004" / "manifest.json").read_text())
              for d in ("ref", "port"))
    assert mr == mp


# ======================================================================
# 4. train steps, restart and the driver
# ======================================================================
STEP_CASES = {
    # name: (accum, compress_grads, opt state dtype)
    "plain": (1, False, "float32"),
    "accum4": (4, False, "float32"),
    "compress": (1, True, "float32"),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_the_reference(case):
    """Three ``make_train_step`` steps of reduced qwen2-1.5b against the
    reference's step, jitted outside any mesh (``train.main`` itself fails
    in the reference, ROADMAP.md queue 3), on the reference's batches."""
    accum, compress, state_dtype = STEP_CASES[case]
    cfg, tcfg = _cfgs("qwen2-1.5b")
    params = _random_params(cfg, 21)
    tp = convert.lm_params(params, "cpu")
    opt = radamw.AdamWConfig(lr=1e-3, state_dtype=state_dtype)
    topt = tadamw.AdamWConfig(lr=1e-3, state_dtype=state_dtype)
    state, tstate = radamw.adamw_init(params, opt), tadamw.adamw_init(tp, topt)
    if compress:
        state["ef"] = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        tstate["ef"] = {**convert.lm_params(state["ef"], "cpu")}
    step = jax.jit(rsteps.make_train_step(cfg, opt, accum=accum, compress_grads=compress))
    tstep = tsteps.make_train_step(tcfg, topt, accum=accum, compress_grads=compress)
    data = rdata.TokenStream(rdata.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    for i in range(3):
        b = data.batch(i)
        params, state, m = step(params, state, jax.tree.map(jnp.asarray, b))
        tp, tstate, tm = tstep(tp, tstate, {k: _t(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(m["grad_norm"]), rtol=1e-4)
    assert int(tstate["step"]) == 3 and set(tstate) == set(state)
    for r, t in zip(jax.tree.leaves(params), tree_leaves(tp)):
        np.testing.assert_allclose(_np(t), np.asarray(r), rtol=0, atol=1e-5)


def test_restart_is_bit_exact_and_main_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Six straight steps, and three steps, a checkpoint and three resumed
    steps, give the same losses bit for bit; ``main`` prints the
    reference's ``[train]`` lines and without a device needs CUDA.  At 512
    tokens a step the embedding's gradient is large enough that indexing's
    backward would add its rows with atomics on the CPU and the runs would
    part; ``F.embedding``'s backward adds them in a fixed order."""
    argv = ["--smoke", "--steps", "6", "--batch", "4", "--seq-len", "128", "--log-every", "1"]
    straight = ttrain.main(argv, device="cpu")
    assert len(straight) == 6 and all(np.isfinite(straight))
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    first = ttrain.main(argv[:2] + ["3"] + argv[3:] + ckpt + ["--device", "cpu"])
    assert tckpt.latest_step(tmp_path) == 3
    resumed = ttrain.main(argv + ckpt, device="cpu")
    assert first + resumed == straight
    out = capsys.readouterr().out
    assert "[train] resumed from step 3" in out and "[train] step=5 loss=" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(argv)
