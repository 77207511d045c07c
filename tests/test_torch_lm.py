"""The port's LM serving path against the JAX reference, on the CPU.

Inputs come from numpy with a seed and go through both packages.  The
port's parameters are the reference's, converted by ``convert.lm_params``
after every leaf was overwritten with seeded random values (the
reference's init leaves biases at 0 and norm weights at 1, which would
leave them untested).  Attention reaches the reference's Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, get_arch, reduced
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.launch import steps as rsteps
from repro.models import attention as rattn
from repro.models import blocks as rblocks
from repro.models import transformer as rtf
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import transformer as ttf
from repro_torch.models import xlstm as txl

F32 = np.float32


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).copy())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _cfgs(name, **kw):
    """(reference, port) reduced configs of one architecture."""
    ref = dataclasses.replace(reduced(get_arch(name)), **kw)
    port = dataclasses.replace(tconfigs.reduced(tconfigs.get_arch(name)), **kw)
    return ref, port


def _random_params(cfg, seed):
    """The reference's parameter pytree with every leaf redrawn from a
    seeded numpy stream: weights N(0, 1/d_in), norm weights 1 + N(0, 0.1^2),
    biases N(0, 0.1^2).  The layout comes from ``jax.eval_shape`` (the
    reference's init is not run)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        if name.startswith("norm") and not name.endswith("_b") or name == "final_norm":
            x = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif len(leaf.shape) == 1 or name.startswith("b") or name.endswith("_b"):
            x = 0.1 * rng.standard_normal(leaf.shape)
        else:
            x = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
        return jnp.asarray(x.astype(F32))

    return jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(lambda: rtf.init_params(cfg, jax.random.PRNGKey(seed)))
    )


# ======================================================================
# configs
# ======================================================================
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_configs_match_the_reference(name):
    ref, port = get_arch(name), tconfigs.get_arch(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(tconfigs.reduced(port)) == dataclasses.asdict(reduced(ref))
    assert (port.head_dim, port.n_layers) == (ref.head_dim, ref.n_layers)
    assert str(port.activation_dtype).split(".")[-1] == jnp.dtype(ref.activation_dtype).name


# ======================================================================
# 1. blocks, float32
# ======================================================================
def _block_case(name, rng):
    d, f = 96, 160
    x = rng.standard_normal((2, 5, d)).astype(F32)
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(F32)  # noqa: E731
    v = lambda *s: (0.1 * rng.standard_normal(s)).astype(F32)            # noqa: E731
    if name == "rms_norm":
        g = (1 + v(d)).astype(F32)
        return rblocks.rms_norm(g, x), tblocks.rms_norm(_t(g), _t(x))
    if name == "layer_norm":
        g, b = (1 + v(d)).astype(F32), v(d)
        return rblocks.layer_norm(g, b, x), tblocks.layer_norm(_t(g), _t(b), _t(x))
    if name == "gelu_ffn":
        p = {"w_up": w(d, f), "b_up": v(f), "w_down": w(f, d), "b_down": v(d)}
    elif name == "swiglu_ffn":
        p = {"w_gate": w(d, f), "w_up": w(d, f), "w_down": w(f, d)}
    else:
        xr = rng.standard_normal((2, 3, 37, 64)).astype(F32)
        pos = rng.integers(0, 200, (2, 1, 37))
        return (
            rblocks.apply_rope(xr, jnp.asarray(pos), theta=1e6),
            tblocks.apply_rope(_t(xr), _t(pos), theta=1e6),
        )
    fn = name
    tp = {k: _t(a) for k, a in p.items()}
    return getattr(rblocks, fn)(p, x), getattr(tblocks, fn)(tp, _t(x))


@pytest.mark.parametrize("name", ["rms_norm", "layer_norm", "gelu_ffn", "swiglu_ffn", "apply_rope"])
def test_blocks_match_the_reference(name):
    ref, port = _block_case(name, np.random.default_rng(7))
    assert port.dtype == torch.float32
    np.testing.assert_allclose(_np(port), np.asarray(ref), rtol=1e-6, atol=1e-6)


# ======================================================================
# 2. the plain attention against the reference's oracle and Pallas kernel
# ======================================================================
ATTN_CASES = {
    # name: (b, hq, hkv, s, d, causal, window)
    "causal": (1, 2, 2, 128, 64, True, 0),
    "ragged_gqa": (2, 4, 2, 200, 64, True, 0),
    "mqa": (1, 8, 1, 384, 128, True, 0),
    "window64": (1, 4, 2, 256, 64, True, 64),
    "non_causal": (1, 2, 2, 128, 64, False, 0),
}


def _qkv(b, hq, hkv, s, d, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)).astype(F32),
            rng.standard_normal((b, hkv, s, d)).astype(F32),
            rng.standard_normal((b, hkv, s, d)).astype(F32))


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_ref_matches_reference_float32(case):
    b, hq, hkv, s, d, causal, window = ATTN_CASES[case]
    q, k, v = _qkv(b, hq, hkv, s, d)
    port = _np(tref.attention_ref(_t(q), _t(k), _t(v), causal=causal, window=window))
    oracle = rref.attention_ref(q, k, v, causal=causal, window=window)
    kernel = rops.flash_attention(q, k, v, causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(port, np.asarray(oracle), atol=2e-5)
    np.testing.assert_allclose(port, np.asarray(kernel), atol=2e-5)
    # the TPU kernel passes the check the CUDA kernel is held to
    assert tref.attention_excess(_t(np.asarray(kernel)), _t(port)) <= 1.0


def test_attention_ref_matches_reference_bfloat16():
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(1, 4, 2, 256, 64))
    tq, tk, tv = (_t(np.asarray(a, F32)).to(torch.bfloat16) for a in (q, k, v))
    port = tref.attention_ref(tq, tk, tv, causal=True)
    assert port.dtype == torch.bfloat16
    for ref in (rref.attention_ref(q, k, v, causal=True),
                rops.flash_attention(q, k, v, causal=True, interpret=True)):
        np.testing.assert_allclose(_np(port), np.asarray(ref, F32), atol=3e-2)
        assert tref.attention_excess(_t(np.asarray(ref, F32)).to(torch.bfloat16), port) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attention_check_catches_a_dropped_kv_tile(dtype):
    """The check holds each element against its own row's size, so it
    fails a kernel that drops the 64 keys 1024..1087 from every row that
    reaches them, and passes the same attention computed another way."""
    b, h, s, d = 1, 2, 2048, 64
    q, k, v = (_t(a).to(dtype) for a in _qkv(b, h, h, s, d, seed=5))
    plain = tref.attention_ref(q, k, v, causal=True)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / np.sqrt(d)
    idx = torch.arange(s)
    keep = idx[:, None] >= idx[None, :]

    def attend(mask):
        p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(dtype)

    dropped = keep.clone()
    dropped[:, 1024:1088] = False
    assert tref.attention_excess(attend(keep), plain) <= 1.0
    assert tref.attention_excess(attend(dropped), plain) > 1.0
    assert tref.attention_excess(plain, plain) == 0.0
    zero_rows = torch.zeros_like(plain)
    assert tref.attention_excess(zero_rows + 1e-30, zero_rows) == float("inf")


# ======================================================================
# 3. gqa_forward and gqa_decode
# ======================================================================
@pytest.mark.parametrize("name", ["qwen2-1.5b", "starcoder2-3b"])
def test_gqa_forward_and_decode_match_the_reference(name):
    """Decode runs 80 steps into a 64-slot cache: starcoder2's window-64
    ring wraps, qwen2's full cache clamps its writes to the last slot."""
    cfg, tcfg = _cfgs(name)
    params = _random_params(cfg, 11)
    rp = jax.tree.map(lambda t: t[0], params["stack0"]["l0"]["mixer"])
    tp = convert.lm_params(rp, "cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 100, cfg.d_model)).astype(F32)
    np.testing.assert_allclose(
        _np(tattn.gqa_forward(tp, _t(x), tcfg)), np.asarray(rattn.gqa_forward(rp, x, cfg)),
        rtol=1e-5, atol=1e-5)

    max_len, steps = 64, 80
    rc = rattn.gqa_init_cache(cfg, 2, max_len, jnp.float32)
    tc = tattn.gqa_init_cache(tcfg, 2, max_len, torch.float32, "cpu")
    assert tuple(tc["k"].shape) == rc["k"].shape
    dec = jax.jit(lambda p, x, c, n: rattn.gqa_decode(p, x, c, n, cfg))
    xs = rng.standard_normal((steps, 2, 1, cfg.d_model)).astype(F32)
    for i in range(steps):
        ro, rc = dec(rp, xs[i], rc, jnp.int32(i))
        to, tc = tattn.gqa_decode(tp, _t(xs[i]), tc, i, tcfg)
        np.testing.assert_allclose(_np(to), np.asarray(ro), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tc["k"]), np.asarray(rc["k"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tc["v"]), np.asarray(rc["v"]), rtol=1e-5, atol=1e-5)


# ======================================================================
# 4. forward and decode_step
# ======================================================================
LM_CASES = {
    # name: (arch, config overrides, tolerance)
    "qwen2": ("qwen2-1.5b", {}, 1e-4),
    "starcoder2": ("starcoder2-3b", {}, 1e-4),
    "phi3_vision": ("phi-3-vision-4.2b", {}, 1e-4),
    # bf16 activations over float32 weights: the promotion trap.  The
    # reference's scan refuses a carry that changes type, so it runs its
    # stacks unrolled (the same layers, in a Python loop).
    "qwen2_bf16": ("qwen2-1.5b", {"dtype": "bfloat16", "layer_unroll": True}, 2e-2),
    "starcoder2_bf16": ("starcoder2-3b", {"dtype": "bfloat16", "layer_unroll": True}, 2e-2),
    # MLA (a dense-prefix layer and MoE layers) and xLSTM (sLSTM and mLSTM;
    # 40 tokens end a 16-token chunk ragged)
    "deepseek_v3": ("deepseek-v3-671b", {}, 1e-4),
    # float32 rounding, amplified: the mLSTM divides by max(|q.n|, exp(-m)),
    # and where |q.n| is small its 14 layers grow a rounding to 1e-3.  The
    # two packages' logits lie 1.1e-3 apart, each 2.3-2.5e-3 from a run of
    # the port with float64 weights (its recurrences stay float32)
    "xlstm": ("xlstm-350m", {}, 5e-3),
}


@pytest.mark.parametrize("case", list(LM_CASES))
def test_forward_and_decode_step_match_the_reference(case):
    name, kw, tol = LM_CASES[case]
    cfg, tcfg = _cfgs(name, **kw)
    params = _random_params(cfg, 13)
    tp = convert.lm_params(params, "cpu")
    rng = np.random.default_rng(17)
    b, s = 2, 40
    tokens = rng.integers(0, cfg.vocab, (b, s))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    tbatch = {"tokens": _t(tokens)}
    if cfg.frontend:
        fe = rng.standard_normal((b, cfg.frontend_tokens, cfg.d_model)).astype(F32)
        batch["frontend_embeds"], tbatch["frontend_embeds"] = jnp.asarray(fe), _t(fe)
    ref, ref_aux = rtf.forward(params, batch, cfg)
    port, aux = ttf.forward(tp, tbatch, tcfg)
    assert port.dtype == torch.float32 and port.shape == ref.shape
    # 0 exactly without MoE layers; deepseek-v3's MoE layers' aux loss
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)
    np.testing.assert_allclose(_np(port), np.asarray(ref), rtol=tol, atol=tol)

    # teacher-forced decode, text only
    rc = rtf.init_cache(cfg, b, 16, dtype=jnp.float32)
    tc = ttf.init_cache(tcfg, b, 16, dtype=torch.float32, device="cpu")
    dec = jax.jit(lambda p, t, c, n: rtf.decode_step(p, t, c, n, cfg))
    for i in range(10):
        rl, rc = dec(params, batch["tokens"][:, i:i + 1], rc, jnp.int32(i))
        tl, tc = ttf.decode_step(tp, tbatch["tokens"][:, i:i + 1], tc, i, tcfg)
        np.testing.assert_allclose(_np(tl), np.asarray(rl), rtol=tol, atol=tol)


# ======================================================================
# 5. the prefill step and the serve loop
# ======================================================================
def _reference_serve(cfg, params, prompts, gen_tokens, max_len):
    """``repro.launch.serve.main``'s loop, built on ``tf.decode_step``
    outside any mesh (``serve.main`` itself fails under ``use_mesh`` on
    this JAX)."""
    decode = jax.jit(lambda p, t, c, n: rtf.decode_step(p, t, c, n, cfg))
    cache = rtf.init_cache(cfg, prompts.shape[0], max_len, dtype=jnp.float32)
    logits = None
    for i in range(prompts.shape[1]):
        logits, cache = decode(params, jnp.asarray(prompts[:, i:i + 1]), cache, jnp.int32(i))
    out = []
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    for j in range(gen_tokens):
        out.append(np.asarray(tok))
        logits, cache = decode(params, tok, cache, jnp.int32(prompts.shape[1] + j))
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    return np.concatenate(out, axis=1)


#: prefill logits against the reference's, and against the port's own
#: teacher-forced decode (xlstm-350m: LM_CASES' float32 amplification)
SERVE_CASES = {"qwen2-1.5b": 1e-4, "deepseek-v3-671b": 1e-4, "xlstm-350m": 5e-3}


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_prefill_step_and_serve_loop_match_the_reference(name):
    cfg, tcfg = _cfgs(name)
    tol = SERVE_CASES[name]
    params = _random_params(cfg, 19)
    tp = convert.lm_params(params, "cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 8))

    ref_logits = rsteps.make_prefill_step(cfg)(params, {"tokens": jnp.asarray(prompts)})
    port_logits = tsteps.make_prefill_step(tcfg)(tp, {"tokens": _t(prompts)})
    np.testing.assert_allclose(_np(port_logits), np.asarray(ref_logits), rtol=tol, atol=tol)

    res = tserve.serve(tcfg, tp, prompts, 8, 32, device="cpu", keep_prompt_logits=True)
    np.testing.assert_array_equal(res.tokens, _reference_serve(cfg, params, prompts, 8, 32))
    # the serve loop's teacher-forced logits are the prefill step's
    np.testing.assert_allclose(_np(res.prompt_logits), _np(port_logits), rtol=tol, atol=tol)
    assert res.tokens.shape == (2, 8) and res.tokens_per_s > 0


def test_serve_main_runs_on_the_cpu_and_defaults_to_cuda(monkeypatch, capsys):
    argv = ["--smoke", "--requests", "2", "--prompt-len", "4", "--gen-tokens", "3",
            "--max-len", "16"]
    res = tserve.main(argv + ["--device", "cpu"])
    assert res.tokens.shape == (2, 3) and "[serve]" in capsys.readouterr().out
    assert ((res.tokens >= 0) & (res.tokens < 512)).all()
    np.testing.assert_array_equal(tserve.main(argv, device="cpu").tokens, res.tokens)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(argv)


@pytest.mark.parametrize("entry", ["lm_params", "init_cache", "gqa_init_cache", "rope_frequencies",
                                   "mla_init_cache", "mlstm_init_state", "slstm_init_state"])
def test_lm_allocators_default_to_cuda(monkeypatch, entry):
    """Without a device they allocate on the card, so they raise without one."""
    tcfg = tconfigs.reduced(tconfigs.get_arch("qwen2-1.5b"))
    xcfg = tconfigs.reduced(tconfigs.get_arch("xlstm-350m"))
    calls = {
        "lm_params": lambda: convert.lm_params({"w": np.zeros((2, 2), np.float32)}),
        "init_cache": lambda: ttf.init_cache(tcfg, 1, 8),
        "gqa_init_cache": lambda: tattn.gqa_init_cache(tcfg, 1, 8),
        "rope_frequencies": lambda: tblocks.rope_frequencies(tcfg.head_dim),
        "mla_init_cache": lambda: tattn.mla_init_cache(
            tconfigs.reduced(tconfigs.get_arch("deepseek-v3-671b")), 1, 8),
        "mlstm_init_state": lambda: txl.mlstm_init_state(xcfg, 1),
        "slstm_init_state": lambda: txl.slstm_init_state(xcfg, 1),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


# ======================================================================
# 6. parameter layout and layer kinds
# ======================================================================
def test_unknown_layer_kinds_raise_value_error():
    """As the reference's: an unknown mixer or FFN raises ``ValueError``."""
    _, tcfg = _cfgs("qwen2-1.5b")
    gen = torch.Generator().manual_seed(0)
    for spec in (tconfigs.LayerSpec("rwkv", "swiglu"), tconfigs.LayerSpec("gqa", "glu")):
        bad = dataclasses.replace(tcfg, stacks=((1, (spec,)),))
        with pytest.raises(ValueError, match=spec.mixer if spec.mixer == "rwkv" else spec.ffn):
            ttf.init_params(bad, gen)
    bad = dataclasses.replace(tcfg, stacks=((1, (tconfigs.LayerSpec("rwkv", "swiglu"),)),))
    with pytest.raises(ValueError, match="rwkv"):
        ttf.init_cache(bad, 1, 8, device="cpu")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_port_init_params_has_the_reference_layout(name):
    cfg, tcfg = _cfgs(name)
    ref = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: rtf.init_params(cfg, jax.random.PRNGKey(0))))[0]
    port = ttf.init_params(tcfg, torch.Generator().manual_seed(0))
    flat = {}

    def walk(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[prefix + (k,)] = v

    walk(port)
    assert {tuple(p.key for p in path): leaf.shape for path, leaf in ref} == {
        k: tuple(v.shape) for k, v in flat.items()}
    assert all(v.dtype == torch.float32 for v in flat.values())
    assert bool((flat[("stack0", "l0", "norm1")] == 1).all())
    assert float(flat[("embed",)].abs().max()) <= 2 * 0.02
