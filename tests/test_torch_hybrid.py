"""The port's hybrid serving path (jamba) against the JAX reference, on the
CPU: the chunked scan (K7's plain version) and ``ops.mamba_scan``, the
Mamba block, the MoE layer, reduced jamba ``forward`` and the greedy serve
loop.

Inputs come from numpy with a seed and go through both packages; the
parameters are the reference's, redrawn from a seeded numpy stream
(``test_torch_lm._random_params``) and converted by ``convert.lm_params``.
The reference's scan kernel runs in interpret mode.  Tolerances, float32:

* the scans: 1e-5 absolute on outputs of size up to about 7 (float32
  association over a few hundred steps; the reference's own tests use
  3e-3), and ``ref.scan_excess`` <= 1 against the other implementation;
* the Mamba and MoE blocks: 1e-5 (different matmul and exp roundings);
* whole-model logits: 1e-4, as for the dense models (test_torch_lm.py);
* the port's prefill (two-phase chunked scan) against its own decode
  recurrence: 1e-5, float32 association only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.mamba_scan import mamba_chunk_scan as r_chunk_scan
from repro.launch import steps as rsteps
from repro.models import mamba as rmam
from repro.models import moe as rmoe
from repro.models import transformer as rtf

from repro_torch import convert
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import mamba as tmam
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf

from test_torch_lm import _cfgs, _np, _random_params, _reference_serve, _t

F32 = np.float32
SCAN_ATOL = 1e-5
BLOCK_TOL = 1e-5
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def jamba():
    """(reference cfg, port cfg, reference params, port params) of reduced jamba."""
    cfg, tcfg = _cfgs("jamba-v0.1-52b")
    params = _random_params(cfg, 13)
    return cfg, tcfg, params, convert.lm_params(params, "cpu")


def _layer(jamba_, li, part):
    cfg, tcfg, params, _ = jamba_
    rp = jax.tree.map(lambda t: t[0], params["stack0"][f"l{li}"][part])
    return cfg, tcfg, rp, convert.lm_params(rp, "cpu")


# ======================================================================
# the chunked scan
# ======================================================================
SCAN_CASES = [(1, 128, 128, 8, 64), (2, 256, 256, 16, 128), (1, 200, 128, 16, 64)]


def _scan_inputs(B, L, D, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, L, D)).astype(F32),
            (0.01 + 0.1 * rng.random((B, L, D))).astype(F32),
            (-np.exp(rng.normal(size=(D, N)))).astype(F32),
            rng.normal(size=(B, L, N)).astype(F32),
            rng.normal(size=(B, L, N)).astype(F32))


@pytest.mark.parametrize("B,L,D,N,chunk", SCAN_CASES)
def test_mamba_scan_matches_the_reference(B, L, D, N, chunk):
    inputs = _scan_inputs(B, L, D, N, L + D)
    y, h = tops.mamba_scan(*map(_t, inputs), chunk=chunk)
    assert y.shape == (B, L, D) and h.shape == (B, D, N) and h.dtype == torch.float32
    seq_y, seq_h = tref.mamba_scan_ref(*map(_t, inputs))
    for ry, rh in (rops.mamba_scan(*inputs, chunk=chunk),
                   rref.mamba_scan_ref(*map(jnp.asarray, inputs))):
        np.testing.assert_allclose(_np(y), np.asarray(ry), atol=SCAN_ATOL)
        np.testing.assert_allclose(_np(h), np.asarray(rh), atol=SCAN_ATOL)
        assert tref.scan_excess(y, _t(np.asarray(ry)), chunk) <= 1.0
    # the port's sequential oracle is the reference's
    ry, rh = rref.mamba_scan_ref(*map(jnp.asarray, inputs))
    np.testing.assert_allclose(_np(seq_y), np.asarray(ry), atol=SCAN_ATOL)
    np.testing.assert_allclose(_np(seq_h), np.asarray(rh), atol=SCAN_ATOL)


@pytest.mark.parametrize("B,L,D,N,chunk", SCAN_CASES)
def test_mamba_chunk_scan_matches_the_reference_kernel(B, L, D, N, chunk):
    """The plain chunk scan from random per-chunk states against the Pallas
    kernel (interpret mode, which needs whole chunks) or, for a ragged L,
    against the port's own scan of the zero-padded sequence."""
    inputs = _scan_inputs(B, L, D, N, 7 * L + N)
    nc = -(-L // chunk)
    h0 = np.random.default_rng(3).normal(size=(B, nc, D, N)).astype(F32)
    y, h = tops.mamba_chunk_scan(*map(_t, inputs), _t(h0), chunk=chunk)
    assert y.shape == (B, L, D) and h.shape == (B, nc, D, N)
    if L % chunk == 0:
        ry, rh = r_chunk_scan(*map(jnp.asarray, (*inputs, h0)), chunk=chunk, bd=min(128, D),
                              interpret=True)
        ry, rh = np.asarray(ry), np.asarray(rh)
    else:
        pad = nc * chunk - L
        padded = [np.pad(t, ((0, 0), (0, pad), (0, 0))) if t.ndim == 3 else t for t in inputs]
        py, ph = tref.mamba_chunk_scan_ref(*map(_t, padded), _t(h0), chunk=chunk)
        ry, rh = _np(py)[:, :L], _np(ph)
    np.testing.assert_allclose(_np(y), ry, atol=SCAN_ATOL)
    np.testing.assert_allclose(_np(h), rh, atol=SCAN_ATOL)
    assert tref.scan_excess(y, _t(ry), chunk) <= 1.0


def test_mamba_combine_matches_the_references_lax_scan():
    """The combine's plain version against the reference ``ops.mamba_scan``'s
    own combine (its ``jnp`` dt sum, ``exp`` and ``lax.scan``, restated here
    on the same inputs), and the port's states pass and combine against the
    sequential scan's state at each chunk boundary.  Float32; dt sums of
    a chunk may associate otherwise in XLA, so 1e-6 of the states' size."""
    B, L, D, N, chunk = 2, 200, 64, 16, 32
    x, dt, a, b, c = _scan_inputs(B, L, D, N, 17)
    nc = -(-L // chunk)
    s_local = np.random.default_rng(5).normal(size=(B, nc, D, N)).astype(F32)
    port = tref.mamba_combine_ref(_t(dt), _t(a), _t(s_local), chunk=chunk)
    # the reference's combine (src/repro/kernels/ops.py mamba_scan), whose dt
    # is zero-padded to whole chunks
    dtp = jnp.pad(jnp.asarray(dt), ((0, 0), (0, nc * chunk - L), (0, 0)))
    decay = jnp.exp(dtp.reshape(B, nc, chunk, D).sum(axis=2)[..., None] * jnp.asarray(a)[None, None])

    def comb(h, inp):
        dec, s = inp
        return dec * h + s, h

    _, h_inits = jax.lax.scan(comb, jnp.zeros((B, D, N), jnp.float32),
                              (jnp.moveaxis(decay, 1, 0), jnp.moveaxis(jnp.asarray(s_local), 1, 0)))
    expect = np.moveaxis(np.asarray(h_inits), 0, 1)
    np.testing.assert_allclose(_np(port), expect, rtol=1e-6, atol=1e-6 * np.abs(expect).max())
    states = tops.mamba_chunk_states(*map(_t, (x, dt, a, b)), chunk=chunk)
    h_init = tops.mamba_chunk_combine(_t(dt), _t(a), states, chunk=chunk)
    for ci in range(1, nc):
        _, h_seq = rref.mamba_scan_ref(*(jnp.asarray(t[:, :ci * chunk]) for t in (x, dt)),
                                       jnp.asarray(a), *(jnp.asarray(t[:, :ci * chunk])
                                                         for t in (b, c)))
        assert tref.state_excess(h_init[:, ci], _t(np.asarray(h_seq))) <= 1.0


def test_scan_excess_catches_a_wrong_chunk_state():
    """The limit passes another float32 order and fails a scan whose second
    chunk starts from a zero state, and a bf16 rounding of the output."""
    inputs = [_t(a) for a in _scan_inputs(1, 256, 64, 16, 1)]
    y, _ = tops.mamba_scan(*inputs, chunk=64)
    seq, _ = tref.mamba_scan_ref(*inputs)
    assert tref.scan_excess(y, seq, 64) <= 1.0 and tref.scan_excess(seq, seq, 64) == 0.0
    nc = 4
    wrong, _ = tops.mamba_chunk_scan(*inputs, torch.zeros((1, nc, 64, 16)), chunk=64)
    assert tref.scan_excess(wrong, seq, 64) > 1.0
    assert tref.scan_excess(seq.bfloat16().float(), seq, 64) > 1.0
    assert tref.scan_excess(seq.bfloat16(), seq.bfloat16(), 64) == 0.0


def test_mamba_scan_is_causal():
    """Perturbing the future never changes the past (the reference's test)."""
    x, dt, a, b, c = (_t(t) for t in _scan_inputs(1, 128, 128, 8, 2))
    y1, _ = tops.mamba_scan(x, dt, a, b, c, chunk=64)
    x2 = x.clone()
    x2[:, 100:] += 10.0
    y2, _ = tops.mamba_scan(x2, dt, a, b, c, chunk=64)
    assert torch.equal(y1[:, :100], y2[:, :100]) and not torch.equal(y1[:, 100:], y2[:, 100:])


# ======================================================================
# the Mamba block
# ======================================================================
def test_mamba_forward_and_decode_match_the_reference(jamba):
    cfg, tcfg, rp, tp = _layer(jamba, 0, "mixer")
    rng = np.random.default_rng(5)
    steps = 70                   # three chunks of 32, the last one ragged
    x = rng.standard_normal((2, steps, cfg.d_model)).astype(F32)
    fwd = tmam.mamba_forward(tp, _t(x), tcfg)
    np.testing.assert_allclose(_np(fwd), np.asarray(rmam.mamba_forward(rp, x, cfg)),
                               atol=BLOCK_TOL)
    r_state = rmam.mamba_init_state(cfg, 2)
    t_state = tmam.mamba_init_state(tcfg, 2, device="cpu")
    assert {k: tuple(v.shape) for k, v in t_state.items()} == {
        k: v.shape for k, v in r_state.items()}
    dec = jax.jit(lambda p, x, s: rmam.mamba_decode(p, x, s, cfg))
    outs = []
    for i in range(steps):
        r_out, r_state = dec(rp, x[:, i:i + 1], r_state)
        t_out, t_state = tmam.mamba_decode(tp, _t(x[:, i:i + 1]), t_state, tcfg)
        np.testing.assert_allclose(_np(t_out), np.asarray(r_out), atol=BLOCK_TOL)
        outs.append(t_out)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(_np(t_state[k]), np.asarray(r_state[k]), atol=BLOCK_TOL)
    # the prefill scan against the port's own recurrence (chip_smoke's check)
    np.testing.assert_allclose(_np(torch.cat(outs, dim=1)), _np(fwd), atol=BLOCK_TOL)


# ======================================================================
# the MoE layer
# ======================================================================
MOE_CASES = {
    # name: (arch, dispatch, capacity)
    "gather": ("jamba-v0.1-52b", "gather", 8.0),
    "onehot": ("jamba-v0.1-52b", "onehot", 8.0),
    "gather_drops": ("jamba-v0.1-52b", "gather", 0.5),
    "onehot_drops": ("jamba-v0.1-52b", "onehot", 0.5),
    "shard_map_without_mesh": ("jamba-v0.1-52b", "shard_map", 1.25),
    "shared_experts": ("deepseek-moe-16b", "shard_map", 1.25),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_forward_matches_the_reference(case, jamba):
    arch, dispatch, capacity = MOE_CASES[case]
    cfg, tcfg = _cfgs(arch, moe_dispatch=dispatch, moe_capacity=capacity)
    if arch == "jamba-v0.1-52b":
        params, li = jamba[2], 1
    else:
        params, li = _random_params(cfg, 23), 0
    stack = "stack0" if arch == "jamba-v0.1-52b" else "stack1"
    rp = jax.tree.map(lambda t: t[0], params[stack][f"l{li}"]["ffn"])
    tp = convert.lm_params(rp, "cpu")
    x = np.random.default_rng(9).standard_normal((2, 40, cfg.d_model)).astype(F32)
    ry, raux = rmoe.moe_forward(rp, x, cfg)
    ty, taux = tmoe.moe_forward(tp, _t(x), tcfg)
    assert ty.shape == ry.shape and taux.dtype == torch.float32 and taux.dim() == 0
    np.testing.assert_allclose(_np(ty), np.asarray(ry), atol=BLOCK_TOL)
    np.testing.assert_allclose(float(taux), float(raux), rtol=1e-6)
    if capacity < 1.0:   # capacity drops happened, and were the reference's
        full, _ = tmoe.moe_forward(tp, _t(x), dataclasses.replace(tcfg, moe_capacity=8.0))
        assert not torch.allclose(full, ty, atol=1e-3)


def test_moe_routing_breaks_ties_by_the_lower_expert():
    """Equal probabilities keep the lower expert first, as jax.lax.top_k."""
    cfg, tcfg = _cfgs("jamba-v0.1-52b")
    p = {"router": np.zeros((cfg.d_model, cfg.moe_experts), F32)}
    x = np.ones((3, cfg.d_model), F32)
    _, r_idx, _ = rmoe._routing(p, x, cfg)
    _, t_idx, _ = tmoe._routing({"router": _t(p["router"])}, _t(x), tcfg)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(r_idx))
    assert t_idx[0].tolist() == [0, 1]


def test_moe_with_a_mesh_matches_the_unsharded_path():
    """moe_forward under a (1, 1) LM mesh of one gloo rank, on DTensors:
    the expert-parallel dispatch (shard_map, then inference_ep) against the
    unsharded gather path, and the explicit ``mesh=`` against the ambient one."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import sharding as tsh

    cfg, tcfg = _cfgs("jamba-v0.1-52b")
    params = _random_params(cfg, 29)
    tp = convert.lm_params(jax.tree.map(lambda t: t[0], params["stack0"]["l1"]["ffn"]), "cpu")
    x = _t(np.random.default_rng(9).standard_normal((2, 40, cfg.d_model)).astype(F32))
    want_y, want_aux = tmoe.moe_forward(tp, x, tcfg)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = tmesh.make_local_mesh("cpu")
        for inference in (False, True):
            cfg_m = dataclasses.replace(tcfg, inference_ep=inference)
            dp = tsh.distribute(tp, tsh.params_shardings(tp, mesh, inference=inference))
            dx = tsh.distribute(x, tsh.NamedSharding(mesh, ("data", None, None)))
            with tsh.use_mesh(mesh):
                y, aux = tmoe.moe_forward(dp, dx, cfg_m)
            y2, aux2 = tmoe.moe_forward(dp, dx, cfg_m, mesh=mesh)
            for got, got_aux in ((y, aux), (y2, aux2)):
                np.testing.assert_allclose(_np(tsh.full(got)), _np(want_y), atol=BLOCK_TOL)
                assert float(tsh.full(got_aux)) == pytest.approx(float(want_aux), rel=1e-6)
    finally:
        dist.destroy_process_group()


# ======================================================================
# reduced jamba: forward, decode, prefill step and the serve loop
# ======================================================================
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "deepseek-moe-16b"])
def test_forward_matches_the_reference_with_aux(arch, jamba):
    if arch == "jamba-v0.1-52b":
        cfg, tcfg, params, tp = jamba
    else:
        cfg, tcfg = _cfgs(arch)
        params = _random_params(cfg, 29)
        tp = convert.lm_params(params, "cpu")
    tokens = np.random.default_rng(17).integers(0, cfg.vocab, (2, 40))
    ref, raux = rtf.forward(params, {"tokens": jnp.asarray(tokens, jnp.int32)}, cfg)
    port, aux = ttf.forward(tp, {"tokens": _t(tokens).long()}, tcfg)
    assert port.dtype == torch.float32 and port.shape == ref.shape
    np.testing.assert_allclose(_np(port), np.asarray(ref), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


def test_jamba_cache_decode_prefill_and_serve_match_the_reference(jamba):
    cfg, tcfg, params, tp = jamba
    # the cache: K/V for the GQA layer, float32 recurrent state for Mamba
    rc = rtf.init_cache(cfg, 2, 16, dtype=jnp.float32)
    tc = ttf.init_cache(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    shapes = {li: {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in c.items()}
              for li, c in tc["stack0"].items()}
    assert shapes == {li: {k: (v.shape, v.dtype.name) for k, v in c.items()}
                      for li, c in rc["stack0"].items()}
    assert set(shapes["l3"]) == {"k", "v"} and set(shapes["l0"]) == {"ssm", "conv"}

    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 8))
    ref_logits = rsteps.make_prefill_step(cfg)(params, {"tokens": jnp.asarray(prompts)})
    port_logits = tsteps.make_prefill_step(tcfg)(tp, {"tokens": _t(prompts).long()})
    np.testing.assert_allclose(_np(port_logits), np.asarray(ref_logits),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    res = tserve.serve(tcfg, tp, prompts, 8, 32, device="cpu", keep_prompt_logits=True)
    np.testing.assert_array_equal(res.tokens, _reference_serve(cfg, params, prompts, 8, 32))
    # teacher-forced decode logits are the prefill step's (capacity 8.0 drops nothing)
    np.testing.assert_allclose(_np(res.prompt_logits), _np(port_logits),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_hybrid_init_params_have_the_reference_layout():
    for arch in ("jamba-v0.1-52b", "deepseek-moe-16b"):
        cfg, tcfg = _cfgs(arch)
        ref = jax.tree_util.tree_flatten_with_path(
            jax.eval_shape(lambda k: rtf.init_params(cfg, k), jax.random.PRNGKey(0)))[0]
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
        if arch == "jamba-v0.1-52b":
            a_log = flat[("stack0", "l0", "mixer", "a_log")]
            assert torch.equal(a_log[0, 0], torch.log(torch.arange(1.0, cfg.mamba_d_state + 1)))
            assert bool((flat[("stack0", "l0", "mixer", "d_skip")] == 1).all())
