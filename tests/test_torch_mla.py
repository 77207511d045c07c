"""The port's MLA (DeepSeek-V3's multi-head latent attention) and its dense
masked attention ``_sdpa`` against the JAX reference, on the CPU.

Parameters are the reference's, redrawn from a seeded numpy stream
(``test_torch_lm._random_params``) and converted by ``convert.lm_params``;
inputs come from numpy with a seed.  The reference's MLA reaches no Pallas
kernel: its prefill calls the masked dense ``_sdpa`` on every backend, and
its decode is plain einsums.  Tolerances: float32 1e-5; a bf16 input over
float32 weights 2e-2; the port's decompressed prefill against its absorbed
decode the reference's own 2e-2 (``tests/test_models_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as rattn
from repro_torch import convert
from repro_torch.models import attention as tattn

from test_torch_lm import _cfgs, _np, _random_params, _t

F32 = np.float32
ARCH = "deepseek-v3-671b"

SDPA_CASES = {
    # name: (b, h, sq, skv, d, dv, causal, window, q_offset, kv_len)
    "causal": (2, 3, 40, 40, 24, 24, True, 0, 0, None),
    "dv_ne_dqk": (1, 4, 33, 33, 48, 32, True, 0, 0, None),
    # Sq > 2048: two query blocks, the second from q_offset 2048
    "chunked": (1, 1, 2100, 2100, 8, 4, True, 0, 0, None),
    "window_kv_len": (2, 2, 30, 50, 16, 8, True, 7, 20, 45),
    # rows before the first key see none: they must give 0, not NaN
    "masked_rows": (1, 2, 12, 12, 16, 16, True, 0, -4, None),
    "non_causal": (1, 2, 20, 28, 16, 12, False, 0, 0, None),
}


@pytest.mark.parametrize("case", list(SDPA_CASES))
def test_sdpa_matches_the_reference(case):
    b, h, sq, skv, d, dv, causal, window, q_offset, kv_len = SDPA_CASES[case]
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, h, sq, d)).astype(F32)
    k = rng.standard_normal((b, h, skv, d)).astype(F32)
    v = rng.standard_normal((b, h, skv, dv)).astype(F32)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    ref = np.asarray(rattn._sdpa(q, k, v, **kw))
    port = tattn._sdpa(_t(q), _t(k), _t(v), **kw)
    assert port.dtype == torch.float32 and tuple(port.shape) == ref.shape == (b, h, sq, dv)
    assert np.isfinite(_np(port)).all()
    np.testing.assert_allclose(_np(port), ref, rtol=1e-5, atol=1e-5)
    if case == "masked_rows":
        assert not _np(port)[:, :, :4].any()


def test_sdpa_keeps_a_bf16_query_type():
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((1, 2, 24, 16)).astype(F32) for _ in range(3))
    ref = rattn._sdpa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True, window=0)
    port = tattn._sdpa(*(_t(a).to(torch.bfloat16) for a in (q, k, v)), causal=True, window=0)
    assert port.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(port), np.asarray(ref, F32), atol=2e-2)


def test_init_mla_has_the_reference_layout():
    cfg, tcfg = _cfgs(ARCH)
    ref = jax.eval_shape(lambda: rattn.init_mla(jax.random.PRNGKey(0), cfg, stack=(2,)))
    port = tattn.init_mla(torch.Generator().manual_seed(0), tcfg, stack=(2,))
    assert {k: v.shape for k, v in ref.items()} == {k: tuple(v.shape) for k, v in port.items()}
    assert all(v.dtype == torch.float32 for v in port.values())


def _mixer(seed=11):
    """Layer 0's MLA parameters of reduced deepseek-v3, both packages'."""
    cfg, tcfg = _cfgs(ARCH)
    rp = jax.tree.map(lambda t: t[0], _random_params(cfg, seed)["stack0"]["l0"]["mixer"])
    return cfg, tcfg, rp, convert.lm_params(rp, "cpu")


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16_input"])
def test_mla_forward_matches_the_reference(dtype):
    cfg, tcfg, rp, tp = _mixer()
    x = np.random.default_rng(5).standard_normal((2, 37, cfg.d_model)).astype(F32)
    xr = jnp.asarray(x, dtype)
    xt = _t(x).to(torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32)
    ref = np.asarray(rattn.mla_forward(rp, xr, cfg), F32)
    port = tattn.mla_forward(tp, xt, tcfg)
    assert port.dtype == torch.float32        # promoted by the float32 weights
    tol = 1e-5 if dtype is np.float32 else 2e-2
    np.testing.assert_allclose(_np(port), ref, rtol=tol, atol=tol)


def test_mla_decode_matches_the_reference_and_clamps_its_write():
    """12 steps into an 8-slot cache: steps 8-11 write the last slot, as
    the reference's ``dynamic_update_slice`` clamps, and attend to all 8."""
    cfg, tcfg, rp, tp = _mixer()
    b, max_len, steps = 2, 8, 12
    xs = np.random.default_rng(6).standard_normal((steps, b, 1, cfg.d_model)).astype(F32)
    rc = rattn.mla_init_cache(cfg, b, max_len, jnp.float32)
    tc = tattn.mla_init_cache(tcfg, b, max_len, torch.float32, "cpu")
    assert {k: v.shape for k, v in rc.items()} == {k: tuple(v.shape) for k, v in tc.items()}
    dec = jax.jit(lambda p, x, c, n: rattn.mla_decode(p, x, c, n, cfg))
    buffers = dict(tc)
    for i in range(steps):
        ro, rc = dec(rp, xs[i], rc, jnp.int32(i))
        to, tc = tattn.mla_decode(tp, _t(xs[i]), tc, i, tcfg)
        np.testing.assert_allclose(_np(to), np.asarray(ro), rtol=1e-5, atol=1e-5)
        for name in ("c_kv", "k_rope"):
            assert tc[name] is buffers[name]              # written in place
            np.testing.assert_allclose(_np(tc[name]), np.asarray(rc[name]), rtol=1e-5, atol=1e-5)


def test_mla_forward_matches_its_own_decode():
    """The decompressed prefill against the absorbed decode, token by token
    with a float32 cache, within the reference's decode-vs-forward 2e-2."""
    cfg, tcfg, rp, tp = _mixer(13)
    b, s = 2, 20
    x = _t(np.random.default_rng(7).standard_normal((b, s, cfg.d_model)).astype(F32))
    full = tattn.mla_forward(tp, x, tcfg)
    cache = tattn.mla_init_cache(tcfg, b, s, torch.float32, "cpu")
    steps = torch.cat([tattn.mla_decode(tp, x[:, i:i + 1], cache, i, tcfg)[0] for i in range(s)],
                      dim=1)
    np.testing.assert_allclose(_np(steps), _np(full), rtol=2e-2, atol=2e-2)
