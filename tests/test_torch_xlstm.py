"""The port's xLSTM blocks (mLSTM and sLSTM) against the JAX reference, on
the CPU.

Parameters are the reference's, redrawn from a seeded numpy stream
(``test_torch_lm._random_params``) and converted by ``convert.lm_params``;
inputs come from numpy with a seed.  The reference's xLSTM reaches no
Pallas kernel.  Tolerances: float32 1e-5 (the chunk state's three-operand
product contracts in another order in torch); a bf16 input over float32
weights 2e-2 (sLSTM rounds ``h`` to bf16 every step, and a rounding may
fall the other way); the sLSTM's decode over bf16 weights bit for bit
against the reference compiled without excess precision; the port's
chunkwise mLSTM against its own sequential form the reference's
contract, atol 2e-4 and rtol 1e-3 (``tests/test_models_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as rxl
from repro_torch import convert
from repro_torch.models import xlstm as txl

from test_torch_lm import _cfgs, _np, _random_params, _t

F32 = np.float32
ARCH = "xlstm-350m"
#: reduced xlstm-350m's chunk is 16: 96 tokens are 6 chunks, 83 end ragged
LENGTHS = {"whole_chunks": 96, "ragged": 83}
DTYPES = {"f32": (np.float32, torch.float32), "bf16_input": (jnp.bfloat16, torch.bfloat16)}


def test_b_if_equals_the_references_bit_for_bit():
    """[0, 3] tiled over 2h entries: each gate gets 0, 3, 0, 3 by head."""
    cfg, tcfg = _cfgs(ARCH)
    for stack in ((), (3,)):
        ref = np.asarray(rxl.init_mlstm(jax.random.PRNGKey(0), cfg, stack=stack)["b_if"])
        port = txl.init_mlstm(torch.Generator().manual_seed(0), tcfg, stack=stack)["b_if"]
        assert port.dtype == torch.float32 and tuple(port.shape) == ref.shape
        np.testing.assert_array_equal(port.numpy(), ref)
    assert port[0, :4].tolist() == [0.0, 3.0, 0.0, 3.0]


def test_init_has_the_reference_layout():
    cfg, tcfg = _cfgs(ARCH)
    gen = torch.Generator().manual_seed(0)
    for rinit, tinit in ((rxl.init_mlstm, txl.init_mlstm), (rxl.init_slstm, txl.init_slstm)):
        ref = jax.eval_shape(lambda: rinit(jax.random.PRNGKey(0), cfg, stack=(2,)))
        port = tinit(gen, tcfg, stack=(2,))
        assert {k: v.shape for k, v in ref.items()} == {k: tuple(v.shape) for k, v in port.items()}


def _gates(length, seed=0, b=2, h=2, dh=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, length, dh)).astype(F32) for _ in range(3))
    i_g = rng.standard_normal((b, h, length)).astype(F32)
    f_g = (2.0 + rng.standard_normal((b, h, length))).astype(F32)
    return q, k, v, i_g, f_g


@pytest.mark.parametrize("case", list(LENGTHS))
def test_mlstm_scan_and_chunkwise_match_the_reference(case):
    args = _gates(LENGTHS[case])
    targs = [_t(a) for a in args]
    np.testing.assert_allclose(_np(txl._mlstm_scan(*targs)), np.asarray(rxl._mlstm_scan(*args)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(txl._mlstm_chunkwise(*targs, chunk=16)),
                               np.asarray(rxl._mlstm_chunkwise(*args, chunk=16)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", list(LENGTHS))
def test_mlstm_chunkwise_matches_its_sequential_form(case):
    targs = [_t(a) for a in _gates(LENGTHS[case], seed=1)]
    np.testing.assert_allclose(_np(txl._mlstm_chunkwise(*targs, chunk=32)),
                               _np(txl._mlstm_scan(*targs)), atol=2e-4, rtol=1e-3)


def _layer(li, seed=11):
    """Layer ``li``'s mixer parameters of reduced xlstm-350m (layer 0 an
    sLSTM, 1-7 mLSTMs), both packages'."""
    cfg, tcfg = _cfgs(ARCH)
    params = _random_params(cfg, seed)["stack0"][f"l{li}"]["mixer"]
    rp = jax.tree.map(lambda t: t[0], params)
    return cfg, tcfg, rp, convert.lm_params(rp, "cpu")


KINDS = {"mlstm": (1, rxl.mlstm_forward, txl.mlstm_forward, rxl.mlstm_decode, txl.mlstm_decode,
                   rxl.mlstm_init_state, txl.mlstm_init_state),
         "slstm": (0, rxl.slstm_forward, txl.slstm_forward, rxl.slstm_decode, txl.slstm_decode,
                   rxl.slstm_init_state, txl.slstm_init_state)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", list(KINDS))
def test_forward_matches_the_reference(kind, dtype):
    li, rfwd, tfwd, *_ = KINDS[kind]
    cfg, tcfg, rp, tp = _layer(li)
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(5).standard_normal((2, 37, cfg.d_model)).astype(F32)
    ref = np.asarray(rfwd(rp, jnp.asarray(x, jdt), cfg), F32)
    port = tfwd(tp, _t(x).to(tdt), tcfg)
    assert port.dtype == torch.float32        # promoted by the float32 weights
    tol = 1e-5 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(_np(port), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", list(KINDS))
def test_decode_steps_in_place_match_the_reference(kind, dtype):
    """12 decode steps: each output, and the state tensors the port updates
    in place, against the reference's returned state.  sLSTM's ``h``
    buffer stays float32 where the reference's becomes the input's type;
    it holds that type's value exactly."""
    li, _, _, rdec, tdec, rinit, tinit = KINDS[kind]
    cfg, tcfg, rp, tp = _layer(li)
    jdt, tdt = DTYPES[dtype]
    b, steps = 2, 12
    xs = np.random.default_rng(6).standard_normal((steps, b, 1, cfg.d_model)).astype(F32)
    rs = rinit(cfg, b)
    ts = tinit(tcfg, b, device="cpu")
    buffers = dict(ts)
    dec = jax.jit(lambda p, x, s: rdec(p, x, s, cfg))
    tol = 1e-5 if dtype == "f32" else 2e-2
    for i in range(steps):
        ro, rs = dec(rp, jnp.asarray(xs[i], jdt), rs)
        to, ts = tdec(tp, _t(xs[i]).to(tdt), ts, tcfg)
        np.testing.assert_allclose(_np(to), np.asarray(ro, F32), rtol=tol, atol=tol)
        assert set(ts) == set(rs)
        for name, r in rs.items():
            assert ts[name] is buffers[name] and ts[name].dtype == torch.float32
            np.testing.assert_allclose(_np(ts[name]), np.asarray(r, F32), rtol=tol, atol=tol)
    if kind == "slstm":
        assert rs["h"].dtype == jdt
        assert torch.equal(ts["h"], ts["h"].to(tdt).float())


def test_slstm_decode_multiplies_in_the_references_types_over_bf16_weights():
    """With bf16 weights the reference's ``h @ r_gates`` is a bf16 product
    after the first step (its cache then holds bf16 ``h``): the port reads
    its float32 buffer back in the input's type, and its outputs and ``h``
    equal the reference's bit for bit once XLA rounds each bf16 op as torch
    does (compiled without excess precision)."""
    cfg, tcfg, rp, tp = _layer(0, seed=12)
    rp = jax.tree.map(lambda t: t.astype(jnp.bfloat16), rp)
    tp = convert.lm_params(rp, "cpu")
    xs = np.random.default_rng(8).standard_normal((6, 2, 1, cfg.d_model)).astype(F32)
    rs, ts = rxl.slstm_init_state(cfg, 2), txl.slstm_init_state(tcfg, 2, device="cpu")
    jitted = jax.jit(lambda p, x, s: rxl.slstm_decode(p, x, s, cfg))
    for x in xs:
        xr = jnp.asarray(x, jnp.bfloat16)
        ro, rs = jitted.lower(rp, xr, rs).compile({"xla_allow_excess_precision": False})(rp, xr, rs)
        to, ts = txl.slstm_decode(tp, _t(x).to(torch.bfloat16), ts, tcfg)
        assert to.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(to), np.asarray(ro, F32))
        np.testing.assert_array_equal(_np(ts["h"]), np.asarray(rs["h"], F32))


@pytest.mark.parametrize("kind", list(KINDS))
def test_forward_matches_its_own_decode(kind):
    """The prefill form against the recurrent decode, token by token, in
    float32: the reference's chunkwise-against-sequential contract."""
    li, _, tfwd, _, tdec, _, tinit = KINDS[kind]
    cfg, tcfg, rp, tp = _layer(li, seed=13)
    b, s = 2, 40
    x = _t(np.random.default_rng(7).standard_normal((b, s, cfg.d_model)).astype(F32))
    full = tfwd(tp, x, tcfg)
    state = tinit(tcfg, b, device="cpu")
    steps = torch.cat([tdec(tp, x[:, i:i + 1], state, tcfg)[0] for i in range(s)], dim=1)
    np.testing.assert_allclose(_np(steps), _np(full), atol=2e-4, rtol=1e-3)
