"""The port's SNN execution path against the JAX reference, on the CPU:
the plain LIF crossbar step (K5's plain version), the example's clustered
crossbar trajectory, and the LIF spike recording of ``core/lif.py``.

Inputs come from numpy with a seed and go through both packages.  The
reference's Pallas kernel runs in interpret mode, as its own tests run it.
Tolerance against the reference's XLA ``dot``: spikes equal and membrane
state within 1e-4, the reference's own contract (``tests/test_kernels.py``);
the port's plain version sums in a fixed k order, so its results against
itself are compared bit for bit.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import lif as rlif
from repro.kernels import ops as rops
from repro.kernels import ref as rref

from repro_torch import core as tcore
from repro_torch.core import apps as tapps
from repro_torch.core import hardware as thw
from repro_torch.core import lif as tlif
from repro_torch.core import partition as tpart
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

ROOT = pathlib.Path(__file__).resolve().parents[1]
V_ATOL = 1e-4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ======================================================================
# the plain LIF crossbar step
# ======================================================================
@pytest.mark.parametrize("b,n_in,n_out", [(8, 128, 128), (3, 300, 200), (16, 96, 64)])
def test_lif_crossbar_step_matches_the_reference(b, n_in, n_out):
    rng = np.random.default_rng(b * n_in + n_out)
    s = (rng.random((b, n_in)) < 0.2).astype(np.float32)
    w = rng.normal(size=(n_in, n_out)).astype(np.float32)
    v = rng.normal(size=(b, n_out)).astype(np.float32)
    port_s, port_v = tops.lif_crossbar_step(_t(s), _t(w), _t(v))
    assert port_s.dtype == port_v.dtype == torch.float32
    assert port_s.shape == port_v.shape == (b, n_out)
    oracle = rref.lif_crossbar_step_ref(jnp.asarray(s), jnp.asarray(w), jnp.asarray(v))
    for ref_s, ref_v in (rops.lif_crossbar_step(s, w, v), oracle):
        np.testing.assert_array_equal(port_s.numpy(), np.asarray(ref_s))
        np.testing.assert_allclose(port_v.numpy(), np.asarray(ref_v), atol=V_ATOL)
    # the ops wrapper on a CPU tensor is the plain version, bit for bit
    plain_s, plain_v = tref.lif_crossbar_step_ref(_t(s), _t(w), _t(v))
    assert torch.equal(plain_s, port_s) and torch.equal(plain_v, port_v)


def test_lif_crossbar_step_exact_threshold_fires_and_resets():
    """Column 0 accumulates exactly 1.0 == v_th: it fires and resets; the
    k-ordered float32 sum of 128 terms of 2^-7 is exact."""
    s = np.ones((8, 128), np.float32)
    w = np.zeros((128, 128), np.float32)
    w[:, 0] = 1.0 / 128.0
    v = np.zeros((8, 128), np.float32)
    out_s, out_v = tops.lif_crossbar_step(_t(s), _t(w), _t(v), leak=0.9, v_th=1.0, v_reset=0.0)
    ref_s, ref_v = rops.lif_crossbar_step(s, w, v, leak=0.9, v_th=1.0, v_reset=0.0)
    np.testing.assert_array_equal(out_s.numpy(), np.asarray(ref_s))
    assert (out_s[:, 0] == 1).all() and (out_v[:, 0] == 0).all() and (out_s[:, 1:] == 0).all()
    # leak is a float32 constant: 0.9f * v, not 0.9 * v in float64
    v1 = np.full((1, 1), 1.1, np.float32)
    _, v_next = tops.lif_crossbar_step(_t(np.zeros((1, 1))), _t(np.zeros((1, 1))), _t(v1),
                                       v_th=2.0)
    assert v_next.item() == float(np.float32(0.9) * v1[0, 0])


def test_lif_crossbar_step_stacked_blocks_equal_their_own_calls():
    """The plain version takes a stack of blocks (leading dims), each the
    same bits as its own call; chip_smoke.py checks the example's path so."""
    rng = np.random.default_rng(1)
    s = _t(rng.random((5, 8, 128)) < 0.15)
    w = _t(rng.normal(size=(5, 128, 128)) * 0.2)
    v = _t(rng.normal(size=(5, 8, 128)))
    stack_s, stack_v = tref.lif_crossbar_step_ref(s, w, v)
    for i in range(5):
        one_s, one_v = tops.lif_crossbar_step(s[i], w[i], v[i])
        assert torch.equal(one_s, stack_s[i]) and torch.equal(one_v, stack_v[i])


@pytest.mark.parametrize("g,b,n_in,n_out", [(1, 8, 128, 128), (3, 37, 129, 65), (5, 5, 65, 129)])
def test_stacked_lif_crossbar_step_matches_the_reference_per_block(g, b, n_in, n_out):
    """The wrapper's stacked form, (G, B, n_in) x (G, n_in, n_out), against
    the reference's Pallas kernel (interpret mode) called once per block,
    and against the port's own 2-D call bit for bit."""
    rng = np.random.default_rng(g * 1000 + b)
    s = (rng.random((g, b, n_in)) < 0.2).astype(np.float32)
    w = (rng.normal(size=(g, n_in, n_out)) * 0.3).astype(np.float32)
    v = rng.normal(size=(g, b, n_out)).astype(np.float32)
    port_s, port_v = tops.lif_crossbar_step(_t(s), _t(w), _t(v), leak=0.8, v_th=0.5, v_reset=-0.25)
    assert port_s.shape == port_v.shape == (g, b, n_out)
    for i in range(g):
        ref_s, ref_v = rops.lif_crossbar_step(s[i], w[i], v[i], leak=0.8, v_th=0.5, v_reset=-0.25)
        np.testing.assert_array_equal(port_s[i].numpy(), np.asarray(ref_s))
        np.testing.assert_allclose(port_v[i].numpy(), np.asarray(ref_v), atol=V_ATOL)
        one_s, one_v = tops.lif_crossbar_step(_t(s[i]), _t(w[i]), _t(v[i]), leak=0.8, v_th=0.5,
                                              v_reset=-0.25)
        assert torch.equal(one_s, port_s[i]) and torch.equal(one_v, port_v[i])
    assert port_s.sum() > 0


@pytest.mark.parametrize("case", ["leading_dims_differ", "weights_not_stacked", "four_d"])
def test_lif_crossbar_step_rejects_shapes_it_does_not_take(case):
    """W is never broadcast over G, leading dimensions must agree, and a
    stack has exactly one leading dimension (checked on either device)."""
    s, w, v = torch.zeros((3, 8, 16)), torch.zeros((3, 16, 4)), torch.zeros((3, 8, 4))
    if case == "leading_dims_differ":
        args = (s, w[:2], v)
    elif case == "weights_not_stacked":
        args = (s, w[0], v)
    else:
        args = (s[None], w[None], v[None])
    with pytest.raises(ValueError, match="shape mismatch|2-D"):
        tops.lif_crossbar_step(*args)


# ======================================================================
# the example's path: one crossbar block per cluster, spikes fed back
# ======================================================================
def _example_blocks(cl):
    """examples/snn_on_tpu.py's own loop, the oracle of chip_smoke.crossbar_blocks."""
    work = cl.snn
    blocks = []
    for c in range(cl.n_clusters):
        members = np.flatnonzero(cl.cluster_of == c)
        mask = np.isin(work.post, members)
        pre_ids = np.unique(work.pre[mask])
        w = np.zeros((128, 128), np.float32)
        row = {int(p): i for i, p in enumerate(pre_ids)}
        col = {int(n): i for i, n in enumerate(members)}
        for p_, n_, wt in zip(work.pre[mask], work.post[mask], work.weight[mask]):
            w[row[int(p_)], col[int(n_)]] += wt
        blocks.append((pre_ids, members, w))
    return blocks


def test_example_crossbar_trajectory_matches_the_reference():
    cl = tpart.partition_greedy(tapps.small_app(200, 2400, seed=5), thw.DYNAP_SE)
    example = _example_blocks(cl)
    blocks, inputs, members = _chip_smoke().crossbar_blocks(cl)
    assert blocks.shape == (cl.n_clusters, 128, 128)
    for (pre_ids, mem, w), blk, n_in, n_mem in zip(example, blocks, inputs, members):
        np.testing.assert_array_equal(blk, w)
        assert (n_in, n_mem) == (len(pre_ids), len(mem))

    rng = np.random.default_rng(0)
    for _, _, w in example[:4]:
        s = (rng.random((8, 128)) < 0.15).astype(np.float32)
        t_s, t_v = _t(s), torch.zeros((8, 128))
        r_s, r_v = jnp.asarray(s), jnp.zeros((8, 128), jnp.float32)
        k_s, k_v = s, np.zeros((8, 128), np.float32)
        fired = 0
        for _ in range(5):
            t_s, t_v = tops.lif_crossbar_step(t_s, _t(w), t_v)
            r_s, r_v = rref.lif_crossbar_step_ref(r_s, jnp.asarray(w), r_v)
            k_s, k_v = rops.lif_crossbar_step(np.asarray(k_s), w, np.asarray(k_v))
            for ref_s, ref_v in ((r_s, r_v), (k_s, k_v)):
                np.testing.assert_array_equal(t_s.numpy(), np.asarray(ref_s))
                np.testing.assert_allclose(t_v.numpy(), np.asarray(ref_v), atol=V_ATOL)
            fired += int(t_s.sum())
        assert fired > 0


# ======================================================================
# core/lif.py: the spike recording
# ======================================================================
def _draws(n_neurons, n_steps, seed):
    """The uniform draws of the reference's ``_simulate``: one key per step."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_steps)
    return np.array(jax.vmap(lambda k: jax.random.uniform(k, (n_neurons,)))(keys))


@pytest.mark.parametrize("app", ["small", "MLP-MNIST"])
def test_simulate_matches_the_reference_on_the_same_draws(app):
    n_steps = 64
    if app == "small":
        r_snn, t_snn = rc.small_app(200, 2400, seed=5), tapps.small_app(200, 2400, seed=5)
    else:
        r_snn, t_snn = rc.build_app(app), tapps.build_app(app)
    ref = rlif.simulate_spikes(r_snn, n_steps=n_steps, seed=3)
    draws = torch.from_numpy(_draws(t_snn.n_neurons, n_steps, 3))
    port = tlif._simulate(*tlif.snn_tensors(t_snn, "cpu"), draws, params=tlif.LIFParams())
    assert port.dtype == torch.float32 and port.shape == (t_snn.n_neurons,)
    np.testing.assert_array_equal(port.numpy().astype(np.float64), ref)
    hidden = r_snn.layer_of != 0
    assert ref[hidden].sum() > 0 and ref[~hidden].sum() > 0


def test_simulate_spikes_and_with_simulated_spikes_on_the_cpu(monkeypatch):
    snn = tapps.small_app(200, 2400, seed=5)
    counts = tcore.simulate_spikes(snn, n_steps=32, seed=1, device="cpu")
    assert counts.dtype == np.float64 and counts.shape == (snn.n_neurons,)
    assert (counts >= 0).all() and (counts <= 32).all() and counts.sum() > 0
    np.testing.assert_array_equal(
        counts, tcore.simulate_spikes(snn, n_steps=32, seed=1, device="cpu"))
    out = tcore.with_simulated_spikes(snn, n_steps=32, seed=1, device="cpu")
    np.testing.assert_array_equal(out.spikes, np.maximum(counts, 1e-3))
    np.testing.assert_array_equal(out.weight, snn.weight)
    assert tcore.LIFParams() == tlif.LIFParams() and tlif.LIFParams().refractory == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcore.simulate_spikes(snn, n_steps=2)
