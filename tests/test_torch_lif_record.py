"""The LIF spike recording as one launch (``ops.lif_record``) and the
synaptic sum's zero skip, on the CPU.

The card's ordered sum (``csrc/spike_sum.cuh``) adds only the nonzero
products, in synapse order: a warp's ballots of them, compacted in order
into a buffer padded with +0 to a multiple of 8, added from there.
Here the argument that this changes no bit is checked on numpy float32
sums, a Python model of the walk is held against ``ref.spike_input_ref``
bit for bit, and the recording's plain version (what ``ops.lif_record``
runs on a CPU tensor) against the JAX reference's counts on the
reference's own draws, and its counts, last ``v`` and ``refr`` against an
independent numpy loop, every bit equal.
"""

import jax
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import lif as rlif

from repro_torch.core import apps as tapps
from repro_torch.core import lif as tlif
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import work as twork

F32 = np.float32
#: s values of the zero-skip checks: zeros of both signs, the recording's
#: 1, general floats, a scale whose products with the small weights
#: underflow to zeros of either sign, and the non-finite
SPECIAL_S = np.array([0.0, -0.0, 1.0, 0.375, -2.5, 3e-30, -3e-30, np.inf, -np.inf, np.nan], F32)


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=F32).reshape(-1).view(np.int32)


def _ordered_sum(products, *, check_never_negative_zero=False) -> np.float32:
    """The float32 sum from +0 in the given order, one rounding an add."""
    acc = F32(0.0)
    for p in products:
        acc = F32(acc + p)
        if check_never_negative_zero:
            assert not (acc == 0 and np.signbit(acc)), "the running sum became -0"
    return acc


def _segments(seed: int, n: int):
    """n segments of 0-80 synapses: signed weights of ordinary and of tiny
    magnitude, and s values drawn from ``SPECIAL_S`` and from [-4, 4)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = int(rng.integers(0, 81))
        w = (rng.standard_normal(m) * np.where(rng.random(m) < 0.2, 1e-20, 1.0)).astype(F32)
        s = np.where(rng.random(m) < 0.6, rng.choice(SPECIAL_S, m),
                     rng.uniform(-4, 4, m)).astype(F32)
        out.append((w, s))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_skipping_zero_products_changes_no_bit(seed):
    """The ordered float32 sum of only the nonzero products equals the full
    ordered sum bit for bit (compared as int32), over products of every
    kind: +-0 from +-0 spikes and from underflow, infinities and NaNs; the
    running sum from +0 is never -0."""
    skipped = kept = 0
    with np.errstate(all="ignore"):
        for w, s in _segments(seed, 400):
            p = w * s                                         # float32, one rounding each
            nonzero = p[p != 0]                               # a NaN is != 0
            full = _ordered_sum(p, check_never_negative_zero=True)
            assert _bits(_ordered_sum(nonzero)) == _bits(full)
            skipped += p.size - nonzero.size
            kept += nonzero.size
    assert skipped > 1000 and kept > 1000


def test_the_skip_adds_every_non_finite_product():
    """inf and NaN products are not zero: they reach the sum, as in the full
    order (inf + -inf is NaN, a NaN stays NaN)."""
    with np.errstate(all="ignore"):
        for s, expect in ((np.array([1, np.inf, 0], F32), np.inf),      # 2, inf, -0
                          (np.array([np.inf, 0, np.inf], F32), np.nan),  # inf, 0, -inf
                          (np.array([np.nan, 0, 0], F32), np.nan),
                          (np.array([0, np.inf, 0], F32), np.inf)):
            p = np.array([2.0, 3.0, -5.0], F32) * s
            got = _ordered_sum(p[p != 0])
            assert (np.isnan(got) and np.isnan(expect)) or got == expect
            assert _bits(got) == _bits(_ordered_sum(p))


def _warp_walk(csr: tref.SynapseCSR, s: np.ndarray, batch: int = 4) -> tuple[np.ndarray, int]:
    """spike_sum.cuh's walk in Python: per neuron, ``batch`` groups of 32
    synapses at a time, w read only where s[pre] != 0, each group's ballot
    of nonzero products compacted in lane order, the batch's buffer padded
    with +0 to a multiple of 8 and added in order.  Returns the sums and how
    many w were read."""
    indptr, pre, w = csr.indptr.numpy(), csr.pre.numpy(), csr.weight.numpy()
    out = np.zeros(csr.n_neurons, F32)
    w_reads = 0
    with np.errstate(all="ignore"):
        for v in range(csr.n_neurons):
            acc = F32(0.0)
            for base in range(indptr[v], indptr[v + 1], 32 * batch):
                buf = []
                for k in range(batch):
                    lanes = np.arange(base + 32 * k, min(base + 32 * (k + 1), indptr[v + 1]))
                    sv = s[pre[lanes]]
                    live = sv != 0
                    w_reads += int(live.sum())
                    p = np.zeros(lanes.size, F32)
                    p[live] = w[lanes[live]] * sv[live]
                    buf += [x for x in p if x != 0]               # ballot order = lane order
                buf += [F32(0.0)] * (-len(buf) % 8)
                for x in buf:
                    acc = F32(acc + x)
            out[v] = acc
    return out, w_reads


@pytest.mark.parametrize("spikes", ["zero_one", "general", "special"])
def test_the_compacted_walk_equals_spike_input_ref(spikes):
    """The walk over nonzero products equals ``ref.spike_input_ref`` (the
    CPU's index_add_ over every product) bit for bit, NaN where it is NaN,
    on in-degrees of 0 to 200 and signed weights; w is read only for
    synapses whose source s is nonzero."""
    rng = np.random.default_rng(5)
    n, e = 300, 12_000
    post = rng.integers(0, n - 3, e)
    post[:200] = 4                                   # one neuron of 200 synapses
    pre = rng.integers(0, n, e)
    w = rng.standard_normal(e).astype(F32)
    if spikes == "zero_one":
        s = (rng.random(n) < 0.2).astype(F32)
    elif spikes == "general":
        s = np.where(rng.random(n) < 0.5, rng.uniform(-3, 3, n), 0.0).astype(F32)
    else:
        s = rng.choice(SPECIAL_S[:-3], n)
        s[[7, 11]] = (np.inf, np.nan)
    csr = tlif.synapse_csr(pre, post, w, n, "cpu")
    got, w_reads = _warp_walk(csr, s)
    expect = tref.spike_input_ref(torch.from_numpy(s), csr).numpy()
    nan = np.isnan(expect)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got[~nan]), _bits(expect[~nan]))
    assert w_reads == int((s[csr.pre.numpy()] != 0).sum()) < e
    np.testing.assert_array_equal(
        tops.spike_input(torch.from_numpy(s), csr).numpy().view(np.int32), expect.view(np.int32))


# ======================================================================
# the recording: ops.lif_record on the CPU
# ======================================================================
#: LIFParams variants: the defaults, no refractory period, a longer one with
#: a reset below zero, and no leak with a lower threshold
PARAMS = {
    "default": {},
    "refractory_0": {"refractory": 0},
    "refractory_3_reset": {"refractory": 3, "v_reset": -0.25},
    "leak_1": {"leak": 1.0, "v_threshold": 0.5},
}
APPS = ("small", "MLP-MNIST", "recurrent")
N_STEPS = 40


def _draws(n_neurons, n_steps, seed):
    """The uniform draws of the reference's ``_simulate``: one key per step."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_steps)
    return np.array(jax.vmap(lambda k: jax.random.uniform(k, (n_neurons,)))(keys))


def _apps(name):
    if name == "small":
        return rc.small_app(200, 2400, seed=5), tapps.small_app(200, 2400, seed=5)
    if name == "recurrent":
        return (rc.small_app(240, 3000, seed=9, recurrent=True),
                tapps.small_app(240, 3000, seed=9, recurrent=True))
    return rc.build_app(name), tapps.build_app(name)


def _numpy_recording(csr: tref.SynapseCSR, is_input, draws, p):
    """The recording in numpy float32, independent of torch: np.add.at adds
    each neuron's products in synapse order."""
    n_steps, n = draws.shape
    pre, post, w = csr.pre.numpy(), csr.post.numpy(), csr.weight.numpy()
    v, counts = np.zeros(n, F32), np.zeros(n, F32)
    refr = np.zeros(n, np.int32)
    for t in range(n_steps):
        fired = np.where(is_input, draws[t] < F32(p.input_rate),
                         (v >= F32(p.v_threshold)) & (refr <= 0))
        s = fired.astype(F32)
        i = np.zeros(n, F32)
        np.add.at(i, post, w * s[pre])
        v = np.where(fired, F32(p.v_reset), v * F32(p.leak)) + np.where(is_input, F32(0.0), i)
        refr = np.where(fired, np.int32(p.refractory), np.maximum(refr - 1, 0)).astype(np.int32)
        counts += s
    return counts, v, refr


@pytest.mark.parametrize("variant", list(PARAMS))
@pytest.mark.parametrize("app", APPS)
def test_lif_record_matches_the_reference_on_the_same_draws(app, variant):
    """``ops.lif_record`` on CPU tensors: counts equal to the JAX reference's
    ``simulate_spikes`` on its own draws, and counts, last v and refr equal
    to the numpy loop, every bit; hidden neurons spike."""
    r_snn, t_snn = _apps(app)
    r_params = rlif.LIFParams(**PARAMS[variant])
    params = tlif.LIFParams(**PARAMS[variant])
    ref_counts = rlif.simulate_spikes(r_snn, n_steps=N_STEPS, params=r_params, seed=3)
    draws = _draws(t_snn.n_neurons, N_STEPS, 3)
    csr, is_input = tlif.snn_tensors(t_snn, "cpu")
    counts, v, refr = tops.lif_record(csr, is_input, torch.from_numpy(draws), params)
    assert (counts.dtype, v.dtype, refr.dtype) == (torch.float32, torch.float32, torch.int32)
    np.testing.assert_array_equal(counts.numpy().astype(np.float64), ref_counts)
    for got, want in zip((counts, v, refr), _numpy_recording(csr, is_input.numpy(), draws, params)):
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    hidden = r_snn.layer_of != 0
    assert ref_counts[hidden].sum() > 0 and ref_counts[~hidden].sum() > 0
    # _simulate is the recording's counts
    np.testing.assert_array_equal(
        tlif._simulate(csr, is_input, torch.from_numpy(draws), params=params).numpy(),
        counts.numpy())


def test_lif_record_of_no_steps_and_mismatched_shapes():
    """Zero steps give zero state; mismatched shapes raise on every device."""
    csr, is_input = tlif.snn_tensors(tapps.small_app(60, 400, seed=1), "cpu")
    n = csr.n_neurons
    counts, v, refr = tops.lif_record(csr, is_input, torch.zeros((0, n)), tlif.LIFParams())
    assert counts.shape == v.shape == refr.shape == (n,)
    assert not counts.any() and not v.any() and not refr.any()
    with pytest.raises(ValueError, match="shape mismatch"):
        tops.lif_record(csr, is_input[:-1], torch.zeros((3, n)), tlif.LIFParams())
    with pytest.raises(ValueError, match="shape mismatch"):
        tops.lif_record(csr, is_input, torch.zeros((3, n + 1)), tlif.LIFParams())


# ======================================================================
# kernels/work.py: the synaptic sum's and the recording's work
# ======================================================================
def test_spike_input_and_lif_record_work_by_hand():
    # 3 neurons, 10 synapses: indptr 16, pre and w 80, s and i 24
    assert twork.spike_input_work(3, 10) == (120, 20)
    # 4 synapses whose source fired: w's 16 bytes in place of 40
    assert twork.spike_input_work(3, 10, active=4) == (96, 8)
    # HeartClass: 24,732 neurons, 2,396,521 synapses, 19.47 MB a call
    assert twork.spike_input_work(24_732, 2_396_521)[0] == 98_932 + 19_172_168 + 197_856
    # indptr 16, pre and w 80, is_input 3, 1 input neuron's draws over 5
    # steps 20, counts, v and refr 36; 2 flops x 10 synapses x 5 steps
    assert twork.lif_record_work(3, 10, 5, 1) == (155, 100)
    assert twork.lif_record_work(3, 10, 5, 1, active=7) == (155, 14)
