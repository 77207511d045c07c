"""The port's max-plus layer against the JAX reference.

The plain PyTorch versions of the CUDA kernels are held against the
reference's Pallas kernel bodies (interpret mode) and its ``ops`` wrappers,
exactly.  ``mcr_batch`` is held against the reference: ``"edges"`` bit for
bit, ``"csr"`` to ``rtol 1e-8`` against ``"edges"`` and ``1e-6`` against
Howard (the reference's own csr-jit cannot run on this JAX), ``"dense"``
and the Eq.-4 path to ``1e-4`` (float32).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import maxplus as rmp
from repro.core import ChipState as RChipState
from repro.core import DYNAP_SE as R_DYNAP_SE
from repro.core import batch_execute as r_batch_execute
from repro.core import partition_greedy as r_partition_greedy
from repro.core import sdfg_from_clusters as r_sdfg_from_clusters
from repro.core import small_app as r_small_app
from repro.core.sdfg import SDFG, Channel
from repro.kernels import ops as rops
from repro.kernels.maxplus_bellman import segment_max_pallas
from repro.kernels.maxplus_matmul import maxplus_bmm as pallas_bmm
from repro.kernels.maxplus_matmul import maxplus_bmv as pallas_bmv

from repro_torch import convert
from repro_torch.core import engine as tengine
from repro_torch.core import maxplus as tmp
from repro_torch.kernels import ops

from _torch_helpers import dyadic_csr

NEG_INF = float("-inf")
CPU = "cpu"


def random_live_sdfg(rng: np.random.Generator, n: int) -> SDFG:
    """Random strongly-cyclic live event graph (reference IR)."""
    tau = rng.uniform(0.5, 5.0, size=n)
    channels = [Channel(i, i, 1, 1.0, kind="self") for i in range(n)]
    for i in range(n):
        channels.append(Channel(i, (i + 1) % n, 1 if i == n - 1 else 0, 1.0))
    for _ in range(int(rng.integers(0, 2 * n))):
        i, j = int(rng.integers(n)), int(rng.integers(n))
        if i == j:
            continue
        channels.append(
            Channel(i, j, 1 if j <= i else int(rng.integers(0, 3)), 1.0,
                    delay=float(rng.uniform(0, 2.0)))
        )
    g = SDFG(n_actors=n, exec_time=tau, channels=channels)
    g.validate()
    return g


def random_stack(seed: int, n_graphs: int = 5):
    rng = np.random.default_rng(seed)
    graphs = [random_live_sdfg(rng, int(rng.integers(3, 14))) for _ in range(n_graphs)]
    return graphs, rmp.stack_graphs(graphs)


# ======================================================================
# plain versions vs the reference's Pallas bodies (exact)
# ======================================================================
@pytest.mark.parametrize("k", [1, 3])
def test_segment_relax_ref_matches_pallas_segment_max(k):
    b, n = 4, 64
    csr, dist, lams, cand, _, dst = dyadic_csr(0, b, n, 128, k)
    ours = ops.relax_round(dist, lams, csr).numpy()
    theirs = np.asarray(segment_max_pallas(
        jnp.asarray(cand, dtype=jnp.float32), jnp.asarray(dst, dtype=jnp.int32),
        n_segments=b * n, block_e=128, interpret=True,
    ))
    np.testing.assert_array_equal(ours, theirs.astype(np.float64))
    assert np.isneginf(ours[np.bincount(dst, minlength=b * n) == 0]).all()


def test_segment_relax_witness_matches_reference_tie_rule():
    """psrc = the largest src among the edges at the max: the reference
    segment path's second fold (maxplus_bellman.py:219-227)."""
    b, n, k = 2, 64, 3
    csr, dist, lams, cand, src, dst = dyadic_csr(1, b, n, 256, k)
    best, psrc = ops.relax_round_witness(dist, lams, csr)
    np.testing.assert_array_equal(best.numpy(), ops.relax_round(dist, lams, csr).numpy())
    cand32 = jnp.asarray(cand, dtype=jnp.float32)
    seg = jnp.asarray(dst, dtype=jnp.int32)
    best_ref = segment_max_pallas(cand32, seg, n_segments=b * n, block_e=128, interpret=True)
    at_max = cand32 >= best_ref[seg]
    tagged = jnp.where(at_max, jnp.asarray(src, dtype=jnp.float32)[:, None], NEG_INF)
    psrc_ref = np.asarray(segment_max_pallas(
        tagged, seg, n_segments=b * n, block_e=128, interpret=True))
    has_in = np.bincount(dst, minlength=b * n) > 0
    np.testing.assert_array_equal(psrc.numpy()[has_in], psrc_ref[has_in].astype(np.int64))
    assert (psrc.numpy()[~has_in] == -1).all()
    # ties exist in this input, so the rule is exercised
    assert np.asarray(at_max).sum() > has_in.sum() * k


@pytest.mark.parametrize("k", [2, 4])
def test_relax_round_rejects_probe_counts_the_kernel_lacks(k):
    """K1 is built for the search's 3 probes and the deadlock probe's 1;
    the wrappers refuse any other count on every device alike."""
    csr, dist, lams, *_ = dyadic_csr(0, 2, 8, 16, k)
    with pytest.raises(ValueError, match="probes"):
        ops.relax_round(dist, lams, csr)
    with pytest.raises(ValueError, match="probes"):
        ops.relax_round_witness(dist, lams, csr)


def test_maxplus_bmm_and_bmv_ref_match_pallas_bodies():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((2, 16, 32)).astype(np.float32)
    b = rng.standard_normal((2, 32, 24)).astype(np.float32)
    x = rng.standard_normal((2, 32)).astype(np.float32)
    a[0, 3, :] = NEG_INF
    c_ref = np.asarray(pallas_bmm(jnp.asarray(a), jnp.asarray(b), bm=8, bn=8, bk=8, interpret=True))
    y_ref = np.asarray(pallas_bmv(jnp.asarray(a), jnp.asarray(x), bm=8, bk=8, interpret=True))
    np.testing.assert_array_equal(ops.maxplus_bmm(torch.from_numpy(a), torch.from_numpy(b)).numpy(), c_ref)
    np.testing.assert_array_equal(ops.maxplus_bmv(torch.from_numpy(a), torch.from_numpy(x)).numpy(), y_ref)


@pytest.mark.parametrize("shape", [(3, 7, 5, 9), (1, 33, 17, 1), (2, 1, 40, 3)])
def test_maxplus_products_match_reference_ops_at_ragged_shapes(shape):
    g, m, k, n = shape
    rng = np.random.default_rng(sum(shape))
    a = rng.standard_normal((g, m, k)).astype(np.float32)
    b = rng.standard_normal((g, k, n)).astype(np.float32)
    x = rng.standard_normal((g, k)).astype(np.float32)
    a[a > 1.5] = NEG_INF
    np.testing.assert_array_equal(
        ops.maxplus_bmm(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(rops.maxplus_bmm(a, b)))
    np.testing.assert_array_equal(
        ops.maxplus_bmv(torch.from_numpy(a), torch.from_numpy(x)).numpy(),
        np.asarray(rops.maxplus_bmv(a, x)))
    np.testing.assert_array_equal(
        ops.maxplus_matmul(torch.from_numpy(a[0]), torch.from_numpy(b[0])).numpy(),
        np.asarray(rops.maxplus_matmul(a[0], b[0])))


# ======================================================================
# mcr_batch backends vs the reference
# ======================================================================
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_edges_bit_identical_and_csr_matches_edges_and_howard(seed):
    graphs, rstack = random_stack(seed)
    stack = convert.convert(rstack)
    pe_ref = rmp.mcr_batch(rstack, backend="edges", rel_tol=1e-9)
    pe = tmp.mcr_batch(stack, backend="edges", rel_tol=1e-9, device=CPU)
    np.testing.assert_array_equal(pe, pe_ref)
    pc = tmp.mcr_batch(stack, backend="csr", rel_tol=1e-9, device=CPU)
    howard = np.array([rmp.mcr_howard(g) for g in graphs])
    np.testing.assert_allclose(pc, pe_ref, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(pc, howard, rtol=1e-6, atol=1e-6)
    # auto is the device search
    np.testing.assert_array_equal(tmp.mcr_batch(stack, rel_tol=1e-9, device=CPU), pc)


def test_csr_deadlocked_rows_report_inf():
    live = SDFG(n_actors=3, exec_time=np.array([1.0, 2.0, 3.0]),
                channels=[Channel(0, 1, 0, 1.0), Channel(1, 2, 0, 1.0), Channel(2, 0, 1, 1.0)])
    dead = SDFG(n_actors=3, exec_time=np.array([1.0, 2.0, 3.0]),
                channels=[Channel(0, 1, 0, 1.0), Channel(1, 0, 0, 1.0), Channel(2, 2, 1, 1.0)])
    stack = convert.convert(rmp.stack_graphs([live, dead, live]))
    pe = rmp.mcr_batch(rmp.stack_graphs([live, dead, live]), backend="edges", detect_deadlock=True)
    pc = tmp.mcr_batch(stack, backend="csr", detect_deadlock=True, device=CPU)
    assert pc[1] == np.inf
    np.testing.assert_allclose(pc, pe, rtol=1e-8)


def test_csr_acyclic_rows_report_neg_inf():
    chain = SDFG(n_actors=4, exec_time=np.ones(4),
                 channels=[Channel(0, 1, 1, 1.0), Channel(1, 2, 0, 1.0), Channel(2, 3, 2, 1.0)])
    ring = SDFG(n_actors=4, exec_time=np.ones(4),
                channels=[Channel(i, (i + 1) % 4, 1 if i == 3 else 0, 1.0) for i in range(4)])
    stack = convert.convert(rmp.stack_graphs([chain, ring, chain]))
    for backend in ("edges", "csr"):
        p = tmp.mcr_batch(stack, backend=backend, device=CPU)
        assert p[0] == NEG_INF and p[2] == NEG_INF, (backend, p)
        np.testing.assert_allclose(p[1], rmp.mcr_howard(ring), rtol=1e-6)


def test_csr_ignores_neg_inf_padding_rows_and_slots():
    rng = np.random.default_rng(5)
    g = random_live_sdfg(rng, 8)
    base = convert.convert(rmp.stack_graphs([g, g]))
    pad = 7
    padded = tmp.EdgeStack(
        n_actors=base.n_actors + 3,
        src=np.pad(base.src, ((0, 1), (0, pad))),
        dst=np.pad(base.dst, ((0, 1), (0, pad))),
        tokens=np.pad(base.tokens, ((0, 1), (0, pad)), constant_values=1),
        weights=np.pad(base.weights, ((0, 1), (0, pad)), constant_values=NEG_INF),
    )
    p = tmp.mcr_batch(padded, backend="csr", device=CPU)
    np.testing.assert_array_equal(p[:2], tmp.mcr_batch(base, backend="csr", device=CPU))
    assert p[2] == NEG_INF


def test_csr_deterministic_and_probe_count_invariant():
    _, rstack = random_stack(77, 4)
    stack = convert.convert(rstack)
    a = tmp.mcr_batch(stack, backend="csr", rel_tol=1e-9, device=CPU)
    np.testing.assert_array_equal(a, tmp.mcr_batch(stack, backend="csr", rel_tol=1e-9, device=CPU))
    k1 = tmp._mcr_batch_csr(stack, rel_tol=1e-9, k_probes=1, device=torch.device(CPU))
    np.testing.assert_allclose(k1, a, rtol=1e-8, atol=1e-8)


@pytest.fixture(scope="module")
def compiled_app():
    snn = r_small_app(200, 2600, seed=21)
    cl = r_partition_greedy(snn, R_DYNAP_SE)
    app = r_sdfg_from_clusters(cl, hw=R_DYNAP_SE)
    rng = np.random.default_rng(11)
    bindings = np.stack([
        rng.integers(0, R_DYNAP_SE.n_tiles, size=app.n_actors) for _ in range(6)
    ])
    return app, bindings


def test_backends_agree_on_degraded_chip_state(compiled_app):
    app, bindings = compiled_app
    state = RChipState(R_DYNAP_SE)
    state.fail_tiles([int(bindings[0, 0])])
    state.throttle_link(0, 1, 3.0)
    rep_ref = r_batch_execute(app, bindings, R_DYNAP_SE, backend="edges", chip_state=state)
    t_app, t_hw, t_state = convert.convert(app), convert.convert(R_DYNAP_SE), convert.convert(state)
    rep_e = tengine.batch_execute(t_app, bindings, t_hw, backend="edges",
                                  chip_state=t_state, device=CPU)
    rep_c = tengine.batch_execute(t_app, bindings, t_hw, backend="csr",
                                  chip_state=t_state, device=CPU)
    dead = state.dead_rows(bindings)
    assert dead.any() and not dead.all()
    np.testing.assert_array_equal(rep_e.periods, rep_ref.periods)
    assert np.isinf(rep_c.periods[dead]).all()
    np.testing.assert_allclose(rep_c.periods[~dead], rep_ref.periods[~dead], rtol=1e-8)


def test_dense_matches_reference_dense():
    _, rstack = random_stack(0, 4)
    ref = rmp.mcr_batch(rstack, backend="dense")
    ours = tmp.mcr_batch(convert.convert(rstack), backend="dense", device=CPU)
    np.testing.assert_allclose(ours, ref, rtol=1e-4)


def test_eq4_matrix_evolution_and_power_iteration_match_reference():
    graphs, rstack = random_stack(9, 3)
    stack = convert.convert(rstack)
    t_ref = np.asarray(rmp.maxplus_matrix_batch(rstack))
    t_ours = tmp.maxplus_matrix_batch(stack, device=CPU).numpy()
    np.testing.assert_allclose(t_ours, t_ref, rtol=1e-4)
    x_ref, g_ref = rmp.evolve_batch(t_ref, iters=32)
    x, g = tmp.evolve_batch(t_ours, iters=32, device=CPU)
    np.testing.assert_allclose(x, x_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g, g_ref, rtol=1e-4)
    T = rmp.maxplus_matrix(graphs[0])
    np.testing.assert_allclose(
        tmp.mcm_power_iteration(T, iters=60, device=CPU),
        rmp.mcm_power_iteration(T, iters=60), rtol=1e-4)


def test_mcr_batch_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, rstack = random_stack(0, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmp.mcr_batch(convert.convert(rstack))
    with pytest.raises(RuntimeError, match="CUDA"):
        tmp.mcr_batch(convert.convert(rstack), backend="edges")
