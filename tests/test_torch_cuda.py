"""The port's CUDA kernels on the card, and the no-fallback rule.

Imports torch, numpy and the port only (no JAX), so it runs on a machine
with the card:  ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tests marked ``cuda`` skip where there is no CUDA device.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import engine as tengine
from repro_torch.core import maxplus as tmp
from repro_torch.core.apps import small_app
from repro_torch.core.hardware import DYNAP_SE_16
from repro_torch.core.partition import partition_greedy
from repro_torch.core.runtime import single_tile_order
from repro_torch.core.sdfg import sdfg_from_clusters
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref

from _torch_helpers import dyadic_csr


def _need_cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _to(csr: tref.RelaxCSR, dev) -> tref.RelaxCSR:
    return tref.RelaxCSR(
        n_actors=csr.n_actors, **{
            f: getattr(csr, f).to(dev)
            for f in ("indptr", "src", "w", "t", "dst", "dst_row")
        })


def _no_nvcc(monkeypatch, tmp_path):
    def missing():
        raise RuntimeError("cannot build the repro_torch CUDA kernels: no nvcc")

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", missing)


def _kernel_calls(dist, lams, csr, a):
    return (
        lambda: ops.relax_round(dist, lams, csr),
        lambda: ops.relax_round_witness(dist, lams, csr),
        lambda: ops.maxplus_bmm(a, a),
        lambda: ops.maxplus_bmv(a, a[:, 0].contiguous()),
        lambda: ops.maxplus_matmul(a[0], a[0]),
    )


def test_kernel_path_raises_when_the_library_cannot_be_built(monkeypatch, tmp_path):
    """A tensor routed to a kernel never falls back to the plain version:
    a failed build surfaces as an error (routing forced, since this test
    also runs without a card)."""
    _no_nvcc(monkeypatch, tmp_path)
    monkeypatch.setattr(ops, "_on_cpu", lambda *ts: False)
    csr, dist, lams, *_ = dyadic_csr(0, 2, 8, 8, 3)
    before = dict(ops.LAUNCHES)
    for call in _kernel_calls(dist, lams, csr, torch.zeros((1, 4, 4))):
        with pytest.raises(RuntimeError, match="nvcc"):
            call()
    assert ops.LAUNCHES == before


def test_wrappers_reject_devices_without_a_kernel():
    a = torch.zeros((1, 4, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.maxplus_bmm(a, a)


@pytest.mark.cuda
def test_cuda_tensors_raise_when_the_library_cannot_be_built(monkeypatch, tmp_path):
    dev = _need_cuda()
    _no_nvcc(monkeypatch, tmp_path)
    csr, dist, lams, *_ = dyadic_csr(0, 2, 8, 8, 3)
    for call in _kernel_calls(dist.to(dev), lams.to(dev), _to(csr, dev),
                              torch.zeros((1, 4, 4), device=dev)):
        with pytest.raises(RuntimeError, match="nvcc"):
            call()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3])
def test_relax_round_bit_identical_on_the_card(k):
    dev = _need_cuda()
    csr, dist, lams, *_ = dyadic_csr(3, 4, 64, 300, k)
    gpu = _to(csr, dev)
    rng = np.random.default_rng(k)
    dist = torch.as_tensor(rng.standard_normal(dist.shape) * 10).to(dev)
    lams = torch.as_tensor(rng.standard_normal(lams.shape)).to(dev)
    assert torch.equal(ops.relax_round(dist, lams, gpu), tref.segment_relax_ref(dist, lams, gpu))
    b1, p1 = ops.relax_round_witness(dist, lams, gpu)
    b2, p2 = tref.segment_relax_witness_ref(dist, lams, gpu)
    assert torch.equal(b1, b2) and torch.equal(p1, p2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 70, 50, 90), (1, 150, 150, 1), (2, 1, 7, 129)])
def test_maxplus_products_bit_identical_on_the_card(shape):
    dev = _need_cuda()
    g, m, k, n = shape
    gen = torch.Generator(device="cpu").manual_seed(sum(shape))
    a = torch.randn(g, m, k, generator=gen)
    a[a > 1.5] = float("-inf")
    a, b = a.to(dev), torch.randn(g, k, n, generator=gen).to(dev)
    x = torch.randn(g, k, generator=gen).to(dev)
    assert torch.equal(ops.maxplus_bmm(a, b), tref.maxplus_bmm_ref(a, b))
    assert torch.equal(ops.maxplus_bmv(a, x), tref.maxplus_bmv_ref(a, x))
    assert torch.equal(ops.maxplus_matmul(a[0], b[0]), tref.maxplus_matmul_ref(a[0], b[0]))


@pytest.mark.cuda
def test_device_backends_match_host_on_the_card():
    dev = _need_cuda()
    snn = small_app(220, 2600, seed=11)
    cl = partition_greedy(snn, DYNAP_SE_16)
    app = sdfg_from_clusters(cl, hw=DYNAP_SE_16)
    order, _ = single_tile_order(cl, DYNAP_SE_16)
    b = np.random.default_rng(0).integers(0, 16, size=(8, app.n_actors))
    ob = tengine.project_order_batch(order, b)
    stack = tengine.stack_hardware_aware(app, b, DYNAP_SE_16, ob, relax_shortcuts=True)
    edges = tmp.mcr_batch(stack, backend="edges", device="cpu")
    np.testing.assert_allclose(tmp.mcr_batch(stack, device=dev), edges, rtol=1e-8)
    dense = tmp.mcr_batch(stack, backend="dense", device=dev)
    # K2/K3 are bit-exact, so the dense search takes the same path on the card
    np.testing.assert_array_equal(dense, tmp.mcr_batch(stack, backend="dense", device="cpu"))
    # the dense backend's own contract against the exact search (float32
    # squaring with a 1e-4 growth threshold; the reference tests 5e-4)
    np.testing.assert_allclose(dense, edges, rtol=5e-4)
    on_card = tengine.batch_execute(app, b, DYNAP_SE_16, ob, with_starts=True, device=dev)
    on_host = tengine.batch_execute(app, b, DYNAP_SE_16, ob, with_starts=True, device="cpu")
    np.testing.assert_allclose(on_card.periods, on_host.periods, rtol=1e-8)
    np.testing.assert_allclose(on_card.starts, on_host.starts, rtol=1e-4, atol=1e-4)
