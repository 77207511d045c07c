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
    qkv = torch.zeros((1, 2, 8, 64), device=a.device)
    scan = _scan_args(1, 40, 16, 8, torch.float32, a.device, chunk=16)
    return (
        lambda: ops.relax_round(dist, lams, csr),
        lambda: ops.relax_round_witness(dist, lams, csr),
        lambda: ops.maxplus_bmm(a, a),
        lambda: ops.maxplus_bmv(a, a[:, 0].contiguous()),
        lambda: ops.maxplus_matmul(a[0], a[0]),
        lambda: ops.flash_attention(qkv, qkv, qkv),
        lambda: ops.lif_crossbar_step(a[0], a[0], a[0]),
        lambda: ops.mamba_chunk_scan(*scan, chunk=16),
        lambda: ops.mamba_scan(*scan[:5], chunk=16),
    )


def _scan_args(b, length, d, n, dtype, dev, chunk, seed=0, h0_scale=0.0):
    """(x, dt, a, b, c, h0) of a chunk scan, seeded; h0 is ``h0_scale`` times
    a standard normal draw."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    nc = -(-length // chunk)
    x = torch.randn(b, length, d, generator=gen)
    dt = 0.01 + 0.1 * torch.rand(b, length, d, generator=gen)
    a = -torch.exp(torch.randn(d, n, generator=gen))
    bm = torch.randn(b, length, n, generator=gen)
    cm = torch.randn(b, length, n, generator=gen)
    h0 = h0_scale * torch.randn(b, nc, d, n, generator=gen)
    return (*(t.to(dev, dtype) for t in (x, dt)), a.to(dev),
            *(t.to(dev, dtype) for t in (bm, cm)), h0.to(dev))


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


def test_flash_attention_rejects_what_its_kernel_does_not_take(monkeypatch):
    """Checked before the build, so these raise here too (routing forced)."""
    monkeypatch.setattr(ops, "_on_cpu", lambda *ts: False)
    q = torch.zeros((1, 4, 8, 64))
    kv = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(q[..., :48], kv[..., :48], kv[..., :48])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(TypeError, match="one type"):
        ops.flash_attention(q, kv.bfloat16(), kv.bfloat16())
    with pytest.raises(ValueError, match="contiguous head"):
        ops.flash_attention(q, kv, kv.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.flash_attention(q, kv[:, :, :4], kv)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.flash_attention(q[:, :3], kv, kv)


def test_lif_and_scan_wrappers_reject_what_their_kernels_do_not_take(monkeypatch):
    """Checked before the build, so these raise here too (routing forced)."""
    monkeypatch.setattr(ops, "_on_cpu", lambda *ts: False)
    s, w, v = torch.zeros((8, 128)), torch.zeros((128, 64)), torch.zeros((8, 64))
    with pytest.raises(TypeError, match="float32"):
        ops.lif_crossbar_step(s.double(), w.double(), v.double())
    with pytest.raises(TypeError, match="float32"):
        ops.lif_crossbar_step(s.bfloat16(), w, v)
    with pytest.raises(ValueError, match="contiguous"):
        ops.lif_crossbar_step(s, w.t().contiguous().t(), v)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.lif_crossbar_step(s, w, v[:, :32])
    x, dt, a, b, c, h0 = _scan_args(1, 40, 16, 8, torch.float32, "cpu", chunk=16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.mamba_chunk_scan(x.half(), dt.half(), a, b.half(), c.half(), h0, chunk=16)
    with pytest.raises(TypeError, match="dt must be"):
        ops.mamba_chunk_scan(x, dt.bfloat16(), a, b, c, h0, chunk=16)
    with pytest.raises(TypeError, match="h0 must be"):
        ops.mamba_chunk_scan(x, dt, a, b, c, h0.bfloat16(), chunk=16)
    x4, dt4, a4, b4, c4, h04 = _scan_args(1, 40, 16, 4, torch.float32, "cpu", chunk=16)
    with pytest.raises(ValueError, match="state sizes"):
        ops.mamba_chunk_scan(x4, dt4, a4, b4, c4, h04, chunk=16)
    with pytest.raises(ValueError, match="chunk"):
        ops.mamba_chunk_scan(*_scan_args(1, 40, 16, 16, torch.float32, "cpu", chunk=512),
                             chunk=512)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.mamba_chunk_scan(x, dt, a, b, c, h0, chunk=8)
    with pytest.raises(ValueError, match="contiguous"):
        ops.mamba_chunk_scan(x, dt, a, b.transpose(1, 2).contiguous().transpose(1, 2), c, h0,
                             chunk=16)


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


# ======================================================================
# K6: flash attention against its plain version
# ======================================================================
FLASH_CASES = {
    # name: (b, hq, hkv, sq, skv, d, causal, window)
    "causal": (1, 2, 2, 128, 128, 64, True, 0),
    "ragged_gqa": (2, 4, 2, 200, 200, 64, True, 0),
    "mqa": (1, 8, 1, 384, 384, 128, True, 0),
    "d96": (1, 4, 2, 300, 300, 96, True, 0),
    "window": (1, 4, 2, 384, 384, 128, True, 64),
    "non_causal_ragged": (2, 4, 4, 130, 130, 64, False, 0),
    "non_causal_window": (1, 4, 2, 257, 257, 128, False, 100),
    "sq_ne_skv": (1, 2, 1, 70, 190, 64, True, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_matches_its_plain_version_on_the_card(case, dtype):
    dev = _need_cuda()
    b, hq, hkv, sq, skv, d, causal, window = FLASH_CASES[case]
    gen = torch.Generator(device="cpu").manual_seed(sq * d + hq)
    q = torch.randn(b, hq, sq, d, generator=gen).to(dev, dtype)
    k = torch.randn(b, hkv, skv, d, generator=gen).to(dev, dtype)
    v = torch.randn(b, skv, hkv, d, generator=gen).to(dev, dtype).transpose(1, 2)  # strided
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    plain = tref.attention_ref(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype and out.shape == q.shape and torch.isfinite(out).all()
    # within one rounding of the output type and 2^-14 of each row's size
    assert tref.attention_excess(out, plain) <= 1.0


@pytest.mark.cuda
def test_flash_attention_takes_unaligned_bf16_rows():
    """The tensor-core body loads 16-byte rows; the wrapper copies inputs
    whose rows are not aligned so, and the result is unchanged."""
    dev = _need_cuda()
    gen = torch.Generator(device="cpu").manual_seed(1)
    base = torch.randn(3, 1, 4, 100, 72, generator=gen).to(dev, torch.bfloat16)
    q, k, v = (base[i, :, :, :, 4:68] for i in range(3))   # rows 8 bytes off
    out = ops.flash_attention(q, k, v, causal=True)
    plain = tref.attention_ref(q, k, v, causal=True)
    assert tref.attention_excess(out, plain) <= 1.0
    aligned = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    assert torch.equal(out, aligned)


# ======================================================================
# K5: the LIF crossbar step, bit for bit
# ======================================================================
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128, 128), (3, 300, 200), (16, 96, 64), (37, 129, 65)])
def test_lif_crossbar_step_bit_identical_on_the_card(shape):
    dev = _need_cuda()
    b, n_in, n_out = shape
    gen = torch.Generator(device="cpu").manual_seed(b + n_in)
    s = (torch.rand(b, n_in, generator=gen) < 0.2).float().to(dev)
    w = torch.randn(n_in, n_out, generator=gen).to(dev)
    v = torch.randn(b, n_out, generator=gen).to(dev)
    before = ops.LAUNCHES["lif_crossbar_step"]
    out_s, out_v = ops.lif_crossbar_step(s, w, v)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["lif_crossbar_step"] == before + 1
    plain_s, plain_v = tref.lif_crossbar_step_ref(s, w, v)
    assert torch.equal(out_s, plain_s) and torch.equal(out_v, plain_v)
    # the exact threshold: 128 terms of 2^-7 sum to v_th and fire
    w0 = torch.zeros((128, 128), device=dev)
    w0[:, 0] = 1.0 / 128.0
    fired, reset = ops.lif_crossbar_step(torch.ones((8, 128), device=dev), w0,
                                         torch.zeros((8, 128), device=dev))
    assert (fired[:, 0] == 1).all() and (reset[:, 0] == 0).all() and (fired[:, 1:] == 0).all()


# ======================================================================
# K7: the chunk scan, within SCAN_TOL
# ======================================================================
SCAN_CASES = {
    # name: (b, length, d, n, chunk)
    "whole": (1, 128, 128, 8, 64),
    "two_batches": (2, 256, 256, 16, 128),
    "ragged_l_and_d": (1, 200, 130, 16, 64),
    "ragged_small": (2, 77, 200, 8, 32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_mamba_chunk_scan_matches_its_plain_version_on_the_card(case, dtype):
    dev = _need_cuda()
    b, length, d, n, chunk = SCAN_CASES[case]
    args = _scan_args(b, length, d, n, dtype, dev, chunk, seed=length + d, h0_scale=1.0)
    before = ops.LAUNCHES["mamba_chunk_scan"]
    y, h = ops.mamba_chunk_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mamba_chunk_scan"] == before + 1
    plain_y, plain_h = tref.mamba_chunk_scan_ref(*args, chunk=chunk)
    assert y.dtype == dtype and h.dtype == torch.float32 and torch.isfinite(y).all()
    assert tref.scan_excess(y, plain_y, chunk) <= 1.0
    rms = plain_h.square().mean(dim=-1, keepdim=True).sqrt()
    assert ((h - plain_h).abs() <= 2.0**-20 * plain_h.abs() + 2.0**-14 * rms).all()
    # the full scan: two launches around the combine, the card against the host
    full_y, full_h = ops.mamba_scan(*args[:5], chunk=chunk)
    assert ops.LAUNCHES["mamba_chunk_scan"] == before + 3
    host_y, _ = ops.mamba_scan(*(t.cpu() for t in args[:5]), chunk=chunk)
    assert tref.scan_excess(full_y.cpu(), host_y, chunk) <= 1.0 and full_h.shape == (b, d, n)
