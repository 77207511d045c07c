"""The port's CUDA kernels on the card, and the no-fallback rule.

Imports torch, numpy and the port only (no JAX), so it runs on a machine
with the card:  ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tests marked ``cuda`` skip where there is no CUDA device.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import engine as tengine
from repro_torch.core import lif as tlif
from repro_torch.core import maxplus as tmp
from repro_torch.core.apps import small_app
from repro_torch.core.hardware import DYNAP_SE_16
from repro_torch.core.partition import partition_greedy
from repro_torch.core.runtime import single_tile_order
from repro_torch.core.sdfg import sdfg_from_clusters
from repro_torch import configs as tconfigs
from repro_torch.data import DataConfig, TokenStream
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttf
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import tree_leaves, tree_map

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
    idx = torch.zeros((a.shape[1], 1), dtype=torch.int64, device=a.device)
    return (
        lambda: ops.relax_round(dist, lams, csr),
        lambda: ops.relax_round_witness(dist, lams, csr),
        lambda: ops.maxplus_bmm(a, a),
        lambda: ops.maxplus_bmv(a, a[:, 0].contiguous()),
        lambda: ops.maxplus_matmul(a[0], a[0]),
        lambda: ops.flash_attention(qkv, qkv, qkv),
        lambda: ops.lif_crossbar_step(a[0], a[0], a[0]),
        lambda: ops.mamba_chunk_scan(*scan, chunk=16),
        lambda: ops.mamba_chunk_states(*scan[:4], chunk=16),
        lambda: ops.mamba_chunk_combine(scan[1], scan[2], scan[5], chunk=16),
        lambda: ops.mamba_scan(*scan[:5], chunk=16),
        lambda: ops.mamba_scan_route(*scan[:5], chunk=16),
        lambda: ops.spike_input(a[0, 0], tlif.synapse_csr(
            np.array([0, 1]), np.array([1, 2]), np.ones(2), 4, a.device)),
        lambda: ops.lif_record(tlif.synapse_csr(
            np.array([0, 1]), np.array([1, 2]), np.ones(2), 4, a.device),
            torch.zeros(4, dtype=torch.bool, device=a.device), a[0, :3], tlif.LIFParams()),
        lambda: ops.moe_gate_up(a[0], idx, a, a, capacity=4),
        lambda: ops.moe_down(a[0], idx, a, capacity=4),
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


class _FakeFlashLib:
    """Stands in for the built library: records what the wrapper passes."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def flash_attention(self, q, k, v, o, is_bf16, b, hq, hkv, sq, skv, d, *rest):
        self.calls.append({"ptrs": (q, k, v), "is_bf16": is_bf16,
                           "shape": (b, hq, hkv, sq, skv, d), "strides": rest[:9],
                           "causal": rest[9], "window": rest[10]})
        return self.err


class _DeviceGuard:
    """Stands in for ``torch.cuda.device``: records the device each guard
    was entered with, and whether one is open."""

    def __init__(self):
        self.entered, self.open = [], 0

    def __call__(self, device):
        guard = self

        class _Ctx:
            def __enter__(self):
                guard.entered.append(device)
                guard.open += 1

            def __exit__(self, *exc):
                guard.open -= 1
                return False

        return _Ctx()


def _fake_flash(monkeypatch, err=0):
    lib = _FakeFlashLib(err)
    monkeypatch.setattr(ops, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(ops, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", _DeviceGuard())
    monkeypatch.setattr(_build, "library", lambda stem: lib)
    return lib


class _FakeLib:
    """Stands in for every built library: each C entry records its name, its
    arguments and the devices of the guards open when it was called."""

    def __init__(self, guard):
        self.calls, self.guard = [], guard

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((entry, args, list(self.guard.entered) if self.guard.open else None))
            return 0
        return call


def _fake_lib(monkeypatch):
    guard = _DeviceGuard()
    lib = _FakeLib(guard)
    monkeypatch.setattr(ops, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(ops, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(_build, "library", lambda stem: lib)
    return lib


def _wrapper_calls():
    """(wrapper, its call on small CPU operands) for every wrapper that
    launches a kernel, the operand each launch must run beside first."""
    csr, dist, lams, *_ = dyadic_csr(0, 2, 8, 8, 3)
    a = torch.zeros((2, 8, 8))
    qkv = torch.zeros((1, 2, 8, 64))
    scan = _scan_args(1, 40, 16, 8, torch.float32, "cpu", chunk=16)
    syn = tref.SynapseCSR(indptr=torch.tensor([0, 1, 2], dtype=torch.int32),
                          pre=torch.tensor([1, 0], dtype=torch.int32),
                          weight=torch.ones(2), post=torch.tensor([0, 1]))
    draws = torch.zeros((3, 2))
    idx = torch.zeros((8, 1), dtype=torch.int64)
    return {
        "relax_round": (dist, lambda: ops.relax_round(dist, lams, csr)),
        "relax_round_witness": (dist, lambda: ops.relax_round_witness(dist, lams, csr)),
        "maxplus_bmm": (a, lambda: ops.maxplus_bmm(a, a)),
        "maxplus_bmv": (a, lambda: ops.maxplus_bmv(a, a[:, 0].contiguous())),
        "maxplus_matmul": (a, lambda: ops.maxplus_matmul(a[0], a[0])),
        "flash_attention": (qkv, lambda: ops.flash_attention(qkv, qkv, qkv)),
        "lif_crossbar_step": (a, lambda: ops.lif_crossbar_step(a[0], a[0], a[0])),
        "mamba_chunk_scan": (scan[0], lambda: ops.mamba_chunk_scan(*scan, chunk=16)),
        "mamba_chunk_states": (scan[0], lambda: ops.mamba_chunk_states(*scan[:4], chunk=16)),
        "mamba_chunk_combine": (scan[1], lambda: ops.mamba_chunk_combine(
            scan[1], scan[2], scan[5], chunk=16)),
        "mamba_scan_route": (scan[0], lambda: ops.mamba_scan_route(*scan[:5], chunk=16)),
        "spike_input": (syn.weight, lambda: ops.spike_input(torch.ones(2), syn)),
        "lif_record": (draws, lambda: ops.lif_record(
            syn, torch.zeros(2, dtype=torch.bool), draws, tlif.LIFParams())),
        "moe_gate_up": (a[0], lambda: ops.moe_gate_up(a[0], idx, a, a, capacity=4)),
        "moe_down": (a[0], lambda: ops.moe_down(a[0], idx, a, capacity=4)),
    }


def test_every_launch_runs_under_its_operands_device(monkeypatch):
    """Each wrapper calls its C entry inside ``torch.cuda.device`` of its
    operands' device (a kernel launches on the current device), entered
    once per launch and closed after it; each launch is counted once."""
    lib = _fake_lib(monkeypatch)
    calls = _wrapper_calls()
    assert set(calls) == set(ops.LAUNCHES)
    for name, (operand, call) in calls.items():
        lib.calls.clear()
        lib.guard.entered.clear()
        before = dict(ops.LAUNCHES)
        call()
        assert [guards for _, _, guards in lib.calls] == [[operand.device]], name
        assert lib.guard.open == 0
        assert {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]} == {name: 1}


def test_scan_and_matvec_routes_reach_their_c_entries(monkeypatch):
    """``mamba_scan`` over more than one chunk: one launch of the route's C
    entry on x, dt, a, b and c as they lie (rows of 16-byte multiples), y
    and the last state (B, D, N) out, x's rows as their stride; over one
    chunk only the full launch of K7, from zero states (no h0 passed).
    ``maxplus_matmul`` at N = 1 is K2's C entry with G = 1 and N = 1, the
    matvec route inside it."""
    lib = _fake_lib(monkeypatch)
    x, dt, a, b, c, _ = _scan_args(2, 40, 16, 8, torch.bfloat16, "cpu", chunk=16)
    before = dict(ops.LAUNCHES)
    y, h = ops.mamba_scan(x, dt, a, b, c, chunk=16)
    (entry, route, _), = lib.calls
    assert entry == "mamba_scan_route"
    assert route[:5] == tuple(t.data_ptr() for t in (x, dt, a, b, c))
    assert route[5:7] == (y.data_ptr(), h.data_ptr()) and h.shape == (2, 16, 8)
    assert route[7:14] == (1, 2, 40, 16, 16, 8, 16)
    assert {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]} \
        == {"mamba_scan_route": 1}
    lib.calls.clear()
    ops.mamba_scan(*(t[:, :16].contiguous() for t in (x, dt)), a,
                   *(t[:, :16].contiguous() for t in (b, c)), chunk=16)
    (entry, one, _), = lib.calls
    assert entry == "mamba_chunk_scan" and one[5] is None and one[6] is not None
    lib.calls.clear()
    m = torch.zeros((150, 150))
    out = ops.maxplus_matmul(m, torch.zeros((150, 1)))
    (entry, args, _), = lib.calls
    assert entry == "maxplus_bmm" and args[3:7] == (1, 150, 1, 150) and out.shape == (150, 1)


def test_flash_attention_passes_tma_loadable_views_as_they_lie(monkeypatch):
    """Strided and transposed bf16 views whose strides are 16-byte multiples
    reach the kernel uncopied, with their own strides (the tensor maps
    take them); the launch is counted once."""
    lib = _fake_flash(monkeypatch)
    q = torch.zeros((2, 40, 4, 64), dtype=torch.bfloat16).transpose(1, 2)
    kv = torch.zeros((2, 56, 4, 64), dtype=torch.bfloat16)
    k, v = kv[:, :, :2].transpose(1, 2), kv[:, :, 2:].transpose(1, 2)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=False, window=9)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    (call,) = lib.calls
    assert call["ptrs"] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert call["strides"] == (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    assert call["shape"] == (2, 4, 2, 40, 56, 64) and call["is_bf16"] == 1
    assert (call["causal"], call["window"]) == (0, 9)
    assert out.shape == (2, 4, 40, 64) and out.is_contiguous() and out.dtype == torch.bfloat16


def test_flash_attention_copies_what_tma_cannot_load(monkeypatch):
    """A stride that is not a multiple of 16 bytes, or a base that is not
    16-byte aligned, is copied to a contiguous tensor in the wrapper (never
    routed elsewhere), in bf16 (TMA) and in float32 (16-byte cp.async); the
    stride of a dim of extent 1 does not matter; a float32 view whose rows
    are 16-byte aligned goes to its body uncopied."""
    lib = _fake_flash(monkeypatch)
    wide = torch.zeros((1, 2, 24, 68), dtype=torch.bfloat16)
    odd_rows = wide[..., :64]                       # row stride 136 bytes
    shifted = wide.flatten()[4:4 + 2 * 24 * 64].view(1, 2, 24, 64)   # base 8 bytes off
    ok = torch.zeros((1, 2, 24, 64), dtype=torch.bfloat16)
    one_head = torch.zeros((1, 24, 1, 64), dtype=torch.bfloat16).transpose(1, 2)
    one_head = one_head.as_strided(one_head.shape, (24 * 64, 3, 64, 1))   # odd h stride
    ops.flash_attention(odd_rows, ok, ok)
    ops.flash_attention(shifted, ok, ok)
    ops.flash_attention(ok, one_head, one_head)
    f32 = torch.zeros((1, 2, 24, 72))[..., :64]
    ops.flash_attention(f32, f32, f32)
    f32_odd_rows = torch.zeros((1, 2, 24, 66))[..., :64]           # row stride 264 bytes
    f32_shifted = torch.zeros(2 * 24 * 64 + 1)[1:].view(1, 2, 24, 64)   # base 4 bytes off
    ops.flash_attention(f32_odd_rows, f32, f32_shifted)
    (c1, c2, c3, c4, c5) = lib.calls
    assert c1["ptrs"][0] != odd_rows.data_ptr() and c1["strides"][:3] == (2 * 24 * 64, 24 * 64, 64)
    assert c1["ptrs"][1:] == (ok.data_ptr(), ok.data_ptr())
    assert c2["ptrs"][0] != shifted.data_ptr() and c2["ptrs"][0] % 16 == 0
    assert c3["ptrs"][1:] == (one_head.data_ptr(), one_head.data_ptr())
    assert c3["strides"][3:6] == (24 * 64, 3, 64)
    assert c4["ptrs"][0] == f32.data_ptr() and c4["is_bf16"] == 0
    assert c4["strides"][:3] == f32.stride()[:3]
    assert c5["ptrs"][0] != f32_odd_rows.data_ptr() and c5["ptrs"][1] == f32.data_ptr()
    assert c5["strides"][:3] == (2 * 24 * 64, 24 * 64, 64) and c5["ptrs"][2] % 16 == 0
    assert c5["ptrs"][2] != f32_shifted.data_ptr() and c5["is_bf16"] == 0


def test_flash_attention_raises_on_a_failed_launch(monkeypatch):
    """A nonzero cudaError_t (a tensor map the driver refused, a launch the
    card refused) raises and is not counted."""
    _fake_flash(monkeypatch, err=12)
    q = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    before = ops.LAUNCHES["flash_attention"]
    with pytest.raises(RuntimeError, match="flash_attention failed with cudaError_t 12"):
        ops.flash_attention(q, q, q)
    assert ops.LAUNCHES["flash_attention"] == before


def test_library_name_hashes_the_headers_a_source_includes(monkeypatch, tmp_path):
    """Editing csrc/hopper.cuh renames flash_attention's library, so a stale
    build is never loaded; a source that includes no header keeps its name."""
    for name in ("flash_attention.cu", "hopper.cuh", "lif_crossbar.cu"):
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build._headers(tmp_path / "flash_attention.cu") == [tmp_path / "hopper.cuh"]
    assert _build._headers(tmp_path / "lif_crossbar.cu") == []
    flash, lif = _build._lib_path("flash_attention"), _build._lib_path("lif_crossbar")
    with open(tmp_path / "hopper.cuh", "a") as f:
        f.write("// edited\n")
    assert _build._lib_path("flash_attention") != flash
    assert _build._lib_path("lif_crossbar") == lif


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


#: in-degrees of the skewed CSR: none, one, and for every power-of-two
#: team width T from 2 to 32 exactly T and 3T + 1, beside several hundred
SKEWED_DEGREES = (0, 1, 2, 4, 7, 8, 13, 16, 25, 32, 49, 97, 300)


def _skewed_csr(k: int, seed: int):
    """A two-row CSR whose in-degrees cycle through :data:`SKEWED_DEGREES`,
    with many equal candidates from different sources (small integer dist,
    w and t) and nodes whose every candidate is -inf (all their sources
    have dist -inf)."""
    rng = np.random.default_rng(seed)
    n_actors, rows = 52, 2
    n = rows * n_actors
    degrees = np.array([SKEWED_DEGREES[i % len(SKEWED_DEGREES)] for i in range(n)])
    dst = np.repeat(np.arange(n), degrees)
    row = dst // n_actors
    dead = np.zeros(n, dtype=bool)
    dead[rng.choice(n, n // 5, replace=False)] = True
    src = row * n_actors + rng.integers(0, n_actors, dst.size)
    # every fifth node that has edges draws its sources from the dead nodes
    for v in np.flatnonzero(degrees)[::5]:
        pool = np.flatnonzero(dead[v // n_actors * n_actors:(v // n_actors + 1) * n_actors])
        src[dst == v] = v // n_actors * n_actors + rng.choice(pool, degrees[v])
    w = rng.integers(0, 2, dst.size).astype(np.float64)
    t = rng.integers(0, 2, dst.size).astype(np.float64)
    dist = rng.integers(0, 3, (n, k)).astype(np.float64)
    dist[dead] = -np.inf
    lams = rng.integers(0, 2, (rows, k)).astype(np.float64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(degrees, out=indptr[1:])
    csr = tref.RelaxCSR(
        n_actors=n_actors, indptr=torch.as_tensor(indptr, dtype=torch.int32),
        src=torch.as_tensor(src, dtype=torch.int32), w=torch.as_tensor(w),
        t=torch.as_tensor(t), dst=torch.as_tensor(dst), dst_row=torch.as_tensor(row))
    return csr, torch.as_tensor(dist), torch.as_tensor(lams)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k", [1, 3])
def test_relax_round_bit_identical_on_skewed_degrees(k, seed):
    """K1 and K1w on skewed in-degrees (a team's width, more than a pass
    of its lanes, several hundred), ties and all--inf nodes: values and
    psrc equal to the plain versions."""
    dev = _need_cuda()
    csr, dist, lams = _skewed_csr(k, seed)
    gpu, dist, lams = _to(csr, dev), dist.to(dev), lams.to(dev)
    before = dict(ops.LAUNCHES)
    best = ops.relax_round(dist, lams, gpu)
    b1, p1 = ops.relax_round_witness(dist, lams, gpu)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["relax_round"] == before["relax_round"] + 1
    assert ops.LAUNCHES["relax_round_witness"] == before["relax_round_witness"] + 1
    plain = tref.segment_relax_ref(dist, lams, gpu)
    b2, p2 = tref.segment_relax_witness_ref(dist, lams, gpu)
    assert torch.equal(best, plain) and torch.equal(b1, b2) and torch.equal(p1, p2)
    # the input exercises what it claims: ties, all--inf nodes with edges
    cand = tref._candidates(dist, lams, gpu)
    has_in = torch.diff(gpu.indptr.long()) > 0
    assert int((cand == b2[gpu.dst]).sum()) > int(has_in.sum()) * k
    assert bool((torch.isneginf(b2) & has_in[:, None] & (p2 >= 0)).any())


#: (G, M, K, N): ragged tiles and K tails on the 4-byte and the 16-byte copy
#: paths, the dense path's (64,192,192)^2 (384 blocks over 132 SMs) and a
#: stack whose last wave is one block, K4's matvec (N = 1) and K = 0
MAXPLUS_SHAPES = [(3, 70, 50, 90), (1, 150, 150, 1), (2, 1, 7, 129), (64, 192, 192, 192),
                  (5, 97, 193, 131), (2, 200, 36, 260), (133, 96, 20, 64), (4, 33, 0, 8),
                  (3, 70, 51, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MAXPLUS_SHAPES)
def test_maxplus_products_bit_identical_on_the_card(shape):
    dev = _need_cuda()
    g, m, k, n = shape
    gen = torch.Generator(device="cpu").manual_seed(sum(shape))
    a = torch.randn(g, m, k, generator=gen)
    a[a > 1.5] = float("-inf")
    # B and x mostly negative, so most maxima are too: a tile or K tail padded
    # with anything but -inf would show
    a, b = a.to(dev), (torch.randn(g, k, n, generator=gen) - 4.0).to(dev)
    x = (torch.randn(g, k, generator=gen) - 4.0).to(dev)
    before = dict(ops.LAUNCHES)
    assert torch.equal(ops.maxplus_bmm(a, b), tref.maxplus_bmm_ref(a, b))
    assert torch.equal(ops.maxplus_bmv(a, x), tref.maxplus_bmv_ref(a, x))
    assert torch.equal(ops.maxplus_matmul(a[0], b[0]), tref.maxplus_matmul_ref(a[0], b[0]))
    torch.cuda.synchronize()
    assert all(ops.LAUNCHES[name] == before[name] + 1
               for name in ("maxplus_bmm", "maxplus_bmv", "maxplus_matmul"))


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


def _ragged_member_stacks():
    """Three apps' candidate stacks of different (B, n, E), and a small
    stack whose second row holds a zero-token (deadlocked) cycle."""
    stacks = []
    for seed, neurons, rows in ((21, 300, 3), (22, 1200, 5), (23, 700, 2)):
        snn = small_app(neurons, 12 * neurons, seed=seed)
        cl = partition_greedy(snn, DYNAP_SE_16)
        app = sdfg_from_clusters(cl, hw=DYNAP_SE_16)
        order, _ = single_tile_order(cl, DYNAP_SE_16)
        b = np.random.default_rng(seed).integers(0, 16, size=(rows, app.n_actors))
        ob = tengine.project_order_batch(order, b)
        stacks.append(tengine.stack_hardware_aware(app, b, DYNAP_SE_16, ob,
                                                   relax_shortcuts=True))
    src = np.array([[0, 1, 2, 0], [0, 1, 2, 0]])
    dst = np.array([[1, 2, 0, 0], [1, 2, 0, 0]])
    tok = np.array([[0, 0, 1, 1], [0, 0, 0, 1]])
    w = np.array([[2.0, 3.0, 1.5, 0.5], [2.0, 3.0, 1.5, 0.5]])
    stacks.append(tmp.EdgeStack(n_actors=3, src=src, dst=dst, tokens=tok, weights=w))
    return stacks


@pytest.mark.cuda
@pytest.mark.parametrize("detect_deadlock", [False, True], ids=["k1", "k1w_deadlock"])
def test_fused_stack_rows_solve_alone_on_the_card(detect_deadlock):
    """A fused stack of ragged members (-inf edge padding, isolated padded
    actors) through K1 and K1w: each member's rows equal its own card
    solve and the host's plain "csr" bit for bit."""
    dev = _need_cuda()
    members = _ragged_member_stacks()
    fused, slices = tengine.fuse_stacks(members)
    assert np.isneginf(fused.weights).any() and fused.n_actors > members[0].n_actors
    before = ops.LAUNCHES["relax_round"], ops.LAUNCHES["relax_round_witness"]
    got = tmp.mcr_batch(fused, device=dev, detect_deadlock=detect_deadlock)
    assert ops.LAUNCHES["relax_round"] > before[0]
    assert ops.LAUNCHES["relax_round_witness"] > before[1]
    host = tmp.mcr_batch(fused, device="cpu", detect_deadlock=detect_deadlock)
    np.testing.assert_array_equal(got, host)
    for m, s in zip(members, slices):
        np.testing.assert_array_equal(got[s], tmp.mcr_batch(
            m, device=dev, detect_deadlock=detect_deadlock))
        edges = tmp.mcr_batch(m, backend="edges", device="cpu",
                              detect_deadlock=detect_deadlock)
        np.testing.assert_allclose(got[s], edges, rtol=1e-8)
    if detect_deadlock:
        assert np.isinf(got[slices[-1]][1]) and np.isfinite(got[slices[-1]][0])


def _candidate_stack(seed, neurons, rows):
    snn = small_app(neurons, 12 * neurons, seed=seed)
    cl = partition_greedy(snn, DYNAP_SE_16)
    app = sdfg_from_clusters(cl, hw=DYNAP_SE_16)
    order, _ = single_tile_order(cl, DYNAP_SE_16)
    b = np.random.default_rng(seed).integers(0, 16, size=(rows, app.n_actors))
    ob = tengine.project_order_batch(order, b)
    return tengine.stack_hardware_aware(app, b, DYNAP_SE_16, ob, relax_shortcuts=True)


@pytest.mark.cuda
@pytest.mark.parametrize("neurons,rows", [(300, 13), (1200, 64)])
def test_sharded_solve_on_streams_of_one_card(monkeypatch, neurons, rows):
    """Row chunks on streams of one card (k dividing B or not), each run
    twice, equal the unsharded card solve bit for bit; every chunk's K1
    launches go to a stream of its own, not the default stream."""
    dev = _need_cuda()
    stack = _candidate_stack(neurons, neurons, rows)
    ref = tmp.mcr_batch(stack, device=dev)
    np.testing.assert_array_equal(ref, tmp.mcr_batch(stack, device="cpu"))
    streams = []
    stream_of = ops._stream

    def spy(t):
        streams.append(stream_of(t))
        return streams[-1]

    monkeypatch.setattr(ops, "_stream", spy)
    default = torch.cuda.default_stream(dev).cuda_stream
    for k in (2, 3, 4, 7):
        for _ in range(2):
            streams.clear()
            got = tmp.mcr_batch(stack, devices=[dev] * k)
            np.testing.assert_array_equal(got, ref)
            assert len(set(streams)) == k and default not in streams
    dd = tmp.mcr_batch(stack, device=dev, detect_deadlock=True)
    np.testing.assert_array_equal(
        tmp.mcr_batch(stack, devices=[dev] * 3, detect_deadlock=True), dd)


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


#: bf16 cases at the edges of the TMA ring (64-key tiles, 3 stages, 128 q
#: rows a block); q, k and v are strided views of packed (b, s, h, d) tensors
FLASH_PIPELINE_CASES = {
    # name: (b, hq, hkv, sq, skv, d, causal, window)
    "kv_shorter_than_a_stage": (1, 4, 2, 100, 40, 128, True, 0),
    "ring_wraps": (1, 4, 1, 1100, 1100, 128, True, 0),
    "ragged_tiles_non_causal": (1, 2, 2, 333, 461, 64, False, 0),
    "window_narrower_than_a_tile": (1, 4, 2, 500, 500, 128, True, 24),
    "batch_strided_kv": (3, 8, 2, 260, 260, 128, True, 0),
    "d96_ring_wraps": (1, 4, 2, 1200, 1200, 96, True, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FLASH_PIPELINE_CASES))
def test_flash_attention_pipeline_edges_on_the_card(case):
    dev = _need_cuda()
    b, hq, hkv, sq, skv, d, causal, window = FLASH_PIPELINE_CASES[case]
    gen = torch.Generator(device="cpu").manual_seed(7 * sq + skv + d)
    q = torch.randn(b, sq, hq, d, generator=gen).to(dev, torch.bfloat16).transpose(1, 2)
    kv = torch.randn(b, skv, 2 * hkv, d, generator=gen).to(dev, torch.bfloat16)
    k, v = kv[:, :, :hkv].transpose(1, 2), kv[:, :, hkv:].transpose(1, 2)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    plain = tref.attention_ref(q, k, v, causal=causal, window=window)
    assert out.shape == (b, hq, sq, d) and torch.isfinite(out).all()
    assert tref.attention_excess(out, plain) <= 1.0


#: float32 cases at the edges of the 3xTF32 body's tiles (64 q rows a block,
#: a ring of two 64-key cp.async stages, 32-column P V passes) and the train
#: step's call; q, k and v are strided views of packed (b, s, h, d) tensors
FLASH_F32_EDGE_CASES = {
    # name: (b, hq, hkv, sq, skv, d, causal, window)
    "kv_shorter_than_a_stage": (1, 4, 2, 100, 40, 128, True, 0),
    "ring_wraps": (1, 4, 1, 700, 700, 128, True, 0),
    "window_narrower_than_a_tile": (1, 4, 2, 300, 300, 128, True, 24),
    "d96_ring_wraps": (1, 4, 2, 400, 400, 96, True, 0),
    "d64_ragged_non_causal": (2, 2, 2, 150, 333, 64, False, 0),
    "sq_ne_skv": (1, 4, 2, 70, 333, 128, True, 0),
    "batch_strided_kv": (3, 8, 2, 260, 260, 128, True, 0),
    "train_call": (8, 12, 2, 256, 256, 128, True, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FLASH_F32_EDGE_CASES))
def test_flash_attention_float32_tile_edges_on_the_card(case):
    dev = _need_cuda()
    b, hq, hkv, sq, skv, d, causal, window = FLASH_F32_EDGE_CASES[case]
    gen = torch.Generator(device="cpu").manual_seed(5 * sq + skv + d)
    q = torch.randn(b, sq, hq, d, generator=gen).to(dev).transpose(1, 2)
    kv = torch.randn(b, skv, 2 * hkv, d, generator=gen).to(dev)
    k, v = kv[:, :, :hkv].transpose(1, 2), kv[:, :, hkv:].transpose(1, 2)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    plain = tref.attention_ref(q, k, v, causal=causal, window=window)
    assert out.dtype == torch.float32 and out.shape == (b, hq, sq, d)
    assert torch.isfinite(out).all()
    assert tref.attention_excess(out, plain) <= 1.0


@pytest.mark.cuda
def test_flash_attention_takes_unaligned_float32_rows():
    """The float32 body loads 16-byte pieces of rows by cp.async; the
    wrapper copies inputs whose rows are not aligned so, and the result is
    unchanged."""
    dev = _need_cuda()
    gen = torch.Generator(device="cpu").manual_seed(2)
    base = torch.randn(3, 1, 4, 100, 66, generator=gen).to(dev)
    q, k, v = (base[i, :, :, :, 1:65] for i in range(3))   # rows 4 bytes off
    out = ops.flash_attention(q, k, v, causal=True)
    plain = tref.attention_ref(q, k, v, causal=True)
    assert tref.attention_excess(out, plain) <= 1.0
    aligned = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    assert torch.equal(out, aligned)


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


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 37])
@pytest.mark.parametrize("g", [1, 7, 40, 150])
def test_stacked_lif_crossbar_step_bit_identical_on_the_card(g, b):
    """One launch per stacked call over G blocks, ragged B, n_in and n_out
    (the 4-byte copy path where n_out is not a multiple of 4, and for a W
    that is not 16-byte aligned); G = 150 fills the SMs, so a thread
    keeps 8 rows there, 4 in the smaller stacks."""
    dev = _need_cuda()
    for n_in in (128, 129, 65):
        for n_out in (128, 129, 65):
            gen = torch.Generator(device="cpu").manual_seed(g * b + n_in + n_out)
            s = (torch.rand(g, b, n_in, generator=gen) < 0.2).float().to(dev)
            w = (0.3 * torch.randn(g, n_in, n_out, generator=gen)).to(dev)
            v = torch.randn(g, b, n_out, generator=gen).to(dev)
            unaligned = torch.empty(w.numel() + 1, device=dev)[1:].view(w.shape)
            unaligned.copy_(w)
            plain_s, plain_v = tref.lif_crossbar_step_ref(s, w, v, leak=0.8, v_th=0.5)
            for weights in (w, unaligned):
                before = ops.LAUNCHES["lif_crossbar_step"]
                out_s, out_v = ops.lif_crossbar_step(s, weights, v, leak=0.8, v_th=0.5)
                torch.cuda.synchronize()
                assert ops.LAUNCHES["lif_crossbar_step"] == before + 1
                assert torch.equal(out_s, plain_s) and torch.equal(out_v, plain_v), \
                    (g, b, n_in, n_out, weights.data_ptr() % 16)
            assert plain_s.sum() > 0


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
    # the full scan (the route's one launch over more than one chunk, K7
    # from zeros over one), against the host's and the sequential scan
    counts = dict(ops.LAUNCHES)
    full_y, full_h = ops.mamba_scan(*args[:5], chunk=chunk)
    torch.cuda.synchronize()
    assert {k: v - counts[k] for k, v in ops.LAUNCHES.items() if v != counts[k]} == (
        {"mamba_scan_route": 1} if length > chunk else {"mamba_chunk_scan": 1})
    host_y, _ = ops.mamba_scan(*(t.cpu() for t in args[:5]), chunk=chunk)
    assert tref.scan_excess(full_y.cpu(), host_y, chunk) <= 1.0 and full_h.shape == (b, d, n)
    seq_y, seq_h = tref.mamba_scan_ref(*args[:5])
    assert tref.scan_excess(full_y, seq_y, chunk) <= 1.0
    assert tref.state_excess(full_h, seq_h) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_mamba_states_and_combine_on_the_card(case, dtype):
    """The states-only launch gives the full launch's states from zero bit
    for bit, and the plain version's; the combine launch stays within the
    state's tolerance of its plain version."""
    dev = _need_cuda()
    b, length, d, n, chunk = SCAN_CASES[case]
    x, dt, a, bm, cm, h0 = _scan_args(b, length, d, n, dtype, dev, chunk, seed=2 * length + d)
    zeros = torch.zeros_like(h0)
    states = ops.mamba_chunk_states(x, dt, a, bm, chunk=chunk)
    full_h = torch.empty_like(h0)
    ops._scan_launch(x, dt, a, bm, cm, zeros, torch.empty_like(x), full_h, chunk,
                     "mamba_chunk_scan")
    torch.cuda.synchronize()
    assert torch.equal(states, full_h)
    plain = tref.mamba_chunk_scan_ref(x, dt, a, bm, cm, zeros, chunk=chunk)[1]
    assert tref.state_excess(states, plain) == 0.0
    before = ops.LAUNCHES["mamba_chunk_combine"]
    h_init = ops.mamba_chunk_combine(dt, a, states, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mamba_chunk_combine"] == before + 1
    assert torch.equal(h_init[:, 0], torch.zeros_like(h_init[:, 0]))
    assert tref.state_excess(h_init, tref.mamba_combine_ref(dt, a, states, chunk=chunk)) <= 1.0


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (-0 is not +0), float32 or bf16."""
    as_int = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(as_int), b.view(as_int))


#: K7's body at one chunk and from given states: (b, length, d, n, chunk,
#: chunks of a random h0 or None for zero states, edge values: -0 in x and
#: decays that underflow to subnormals and to 0).  At N = 16 a channel takes
#: two lanes where the grid is small, one where it is large (b17, k1).
K7_CASES = {
    "l1_d8_n8": (1, 1, 8, 8, 128, None, False),
    "l5_d130": (3, 5, 130, 16, 128, None, True),
    "l16_d8192": (2, 16, 8192, 16, 16, None, False),
    "l31_d130_n8": (5, 31, 130, 8, 32, None, True),
    "l32_d8192_b8": (8, 32, 8192, 16, 128, None, False),
    "l128_d130_b32": (32, 128, 130, 16, 128, None, True),
    "h0_one_chunk": (2, 32, 130, 16, 128, 1, True),
    "h0_two_chunks_n8": (3, 31, 8192, 8, 16, 2, False),
    "h0_four_chunks": (1, 128, 8192, 16, 32, 4, True),
    "h0_four_ragged_n8": (2, 100, 8, 8, 32, 4, True),
    "l128_d8192_b17": (17, 128, 8192, 16, 128, None, False),
    "h0_four_ragged_k1": (5, 100, 8192, 16, 32, 4, True),
}


@pytest.mark.cuda
def test_k7_cases_take_one_and_two_lanes_a_channel_on_the_card():
    _need_cuda()
    lanes = _build.library("mamba_scan").mamba_chunk_scan_lanes
    taken = {case: lanes(b, length, d, n, chunk)
             for case, (b, length, d, n, chunk, *_) in K7_CASES.items()}
    assert {v for case, v in taken.items() if K7_CASES[case][3] == 16} == {1, 2}, taken
    assert {v for case, v in taken.items() if K7_CASES[case][3] == 8} == {1}, taken


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(K7_CASES))
def test_k7_bit_identical_to_its_plain_version_and_the_route_on_the_card(case, dtype):
    """K7's full and states-only launches, from zero states (no h0 read)
    and from given ones, equal the plain version bit for bit; at one chunk
    from zero ``mamba_scan`` (K7) and the route's one launch equal it too."""
    dev = _need_cuda()
    b, length, d, n, chunk, h0_chunks, edges = K7_CASES[case]
    assert h0_chunks in (None, -(-length // chunk))
    x, dt, a, bm, cm, h0 = _scan_args(b, length, d, n, dtype, dev, chunk, seed=5 * length + d,
                                      h0_scale=1.0)
    if edges:
        x.view(-1)[::7] = -0.0
        a.view(-1)[::5] = -1e4
    start = None if h0_chunks is None else h0
    before = dict(ops.LAUNCHES)
    y, h = ops.mamba_chunk_scan(x, dt, a, bm, cm, start, chunk=chunk)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]} \
        == {"mamba_chunk_scan": 1}
    plain_y, plain_h = tref.mamba_chunk_scan_ref(
        x, dt, a, bm, cm, torch.zeros_like(h0) if start is None else h0, chunk=chunk)
    assert _same_bits(y, plain_y) and _same_bits(h, plain_h)
    states = torch.empty_like(h)
    ops._scan_launch(x, dt, a, bm, None, start, None, states, chunk, "mamba_chunk_states")
    torch.cuda.synchronize()
    assert _same_bits(states, h)
    if start is None:
        assert _same_bits(ops.mamba_chunk_states(x, dt, a, bm, chunk=chunk), h)
    if start is None and length <= chunk:
        for sy, sh in (ops.mamba_scan(x, dt, a, bm, cm, chunk=chunk),
                       ops.mamba_scan_route(x, dt, a, bm, cm, chunk=chunk)):
            assert _same_bits(sy, y) and _same_bits(sh, h[:, -1])


#: the route's own cases beside SCAN_CASES: 32 chunks, two batch rows at
#: N = 8 with a ragged last chunk, and chunks that start inside its tiles
ROUTE_CASES = {**SCAN_CASES, "chunks_32": (1, 4096, 256, 16, 128),
               "two_rows_n8": (2, 300, 96, 8, 32), "chunk_24": (1, 150, 64, 16, 24)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_mamba_scan_route_equals_the_three_launches_on_the_card(case, dtype):
    """The route's one launch gives the three launches' y and last state
    (the states pass, the combine, K7 from the combined states) bit for
    bit, and lies within SCAN_TOL of the plain route and of the sequential
    scan."""
    dev = _need_cuda()
    b, length, d, n, chunk = ROUTE_CASES[case]
    x, dt, a, bm, cm, _ = _scan_args(b, length, d, n, dtype, dev, chunk, seed=3 * length + d)
    before = ops.LAUNCHES["mamba_scan_route"]
    y, h = ops.mamba_scan_route(x, dt, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mamba_scan_route"] == before + 1
    states = ops.mamba_chunk_states(x, dt, a, bm, chunk=chunk)
    y3, h3 = ops.mamba_chunk_scan(x, dt, a, bm, cm,
                                  ops.mamba_chunk_combine(dt, a, states, chunk=chunk), chunk=chunk)
    assert y.dtype == dtype and h.shape == (b, d, n) and torch.isfinite(y).all()
    assert torch.equal(y, y3) and torch.equal(h, h3[:, -1])
    plain_y, plain_h = tref.mamba_route_ref(x, dt, a, bm, cm, chunk=chunk)
    assert tref.scan_excess(y, plain_y, chunk) <= 1.0 and tref.state_excess(h, plain_h) <= 1.0
    seq_y, seq_h = tref.mamba_scan_ref(x, dt, a, bm, cm)
    assert tref.scan_excess(y, seq_y, chunk) <= 1.0 and tref.state_excess(h, seq_h) <= 1.0


def test_route_copies_rows_tma_cannot_load(monkeypatch):
    """x and dt rows that are no 16-byte multiple (D = 20 in bf16) reach the
    route's C entry as padded copies (row stride 24, the first D columns
    equal); B and C, and rows that TMA loads, go as they lie."""
    lib = _fake_lib(monkeypatch)
    x, dt, a, b, c, _ = _scan_args(1, 40, 20, 8, torch.bfloat16, "cpu", chunk=16)
    ops.mamba_scan_route(x, dt, a, b, c, chunk=16)
    (entry, args, _), = lib.calls
    assert entry == "mamba_scan_route" and args[10:12] == (20, 24)
    assert args[0] != x.data_ptr() and args[1] != dt.data_ptr()
    assert args[2:5] == (a.data_ptr(), b.data_ptr(), c.data_ptr())
    xs, ld = ops._tma_rows(x)
    assert ld == 24 and xs.shape == (1, 40, 24) and torch.equal(xs[..., :20], x)
    assert ops._tma_rows(x[..., :16].contiguous())[0].shape == (1, 40, 16)


# ======================================================================
# the spike recording's synaptic input, bit for bit
# ======================================================================
@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_spike_input_bit_identical_twice_on_the_card(seed):
    """In-degrees from 0 to several thousand (more than a warp's pass),
    signed weights: every neuron's input equals the CPU's index_add_ over
    the unsorted synapses, in two runs on the card."""
    dev = _need_cuda()
    rng = np.random.default_rng(seed)
    n, e = 3000, 300_000
    post = rng.integers(0, n - 10, e)
    post[:5000] = 7                               # one neuron with 5000 synapses
    pre = rng.integers(0, n, e)
    w = rng.standard_normal(e).astype(np.float32)
    s = torch.as_tensor((rng.random(n) < 0.3).astype(np.float32))
    host = torch.zeros(n).index_add_(0, torch.as_tensor(post), torch.as_tensor(w) * s[pre])
    csr = tlif.synapse_csr(pre, post, w, n, dev)
    assert torch.equal(tref.spike_input_ref(s, tlif.synapse_csr(pre, post, w, n, "cpu")), host)
    before = ops.LAUNCHES["spike_input"]
    first, second = ops.spike_input(s.to(dev), csr), ops.spike_input(s.to(dev), csr)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["spike_input"] == before + 2
    assert torch.equal(first.cpu(), host) and torch.equal(second, first)


def test_lif_record_passes_its_operands_and_raises_on_a_refused_launch(monkeypatch):
    """The C entry gets the CSR, is_input's bytes (a uint8 view of the bool
    tensor's storage), the draws, the three outputs, n, n_steps and the
    parameters as Python numbers (c_float for ctypes); a recording of no
    steps launches nothing; what the kernel does not take raises before the
    build; a refused cooperative launch (cudaErrorCooperativeLaunchTooLarge,
    720) raises and is not counted, and nothing falls back."""
    lib = _fake_lib(monkeypatch)
    csr, is_input = tlif.snn_tensors(small_app(70, 500, seed=2), "cpu")
    n = csr.n_neurons
    draws = torch.rand((9, n))
    params = tlif.LIFParams(refractory=3, v_reset=-0.25)
    before = ops.LAUNCHES["lif_record"]
    counts, v, refr = ops.lif_record(csr, is_input, draws, params)
    (entry, args, _), = lib.calls
    assert entry == "lif_record" and ops.LAUNCHES["lif_record"] == before + 1
    assert args[:8] == (csr.indptr.data_ptr(), csr.pre.data_ptr(), csr.weight.data_ptr(),
                        is_input.data_ptr(), draws.data_ptr(), counts.data_ptr(),
                        v.data_ptr(), refr.data_ptr())
    assert args[9:] == (n, int(csr.pre.numel()), 9, 1.0, -0.25, 0.9, 3, 0.08, 0)
    assert (counts.dtype, v.dtype, refr.dtype) == (torch.float32, torch.float32, torch.int32)
    lib.calls.clear()
    counts, v, refr = ops.lif_record(csr, is_input, draws[:0], params)
    assert lib.calls == [] and not counts.any() and not v.any() and not refr.any()
    with pytest.raises(TypeError, match="is_input must be"):
        ops.lif_record(csr, is_input.to(torch.uint8), draws, params)
    with pytest.raises(TypeError, match="draws must be"):
        ops.lif_record(csr, is_input, draws.double(), params)
    monkeypatch.setattr(_build, "library", lambda stem: type(
        "Refusing", (), {"lif_record": staticmethod(lambda *a: 720)}))
    with pytest.raises(RuntimeError, match="lif_record failed with cudaError_t 720"):
        ops.lif_record(csr, is_input, draws, params)
    assert ops.LAUNCHES["lif_record"] == before + 1


def _assert_same_bits_nan_where_nan(got: torch.Tensor, want: torch.Tensor):
    """Equal bit for bit, except that a NaN need only be a NaN (the card's
    NaN is canonical, the host's keeps a payload)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("spikes", ["zero", "one", "negative_zero", "non_finite", "general"])
def test_spike_input_skips_only_zero_products_on_the_card(spikes):
    """The walk over nonzero products against the host's sum of every
    product: s all 0, all 1, -0 (with signed weights, so products of both
    zero signs), with inf and NaN, and general floats; every bit equal, a
    NaN where the host has one."""
    dev = _need_cuda()
    rng = np.random.default_rng(3)
    n, e = 2000, 200_000
    post = rng.integers(0, n - 5, e)
    post[:3000] = 11
    pre = rng.integers(0, n, e)
    w = rng.standard_normal(e).astype(np.float32)
    s = {"zero": np.zeros(n), "one": np.ones(n),
         "negative_zero": np.where(rng.random(n) < 0.5, -0.0, 0.0),
         "non_finite": np.where(rng.random(n) < 0.3, 1.0, 0.0),
         "general": np.where(rng.random(n) < 0.5, rng.uniform(-3, 3, n), 0.0)}[spikes]
    s = torch.as_tensor(s.astype(np.float32))
    if spikes == "non_finite":
        s[[3, 50]], s[[8, 90]] = float("inf"), float("nan")
    host = tref.spike_input_ref(s, tlif.synapse_csr(pre, post, w, n, "cpu"))
    card = ops.spike_input(s.to(dev), tlif.synapse_csr(pre, post, w, n, dev)).cpu()
    _assert_same_bits_nan_where_nan(card, host)
    if spikes in ("zero", "negative_zero"):
        assert torch.equal(card.view(torch.int32), torch.zeros(n, dtype=torch.int32))


#: the recording's card test, run in a child process: a grid barrier that
#: never opens would hang the card, and the child's timeout ends it
LIF_RECORD_CHILD = r"""
import ctypes
import json
import numpy as np
import torch
from repro_torch.core import lif as tlif
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref

CASES = {  # name: (neurons, synapses, steps, LIFParams fields)
    "ragged": (3007, 300_000, 64, {}),
    "refractory_0": (3007, 300_000, 64, {"refractory": 0}),
    "refractory_3_reset": (3007, 300_000, 64, {"refractory": 3, "v_reset": -0.25}),
    "leak_1": (3007, 300_000, 64, {"leak": 1.0, "v_threshold": 0.5}),
    "one_word": (29, 400, 20, {}),
    "wide": (1_200_007, 2_400_000, 6, {"input_rate": 0.3}),
}
dev = torch.device("cuda")
out = {}
for name, (n, e, steps, fields) in CASES.items():
    rng = np.random.default_rng(n + e)
    post = rng.integers(0, n - min(10, n // 4), e)        # the last neurons have none
    if e > 5000:
        post[:5000] = 7                                   # one neuron of 5000 synapses
    pre = rng.integers(0, n, e)
    w = (rng.standard_normal(e) * (0.6 if n < 100 else 0.3)).astype(np.float32)
    is_input = torch.as_tensor(rng.random(n) < 0.2)
    draws = torch.as_tensor(rng.random((steps, n), dtype=np.float32))
    params = tlif.LIFParams(**fields)
    host = tref.lif_record_ref(tlif.synapse_csr(pre, post, w, n, "cpu"), is_input, draws, params)
    csr = tlif.synapse_csr(pre, post, w, n, dev)
    before = ops.LAUNCHES["lif_record"]
    first = ops.lif_record(csr, is_input.to(dev), draws.to(dev), params)
    second = ops.lif_record(csr, is_input.to(dev), draws.to(dev), params)
    torch.cuda.synchronize()
    grid = (ctypes.c_int * 5)()
    _build.library("lif_record").lif_record_grid(n, e, grid)
    out[name] = {
        "launches": ops.LAUNCHES["lif_record"] - before,
        "equal_host": [torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
                       for a, b in zip(first, host)],
        "equal_twice": all(torch.equal(a, b) for a, b in zip(first, second)),
        "hidden_spikes": float(host[0][~is_input].sum()),
        "grid": list(grid),
        "n": n,
        "e": e,
    }
print(json.dumps(out))
"""


@pytest.mark.cuda
def test_lif_record_bit_identical_to_its_plain_version_on_the_card():
    """The recording in one launch against ``ref.lif_record_ref`` on the
    host: counts, last v and refr equal bit for bit, and two launches
    equal, at ragged n (not a multiple of 32 or of a block's range), with
    neurons of 0 and 5000 synapses, signed weights, the parameter variants,
    a recording of one word (one block with neurons, the rest empty) and
    one of 1.2M neurons (several chunks a block, the bitmask over 48 KB of
    shared memory, so that most synapses are read from device memory, not
    from the block's cache); one launch a recording.  In a child process
    under a timeout."""
    _need_cuda()
    import json
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", LIF_RECORD_CHILD], env=env, cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    cases = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, case in cases.items():
        assert case["launches"] == 2, name
        assert case["equal_host"] == [True, True, True], (name, case)
        assert case["equal_twice"], name
        assert case["hidden_spikes"] > 0, name
    wide = cases["wide"]
    assert wide["n"] / wide["grid"][0] > wide["grid"][2] and wide["grid"][4] > 48 * 1024
    assert wide["grid"][0] * wide["grid"][3] < wide["e"]
    assert cases["one_word"]["grid"][3] == cases["one_word"]["e"]


# ======================================================================
# gradients through K6 and the scan route
# ======================================================================
def _attention_and_scan_inputs(dev, dtype, seed):
    """(q, k, v, x, dt, a_log, b, c, their output weights), seeded, on
    ``dev``, each input a leaf that requires a gradient."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shapes = [(2, 4, 200, 64), (2, 2, 200, 64), (2, 2, 200, 64),
              (2, 80, 32), (2, 80, 32), (32, 8), (2, 80, 8), (2, 80, 8)]
    ts = [torch.randn(s, generator=gen) for s in shapes]
    ts[4] = 0.01 + 0.1 * torch.rand(shapes[4], generator=gen)
    weights = [torch.randn(s, generator=gen) for s in ((2, 4, 200, 64), (2, 80, 32), (2, 32, 8))]
    leaves = [t.to(dev, torch.float32 if i == 5 else dtype).requires_grad_()
              for i, t in enumerate(ts)]
    return leaves, [w.to(dev) for w in weights]


def _attention_and_scan_loss(leaves, weights):
    q, k, v, x, dt, a_log, b, c = leaves
    o = ops.flash_attention(q, k, v, causal=True, window=0)
    y, h = ops.mamba_scan(x, dt, -torch.exp(a_log), b, c, chunk=32)
    return ((o.float() * weights[0]).sum() + (y.float() * weights[1]).sum()
            + (h * weights[2]).sum()), (o, y)


def test_a_card_call_that_needs_a_gradient_goes_through_the_functions(monkeypatch):
    """With the launches faked: on "CUDA" operands that require a gradient,
    flash_attention and mamba_scan launch their kernels inside
    FlashAttentionFn and MambaScanFn, so each output has a grad_fn and the
    backward (the plain versions recomputed) reaches every input, equal to
    autograd through the plain versions; under no_grad the launches are
    the same and nothing is recorded."""
    lib = _fake_lib(monkeypatch)
    leaves, weights = _attention_and_scan_inputs("cpu", torch.float32, 0)
    loss, (o, y) = _attention_and_scan_loss(leaves, weights)
    assert isinstance(o.grad_fn, ops.FlashAttentionFn._backward_cls)
    assert isinstance(y.grad_fn, ops.MambaScanFn._backward_cls)
    launched = [entry for entry, _, _ in lib.calls]
    assert launched == ["flash_attention", "mamba_scan_route"]
    loss.backward()
    q, k, v, x, dt, a_log, b, c = (t.detach().requires_grad_() for t in leaves)
    y_p, h_p = tref.mamba_route_ref(x, dt, -torch.exp(a_log), b, c, chunk=32)
    plain = ((tref.attention_ref(q, k, v) * weights[0]).sum() + (y_p * weights[1]).sum()
             + (h_p * weights[2]).sum())
    for leaf, g in zip(leaves, torch.autograd.grad(plain, [q, k, v, x, dt, a_log, b, c])):
        assert leaf.grad is not None and torch.equal(leaf.grad, g)
    lib.calls.clear()
    with torch.no_grad():
        _, (o, y) = _attention_and_scan_loss(leaves, weights)
    assert o.grad_fn is None and y.grad_fn is None
    assert [entry for entry, _, _ in lib.calls] == launched


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attention_and_scan_gradients_on_the_card(dtype):
    """K6 and the scan route (its one kernel) in the forward on the card,
    the plain recompute in the backward: every input's gradient within
    ``ref.grad_excess`` 1 of the host's."""
    dev = _need_cuda()
    card, weights = _attention_and_scan_inputs(dev, dtype, 1)
    host = [t.detach().cpu().requires_grad_() for t in card]
    before = dict(ops.LAUNCHES)
    _attention_and_scan_loss(card, weights)[0].backward()
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]} \
        == {"flash_attention": 1, "mamba_scan_route": 1}
    _attention_and_scan_loss(host, [w.cpu() for w in weights])[0].backward()
    for c, h in zip(card, host):
        assert c.grad is not None and c.grad.dtype == h.grad.dtype
        assert tref.grad_excess(c.grad.cpu(), h.grad) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "jamba-v0.1-52b"])
def test_a_reduced_train_step_agrees_between_card_and_host(arch):
    """The same parameters and batch: the loss within 1e-5, every gradient
    leaf within ``ref.TRAIN_GRAD_SCALE`` of ``ref.grad_excess``, and one
    AdamW step from them moving every parameter by at most the learning
    rate (plus its weight decay) on both."""
    dev = _need_cuda()
    cfg = tconfigs.reduced(tconfigs.get_arch(arch))
    host_p = ttf.init_params(cfg, torch.Generator().manual_seed(0))
    card_p = tree_map(lambda t: t.to(dev), host_p)
    b = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2)).batch(0)
    host_b = {k: torch.as_tensor(v) for k, v in b.items()}
    before = dict(ops.LAUNCHES)
    card_loss, card_g = tsteps.loss_and_grads(card_p, {k: v.to(dev) for k, v in host_b.items()},
                                              cfg)
    torch.cuda.synchronize()
    n_gqa = sum(s.mixer == "gqa" for r, specs in cfg.stacks for s in specs for _ in range(r))
    assert ops.LAUNCHES["flash_attention"] - before["flash_attention"] == n_gqa
    host_loss, host_g = tsteps.loss_and_grads(host_p, host_b, cfg)
    assert abs(float(card_loss) - float(host_loss)) <= 1e-5 * abs(float(host_loss))
    for c, h in zip(tree_leaves(card_g), tree_leaves(host_g)):
        assert torch.isfinite(c).all() and bool((c != 0).any())
        assert tref.grad_excess(c.cpu(), h, tref.TRAIN_GRAD_SCALE) <= 1.0
    opt = AdamWConfig(lr=1e-3)
    step = tsteps.make_train_step(cfg, opt)
    card_new, _, _ = step(card_p, adamw_init(card_p, opt), {k: v.to(dev) for k, v in host_b.items()})
    host_new, _, _ = step(host_p, adamw_init(host_p, opt), host_b)
    for p, c, h in zip(tree_leaves(host_p), tree_leaves(card_new), tree_leaves(host_new)):
        bound = opt.lr * (1 + opt.weight_decay * p.abs()) * 1.001
        assert ((c.cpu() - p).abs() <= bound).all() and ((h - p).abs() <= bound).all()


# ----------------------------------------------------------------------
# the MoE's kept-row pair
# ----------------------------------------------------------------------
#: name: (E, D, F, T, k): decode's two shapes at full width, and a ragged
#: one (depth and width off the kernels' tiles, more choices than a block
#: walks at once, an expert with more kept rows than a pass takes)
MOE_SHAPES = {**tref.MOE_DECODE_SHAPES, "ragged": (5, 100, 36, 150, 2)}


def _moe_routings(e, t, k, dev):
    """name -> (idx, capacity): random distinct experts a token, dropless
    (an int64 view of a wider sorted tensor's first k columns, as the
    router passes it); expert 0 first for every token, dropless (one expert
    takes every token's row); the same at capacity 4 (most dropped)."""
    gen = torch.Generator().manual_seed(e * 1000 + t)
    wide = torch.rand((t, e), generator=gen).argsort(dim=1).to(dev)
    skew = wide.clone()
    first = (skew == 0).int().argmax(dim=1)
    skew[torch.arange(t, device=dev), first] = skew[:, 0]
    skew[:, 0] = 0
    return {"random": (wide[:, :k], t), "one_expert_takes_all": (skew[:, :k], t),
            "drops": (skew[:, :k].contiguous(), 4)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(MOE_SHAPES))
def test_moe_kept_row_pair_matches_its_plain_version_on_the_card(shape):
    """Each kernel within ``ref.MOE_TOL`` of its plain version on the same
    inputs (the down kernel on the gate-up kernel's h; float32 sums in
    another order than cuBLAS's, TF32 off), dropped rows 0, two runs bit
    for bit equal, one launch a call."""
    dev = _need_cuda()
    assert not torch.backends.cuda.matmul.allow_tf32
    e, d, f, t, k = MOE_SHAPES[shape]
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((t, d), generator=gen, device=dev)
    wg, wu = (0.02 * torch.randn((e, d, f), generator=gen, device=dev) for _ in range(2))
    wd = 0.02 * torch.randn((e, f, d), generator=gen, device=dev)
    for name, (idx, cap) in _moe_routings(e, t, k, dev).items():
        before = dict(ops.LAUNCHES)
        h = ops.moe_gate_up(x, idx, wg, wu, capacity=cap)
        out = ops.moe_down(h, idx, wd, capacity=cap)
        assert {n: v - before[n] for n, v in ops.LAUNCHES.items() if v != before[n]} \
            == {"moe_gate_up": 1, "moe_down": 1}
        assert torch.equal(ops.moe_gate_up(x, idx, wg, wu, capacity=cap), h)
        assert torch.equal(ops.moe_down(h, idx, wd, capacity=cap), out)
        h_plain = tref.moe_gate_up_ref(x, idx, wg, wu, capacity=cap)
        assert tref.moe_excess(h, h_plain) <= 1.0, name
        assert tref.moe_excess(out, tref.moe_down_ref(h, idx, wd, capacity=cap)) <= 1.0, name
        plain = tref.moe_down_ref(h_plain, idx, wd, capacity=cap)
        assert tref.moe_excess(out, plain) <= 1.0, name
        assert torch.equal(out == 0, plain == 0) and bool((h_plain.abs().sum(1) == 0).any()) \
            == (name == "drops")


def test_moe_wrappers_reject_what_their_kernels_do_not_take(monkeypatch):
    """Checked before the build, so these raise here too (routing forced)."""
    monkeypatch.setattr(ops, "_on_cpu", lambda *ts: False)
    x, idx = torch.zeros((4, 8)), torch.zeros((4, 2), dtype=torch.int64)
    w = torch.zeros((3, 8, 12))
    with pytest.raises(TypeError, match="x must be"):
        ops.moe_gate_up(x.bfloat16(), idx, w, w, capacity=4)
    with pytest.raises(TypeError, match="w_up must be"):
        ops.moe_gate_up(x, idx, w, w.double(), capacity=4)
    with pytest.raises(TypeError, match="int64 idx"):
        ops.moe_gate_up(x, idx.int(), w, w, capacity=4)
    with pytest.raises(TypeError, match="int64 idx"):
        ops.moe_gate_up(x, idx.t().contiguous().t(), w, w, capacity=4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.moe_down(torch.zeros((8, 12)), idx, w.transpose(1, 2), capacity=4)
    with pytest.raises(ValueError, match="multiples of 4"):
        ops.moe_gate_up(x, idx, w[:, :, :10].contiguous(), w[:, :, :10].contiguous(),
                        capacity=4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.moe_gate_up(torch.zeros(33)[1:].view(4, 8), idx, w, w, capacity=4)
    with pytest.raises(ValueError, match="capacity"):
        ops.moe_gate_up(x, idx, w, w, capacity=0)
