"""Kernel wrappers: route by the tensor's device and by nothing else.

A CPU tensor goes to the plain version in :mod:`repro_torch.kernels.ref`.
A CUDA tensor goes to the hand-written kernel in ``csrc/`` or the call
raises: there is no size threshold below which the plain version takes
over, and no fallback when the library cannot be built or a launch fails.
Each wrapper adds one to :data:`LAUNCHES` where it launches its kernel.
"""

from __future__ import annotations

import torch

from . import _build, ref
from .ref import RelaxCSR

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {
    "relax_round": 0,
    "relax_round_witness": 0,
    "maxplus_bmm": 0,
    "maxplus_bmv": 0,
    "maxplus_matmul": 0,
    "flash_attention": 0,
    "lif_crossbar_step": 0,
    "mamba_chunk_scan": 0,
}

#: device operations the chunk combine of :func:`mamba_scan` issued on a
#: CUDA tensor since the last :func:`reset_launches` (plain PyTorch, not a kernel)
COMBINE_LAUNCHES = {"mamba_scan": 0}

#: probe counts relax_round.cu instantiates: the search's K = 3 and the
#: single-lambda deadlock probe
PROBE_COUNTS = (1, 3)
#: head dims flash_attention.cu instantiates: every GQA config, full or reduced
FLASH_HEAD_DIMS = (64, 96, 128)
#: state sizes mamba_scan.cu instantiates: every Mamba config's 16 and the
#: reference's tests' 8
SCAN_STATES = (8, 16)
#: the scan kernel stages a chunk's B and C (2 * chunk * N float32) in at
#: most 48 KB of shared memory
SCAN_SMEM_BYTES = 48 * 1024


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    COMBINE_LAUNCHES["mamba_scan"] = 0


def _on_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands lie on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}; use a CPU or CUDA tensor")
    return False


def _check(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed with cudaError_t {err}")


# ======================================================================
# K1: one relaxation round of the lambda-search
# ======================================================================
def _check_probes(dist: torch.Tensor) -> None:
    if dist.shape[1] not in PROBE_COUNTS:
        raise ValueError(f"relax_round takes {PROBE_COUNTS} probes, got {dist.shape[1]}")


def _relax_launch(dist, lams, csr: RelaxCSR, witness: bool):
    n, k = dist.shape
    if n != csr.n_nodes or lams.shape != (n // csr.n_actors, k):
        raise ValueError(
            f"shape mismatch: dist {tuple(dist.shape)}, lams {tuple(lams.shape)}, "
            f"{csr.n_nodes} nodes of {csr.n_actors} actors"
        )
    for t, dt, name in (
        (dist, torch.float64, "dist"), (lams, torch.float64, "lams"),
        (csr.indptr, torch.int32, "indptr"), (csr.src, torch.int32, "src"),
        (csr.w, torch.float64, "w"), (csr.t, torch.float64, "t"),
    ):
        _check(t, dt, name)
    best = torch.empty_like(dist)
    psrc = torch.empty(dist.shape, dtype=torch.int64, device=dist.device) if witness else None
    if n == 0:
        return best, psrc
    fn = _build.library("relax_round").relax_round
    err = fn(
        dist.data_ptr(), lams.data_ptr(), csr.indptr.data_ptr(),
        csr.src.data_ptr(), csr.w.data_ptr(), csr.t.data_ptr(),
        best.data_ptr(), psrc.data_ptr() if witness else None,
        n, csr.n_actors, k, int(witness), _stream(dist),
    )
    name = "relax_round_witness" if witness else "relax_round"
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return best, psrc


def relax_round(dist: torch.Tensor, lams: torch.Tensor, csr: RelaxCSR) -> torch.Tensor:
    """(n_nodes, K) best candidate per node and probe (see ``ref.segment_relax_ref``)."""
    _check_probes(dist)
    if _on_cpu(dist, lams, csr.src):
        return ref.segment_relax_ref(dist, lams, csr)
    return _relax_launch(dist, lams, csr, witness=False)[0]


def relax_round_witness(
    dist: torch.Tensor, lams: torch.Tensor, csr: RelaxCSR
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(best, psrc)``: :func:`relax_round` plus the largest-src argmax."""
    _check_probes(dist)
    if _on_cpu(dist, lams, csr.src):
        return ref.segment_relax_witness_ref(dist, lams, csr)
    return _relax_launch(dist, lams, csr, witness=True)


# ======================================================================
# K2 / K3: float32 (max,+) products
# ======================================================================
def _bmm_launch(a: torch.Tensor, b: torch.Tensor, name: str) -> torch.Tensor:
    g, m, k = a.shape
    g2, k2, n = b.shape
    if g != g2 or k != k2:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} x {tuple(b.shape)}")
    _check(a, torch.float32, "a")
    _check(b, torch.float32, "b")
    c = torch.empty((g, m, n), dtype=torch.float32, device=a.device)
    if c.numel() == 0:
        return c
    err = _build.library("maxplus_matmul").maxplus_bmm(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), g, m, n, k, _stream(a)
    )
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return c


def maxplus_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[g] = A[g] (x) B[g] in (max,+), (G,M,K) x (G,K,N) float32."""
    if _on_cpu(a, b):
        return ref.maxplus_bmm_ref(a, b)
    return _bmm_launch(a, b, "maxplus_bmm")


def maxplus_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A (x) B in (max,+), (M,K) x (K,N) float32: the G = 1 launch of K2."""
    if _on_cpu(a, b):
        return ref.maxplus_matmul_ref(a, b)
    return _bmm_launch(a[None], b[None], "maxplus_matmul")[0]


def maxplus_bmv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[g] = A[g] (x) x[g] in (max,+), (G,M,K) x (G,K) float32."""
    if _on_cpu(a, x):
        return ref.maxplus_bmv_ref(a, x)
    g, m, k = a.shape
    if x.shape != (g, k):
        raise ValueError(f"shape mismatch: {tuple(a.shape)} x {tuple(x.shape)}")
    _check(a, torch.float32, "a")
    _check(x, torch.float32, "x")
    y = torch.empty((g, m), dtype=torch.float32, device=a.device)
    if y.numel() == 0:
        return y
    err = _build.library("maxplus_matmul").maxplus_bmv(
        a.data_ptr(), x.data_ptr(), y.data_ptr(), g, m, k, _stream(a)
    )
    _raise_on(err, "maxplus_bmv")
    LAUNCHES["maxplus_bmv"] += 1
    return y


# ======================================================================
# K6: flash attention
# ======================================================================
def _aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` when every (b, h, s) row starts 16-byte aligned, else an aligned copy."""
    if t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0
) -> torch.Tensor:
    """(B,Hq,Sq,D) x (B,Hkv,Skv,D) -> (B,Hq,Sq,D) masked softmax attention
    in q's dtype (see ``ref.attention_ref``).  Sq and Skv may be any length;
    nothing is padded."""
    b, hq, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if _on_cpu(q, k, v):
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.dtype == k.dtype == v.dtype:
        raise TypeError(
            f"flash_attention takes float32 or bfloat16 q, k, v of one type, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {FLASH_HEAD_DIMS}, got {d}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs a contiguous head dimension")
    if q.dtype == torch.bfloat16:   # the tensor-core body loads rows as 16-byte vectors
        q, k, v = (_aligned_rows(t) for t in (q, k, v))
    o = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    err = _build.library("flash_attention").flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        int(q.dtype == torch.bfloat16), b, hq, k.shape[1], sq, k.shape[2], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), int(window), _stream(q),
    )
    _raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o


# ======================================================================
# K5: fused LIF crossbar step
# ======================================================================
def lif_crossbar_step(
    spikes: torch.Tensor, weights: torch.Tensor, v: torch.Tensor,
    *, leak: float = 0.9, v_th: float = 1.0, v_reset: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One crossbar step: (B, n_in) spikes x (n_in, n_out) weights with
    membrane state (B, n_out) -> ``(out_spikes, v_next)`` (see
    ``ref.lif_crossbar_step_ref``).  Any B, n_in and n_out; nothing is padded."""
    b, n_in = spikes.shape
    if weights.shape[0] != n_in or v.shape != (b, weights.shape[1]):
        raise ValueError(
            f"shape mismatch: spikes {tuple(spikes.shape)}, weights "
            f"{tuple(weights.shape)}, v {tuple(v.shape)}"
        )
    if _on_cpu(spikes, weights, v):
        return ref.lif_crossbar_step_ref(spikes, weights, v, leak=leak, v_th=v_th, v_reset=v_reset)
    for t, name in ((spikes, "spikes"), (weights, "weights"), (v, "v")):
        _check(t, torch.float32, name)
    out_s, out_v = torch.empty_like(v), torch.empty_like(v)
    if out_v.numel() == 0:
        return out_s, out_v
    err = _build.library("lif_crossbar").lif_crossbar_step(
        spikes.data_ptr(), weights.data_ptr(), v.data_ptr(), out_s.data_ptr(),
        out_v.data_ptr(), b, n_in, weights.shape[1], leak, v_th, v_reset, _stream(v),
    )
    _raise_on(err, "lif_crossbar_step")
    LAUNCHES["lif_crossbar_step"] += 1
    return out_s, out_v


# ======================================================================
# K7: chunked selective scan
# ======================================================================
def mamba_chunk_scan(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    c: torch.Tensor, h0: torch.Tensor, *, chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan every ``chunk`` steps of (B, L, D) x and dt with (D, N) a and
    (B, L, N) b, c from the chunks' initial states h0 (B, ceil(L/chunk),
    D, N) -> ``(y, h_final)`` (see ``ref.mamba_chunk_scan_ref``).  L need not
    be a multiple of ``chunk``; nothing is padded."""
    bsz, length, d = x.shape
    n = a.shape[1]
    nc = -(-length // chunk)
    if (dt.shape != x.shape or a.shape != (d, n) or b.shape != (bsz, length, n)
            or c.shape != b.shape or h0.shape != (bsz, nc, d, n)):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
            f"b {tuple(b.shape)}, c {tuple(c.shape)}, h0 {tuple(h0.shape)} at chunk {chunk}"
        )
    if _on_cpu(x, dt, a, b, c, h0):
        return ref.mamba_chunk_scan_ref(x, dt, a, b, c, h0, chunk=chunk)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mamba_chunk_scan takes float32 or bfloat16 x, got {x.dtype}")
    for t, name in ((x, "x"), (dt, "dt"), (b, "b"), (c, "c")):
        _check(t, x.dtype, name)
    _check(a, torch.float32, "a")
    _check(h0, torch.float32, "h0")
    if n not in SCAN_STATES:
        raise ValueError(f"mamba_chunk_scan takes state sizes {SCAN_STATES}, got {n}")
    if chunk < 1 or 2 * chunk * n * 4 > SCAN_SMEM_BYTES:
        raise ValueError(f"mamba_chunk_scan takes 1 <= chunk <= "
                         f"{SCAN_SMEM_BYTES // (8 * n)} at N = {n}, got {chunk}")
    y = torch.empty_like(x)
    h_out = torch.empty_like(h0)
    if y.numel() == 0:
        return y, h_out
    err = _build.library("mamba_scan").mamba_chunk_scan(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h_out.data_ptr(), int(x.dtype == torch.bfloat16),
        bsz, length, d, n, chunk, _stream(x),
    )
    _raise_on(err, "mamba_chunk_scan")
    LAUNCHES["mamba_chunk_scan"] += 1
    return y, h_out


def mamba_scan(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    c: torch.Tensor, *, chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The full-sequence S6 scan from a zero state, ``(y (B, L, D),
    h_final (B, D, N))``, in the reference's three steps: the chunk scan
    from zero states, the chunk combine
    ``H_init(c) = Decay(c-1) * H_init(c-1) + S_local(c-1)`` (plain PyTorch,
    a loop over the chunks), and the chunk scan again from ``H_init``."""
    bsz, length, d = x.shape
    n = a.shape[1]
    nc = -(-length // chunk)
    zeros = torch.zeros((bsz, nc, d, n), dtype=torch.float32, device=x.device)
    _, s_local = mamba_chunk_scan(x, dt, a, b, c, zeros, chunk=chunk)
    # the decay over each complete chunk before the last: exp(a * sum of dt)
    full = (nc - 1) * chunk
    dt_sum = dt[:, :full].reshape(bsz, nc - 1, chunk, d).sum(dim=2, dtype=torch.float32)
    decay = torch.exp(dt_sum[..., None] * a.float())
    h_init = torch.zeros_like(zeros)
    for ci in range(1, nc):
        torch.addcmul(s_local[:, ci - 1], decay[:, ci - 1], h_init[:, ci - 1], out=h_init[:, ci])
    if x.is_cuda:
        COMBINE_LAUNCHES["mamba_scan"] += 4 + (nc - 1)   # zeros, sum, mul, exp; a step each
    y, h_fin = mamba_chunk_scan(x, dt, a, b, c, h_init, chunk=chunk)
    return y, h_fin[:, -1]
