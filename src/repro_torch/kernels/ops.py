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
}

#: probe counts relax_round.cu instantiates: the search's K = 3 and the
#: single-lambda deadlock probe
PROBE_COUNTS = (1, 3)


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
