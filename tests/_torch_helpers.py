"""Shared inputs of the port's tests (torch and numpy only, no JAX)."""

import numpy as np
import torch

from repro_torch.kernels import ref as tref


def dyadic_csr(seed: int, b: int, n: int, e_per_row: int, k: int):
    """A random CSR whose arithmetic is exact in float32 and float64
    (small dyadic values), so the float32 Pallas fold is an exact oracle."""
    rng = np.random.default_rng(seed)
    nk = b * n
    row = np.repeat(np.arange(b), e_per_row)
    src = row * n + rng.integers(0, n, row.size)
    dst = row * n + rng.integers(0, n, row.size)
    order = np.argsort(dst, kind="stable")
    src, dst, row = src[order], dst[order], row[order]
    w = rng.integers(-64, 64, src.size) / 8.0
    t = rng.integers(0, 3, src.size).astype(np.float64)
    dist = rng.integers(0, 256, (nk, k)) / 4.0
    lams = rng.integers(0, 32, (b, k)) / 2.0
    indptr = np.zeros(nk + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=nk), out=indptr[1:])
    csr = tref.RelaxCSR(
        n_actors=n,
        indptr=torch.as_tensor(indptr, dtype=torch.int32),
        src=torch.as_tensor(src, dtype=torch.int32),
        w=torch.as_tensor(w), t=torch.as_tensor(t),
        dst=torch.as_tensor(dst), dst_row=torch.as_tensor(row),
    )
    cand = dist[src] + (w[:, None] - lams[row] * t[:, None])
    return csr, torch.as_tensor(dist), torch.as_tensor(lams), cand, src, dst
