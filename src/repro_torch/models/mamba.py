"""Mamba (S6) block for the Jamba hybrid architecture (the port of
``repro.models.mamba``).

Prefill runs the full-sequence scan through ``kernels.ops.mamba_scan``: the
chunk scan (K7 on CUDA, its plain PyTorch version on the CPU), the chunk
combine, and the chunk scan again from the combined states.  The reference
model keeps its own jnp form of the same two-phase scan (``_chunked_scan``,
which adds ``C * (prefix decay * H_init)`` to a zero-start local scan where
K7 rescans from ``H_init``); the two agree up to float32 association.
Decode keeps O(1) recurrent state per layer and stays plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import device as device_mod
from ..kernels import ops
from .blocks import init_linear, mm


def init_mamba(gen, cfg, *, stack=(), dtype=torch.float32):
    d, di, n, dc = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    conv = torch.empty((*stack, dc, di), dtype=torch.float32, device=gen.device)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=gen.device))
    return {
        "w_in": init_linear(gen, d, 2 * di, stack=stack, dtype=dtype),
        "w_conv": conv.normal_(0.0, 0.1, generator=gen).to(dtype),
        "w_x_dbc": init_linear(gen, di, cfg.mamba_dt_rank + 2 * n, stack=stack, dtype=dtype),
        "w_dt": init_linear(gen, cfg.mamba_dt_rank, di, stack=stack, dtype=dtype),
        "a_log": a_log.expand(*stack, di, n).to(dtype).contiguous(),
        "d_skip": torch.ones((*stack, di), dtype=dtype, device=gen.device),
        "w_out": init_linear(gen, di, d, stack=stack, dtype=dtype),
    }


def _ssm_params(p, u, cfg):
    """u: (B, L, di) -> dt (B, L, di), A (di, n) float32, Bmat, Cmat (B, L, n)."""
    n, rk = cfg.mamba_d_state, cfg.mamba_dt_rank
    dbc = mm(u, p["w_x_dbc"])                                 # (B, L, rk + 2n)
    dt = F.softplus(mm(dbc[..., :rk], p["w_dt"]))
    bmat = dbc[..., rk:rk + n]
    cmat = dbc[..., rk + n:]
    a = -torch.exp(p["a_log"].float())
    return dt, a, bmat, cmat


def _causal_conv(p, u, conv_state=None):
    """Depthwise causal conv1d over (B, L, di), from zeros or ``conv_state``
    (B, dc - 1, di); returns (silu(out), the new state in the state's type)."""
    dc = p["w_conv"].shape[0]
    state_dtype = conv_state.dtype if conv_state is not None else u.dtype
    if conv_state is None:
        pad = torch.zeros((u.shape[0], dc - 1, u.shape[2]), dtype=u.dtype, device=u.device)
    else:
        pad = conv_state.to(u.dtype)      # an f32 state must not promote u
    full = torch.cat([pad, u], dim=1)                         # (B, L + dc - 1, di)
    length = u.shape[1]
    out = 0
    for i in range(dc):
        out = out + full[:, i:i + length] * p["w_conv"][i]
    new_state = (full[:, -(dc - 1):] if dc > 1 else pad).to(state_dtype)
    return F.silu(out), new_state


def mamba_forward(p, x, cfg):
    """Full-sequence block. x: (B, L, D) -> (B, L, D)."""
    u, gate = mm(x, p["w_in"]).chunk(2, dim=-1)
    u, _ = _causal_conv(p, u)
    dt, a, bmat, cmat = _ssm_params(p, u, cfg)
    y, _ = ops.mamba_scan(u, dt.contiguous(), a, bmat.contiguous(), cmat.contiguous(),
                          chunk=cfg.mamba_chunk)
    y = y + u * p["d_skip"]
    y = y * F.silu(gate)
    return mm(y, p["w_out"])


def mamba_init_state(cfg, batch, dtype=torch.float32, device=None):
    """Zeroed SSM state (B, di, n) and conv state (B, dc - 1, di);
    ``device=None`` is the card."""
    di, n, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    dev = device_mod.resolve(device)
    return {
        "ssm": torch.zeros((batch, di, n), dtype=dtype, device=dev),
        "conv": torch.zeros((batch, dc - 1, di), dtype=dtype, device=dev),
    }


def mamba_decode(p, x, state, cfg):
    """One-token recurrent step. x: (B, 1, D).  Returns (y, state); the
    state tensors are updated in place."""
    u, gate = mm(x, p["w_in"]).chunk(2, dim=-1)
    u, conv_state = _causal_conv(p, u, state["conv"])
    dt, a, bmat, cmat = _ssm_params(p, u, cfg)
    d_t = dt[:, 0].float()                                     # (B, di)
    h = torch.exp(d_t[..., None] * a) * state["ssm"] \
        + (d_t * u[:, 0].float())[..., None] * bmat[:, 0, None, :].float()
    y = (h * cmat[:, 0, None, :].float()).sum(dim=-1)
    y = y.to(x.dtype)[:, None] + u * p["d_skip"]
    y = y * F.silu(gate)
    state["ssm"].copy_(h)
    state["conv"].copy_(conv_state)
    return mm(y, p["w_out"]), state
