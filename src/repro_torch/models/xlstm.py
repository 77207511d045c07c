"""xLSTM blocks (arXiv:2405.04517), the port of ``repro.models.xlstm``:
mLSTM (matrix memory, parallel over a chunk) and sLSTM (scalar memory,
sequential).

mLSTM prefill runs the chunkwise-parallel form (:func:`_mlstm_chunkwise`):
exponential input gates with a running log-normaliser, the (dh x dh)
matrix memory ``c`` and normaliser ``n`` carried from chunk to chunk;
:func:`_mlstm_scan` is the sequential oracle.  sLSTM runs its recurrence a
token at a time.  Decode keeps O(1) state a layer and updates the state
tensors in place (``decode_step`` hands each layer views of its stacked
cache).  Neither block reaches a Pallas kernel in the reference, so both
are plain PyTorch.

The gate biases keep the reference's layout: ``b_if`` is ``[0, 3]`` tiled
over 2h entries, read as (2, h), so the input and the forget gate each get
0, 3, 0, 3, ... by head.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import device as device_mod
from ..launch import sharding as sh
from .blocks import init_linear, mm


# ======================================================================
# mLSTM
# ======================================================================
def init_mlstm(gen, cfg, *, stack=(), dtype=torch.float32):
    d, h, di = cfg.d_model, cfg.n_heads, cfg.xlstm_d_inner
    return {
        "w_qkv": init_linear(gen, d, 3 * di, stack=stack, dtype=dtype),
        "w_if": init_linear(gen, d, 2 * h, stack=stack, dtype=dtype),
        # jnp.tile([0, 3], (*stack, h)): [0, 3, 0, 3, ...], not i = 0, f = 3
        "b_if": torch.tensor([0.0, 3.0], dtype=dtype, device=gen.device).repeat(*stack, h),
        "w_gate": init_linear(gen, d, di, stack=stack, dtype=dtype),
        "norm": torch.ones((*stack, di), dtype=dtype, device=gen.device),
        "w_out": init_linear(gen, di, d, stack=stack, dtype=dtype),
    }


def _mlstm_step(c, n, m, q_t, k_t, v_t, i_t, lf_t):
    """One token of the log-stabilised recurrence, float32.  c (B, H, dh, dh),
    n (B, H, dh), m (B, H); q_t, k_t, v_t (B, H, dh); i_t, lf_t (B, H).
    Returns (y_t, c, n, m)."""
    m_new = torch.maximum(lf_t + m, i_t)
    f_eff = torch.exp(lf_t + m - m_new)
    i_eff = torch.exp(i_t - m_new)
    kv = k_t[..., :, None] * v_t[..., None, :]
    c = f_eff[..., None, None] * c + i_eff[..., None, None] * kv
    n = f_eff[..., None] * n + i_eff[..., None] * k_t
    num = torch.einsum("bhd,bhde->bhe", q_t, c)
    den = torch.einsum("bhd,bhd->bh", q_t, n).abs()
    y = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return y, c, n, m_new


def _mlstm_scan(q, k, v, i_gate, f_gate):
    """The sequential mLSTM recurrence (the oracle), ``m`` from -inf.

    q, k, v: (B, H, L, dh); i_gate, f_gate: (B, H, L) pre-activation.
    Returns y: (B, H, L, dh) in q's type."""
    b, h, length, dh = q.shape
    logf = F.logsigmoid(f_gate).float()
    c = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, h, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, h), float("-inf"), dtype=torch.float32, device=q.device)
    qf, kf, vf, i_f = q.float(), k.float(), v.float(), i_gate.float()
    ys = []
    for t in range(length):
        y, c, n, m = _mlstm_step(c, n, m, qf[:, :, t], kf[:, :, t], vf[:, :, t],
                                 i_f[:, :, t], logf[:, :, t])
        ys.append(y)
    return torch.stack(ys, dim=2).to(q.dtype)


def _mlstm_chunkwise(q, k, v, i_gate, f_gate, chunk: int):
    """The chunkwise-parallel mLSTM: within a chunk an attention-like masked
    term, across chunks the carried matrix state, ``m`` from -1e30.  A
    ragged end is padded with zero q, k, v and i and a forget gate of 20.0
    (log-sigmoid about 0: the state passes through)."""
    b, h, length, dh = q.shape
    pad = (-length) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        i_gate = F.pad(i_gate, (0, pad))
        f_gate = F.pad(f_gate, (0, pad), value=20.0)
    nc = q.shape[2] // chunk
    qc, kc, vc = (t.reshape(b, h, nc, chunk, dh).float() for t in (q, k, v))
    ic = i_gate.reshape(b, h, nc, chunk).float()
    # along each chunk's own steps: no mesh axis splits that dim
    lf_cum = sh.per_shard(lambda f: torch.cumsum(F.logsigmoid(f), dim=-1),
                          f_gate.reshape(b, h, nc, chunk).float())
    lf_tot = lf_cum[..., -1]
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()

    c = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, h, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, h), -1e30, dtype=torch.float32, device=q.device)
    ys = []
    for j in range(nc):
        q_t, k_t, v_t = qc[:, :, j], kc[:, :, j], vc[:, :, j]
        i_t, lfcum_t, lftot_t = ic[:, :, j], lf_cum[:, :, j], lf_tot[:, :, j]
        # a_ij = i_j + lfcum_i - lfcum_j: the log weight of key j <= i at query i
        a = i_t[..., None, :] + lfcum_t[..., :, None] - lfcum_t[..., None, :]
        a = a.masked_fill(~causal, float("-inf"))
        b_state = m[..., None] + lfcum_t                       # the carried state's log weight
        m_loc = torch.maximum(a.amax(dim=-1), b_state)
        a_w = torch.exp(a - m_loc[..., None])
        s_w = torch.exp(b_state - m_loc)
        weighted = a_w * (q_t @ k_t.transpose(-1, -2))       # (B, H, ch, ch)
        num = weighted @ v_t + s_w[..., None] * (q_t @ c)
        den = weighted.sum(dim=-1) + s_w * torch.einsum("bhid,bhd->bhi", q_t, n)
        ys.append(num / torch.maximum(den.abs(), torch.exp(-m_loc))[..., None])
        # the state at the chunk's end
        key_logw = i_t + lftot_t[..., None] - lfcum_t
        m_new = torch.maximum(lftot_t + m, key_logw.amax(dim=-1))
        decay = torch.exp(lftot_t + m - m_new)
        w = torch.exp(key_logw - m_new[..., None])
        # the reference's einsum("bhj,bhjd,bhje->bhde"), contracted in another
        # order: equal to a float32 tolerance, not bit for bit
        c = decay[..., None, None] * c + (w[..., None] * k_t).transpose(-1, -2) @ v_t
        n = decay[..., None] * n + torch.einsum("bhj,bhjd->bhd", w, k_t)
        m = m_new
    y = torch.stack(ys, dim=2).reshape(b, h, nc * chunk, dh)[:, :, :length]
    return y.to(q.dtype)


def _mlstm_gates(p, x, cfg):
    """(i, f) pre-activations (B, H, L): ``x @ w_if + b_if`` read as (2, h)."""
    if_g = sh.split_dim(mm(x, p["w_if"]) + p["b_if"], -1, (2, cfg.n_heads))
    return if_g[:, :, 0].transpose(1, 2), if_g[:, :, 1].transpose(1, 2)


def _mlstm_out(p, x, y):
    """The output gate and projection: ``(y * norm * silu(x @ w_gate)) @ w_out``."""
    return mm(y * p["norm"] * F.silu(mm(x, p["w_gate"])), p["w_out"])


def mlstm_forward(p, x, cfg):
    """Full-sequence mLSTM block, chunkwise. x: (B, L, D) -> (B, L, D)."""
    h, di = cfg.n_heads, cfg.xlstm_d_inner
    dh = di // h
    q, k, v = (sh.split_dim(t, -1, (h, dh)).transpose(1, 2)
               for t in mm(x, p["w_qkv"]).chunk(3, dim=-1))
    q = q / math.sqrt(dh)
    i_gate, f_gate = _mlstm_gates(p, x, cfg)
    y = _mlstm_chunkwise(q, k, v, i_gate, f_gate, cfg.xlstm_chunk)
    return _mlstm_out(p, x, sh.merge_dims(y.transpose(1, 2), 2))


def mlstm_init_state(cfg, batch, dtype=torch.float32, device=None):
    """Zeroed ``c`` (B, H, dh, dh) and ``n`` (B, H, dh), ``m`` (B, H) at
    -1e30; ``device=None`` is the card."""
    h = cfg.n_heads
    dh = cfg.xlstm_d_inner // h
    dev = device_mod.resolve(device)
    return {
        "c": torch.zeros((batch, h, dh, dh), dtype=dtype, device=dev),
        "n": torch.zeros((batch, h, dh), dtype=dtype, device=dev),
        "m": torch.full((batch, h), -1e30, dtype=dtype, device=dev),
    }


def mlstm_decode(p, x, state, cfg):
    """One-token recurrent mLSTM step. x: (B, 1, D).  Returns (y, state);
    the new ``c``, ``n`` and ``m`` are copied into the state tensors."""
    b = x.shape[0]
    h, di = cfg.n_heads, cfg.xlstm_d_inner
    dh = di // h
    q, k, v = (t.reshape(b, h, dh).float() for t in mm(x, p["w_qkv"])[:, 0].chunk(3, dim=-1))
    q = q / math.sqrt(dh)
    if_g = (mm(x, p["w_if"]) + p["b_if"])[:, 0].reshape(b, 2, h).float()
    y, c, n, m = _mlstm_step(state["c"].float(), state["n"].float(), state["m"].float(),
                             q, k, v, if_g[:, 0], F.logsigmoid(if_g[:, 1]))
    for name, t in (("c", c), ("n", n), ("m", m)):
        sh.assign(state[name], t)
    return _mlstm_out(p, x, y.reshape(b, 1, di).to(x.dtype)), state


# ======================================================================
# sLSTM (scalar memory, sequential)
# ======================================================================
def init_slstm(gen, cfg, *, stack=(), dtype=torch.float32):
    d, di = cfg.d_model, cfg.xlstm_d_inner
    return {
        "w_gates": init_linear(gen, d, 4 * di, stack=stack, dtype=dtype),
        "r_gates": init_linear(gen, di, 4 * di, stack=stack, scale=1.0 / float(di) ** 0.5,
                               dtype=dtype),
        "w_out": init_linear(gen, di, d, stack=stack, dtype=dtype),
    }


def _slstm_step(p, wx_t, c, n, m, h, out_dtype):
    """One token: gates ``wx_t + h @ r_gates`` (in float32 after the sum),
    the stabilised update, and ``h`` rounded to ``out_dtype`` (the block
    input's type), as the reference rounds it every step.
    Returns (c, n, m, h)."""
    z, i, f, o = (wx_t + mm(h, p["r_gates"])).float().chunk(4, dim=-1)
    log_f = sh.per_shard(F.logsigmoid, f)
    m_new = torch.maximum(log_f + m, i)
    i_eff = torch.exp(i - m_new)
    f_eff = torch.exp(log_f + m - m_new)
    c = f_eff * c + i_eff * torch.tanh(z)
    n = f_eff * n + i_eff
    h = (torch.sigmoid(o) * c / n.clamp_min(1e-6)).to(out_dtype)
    return c, n, m_new, h


def slstm_forward(p, x, cfg):
    """The sLSTM over the sequence, a token at a time. x: (B, L, D)."""
    b, length, _ = x.shape
    di = cfg.xlstm_d_inner
    wx = mm(x, p["w_gates"])                                  # (B, L, 4 di)
    c = torch.zeros((b, di), dtype=torch.float32, device=x.device)
    n = torch.zeros_like(c)
    m = torch.full((b, di), -1e30, dtype=torch.float32, device=x.device)
    h = torch.zeros((b, di), dtype=x.dtype, device=x.device)
    hs = []
    for t in range(length):
        c, n, m, h = _slstm_step(p, wx[:, t], c, n, m, h, x.dtype)
        hs.append(h)
    return mm(torch.stack(hs, dim=1), p["w_out"])


def slstm_init_state(cfg, batch, dtype=torch.float32, device=None):
    """Zeroed ``c``, ``n`` and ``h`` (B, d_inner), ``m`` at -1e30;
    ``device=None`` is the card."""
    di = cfg.xlstm_d_inner
    dev = device_mod.resolve(device)
    return {
        "c": torch.zeros((batch, di), dtype=dtype, device=dev),
        "n": torch.zeros((batch, di), dtype=dtype, device=dev),
        "m": torch.full((batch, di), -1e30, dtype=dtype, device=dev),
        "h": torch.zeros((batch, di), dtype=dtype, device=dev),
    }


def slstm_decode(p, x, state, cfg):
    """One-token sLSTM step. x: (B, 1, D).  Returns (y, state); the new
    ``c``, ``n``, ``m`` and ``h`` are copied into the state tensors.

    The reference's cache holds ``h`` in x's type after the first step; the
    port's ``h`` buffer stays float32 and holds the same value, which is
    exact there.  It is read back in x's type, so ``h @ r_gates`` multiplies
    the operand types the reference's does (a bf16 product over bf16
    weights).  The zero ``h`` of the first step gives a zero product in any
    type."""
    c, n, m, h = _slstm_step(p, mm(x, p["w_gates"])[:, 0], state["c"], state["n"], state["m"],
                             state["h"].to(x.dtype), x.dtype)
    for name, t in (("c", c), ("n", n), ("m", m), ("h", h)):
        sh.assign(state[name], t)
    return mm(h[:, None], p["w_out"]), state
