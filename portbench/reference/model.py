"""A plain decoder in float32: the layer kinds the benchmark's
configurations use, written from their published descriptions and kept to
what the program runs, one layer at a time.

Layer kinds (``model["layers"]``, one ``[mixer, ffn]`` pair a layer):

* ``gqa``: grouped-query causal attention, RoPE on interleaved pairs
  ``(x[0::2], x[1::2])``, scale ``1/sqrt(head_dim)``.
* ``mla``: multi-head latent attention (DeepSeek-V2/V3) in its
  decompressed form: queries through the rank-``mla_q_rank`` bottleneck,
  keys and values from the rank-``mla_kv_rank`` latent, one RoPE key shared
  by every head, scale ``1/sqrt(nope_dim + rope_dim)``.
* ``mamba``: the S6 block (Mamba, arXiv:2312.00752): input projection to
  ``u`` and a gate, depthwise causal convolution and SiLU, ``dt`` through a
  rank-``dt_rank`` projection and softplus, ``A = -exp(a_log)``, the
  recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t``, ``y_t = C_t h_t
  + D u_t``, gated by ``silu(gate)``, then the output projection.  The
  recurrence runs step by step over time, every channel at once.
* ``swiglu``: ``down(silu(gate(x)) * up(x))``.
* ``moe``: a softmax router, the top ``moe_top_k`` experts of each token
  (ties to the lower expert id), their gates renormalised to sum to 1, each
  expert a SwiGLU, plus ``moe_shared`` shared experts as one SwiGLU of that
  many times the width.  With a ``capacity`` factor an expert takes at most
  ``max(int(T * top_k * capacity / experts), 4)`` of the request's ``T``
  tokens: the choices are taken in token order, then choice order, and a
  choice past its expert's capacity is dropped.  ``capacity=None`` drops
  nothing.  Each token's margin between its k-th and (k+1)-th router
  logit is kept where the caller asks for it.

Every layer is pre-norm (RMSNorm, ``eps`` from the model) with residual
adds, and a final RMSNorm before the LM head.  Every matrix product goes
through :class:`Precision`: ``"fp32"`` is the reference, ``"tf32"`` and
``"fp8"`` are the controls one precision below float32 and bfloat16 (each
operand rounded as the tensor cores would take it, the sum in float32).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: query rows a block of the attention: bounds its (heads, rows, keys) scores
ATTN_BLOCK = 1024
#: time steps whose decays are formed at once in the Mamba recurrence
SCAN_BLOCK = 256
#: largest finite float8_e4m3fn
FP8_MAX = 448.0


class Precision:
    """How the operands of a matrix product are rounded before it."""

    MODES = ("fp32", "tf32", "fp8")

    def __init__(self, mode: str = "fp32"):
        if mode not in self.MODES:
            raise ValueError(f"precision {mode!r} not in {self.MODES}")
        self.mode = mode

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if self.mode == "tf32":
            # round to 10 mantissa bits, half away from zero (cvt.rna.tf32)
            bits = t.contiguous().view(torch.int32)
            return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        if self.mode == "fp8":
            scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
            return (t / scale).to(torch.float8_e4m3fn).float() * scale
        return t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.cast(a) @ self.cast(b)


def rms_norm(w, x, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w.float()


def rope(x, positions, theta):
    """x (..., S, d) rotated on interleaved pairs at ``positions`` (S,)."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).flatten(-2)


def causal_attention(q, k, v, scale, prec: Precision):
    """q, k (B, H, S, dk), v (B, H, S, dv): softmax attention, causal."""
    s = q.shape[2]
    out = []
    for start in range(0, s, ATTN_BLOCK):
        stop = min(start + ATTN_BLOCK, s)
        scores = prec.mm(q[:, :, start:stop], k[:, :, :stop].transpose(-1, -2)) * scale
        mask = torch.arange(start, stop, device=q.device)[:, None] \
            >= torch.arange(stop, device=q.device)[None, :]
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        out.append(prec.mm(probs, v[:, :, :stop]))
    return torch.cat(out, dim=2)


def split_heads(t, heads):
    b, s, _ = t.shape
    return t.reshape(b, s, heads, -1).transpose(1, 2)


def merge_heads(t):
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def gqa(p, x, m, prec):
    h, hkv, dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    pos = torch.arange(x.shape[1], device=x.device)
    q = rope(split_heads(prec.mm(x, p["wq"]), h), pos, m["rope_theta"])
    k = rope(split_heads(prec.mm(x, p["wk"]), hkv), pos, m["rope_theta"])
    v = split_heads(prec.mm(x, p["wv"]), hkv)
    k, v = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
    return prec.mm(merge_heads(causal_attention(q, k, v, 1.0 / math.sqrt(dh), prec)), p["wo"])


def mla(p, x, m, prec):
    h, dn, dr = m["n_heads"], m["mla_nope_dim"], m["mla_rope_dim"]
    rkv = m["mla_kv_rank"]
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    q = split_heads(prec.mm(prec.mm(x, p["wq_a"]), p["wq_b"]), h)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, m["rope_theta"])], dim=-1)
    kv = prec.mm(x, p["wkv_a"])
    c_kv, k_rope = kv[..., :rkv], rope(kv[:, None, :, rkv:], pos, m["rope_theta"])
    k = torch.cat([split_heads(prec.mm(c_kv, p["wk_b"]), h), k_rope.expand(b, h, s, dr)], dim=-1)
    v = split_heads(prec.mm(c_kv, p["wv_b"]), h)
    o = causal_attention(q, k, v, 1.0 / math.sqrt(dn + dr), prec)
    return prec.mm(merge_heads(o), p["wo"])


def selective_scan(u, dt, a, bm, cm):
    """h_t = exp(dt_t a) h_{t-1} + dt_t u_t B_t from h_0 = 0; y_t = h_t C_t.
    u, dt (B, L, di); a (di, n); bm, cm (B, L, n) -> y (B, L, di)."""
    bsz, length, di = u.shape
    h = torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32, device=u.device)
    y = torch.empty((bsz, length, di), dtype=torch.float32, device=u.device)
    for t0 in range(0, length, SCAN_BLOCK):
        t1 = min(t0 + SCAN_BLOCK, length)
        decay = torch.exp(dt[:, t0:t1, :, None] * a)                       # (B, T, di, n)
        drive = (dt[:, t0:t1] * u[:, t0:t1])[..., None] * bm[:, t0:t1, None, :]
        c_col = cm[:, t0:t1, :, None]                                       # (B, T, n, 1)
        for i in range(t1 - t0):
            h = torch.addcmul(drive[:, i], h, decay[:, i])
            y[:, t0 + i] = torch.bmm(h, c_col[:, i])[..., 0]
    return y


def mamba(p, x, m, prec):
    di, n, rk = m["mamba_d_inner"], m["mamba_d_state"], m["mamba_dt_rank"]
    u, gate = prec.mm(x, p["w_in"]).split(di, dim=-1)
    w_conv = p["w_conv"].float()                                           # (d_conv, di)
    dc = w_conv.shape[0]
    full = torch.cat([u.new_zeros((u.shape[0], dc - 1, di)), u], dim=1)
    u = F.silu(sum(full[:, i:i + u.shape[1]] * w_conv[i] for i in range(dc)))
    dbc = prec.mm(u, p["w_x_dbc"])
    dt = F.softplus(prec.mm(dbc[..., :rk], p["w_dt"]))
    a = -torch.exp(p["a_log"].float())
    y = selective_scan(u, dt, a, dbc[..., rk:rk + n], dbc[..., rk + n:])
    y = (y + u * p["d_skip"].float()) * F.silu(gate)
    return prec.mm(y, p["w_out"])


def swiglu(p, x, prec):
    return prec.mm(F.silu(prec.mm(x, p["w_gate"])) * prec.mm(x, p["w_up"]), p["w_down"])


def capacity_keep(idx, n_experts, cap_tokens):
    """Whether each (token, choice) of ``idx`` (T, k) is within its expert's
    first ``cap_tokens`` choices, counted in token order, then choice order."""
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(flat.numel(), device=flat.device) - starts[flat[order]]
    return (rank < cap_tokens).reshape(idx.shape)


def moe(p, x, m, prec, capacity, margins=None):
    b, s, d = x.shape
    e, k = m["moe_experts"], m["moe_top_k"]
    flat = x.reshape(b * s, d)
    t = flat.shape[0]
    logits = prec.mm(flat, p["router"])
    if margins is not None and k < e:
        top = torch.topk(logits, k + 1, dim=-1).values
        margins.append((top[:, k - 1] - top[:, k]).reshape(b, s))
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    if capacity is not None:
        gates = gates * capacity_keep(idx, e, max(int(t * k * capacity / e), 4))
    y = torch.zeros_like(flat)
    ex = p["experts"]
    for expert in torch.unique(idx).tolist():
        tok, choice = torch.nonzero(idx == expert, as_tuple=True)
        one = {name: ex[name][expert] for name in ("w_gate", "w_up", "w_down")}
        y.index_add_(0, tok, swiglu(one, flat[tok], prec) * gates[tok, choice, None])
    if "shared" in p:
        y = y + swiglu(p["shared"], flat, prec)
    return y.reshape(b, s, d)


MIXERS = {"gqa": gqa, "mla": mla, "mamba": mamba}


def layer(p, kinds, x, m, prec, capacity, margins=None):
    mixer, ffn = kinds
    x = x + MIXERS[mixer](p["mixer"], rms_norm(p["norm1"], x, m["norm_eps"]), m, prec)
    if ffn == "none":
        return x
    h = rms_norm(p["norm2"], x, m["norm_eps"])
    if ffn == "swiglu":
        return x + swiglu(p["ffn"], h, prec)
    if ffn == "moe":
        return x + moe(p["ffn"], h, m, prec, capacity, margins)
    raise ValueError(f"unknown ffn {ffn!r}")


@torch.no_grad()
def logits_at(head, layers, model, tokens, at, *, capacity=None, precision="fp32", margins=None):
    """Logits (B, P, V) float32 at positions ``at`` (B, P) of ``tokens`` (B,
    S), each position seeing itself and what comes before it.

    ``head`` holds ``embed`` (V, D), ``final_norm`` and ``lm_head`` (D, V);
    ``layers`` one weight dict a layer, in the order of ``model["layers"]``.
    A batch of several rows is one request to the MoE's capacity: give
    ``capacity`` only with one request a call.  A list ``margins`` gets one
    (B, S) tensor a MoE layer: each token's k-th router logit less its
    (k+1)-th."""
    prec = Precision(precision)
    if len(layers) != len(model["layers"]):
        raise ValueError(f"{len(layers)} layers of weights for {len(model['layers'])} layers")
    x = head["embed"][tokens].float()
    for p, kinds in zip(layers, model["layers"]):
        x = layer(p, kinds, x, model, prec, capacity, margins)
    x = torch.gather(x, 1, at[..., None].expand(-1, -1, x.shape[-1]))
    return prec.mm(rms_norm(head["final_norm"], x, model["norm_eps"]), head["lm_head"])
