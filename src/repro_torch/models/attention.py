"""Attention of the LM substrate (the port of ``repro.models.attention``).

* GQA (grouped-query) with RoPE, an optional QKV bias (Qwen) and an
  optional sliding window (StarCoder2).  Prefill attention goes through
  ``kernels.ops.flash_attention``: the hand-written CUDA kernel for a CUDA
  tensor, its plain PyTorch version for a CPU tensor.
* MLA (multi-head latent attention, DeepSeek-V3): a low-rank compressed KV
  with a decoupled RoPE key shared by all heads.  Prefill runs the
  decompressed form through the masked dense :func:`_sdpa` on every
  device, as the reference does on every backend (its MLA reaches no
  Pallas kernel); decode runs the absorbed form against the compressed
  cache.

Decode stays plain PyTorch, as the reference's decode reaches no Pallas
kernel.  KV caches are fixed-capacity buffers written at an explicit
length: GQA's (B, Hkv, cap, D), with a sliding window a ring of ``window``
slots; MLA's latent (B, max_len, kv_rank) and RoPE key (B, max_len,
rope_dim).  The port writes a cache in place and returns it.
"""

from __future__ import annotations

import math

import torch

from .. import device as device_mod
from .. import obs
from ..kernels import ops
from ..launch import sharding as sh
from .blocks import apply_rope, init_linear, mm


# ======================================================================
# dense masked attention (the reference's _sdpa), MLA's path on every device
# ======================================================================
_SDPA_CHUNK = 2048


def _sdpa_block(q, k, v, *, causal, window, q_offset, kv_len, scale):
    """Scores, softmax and the weighted sum in float32, over one block of
    query rows starting at ``q_offset``; a fully masked row gives 0."""
    sq, skv = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s.mul_(scale)
    q_idx = q_offset + torch.arange(sq, device=q.device)[:, None]
    kv_idx = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_idx >= kv_idx
    if window and window > 0:
        mask &= (q_idx - kv_idx) < window
    if kv_len is not None:
        mask &= kv_idx < kv_len
    s.masked_fill_(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    del s
    p = torch.where(torch.isnan(p), 0.0, p)          # fully masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _sdpa(q, k, v, *, causal, window, q_offset=0, kv_len=None):
    """q: (B, H, Sq, D), k: (B, H, Skv, D), v: (B, H, Skv, Dv) -> (B, H, Sq, Dv)
    in q's type, softmax in float32, scale ``1/sqrt(D)``.

    Queries go in blocks of ``_SDPA_CHUNK`` rows, as the reference's: a
    block's float32 scores are (B, H, 2048, Skv).  ``v``'s head dim may
    differ from q's (MLA's 128 against 192)."""
    sq = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    kw = dict(causal=causal, window=window, kv_len=kv_len, scale=scale)
    if sq <= _SDPA_CHUNK:
        return _sdpa_block(q, k, v, q_offset=q_offset, **kw)
    return torch.cat([
        _sdpa_block(q[:, :, start:start + _SDPA_CHUNK], k, v, q_offset=q_offset + start, **kw)
        for start in range(0, sq, _SDPA_CHUNK)
    ], dim=2)


def _project(p, x, name, n_heads, dh):
    """(B, S, D) -> (B, n_heads, S, dh) through ``w{name}`` (+ ``b{name}``)."""
    y = mm(x, p["w" + name])
    if "b" + name in p:
        y = y + p["b" + name]
    return sh.split_dim(y, -1, (n_heads, dh)).transpose(1, 2)


# ======================================================================
# GQA
# ======================================================================
def init_gqa(gen, cfg, *, stack=(), dtype=torch.float32):
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": init_linear(gen, d, hq * dh, stack=stack, dtype=dtype),
        "wk": init_linear(gen, d, hkv * dh, stack=stack, dtype=dtype),
        "wv": init_linear(gen, d, hkv * dh, stack=stack, dtype=dtype),
        "wo": init_linear(gen, hq * dh, d, stack=stack, dtype=dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            p[name] = torch.zeros((*stack, width), dtype=dtype, device=gen.device)
    return p


def gqa_forward(p, x, cfg, *, positions=None, window=None):
    """Training / prefill self-attention. x: (B, S, D)."""
    s = x.shape[1]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = apply_rope(_project(p, x, "q", hq, dh), positions[:, None, :], theta=cfg.rope_theta)
    k = apply_rope(_project(p, x, "k", hkv, dh), positions[:, None, :], theta=cfg.rope_theta)
    v = _project(p, x, "v", hkv, dh)
    w = window if window is not None else cfg.window
    o = _flash(q, k, v, w or 0)
    return mm(sh.merge_dims(o.transpose(1, 2), 2), p["wo"])


def _flash(q, k, v, window: int):
    """Causal attention through ``ops.flash_attention`` (the reference's
    _grouped: the flash kernel on its accelerator, the masked dense path
    elsewhere; ops routes by the tensor's device).  On DTensors each rank
    runs it on its own shard (``local_call``): the batch over the batch
    axes, the heads over ``"model"`` where both head counts divide."""
    def attend(q, k, v):
        return ops.flash_attention(q, k, v, causal=True, window=window)

    mesh = getattr(q, "device_mesh", None)
    if mesh is None:
        return attend(q, k, v)
    n_model = sh.axis_sizes(mesh)["model"]
    heads = "model" if q.shape[1] % n_model == 0 and k.shape[1] % n_model == 0 else None
    spec = sh._fit(mesh, q.shape, (sh.batch_axes(mesh), heads, None, None))
    return sh.local_call(attend, (q, k, v), [spec] * 3, [spec], mesh)


def _per_head(fn, q, k, v):
    """``fn(q, k, v)``, attention over (B, H, S, D) tensors.  On DTensors
    whose head counts divide ``"model"`` each rank runs it on its own batch
    and heads (``local_call``, as :func:`_flash`): an einsum over a batch
    and a head dim that both are sharded is refused by torch 2.11's
    DTensor.  Otherwise (a sequence-sharded decode cache) it runs on the
    DTensors as they are."""
    mesh = getattr(q, "device_mesh", None)
    if mesh is None:
        return fn(q, k, v)
    n_model = sh.axis_sizes(mesh)["model"]
    if q.shape[1] % n_model or k.shape[1] % n_model:
        return fn(q, k, v)
    spec = sh._fit(mesh, q.shape, (sh.batch_axes(mesh), "model", None, None))
    return sh.local_call(fn, (q, k, v), [spec] * 3, [spec], mesh)


def gqa_init_cache(cfg, batch, max_len, dtype=torch.bfloat16, device=None):
    """Zeroed K and V buffers; ``device=None`` is the card."""
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    cap = min(max_len, cfg.window) if cfg.window else max_len
    device = device_mod.resolve(device)
    return {
        "k": torch.zeros((batch, hkv, cap, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, hkv, cap, dh), dtype=dtype, device=device),
    }


def gqa_decode(p, x, cache, length: int, cfg):
    """One-token decode. x: (B, 1, D); length: current cache fill.

    With a sliding window the cache is a rotating buffer of ``window``
    slots (slot ``length % cap``); without one the write clamps to the
    last slot, as the reference's ``dynamic_update_slice`` does.  The
    query groups attend to the shared KV heads without repeating them.
    """
    b = x.shape[0]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    length = int(length)
    pos = torch.full((b, 1), length, dtype=torch.int32, device=x.device)
    q = apply_rope(_project(p, x, "q", hq, dh), pos[:, None, :], theta=cfg.rope_theta)
    k = apply_rope(_project(p, x, "k", hkv, dh), pos[:, None, :], theta=cfg.rope_theta)
    v = _project(p, x, "v", hkv, dh)

    ck, cv = cache["k"], cache["v"]
    cap = ck.shape[2]
    slot = length % cap if cfg.window else min(length, cap - 1)
    sh.write_slot(ck, 2, slot, k[:, :, 0])
    sh.write_slot(cv, 2, slot, v[:, :, 0])
    kv_len = min(length + 1, cap)
    # each KV head's query group; KV heads that do not divide the model axis
    # are gathered first (the cache is then split by sequence)
    qg = sh.split_dim(q[:, :, 0], 1, (hkv, hq // hkv)).float()

    def attend(qg, ck, cv):
        s = torch.einsum("bhgd,bhsd->bhgs", qg, ck.float()) / math.sqrt(dh)
        s = s.masked_fill(torch.arange(cap, device=qg.device) >= kv_len, float("-inf"))
        prob = torch.softmax(s, dim=-1)
        return torch.einsum("bhgs,bhsd->bhgd", prob, cv.float())

    o = _per_head(attend, qg, ck, cv)
    return mm(o.to(x.dtype).flatten(1).unsqueeze(1), p["wo"]), cache


# ======================================================================
# MLA (DeepSeek-V3)
# ======================================================================
def init_mla(gen, cfg, *, stack=(), dtype=torch.float32):
    d, h = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.mla_q_rank, cfg.mla_kv_rank
    dn, dr, dv = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    return {
        "wq_a": init_linear(gen, d, rq, stack=stack, dtype=dtype),
        "wq_b": init_linear(gen, rq, h * (dn + dr), stack=stack, dtype=dtype),
        "wkv_a": init_linear(gen, d, rkv + dr, stack=stack, dtype=dtype),
        "wk_b": init_linear(gen, rkv, h * dn, stack=stack, dtype=dtype),
        "wv_b": init_linear(gen, rkv, h * dv, stack=stack, dtype=dtype),
        "wo": init_linear(gen, h * dv, d, stack=stack, dtype=dtype),
    }


def _mla_query(p, x, cfg, positions):
    """(q_nope (B, h, S, dn), q_rope (B, h, S, dr) rotated)."""
    h, dn, dr = cfg.n_heads, cfg.mla_nope_dim, cfg.mla_rope_dim
    q = sh.split_dim(mm(mm(x, p["wq_a"]), p["wq_b"]), -1, (h, dn + dr)).transpose(1, 2)
    return q[..., :dn], apply_rope(q[..., dn:], positions[:, None, :], theta=cfg.rope_theta)


def _mla_latent(p, x, cfg, positions):
    """(c_kv (B, S, kv_rank), k_rope (B, 1, S, dr) rotated: one head for all)."""
    rkv = cfg.mla_kv_rank
    kv = mm(x, p["wkv_a"])
    k_rope = apply_rope(kv[:, None, :, rkv:], positions[:, None, :], theta=cfg.rope_theta)
    return kv[..., :rkv], k_rope


def mla_forward(p, x, cfg, *, positions=None):
    """Training / prefill MLA in the decompressed form. x: (B, S, D)."""
    b, s, _ = x.shape
    h, dn, dr, dv = cfg.n_heads, cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _mla_query(p, x, cfg, positions)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    k_nope = sh.split_dim(mm(c_kv, p["wk_b"]), -1, (h, dn)).transpose(1, 2)
    v = sh.split_dim(mm(c_kv, p["wv_b"]), -1, (h, dv)).transpose(1, 2)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    # the shared RoPE key is broadcast over the heads, not copied per head
    k_full = torch.cat([k_nope, k_rope.expand(b, h, s, dr)], dim=-1)
    with obs.span("mla.sdpa", q_full):
        o = _per_head(lambda q, k, v: _sdpa(q, k, v, causal=True, window=0),   # 1/sqrt(dn + dr)
                      q_full, k_full, v)
    return mm(sh.merge_dims(o.transpose(1, 2), 2), p["wo"])


def mla_init_cache(cfg, batch, max_len, dtype=torch.bfloat16, device=None):
    """The compressed cache: the latent ``c_kv`` and the shared RoPE key
    (kv_rank + rope_dim values a token); ``device=None`` is the card."""
    device = device_mod.resolve(device)
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.mla_kv_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.mla_rope_dim), dtype=dtype, device=device),
    }


def mla_decode(p, x, cache, length: int, cfg):
    """One-token decode in the absorbed form against the compressed cache.
    x: (B, 1, D).  The new latent and RoPE key are written in place at
    ``min(length, max_len - 1)``, where the reference's
    ``dynamic_update_slice`` clamps them, and keys up to ``length`` attend."""
    b = x.shape[0]
    h, dn, dr, dv = cfg.n_heads, cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    length = int(length)
    pos = torch.full((b, 1), length, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_query(p, x, cfg, pos)               # (B, h, 1, dn), (B, h, 1, dr)
    c_new, kr_new = _mla_latent(p, x, cfg, pos)

    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    slot = min(length, c_kv.shape[1] - 1)
    sh.write_slot(c_kv, 1, slot, c_new[:, 0])
    sh.write_slot(k_rope, 1, slot, kr_new[:, 0, 0])

    # absorbed scores: q_nope . (W_kb c) = (q_nope W_kb^T) . c
    ckv = c_kv.float()
    wk = sh.split_dim(p["wk_b"], -1, (h, dn)).float()
    q_lat = torch.einsum("bhod,rhd->bhor", q_nope.float(), wk)          # (B, h, 1, rkv)
    s_lat = torch.einsum("bhor,bsr->bhos", q_lat, ckv)                  # (B, h, 1, S)
    s_rope = torch.einsum("bhod,bsd->bhos", q_rope.float(), k_rope.float())
    s_all = (s_lat + s_rope) * (1.0 / math.sqrt(dn + dr))
    s_all = s_all.masked_fill(torch.arange(c_kv.shape[1], device=x.device) > length,
                              float("-inf"))
    prob = torch.softmax(s_all, dim=-1)
    ctx_lat = torch.einsum("bhos,bsr->bhor", prob, ckv)
    wv = sh.split_dim(p["wv_b"], -1, (h, dv)).float()
    o = torch.einsum("bhor,rhd->bhod", ctx_lat, wv)
    o = o.to(x.dtype).transpose(1, 2).reshape(b, 1, h * dv)
    return mm(o, p["wo"]), cache
