"""Attention of the LM substrate (the port of ``repro.models.attention``).

GQA (grouped-query) with RoPE, an optional QKV bias (Qwen) and an optional
sliding window (StarCoder2).  Prefill attention goes through
``kernels.ops.flash_attention``: the hand-written CUDA kernel for a CUDA
tensor, its plain PyTorch version for a CPU tensor.  Decode stays plain
PyTorch, as the reference's decode reaches no Pallas kernel.

KV caches are fixed-capacity buffers (B, Hkv, cap, D) written at an
explicit length; with a sliding window the buffer is a ring of ``window``
slots.  The port writes the cache in place and returns it.
"""

from __future__ import annotations

import math

import torch

from .. import device as device_mod
from ..kernels import ops
from .blocks import apply_rope, init_linear, mm


def _project(p, x, name, n_heads, dh):
    """(B, S, D) -> (B, n_heads, S, dh) through ``w{name}`` (+ ``b{name}``)."""
    b, s, _ = x.shape
    y = mm(x, p["w" + name])
    if "b" + name in p:
        y = y + p["b" + name]
    return y.reshape(b, s, n_heads, dh).transpose(1, 2)


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
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = apply_rope(_project(p, x, "q", hq, dh), positions[:, None, :], theta=cfg.rope_theta)
    k = apply_rope(_project(p, x, "k", hkv, dh), positions[:, None, :], theta=cfg.rope_theta)
    v = _project(p, x, "v", hkv, dh)
    w = window if window is not None else cfg.window
    # the reference's _grouped: the flash kernel on its accelerator, the
    # masked dense path elsewhere; ops routes by the tensor's device
    o = ops.flash_attention(q, k, v, causal=True, window=w or 0)
    return mm(o.transpose(1, 2).reshape(b, s, hq * dh), p["wo"])


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
    ck[:, :, slot] = k[:, :, 0]
    cv[:, :, slot] = v[:, :, 0]
    kv_len = min(length + 1, cap)
    g = hq // hkv
    qg = q[:, :, 0].reshape(b, hkv, g, dh).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, ck.float()) / math.sqrt(dh)
    s[..., kv_len:] = float("-inf")
    prob = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", prob, cv.float())
    o = o.to(x.dtype).reshape(b, 1, hq * dh)
    return mm(o, p["wo"]), cache

