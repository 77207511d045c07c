"""Decoder-only model over stacked layer groups (the port of
``repro.models.transformer``).

  forward       training / prefill over full sequences (logits)
  init_params   concrete init from a ``torch.Generator``
  init_cache    decode caches per layer
  decode_step   one-token decode updating the cache in place

Parameters keep the reference's layout: ``stack{si}/l{li}/...`` with a
leading ``repeat`` axis, weights ``(d_in, d_out)``.  The reference scans
each stack with ``lax.scan``; here a Python loop walks the ``repeat`` axis
(no gradient is taken, so there is nothing to rematerialize).  The loop
also lets the residual stream change type between layers, as the
reference's unrolled stacks do: with bf16 activations and float32 weights
the first layer's ``x + h`` promotes the stream to float32.

This slice ports the ``gqa`` mixer and the ``swiglu``/``gelu`` FFNs.  The
``mla``, ``mamba``, ``mlstm``/``slstm`` mixers and ``moe`` FFNs raise
``NotImplementedError``; they wait for later slices (ROADMAP.md, module
queue 9).  ``logical_shard`` is the identity on one card and is left out.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig, LayerSpec
from . import attention as attn
from .blocks import (
    gelu_ffn,
    init_gelu_ffn,
    init_linear,
    init_swiglu,
    layer_norm,
    mm,
    rms_norm,
    swiglu_ffn,
    truncated_normal,
)

_MIXERS = ("gqa",)
_FFNS = ("swiglu", "gelu", "none")


def _check_ported(cfg: ArchConfig) -> None:
    for _, specs in cfg.stacks:
        for spec in specs:
            if spec.mixer not in _MIXERS or spec.ffn not in _FFNS:
                raise NotImplementedError(
                    f"{cfg.name}: layer kind ({spec.mixer}, {spec.ffn}) is not ported "
                    f"yet; this slice has mixers {_MIXERS} and FFNs {_FFNS} "
                    "(ROADMAP.md, module queue 9)"
                )


# ======================================================================
# parameter init
# ======================================================================
def _init_layer(gen, spec: LayerSpec, cfg: ArchConfig, stack, dtype):
    p: dict = {"mixer": attn.init_gqa(gen, cfg, stack=stack, dtype=dtype)}
    if spec.ffn == "swiglu":
        p["ffn"] = init_swiglu(gen, cfg.d_model, cfg.d_ff, stack=stack, dtype=dtype)
    elif spec.ffn == "gelu":
        p["ffn"] = init_gelu_ffn(gen, cfg.d_model, cfg.d_ff, stack=stack, bias=True, dtype=dtype)

    def ones():
        return torch.ones((*stack, cfg.d_model), dtype=dtype, device=gen.device)

    def zeros():
        return torch.zeros((*stack, cfg.d_model), dtype=dtype, device=gen.device)

    p["norm1"] = ones()
    if cfg.norm != "rms":
        p["norm1_b"] = zeros()
    if spec.ffn != "none":
        p["norm2"] = ones()
        if cfg.norm != "rms":
            p["norm2_b"] = zeros()
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32):
    """Random parameters on ``gen``'s device, in the reference's layout."""
    _check_ported(cfg)
    params: dict = {
        "embed": truncated_normal(gen, (cfg.vocab, cfg.d_model), 0.02, dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab, dtype=dtype)
    if cfg.frontend:
        params["frontend_proj"] = init_linear(gen, cfg.d_model, cfg.d_model, dtype=dtype)
    for si, (repeat, specs) in enumerate(cfg.stacks):
        params[f"stack{si}"] = {
            f"l{li}": _init_layer(gen, spec, cfg, (repeat,), dtype)
            for li, spec in enumerate(specs)
        }
    return params


# ======================================================================
# forward (training / prefill)
# ======================================================================
def _norm(p, name, x, cfg):
    if cfg.norm == "rms":
        return rms_norm(p[name], x)
    return layer_norm(p[name], p[name + "_b"], x)


def _ffn(p, spec: LayerSpec, x, cfg):
    if spec.ffn == "none":
        return x
    h = _norm(p, "norm2", x, cfg)
    h = swiglu_ffn(p["ffn"], h) if spec.ffn == "swiglu" else gelu_ffn(p["ffn"], h)
    return x + h


def _apply_layer(p, spec: LayerSpec, x, cfg, positions):
    h = attn.gqa_forward(p["mixer"], _norm(p, "norm1", x, cfg), cfg, positions=positions)
    return _ffn(p, spec, x + h, cfg)


def _layers(params, cfg):
    """(stack key, repeat index, layer key, spec, that layer's params)."""
    for si, (repeat, specs) in enumerate(cfg.stacks):
        gp = params[f"stack{si}"]
        for r in range(repeat):
            for li, spec in enumerate(specs):
                yield f"stack{si}", r, f"l{li}", spec, _index(gp[f"l{li}"], r)


def _index(tree, r):
    if isinstance(tree, dict):
        return {k: _index(t, r) for k, t in tree.items()}
    return tree[r]


def _run_stacks(params, x, cfg, positions):
    """Every stack's layers in order, ``repeat`` times each group."""
    for _, _, _, spec, lp in _layers(params, cfg):
        x = _apply_layer(lp, spec, x, cfg, positions)
    return x


def _logits(params, x, cfg):
    x = rms_norm(params["final_norm"], x)   # the final norm is RMS everywhere
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return mm(x, head.to(cfg.activation_dtype))


def forward(params, batch: dict, cfg: ArchConfig):
    """batch: tokens (B,S) [+ frontend_embeds (B,N,D)] -> (logits (B,S,V), aux)."""
    _check_ported(cfg)
    x = params["embed"][batch["tokens"]].to(cfg.activation_dtype)
    n_front = 0
    if cfg.frontend and "frontend_embeds" in batch:
        fe = mm(batch["frontend_embeds"].to(cfg.activation_dtype), params["frontend_proj"])
        dt = torch.promote_types(fe.dtype, x.dtype)
        x = torch.cat([fe.to(dt), x.to(dt)], dim=1)
        n_front = fe.shape[1]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = _run_stacks(params, x, cfg, positions)
    if n_front:
        x = x[:, n_front:]
    # no MoE layer is ported, so the auxiliary loss is 0
    return _logits(params, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)


# ======================================================================
# decode caches
# ======================================================================
def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    _check_ported(cfg)
    cache = {}
    for si, (repeat, specs) in enumerate(cfg.stacks):
        group = {}
        for li in range(len(specs)):
            one = attn.gqa_init_cache(cfg, batch, max_len, dtype, device)
            group[f"l{li}"] = {k: t[None].repeat(repeat, *[1] * t.dim()) for k, t in one.items()}
        cache[f"stack{si}"] = group
    return cache


def _decode_layer(p, spec: LayerSpec, x, cache, length, cfg):
    h, cache = attn.gqa_decode(p["mixer"], _norm(p, "norm1", x, cfg), cache, length, cfg)
    return _ffn(p, spec, x + h, cfg), cache


def decode_step(params, tokens, cache, length: int, cfg: ArchConfig):
    """One-token decode.  tokens: (B, 1) integers; length: cache fill.

    Returns (logits (B, 1, V), cache); the cache is updated in place.
    """
    _check_ported(cfg)
    x = params["embed"][tokens].to(cfg.activation_dtype)
    for sk, r, lk, spec, lp in _layers(params, cfg):
        x, _ = _decode_layer(lp, spec, x, _index(cache[sk][lk], r), length, cfg)
    return _logits(params, x, cfg), cache
