"""Decoder-only model over stacked layer groups (the port of
``repro.models.transformer``).

  forward       training / prefill over full sequences (logits)
  loss_fn       mean token cross-entropy plus the weighted MoE aux loss
  init_params   concrete init from a ``torch.Generator``;
  init_abstract the same tree as ``meta`` tensors (no allocation)
  init_cache    decode caches per layer (``init_cache_abstract``: ``meta``)
  decode_step   one-token decode updating the cache in place

Parameters keep the reference's layout: ``stack{si}/l{li}/...`` with a
leading ``repeat`` axis, weights ``(d_in, d_out)``.  The reference scans
each stack with ``lax.scan``; here a Python loop walks the ``repeat`` axis,
and under autograd with ``remat="full"`` each layer group runs under
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint(group_fn)``.
The loop also lets the residual stream change type between layers, as the
reference's unrolled stacks do: with bf16 activations and float32 weights
the first layer's ``x + h`` promotes the stream to float32.

Every layer kind of the reference is ported: the ``gqa``, ``mla``,
``mamba``, ``mlstm`` and ``slstm`` mixers and the ``swiglu``, ``gelu`` and
``moe`` FFNs (or none); an unknown kind raises ``ValueError``, as the
reference's.  ``logical_shard`` sits at the reference's four sites: the
identity without an LM mesh, on a DTensor a redistribution to the batch
axes (and the vocab over ``"model"`` for the logits).  While a profiler
collects, the embedding, each layer's mixer and FFN (norm, sublayer and
residual) and the head are ``obs`` spans.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import obs
from ..configs.base import ArchConfig, LayerSpec
from ..launch.sharding import embedding, lm_mesh, logical_shard, use_mesh
from . import attention as attn
from . import mamba as mam
from . import moe as moe_mod
from . import xlstm as xl
from .blocks import (
    SHAPE_ONLY,
    cross_entropy,
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


# ======================================================================
# parameter init
# ======================================================================
def _init_layer(gen, spec: LayerSpec, cfg: ArchConfig, stack, dtype):
    if spec.mixer == "gqa":
        init_mixer = attn.init_gqa
    elif spec.mixer == "mla":
        init_mixer = attn.init_mla
    elif spec.mixer == "mamba":
        init_mixer = mam.init_mamba
    elif spec.mixer == "mlstm":
        init_mixer = xl.init_mlstm
    elif spec.mixer == "slstm":
        init_mixer = xl.init_slstm
    else:
        raise ValueError(spec.mixer)
    p: dict = {"mixer": init_mixer(gen, cfg, stack=stack, dtype=dtype)}
    if spec.ffn == "swiglu":
        p["ffn"] = init_swiglu(gen, cfg.d_model, cfg.d_ff, stack=stack, dtype=dtype)
    elif spec.ffn == "gelu":
        p["ffn"] = init_gelu_ffn(gen, cfg.d_model, cfg.d_ff, stack=stack, bias=True, dtype=dtype)
    elif spec.ffn == "moe":
        p["ffn"] = moe_mod.init_moe(gen, cfg, stack=stack, dtype=dtype)
    elif spec.ffn != "none":
        raise ValueError(spec.ffn)

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


def init_abstract(cfg: ArchConfig):
    """Shape-only params in ``cfg.activation_dtype`` (the reference's
    ``eval_shape``): ``meta`` tensors, nothing allocated or drawn."""
    return init_params(cfg, SHAPE_ONLY, dtype=cfg.activation_dtype)


# ======================================================================
# forward (training / prefill)
# ======================================================================
def _norm(p, name, x, cfg):
    if cfg.norm == "rms":
        return rms_norm(p[name], x)
    return layer_norm(p[name], p[name + "_b"], x)


def _ffn(p, spec: LayerSpec, x, cfg):
    """``x`` plus the layer's FFN of it, and the FFN's MoE aux loss (or None)."""
    if spec.ffn == "none":
        return x, None
    with obs.span("ffn." + spec.ffn, x):
        h = _norm(p, "norm2", x, cfg)
        aux = None
        if spec.ffn == "swiglu":
            h = swiglu_ffn(p["ffn"], h)
        elif spec.ffn == "gelu":
            h = gelu_ffn(p["ffn"], h)
        else:
            h, aux = moe_mod.moe_forward(p["ffn"], h, cfg)
        return x + h, aux


def _apply_layer(p, spec: LayerSpec, x, cfg, positions):
    with obs.span("mixer." + spec.mixer, x):
        h = _norm(p, "norm1", x, cfg)
        if spec.mixer == "gqa":
            h = attn.gqa_forward(p["mixer"], h, cfg, positions=positions)
        elif spec.mixer == "mla":
            h = attn.mla_forward(p["mixer"], h, cfg, positions=positions)
        elif spec.mixer == "mamba":
            h = mam.mamba_forward(p["mixer"], h, cfg)
        elif spec.mixer == "mlstm":
            h = xl.mlstm_forward(p["mixer"], h, cfg)
        elif spec.mixer == "slstm":
            h = xl.slstm_forward(p["mixer"], h, cfg)
        else:
            raise ValueError(spec.mixer)
        x = x + h
    x, aux = _ffn(p, spec, x, cfg)
    return logical_shard(x, "act"), aux


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


def _unbind(tree) -> list:
    """The slices of a stacked tree along its ``repeat`` axis, a tree each.
    One ``unbind`` a leaf: its backward writes the stacked gradient once,
    where indexing each slice would add a zero-padded full-size gradient a
    slice (``repeat`` squared leaf sizes of traffic)."""
    if isinstance(tree, dict):
        parts = {k: _unbind(t) for k, t in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[r] for k, v in parts.items()} for r in range(n)]
    return list(tree.unbind(0))


def _run_stacks(params, x, cfg, positions):
    """Every stack's layer groups in order, ``repeat`` times each; returns
    (x, the summed MoE aux loss, float32).  Under autograd with
    ``cfg.remat == "full"`` each group is checkpointed: its activations are
    recomputed in the backward."""
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    mesh = lm_mesh()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, (repeat, specs) in enumerate(cfg.stacks):

        def group_fn(x, gp, specs=specs):
            # remat's recompute runs on autograd's thread on the card, which
            # does not see this thread's ambient mesh: enter it again
            with use_mesh(mesh):
                aux = torch.zeros((), dtype=torch.float32, device=x.device)
                for li, spec in enumerate(specs):
                    x, a = _apply_layer(gp[f"l{li}"], spec, x, cfg, positions)
                    if a is not None:
                        aux = aux + a
            return x, aux

        for gp in _unbind(params[f"stack{si}"]):
            x, aux = checkpoint(group_fn, x, gp, use_reentrant=False) if remat else group_fn(x, gp)
            aux_total = aux_total + aux
    return x, aux_total


def _logits(params, x, cfg):
    with obs.span("head", x):
        x = rms_norm(params["final_norm"], x)   # the final norm is RMS everywhere
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return mm(x, head.to(cfg.activation_dtype))


def forward(params, batch: dict, cfg: ArchConfig):
    """batch: tokens (B,S) [+ frontend_embeds (B,N,D)] -> (logits (B,S,V), aux)."""
    # F.embedding (sharding.embedding), not indexing: its backward adds each
    # token's row in a fixed order, where indexing's (index_put_ with
    # accumulate) adds them with atomics on the CPU, so two runs part and a
    # restart is not exact
    with obs.span("embed", batch["tokens"]):
        x = embedding(batch["tokens"], params["embed"]).to(cfg.activation_dtype)
        n_front = 0
        if cfg.frontend and "frontend_embeds" in batch:
            fe = mm(batch["frontend_embeds"].to(cfg.activation_dtype), params["frontend_proj"])
            dt = torch.promote_types(fe.dtype, x.dtype)
            x = torch.cat([fe.to(dt), x.to(dt)], dim=1)
            n_front = fe.shape[1]
    x = logical_shard(x, "act")
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, aux = _run_stacks(params, x, cfg, positions)
    if n_front:
        x = x[:, n_front:]
    return logical_shard(_logits(params, x, cfg), "logits"), aux


def loss_fn(params, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """batch: tokens and labels (B,S) -> the mean token cross-entropy plus
    ``cfg.aux_loss_weight`` times the MoE aux loss, float32."""
    logits, aux = forward(params, batch, cfg)
    return cross_entropy(logits, batch["labels"]) + cfg.aux_loss_weight * aux


# ======================================================================
# decode caches
# ======================================================================
def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """Per layer: an attention layer's cache in ``dtype`` (GQA's K and V,
    MLA's latent and RoPE key), a Mamba or xLSTM layer's float32 recurrent
    state (as the reference's)."""
    cache = {}
    for si, (repeat, specs) in enumerate(cfg.stacks):
        group = {}
        for li, spec in enumerate(specs):
            if spec.mixer == "gqa":
                one = attn.gqa_init_cache(cfg, batch, max_len, dtype, device)
            elif spec.mixer == "mla":
                one = attn.mla_init_cache(cfg, batch, max_len, dtype, device)
            elif spec.mixer == "mamba":
                one = mam.mamba_init_state(cfg, batch, device=device)
            elif spec.mixer == "mlstm":
                one = xl.mlstm_init_state(cfg, batch, device=device)
            elif spec.mixer == "slstm":
                one = xl.slstm_init_state(cfg, batch, device=device)
            else:
                raise ValueError(spec.mixer)
            group[f"l{li}"] = {k: t[None].repeat(repeat, *[1] * t.dim()) for k, t in one.items()}
        cache[f"stack{si}"] = group
    return cache


def init_cache_abstract(cfg: ArchConfig, batch: int, max_len: int):
    """Shape-only decode caches (the reference's ``eval_shape`` of
    ``init_cache`` at its default bf16): ``meta`` tensors."""
    return init_cache(cfg, batch, max_len, device="meta")


def _decode_layer(p, spec: LayerSpec, x, cache, length, cfg):
    with obs.span("mixer." + spec.mixer, x):
        h = _norm(p, "norm1", x, cfg)
        if spec.mixer == "gqa":
            h, cache = attn.gqa_decode(p["mixer"], h, cache, length, cfg)
        elif spec.mixer == "mla":
            h, cache = attn.mla_decode(p["mixer"], h, cache, length, cfg)
        elif spec.mixer == "mamba":
            h, cache = mam.mamba_decode(p["mixer"], h, cache, cfg)
        elif spec.mixer == "mlstm":
            h, cache = xl.mlstm_decode(p["mixer"], h, cache, cfg)
        elif spec.mixer == "slstm":
            h, cache = xl.slstm_decode(p["mixer"], h, cache, cfg)
        else:
            raise ValueError(spec.mixer)
        x = x + h
    return _ffn(p, spec, x, cfg)[0], cache


def decode_step(params, tokens, cache, length: int, cfg: ArchConfig):
    """One-token decode.  tokens: (B, 1) integers; length: cache fill.

    Returns (logits (B, 1, V), cache); the cache is updated in place.
    """
    with obs.span("embed", tokens):
        x = logical_shard(embedding(tokens, params["embed"]).to(cfg.activation_dtype), "act")
    for sk, r, lk, spec, lp in _layers(params, cfg):
        x, _ = _decode_layer(lp, spec, x, _index(cache[sk][lk], r), length, cfg)
    return _logits(params, x, cfg), cache
