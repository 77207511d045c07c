"""Train, prefill and serve steps (the port of ``repro.launch.steps``).

The train step differentiates ``transformer.loss_fn`` with
``torch.autograd.grad`` over the parameter leaves in the reference's leaf
order and applies AdamW.  It runs on one device, or on DTensors under an
LM mesh (``launch.sharding.use_mesh``): then the new params and optimizer
state keep the layouts they came in with, as the reference's jitted step
keeps its ``out_shardings`` equal to its ``in_shardings``.  The prefill and
serve steps run without autograd: serving takes no gradient.
"""

from __future__ import annotations

import torch

from .. import obs
from ..configs.base import ArchConfig
from ..models import transformer as tf
from ..optim import (AdamWConfig, adamw_update, cosine_schedule, decompress_int8,
                     ef_compress_gradients)
from ..tree import tree_leaves, tree_map, tree_unflatten
from .sharding import split_dim


def loss_and_grads(params, batch: dict, cfg: ArchConfig):
    """``(loss, grads)``: ``loss_fn`` and its gradient in every parameter leaf,
    the counterpart of ``jax.value_and_grad(loss_fn)``.  A leaf the loss does
    not reach raises (``torch.autograd.grad`` without ``allow_unused``)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = tf.loss_fn(tree_unflatten(params, leaves), batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def _keep_layout(new, old):
    """Each DTensor leaf of ``new`` laid out as the leaf of ``old`` at its
    place (the update's elementwise ops may leave another layout)."""
    from torch.distributed.tensor import DTensor

    def keep(n, o):
        if isinstance(o, DTensor) and tuple(n.placements) != tuple(o.placements):
            return n.redistribute(o.device_mesh, o.placements)
        return n

    return tree_map(keep, new, old)


def make_train_step(cfg: ArchConfig, opt: AdamWConfig, *, accum: int = 1,
                    accum_dtype=torch.bfloat16, compress_grads: bool = False):
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    arguments left as they were; ``metrics`` holds ``loss`` and
    ``grad_norm`` as 0-dim float32 tensors on the parameters' device.

    ``accum`` > 1 splits the batch into that many microbatches and sums
    their gradients in ``accum_dtype``.  ``compress_grads`` applies int8
    error-feedback compression to the gradients (the residual rides in the
    optimizer state as ``ef``).
    """

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, grads = loss_and_grads(params, batch, cfg)
        else:
            # a batch sharded over more ranks than a microbatch has rows is
            # gathered first (sharding.split_dim)
            micro = {k: split_dim(t, 0, (accum, t.shape[0] // accum)) for k, t in batch.items()}
            loss = 0.0
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype, device=p.device),
                             params)
            for i in range(accum):
                part, g = loss_and_grads(params, {k: t[i] for k, t in micro.items()}, cfg)
                grads = tree_map(lambda a, b: a + b.to(accum_dtype), grads, g)
                loss = loss + part
            loss = loss / accum
            grads = tree_map(lambda g: g / accum, grads)
        if compress_grads:
            comp, ef = ef_compress_gradients(grads, opt_state.get("ef"), block=256)
            grads = tree_map(lambda pair, g: decompress_int8(*pair, g.shape), comp, grads,
                             is_leaf=lambda x: isinstance(x, tuple))
            opt_state = dict(opt_state, ef=ef)
        ef_state = opt_state.get("ef")
        old = (params, {k: v for k, v in opt_state.items() if k != "ef"})
        params, opt_state = _keep_layout(adamw_update(
            params, grads, old[1], opt, cosine_schedule(opt_state["step"])), old)
        if ef_state is not None:
            opt_state = dict(opt_state, ef=ef_state)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ArchConfig):
    """(params, batch) -> logits for the full prompt (no cache write-back:
    the prefill cell measures the prompt-processing compute)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        with obs.span("step.prefill", batch["tokens"]):
            logits, _ = tf.forward(params, batch, cfg)
        return logits

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """One-token decode against a cache: (params, cache, tokens, cache_len)
    -> (logits, cache), the cache updated in place."""

    @torch.no_grad()
    def serve_step(params, cache, tokens, cache_len):
        with obs.span("step.decode", tokens):
            return tf.decode_step(params, tokens, cache, cache_len, cfg)

    return serve_step
