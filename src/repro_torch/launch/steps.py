"""Prefill and serve steps (the port of ``repro.launch.steps``).

``make_train_step`` waits for the training slice (ROADMAP.md, module
queue 9).  The steps run without autograd: serving takes no gradient.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models import transformer as tf


def make_prefill_step(cfg: ArchConfig):
    """(params, batch) -> logits for the full prompt (no cache write-back:
    the prefill cell measures the prompt-processing compute)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = tf.forward(params, batch, cfg)
        return logits

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """One-token decode against a cache: (params, cache, tokens, cache_len)
    -> (logits, cache), the cache updated in place."""

    @torch.no_grad()
    def serve_step(params, cache, tokens, cache_len):
        return tf.decode_step(params, tokens, cache, cache_len, cfg)

    return serve_step
