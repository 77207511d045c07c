"""Gradient compression with error feedback (the port of
``repro.optim.compression``).

int8 blockwise quantization of the gradients, the payload a cross-pod
data-parallel all-reduce would carry; error feedback keeps the quantization
residual and adds it back at the next step.  On one device the train step
compresses and decompresses in place of that all-reduce
(``launch/steps.make_train_step(compress_grads=True)``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..tree import tree_leaves, tree_map, tree_unflatten


def compress_int8(g: torch.Tensor, block: int = 256):
    """(q (n_blocks, block) int8, scale (n_blocks, 1) float32) of ``g``
    flattened and zero-padded to whole blocks; ``torch.round`` rounds half
    to even, as ``jnp.round``."""
    flat = g.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def ef_compress_gradients(grads, error_state, block: int = 256):
    """Error-feedback compression of a gradient tree: (a tree of (q, scale)
    pairs, the new error state).  ``error_state`` None starts from zeros."""
    if error_state is None:
        error_state = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
    pairs, errors = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(error_state)):
        corrected = g.float() + e
        q, scale = compress_int8(corrected, block)
        pairs.append((q, scale))
        errors.append(corrected - decompress_int8(q, scale, g.shape))
    return tree_unflatten(grads, pairs), tree_unflatten(grads, errors)
