"""Shared building blocks of the LM substrate (the port of ``repro.models.blocks``).

Parameters are nested dicts of tensors and every block is a function
``f(params, x, ...) -> y``.  Weights are ``(d_in, d_out)`` and applied as
``x @ W``.  Initializers draw from an explicit ``torch.Generator`` and
allocate on its device; given :data:`SHAPE_ONLY` they make ``meta``
tensors.

Mixed types follow the reference's promotion: JAX promotes ``bf16 @ f32``
to float32, while ``torch.matmul`` refuses mixed operands, so every
product goes through :func:`mm`, which casts both sides up to
``torch.promote_types`` and never casts a weight down.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..device import resolve


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted type of the two operands."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


class ShapeOnly:
    """A stand-in for a ``torch.Generator`` on the ``meta`` device: the
    initialisers given it make ``meta`` tensors of their parameters' shapes
    and dtypes, allocate nothing and draw nothing (``init_abstract``)."""

    device = torch.device("meta")


SHAPE_ONLY = ShapeOnly()


def is_shape_only(gen) -> bool:
    return gen.device.type == "meta"


def truncated_normal(gen: torch.Generator, shape, scale, dtype=torch.float32):
    """``scale`` times a standard normal truncated to [-2, 2], on ``gen``'s
    device; a ``meta`` tensor for :data:`SHAPE_ONLY`."""
    if is_shape_only(gen):
        return torch.empty(shape, dtype=dtype, device="meta")
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(float(scale)).to(dtype)


def init_linear(gen, d_in, d_out, *, stack=(), dtype=torch.float32, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(max(d_in, 1))
    return truncated_normal(gen, (*stack, d_in, d_out), scale, dtype)


# ----------------------------------------------------------------------
def rms_norm(w: torch.Tensor, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w.float()).to(dtype)


def layer_norm(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, *, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dtype)


# ----------------------------------------------------------------------
def swiglu_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    """LLaMA-style gated FFN: down(silu(gate(x)) * up(x))."""
    h = F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"])
    return mm(h, p["w_down"])


def init_swiglu(gen, d_model, d_ff, *, stack=(), dtype=torch.float32):
    return {
        "w_gate": init_linear(gen, d_model, d_ff, stack=stack, dtype=dtype),
        "w_up": init_linear(gen, d_model, d_ff, stack=stack, dtype=dtype),
        "w_down": init_linear(gen, d_ff, d_model, stack=stack, dtype=dtype),
    }


def _add_bias(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    return x + p[name] if name in p else x


def gelu_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Plain 2-layer GELU FFN (StarCoder2, Phi-3 style).  ``jax.nn.gelu``
    defaults to the tanh approximation, so this uses it too."""
    h = F.gelu(_add_bias(mm(x, p["w_up"]), p, "b_up"), approximate="tanh")
    return _add_bias(mm(h, p["w_down"]), p, "b_down")


def init_gelu_ffn(gen, d_model, d_ff, *, stack=(), bias=True, dtype=torch.float32):
    p = {
        "w_up": init_linear(gen, d_model, d_ff, stack=stack, dtype=dtype),
        "w_down": init_linear(gen, d_ff, d_model, stack=stack, dtype=dtype),
    }
    if bias:
        p["b_up"] = torch.zeros((*stack, d_ff), dtype=dtype, device=gen.device)
        p["b_down"] = torch.zeros((*stack, d_model), dtype=dtype, device=gen.device)
    return p


# ----------------------------------------------------------------------
def rope_frequencies(d_head: int, *, theta: float = 10_000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=resolve(device)) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10_000.0):
    """x: (..., S, D_head); positions: broadcastable to (..., S).

    Rotates interleaved pairs ``(x[..., 0::2], x[..., 1::2])``, as the
    reference does, not the two halves of the head.
    """
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta=theta, device=x.device)      # (d/2,)
    angles = positions[..., None].float() * freqs                   # (..., S, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# ----------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in float32.

    As the reference: logsumexp over float32 logits, and the gold logit
    taken in the logits' type by a contraction with a one-hot of the labels
    (built in that type, without an int64 one-hot of the logits' size).  All
    but one term of the contraction are zeros, so it is the gathered logit.
    """
    logz = torch.logsumexp(logits.float(), dim=-1)
    onehot = torch.zeros_like(logits).scatter(-1, labels[..., None].long(), 1.0)
    gold = torch.einsum("...v,...v->...", logits, onehot).float()
    return torch.mean(logz - gold)
