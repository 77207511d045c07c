"""Mixture-of-Experts layer, the single-device part (the port of
``repro.models.moe``).

Fine-grained experts with optional shared experts and top-k routing, two
dispatch modes:

* ``onehot``  GShard-classic dense dispatch/combine einsums with a
  (tokens, E, C) one-hot tensor;
* ``gather``  capacity dispatch by gather and scatter.

Both drop tokens beyond an expert's capacity and return the switch-style
load-balancing aux loss.  The reference's expert-parallel modes
(``shard_map``, ``inference_ep``) need a device mesh; without one the
reference runs ``shard_map`` configs through ``gather``, and so does the
port, which has no mesh yet: :func:`moe_forward` raises for a mesh until
the sharding slice (ROADMAP.md, module queue 9).  MoE has no Pallas
kernel; it is plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .blocks import init_linear, init_swiglu, mm, swiglu_ffn


def init_moe(gen, cfg, *, stack=(), dtype=torch.float32):
    d, e, fe = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    p = {
        "router": init_linear(gen, d, e, stack=stack, dtype=dtype),
        "experts": init_swiglu(gen, d, fe, stack=(*stack, e), dtype=dtype),
    }
    if cfg.moe_shared > 0:
        p["shared"] = init_swiglu(gen, d, fe * cfg.moe_shared, stack=stack, dtype=dtype)
    return p


def _routing(p, x, cfg):
    """Top-k gates (T, k) in x's dtype, expert ids (T, k) and the aux loss.

    Ties keep the lower expert id first, as ``jax.lax.top_k`` does (a
    stable descending sort)."""
    e, k = cfg.moe_experts, cfg.moe_top_k
    logits = mm(x, p["router"]).float()                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    # switch aux loss: E * sum_e (frac_tokens_e * mean_prob_e)
    onehot_top1 = F.one_hot(idx[:, 0], e).float()
    aux = e * torch.mean(onehot_top1.mean(dim=0) * probs.mean(dim=0))
    return gates.to(x.dtype), idx, aux


def _capacity(cfg, tokens: int) -> int:
    c = int(tokens * cfg.moe_top_k * cfg.moe_capacity / cfg.moe_experts)
    return max(c, 4)


def _run_experts(p, expert_in):
    """Per-expert SwiGLU over (E, C, D) with stacked weights (E, D, F)."""
    ex = p["experts"]
    h = F.silu(mm(expert_in, ex["w_gate"])) * mm(expert_in, ex["w_up"])
    return mm(h, ex["w_down"])


def _einsum(eq, *ops):
    """``torch.einsum`` in the promoted type of its operands, as JAX's."""
    dt = ops[0].dtype
    for t in ops[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(eq, *(t.to(dt) for t in ops))


def _dispatch_onehot(p, x, gates, idx, cfg):
    """GShard dense dispatch: (T, E, C) mask einsums."""
    t = x.shape[0]
    e = cfg.moe_experts
    c = _capacity(cfg, t)
    oh_e = F.one_hot(idx, e)                                  # (T, k, E) int64
    flat = oh_e.reshape(-1, e)
    pos = (torch.cumsum(flat, dim=0) - flat) * flat
    pos = pos.sum(dim=-1).reshape(idx.shape)                  # (T, k)
    # a position past the capacity matches no slot: the choice is dropped
    oh_c = (pos[..., None] == torch.arange(c, device=x.device)).to(x.dtype)
    oh_e = oh_e.to(x.dtype)
    dispatch = _einsum("tke,tkc->tec", oh_e, oh_c)
    expert_in = _einsum("tec,td->ecd", dispatch, x)
    expert_out = _run_experts(p, expert_in)
    combine = _einsum("tke,tkc,tk->tec", oh_e, oh_c, gates)
    return _einsum("tec,ecd->td", combine, expert_out)


def _dispatch_gather(p, x, gates, idx, cfg):
    """Capacity dispatch by scatter and gather (no dense (T, E, C) einsum)."""
    t, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    c = _capacity(cfg, t)
    flat_idx = idx.reshape(-1)                                # (T*k,)
    oh = F.one_hot(flat_idx, e)
    pos = (torch.cumsum(oh, dim=0) - oh).gather(1, flat_idx[:, None])[:, 0]
    keep = pos < c
    # every dropped choice writes the overflow row e*c, which is discarded
    slot = torch.where(keep, flat_idx * c + pos, e * c)
    buf = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x.repeat_interleave(k, dim=0)                 # jnp.repeat(x, k, axis=0)
    expert_out = _run_experts(p, buf[:e * c].reshape(e, c, d)).reshape(e * c, d)
    expert_out = torch.cat([expert_out, expert_out.new_zeros((1, d))])
    w = gates.reshape(-1)[:, None] * keep[:, None].to(gates.dtype)
    picked = expert_out[slot] * w
    return picked.reshape(t, k, -1).sum(dim=1)


def moe_forward(p, x, cfg, *, mesh=None):
    """x: (B, S, D) -> (y, aux_loss).

    Without a mesh the reference runs ``shard_map`` as ``gather`` and
    ignores ``inference_ep``; the port does the same.  A mesh raises."""
    if mesh is not None:
        raise NotImplementedError(
            "expert-parallel MoE dispatch (shard_map, inference_ep) needs the "
            "sharding slice (ROADMAP.md, module queue 9)"
        )
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    gates, idx, aux = _routing(p, flat, cfg)
    if cfg.moe_dispatch == "onehot":
        y = _dispatch_onehot(p, flat, gates, idx, cfg)
    elif cfg.moe_dispatch in ("gather", "shard_map"):
        y = _dispatch_gather(p, flat, gates, idx, cfg)
    else:
        raise ValueError(f"unknown moe_dispatch {cfg.moe_dispatch!r}")
    if "shared" in p:
        y = y + swiglu_ffn(p["shared"], flat)
    return y.reshape(b, s, -1), aux
