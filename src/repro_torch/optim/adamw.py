"""AdamW with float32, bf16 or int8 moments (the port of ``repro.optim.adamw``).

``state_dtype`` selects the moments' storage.  int8 moments are quantized in
blocks of ``block`` along the parameter's last axis with a per-block absmax
scale (the leading dims kept, as the reference keeps them for sharding), and
v is stored log-quantized: linear int8 would round a block's small entries
to zero, and ``1/sqrt(v) + eps`` would explode.

Every tree is walked in ``repro_torch.tree``'s order, the reference's: the
global-norm clip sums the leaves in it.  Arithmetic is float32, in the
reference's order of operations; ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..launch.sharding import split_dim
from ..tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"   # float32 | bfloat16 | int8
    block: int = 128               # int8 quantization block


def _pad_last(x: torch.Tensor, block: int) -> torch.Tensor:
    pad = (-x.shape[-1]) % block
    if not pad:
        return x
    # a concatenation of zeros, not F.pad: torch 2.11's DTensor fails on the
    # padding of a sharded tensor
    return torch.cat([x, torch.zeros((*x.shape[:-1], pad), dtype=x.dtype, device=x.device)],
                     dim=-1)


def _quantize(x: torch.Tensor, block: int):
    xp = _pad_last(x, block)
    nb = xp.shape[-1] // block
    # a sharded last dim whose shards do not hold whole blocks is gathered
    blocks = split_dim(xp, -1, (nb, block))
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q.flatten(-2), scale[..., 0].float()


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape, block: int) -> torch.Tensor:
    nb = q.shape[-1] // block
    blocks = split_dim(q, -1, (nb, block)).float()
    full = (blocks * scale[..., None]).flatten(-2)
    return full[..., : shape[-1]]


_V_FLOOR = 1e-16
#: a log-quantized v at or below this decodes as 0: float32 log(1e-16) plus
#: 1e-3 in float32, as the reference computes it
_LOG_V_ZERO = float(torch.log(torch.tensor(_V_FLOOR, dtype=torch.float32)) + 1e-3)

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _is_moment_leaf(x) -> bool:
    return isinstance(x, dict) and "q" in x


def _moment_read(m, shape, cfg: AdamWConfig, *, kind: str = "m") -> torch.Tensor:
    if cfg.state_dtype == "int8":
        full = _dequantize(m["q"], m["scale"], shape, cfg.block)
        if kind == "v":
            return torch.where(full <= _LOG_V_ZERO, 0.0, torch.exp(full))
        return full
    return m.float()


def _moment_write(val: torch.Tensor, cfg: AdamWConfig, *, kind: str = "m"):
    if cfg.state_dtype == "int8":
        if kind == "v":
            val = torch.log(torch.clamp_min(val, _V_FLOOR))
        q, scale = _quantize(val, cfg.block)
        return {"q": q, "scale": scale}
    return val.to(_MOMENT_DTYPES[cfg.state_dtype])


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """``{"step": 0 (int32), "m": ..., "v": ...}`` on the parameters' device;
    int8 zeros go through the codec, so a zero v decodes as zero."""
    device = tree_leaves(params)[0].device

    def zero(p, kind):
        return _moment_write(torch.zeros(p.shape, dtype=torch.float32, device=p.device), cfg,
                             kind=kind)

    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(lambda p: zero(p, "m"), params),
        "v": tree_map(lambda p: zero(p, "v"), params),
    }


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step with a global-norm clip in float32; returns
    ``(new_params, new_state)`` and leaves its arguments as they were."""
    step = state["step"] + 1
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
    clip = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        g = g.float() * clip
        m_f = _moment_read(m, p.shape, cfg, kind="m")
        v_f = _moment_read(v, p.shape, cfg, kind="v")
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * g * g
        step_ = (m_f / b1c) / (torch.sqrt(v_f / b2c) + cfg.eps)
        decay = cfg.weight_decay * p.float() if p.dim() >= 2 else 0.0
        new_p = (p.float() - lr * (step_ + decay)).to(p.dtype)
        return new_p, _moment_write(m_f, cfg, kind="m"), _moment_write(v_f, cfg, kind="v")

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads),
        tree_leaves(state["m"], _is_moment_leaf), tree_leaves(state["v"], _is_moment_leaf))]
    return tree_unflatten(params, [o[0] for o in out]), {
        "step": step,
        "m": tree_unflatten(params, [o[1] for o in out]),
        "v": tree_unflatten(params, [o[2] for o in out]),
    }
