"""Architecture config schema and the shape cells.

The port's copy of ``repro.configs.base``: every architecture is one
:class:`ArchConfig`; heterogeneous stacks (Jamba groups, DeepSeek dense
prefix) are ``stacks``, a tuple of ``(repeat, (LayerSpec, ...))`` groups
whose parameters carry a leading ``repeat`` axis.  ``activation_dtype`` is
a ``torch.dtype``.  ``param_count`` and ``active_param_count`` count the
shape-only init; ``input_specs`` and ``decode_cache_specs`` give a shape
cell's inputs and decode caches as ``meta`` tensors (the reference's
``ShapeDtypeStruct``s).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside a scanned group."""

    mixer: str          # gqa | mla | mamba | mlstm | slstm
    ffn: str            # swiglu | gelu | moe | none


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    stacks: tuple                    # ((repeat, (LayerSpec, ...)), ...)
    d_head: int = 0                  # 0 -> d_model // n_heads

    # attention
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window: int = 0                  # sliding-window size (0 = full)

    # MLA (DeepSeek-V3)
    mla_q_rank: int = 1536
    mla_kv_rank: int = 512
    mla_nope_dim: int = 128
    mla_rope_dim: int = 64
    mla_v_dim: int = 128

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared: int = 0
    moe_d_ff: int = 0
    moe_capacity: float = 1.25
    moe_dispatch: str = "shard_map"  # shard_map (EP) | gather | onehot
    inference_ep: bool = False
    aux_loss_weight: float = 0.01

    # Mamba
    mamba_d_inner: int = 0
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_dt_rank: int = 0
    mamba_chunk: int = 128

    # xLSTM
    xlstm_d_inner: int = 0
    xlstm_chunk: int = 64

    # frontends (stubs: precomputed embeddings)
    frontend: Optional[str] = None   # vision | audio | None
    frontend_tokens: int = 0         # e.g. image patches prepended

    # norms / misc
    norm: str = "rms"                # rms | ln
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"              # none | full: checkpoint each layer group under autograd
    layer_unroll: bool = False       # the port always runs layers as a Python loop
    subquadratic: bool = False       # decides long_500k applicability

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def n_layers(self) -> int:
        return sum(r * len(specs) for r, specs in self.stacks)

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline maths)."""
        from ..models.transformer import init_abstract
        from ..tree import tree_leaves

        return sum(t.numel() for t in tree_leaves(init_abstract(self)))

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top_k experts only)."""
        total = self.param_count()
        if self.moe_experts == 0:
            return total
        expert_p = 3 * self.d_model * self.moe_d_ff
        n_moe_layers = sum(
            r * sum(1 for s in specs if s.ffn == "moe") for r, specs in self.stacks
        )
        inactive = n_moe_layers * (self.moe_experts - self.moe_top_k) * expert_p
        return total - inactive


# ======================================================================
# shape cells (4 shapes per LM arch)
# ======================================================================
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4_096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32_768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32_768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524_288, global_batch=1),
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _cell(shape: str, reduced: bool):
    info = SHAPES[shape]
    s, b = info["seq_len"], info["global_batch"]
    if reduced:
        s, b = min(s, 256), min(b, 4)
    return info, s, b


def input_specs(cfg: ArchConfig, shape: str, *, reduced: bool = False):
    """``(specs, info)``: ``meta`` stand-ins for every model input of a shape
    cell, and the cell's row of :data:`SHAPES`.

    ``train``/``prefill``: token batch (+ stub frontend embeddings).
    ``decode``: one new token against a KV/state cache of seq_len.
    """
    info, s, b = _cell(shape, reduced)
    i32 = torch.int32
    specs: dict = {}
    if info["kind"] in ("train", "prefill"):
        n_front = cfg.frontend_tokens if cfg.frontend else 0
        s_tok = s - n_front
        if s_tok < 0:   # the reference returns a negative token length here
            raise ValueError(f"{cfg.name}'s {n_front} frontend tokens exceed the {s}-token "
                             f"cell {shape}{' (reduced)' if reduced else ''}")
        specs["tokens"] = _meta((b, s_tok), i32)
        if info["kind"] == "train":
            specs["labels"] = _meta((b, s_tok), i32)
        if cfg.frontend:
            specs["frontend_embeds"] = _meta((b, n_front, cfg.d_model), cfg.activation_dtype)
    else:  # decode
        specs["tokens"] = _meta((b, 1), i32)
        specs["cache_len"] = _meta((), i32)
    return specs, info


def decode_cache_specs(cfg: ArchConfig, shape: str, *, reduced: bool = False):
    """The decode cache of a shape cell as ``meta`` tensors."""
    from ..models.transformer import init_cache_abstract

    _, s, b = _cell(shape, reduced)
    return init_cache_abstract(cfg, b, s)
