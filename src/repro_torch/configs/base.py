"""Architecture config schema and the shape cells.

The port's copy of ``repro.configs.base``: every architecture is one
:class:`ArchConfig`; heterogeneous stacks (Jamba groups, DeepSeek dense
prefix) are ``stacks``, a tuple of ``(repeat, (LayerSpec, ...))`` groups
whose parameters carry a leading ``repeat`` axis.  ``activation_dtype`` is
a ``torch.dtype``.  The dry-run helpers (``input_specs``,
``decode_cache_specs``, ``param_count``) wait for the dry-run slice.
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


# ======================================================================
# shape cells (4 shapes per LM arch)
# ======================================================================
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4_096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32_768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32_768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524_288, global_batch=1),
}
