"""Architecture registry: ``--arch <id>`` resolution and reduced smoke configs."""

from __future__ import annotations

import dataclasses

from .base import SHAPES, ArchConfig, LayerSpec, decode_cache_specs, input_specs
from .codeqwen15_7b import CONFIG as CODEQWEN15_7B
from .deepseek_moe_16b import CONFIG as DEEPSEEK_MOE_16B
from .deepseek_v3_671b import CONFIG as DEEPSEEK_V3_671B
from .jamba_v01_52b import CONFIG as JAMBA_V01_52B
from .musicgen_medium import CONFIG as MUSICGEN_MEDIUM
from .phi3_vision_4_2b import CONFIG as PHI3_VISION_4_2B
from .qwen15_110b import CONFIG as QWEN15_110B
from .qwen2_1_5b import CONFIG as QWEN2_1_5B
from .starcoder2_3b import CONFIG as STARCODER2_3B
from .xlstm_350m import CONFIG as XLSTM_350M

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (
        DEEPSEEK_MOE_16B,
        DEEPSEEK_V3_671B,
        XLSTM_350M,
        CODEQWEN15_7B,
        QWEN2_1_5B,
        QWEN15_110B,
        STARCODER2_3B,
        PHI3_VISION_4_2B,
        MUSICGEN_MEDIUM,
        JAMBA_V01_52B,
    )
}

ARCH_NAMES = tuple(ARCHS)


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; have {sorted(ARCHS)}")


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Shrink an architecture to CPU smoke-test size, same family/topology."""
    n_heads = 4
    n_kv = max(1, min(cfg.n_kv_heads * n_heads // cfg.n_heads, n_heads))
    stacks = tuple((min(r, 2), specs) for r, specs in cfg.stacks)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        d_model=256,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=64,
        d_ff=512 if cfg.d_ff else 0,
        vocab=512,
        stacks=stacks,
        window=min(cfg.window, 64) if cfg.window else 0,
        moe_experts=min(cfg.moe_experts, 8),
        moe_top_k=min(cfg.moe_top_k, 2),
        moe_d_ff=128 if cfg.moe_experts else 0,
        # undropped at smoke scale: capacity drops depend on batch
        # composition, which would make decode != forward by construction
        moe_capacity=8.0,
        mla_q_rank=96,
        mla_kv_rank=64,
        mla_nope_dim=32,
        mla_rope_dim=16,
        mla_v_dim=32,
        mamba_d_inner=512 if cfg.mamba_d_inner else 0,
        mamba_dt_rank=16 if cfg.mamba_d_inner else 0,
        mamba_chunk=32,
        xlstm_d_inner=512 if cfg.xlstm_d_inner else 0,
        xlstm_chunk=16,
        frontend_tokens=min(cfg.frontend_tokens, 16),
        dtype="float32",
        remat="none",
    )


__all__ = [
    "ARCHS",
    "ARCH_NAMES",
    "ArchConfig",
    "LayerSpec",
    "SHAPES",
    "get_arch",
    "reduced",
    "input_specs",
    "decode_cache_specs",
]
