"""jamba-v0.1-52b [arXiv:2403.19887]: 32L d4096 hybrid — Jamba blocks of 8
layers with attention:mamba 1:7 (attention at in-block index 3) and MoE (16
experts top-2) on every other layer; GQA 32H/kv8.  SSM state + 1/8 attention
layers => runs the long_500k cell."""

from .base import ArchConfig, LayerSpec


def _jamba_block():
    specs = []
    for i in range(8):
        mixer = "gqa" if i == 3 else "mamba"
        ffn = "moe" if i % 2 == 1 else "swiglu"
        specs.append(LayerSpec(mixer, ffn))
    return tuple(specs)


CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65_536,
    stacks=((4, _jamba_block()),),
    moe_experts=16,
    moe_top_k=2,
    moe_shared=0,
    moe_d_ff=14336,
    mamba_d_inner=8192,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_dt_rank=256,
    rope_theta=10_000.0,
    subquadratic=True,
)
