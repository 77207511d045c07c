"""deepseek-moe-16b [arXiv:2401.06066]: 28L d2048 16H MHA, fine-grained MoE
64 routed top-6 + 2 shared experts (d_ff 1408); layer 0 is a dense FFN."""

from .base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,            # dense layer-0 FFN (official DeepSeekMoE width)
    vocab=102_400,
    stacks=(
        (1, (LayerSpec("gqa", "swiglu"),)),
        (27, (LayerSpec("gqa", "moe"),)),
    ),
    moe_experts=64,
    moe_top_k=6,
    moe_shared=2,
    moe_d_ff=1408,
    rope_theta=10_000.0,
)
