"""starcoder2-3b [arXiv:2402.19173]: 30L d3072, GQA 24H/kv2, RoPE, sliding-
window attention (4096) => O(window) KV and a valid long_500k cell;
LayerNorm + GELU FFN per the StarCoder2 architecture."""

from .base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49_152,
    stacks=((30, (LayerSpec("gqa", "gelu"),)),),
    window=4096,
    norm="ln",
    rope_theta=100_000.0,
    subquadratic=True,
)
