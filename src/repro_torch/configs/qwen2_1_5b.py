"""qwen2-1.5b [arXiv:2407.10671]: 28L d1536, GQA 12H/kv2, QKV bias, SwiGLU
d_ff 8960, tied embeddings over the 152k vocab."""

from .base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151_936,
    stacks=((28, (LayerSpec("gqa", "swiglu"),)),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
