"""qwen1.5-110b [hf:Qwen/Qwen1.5-110B]: 80L d8192, GQA 64H/kv8, QKV bias,
SwiGLU d_ff 49152, 152k vocab."""

from .base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152_064,
    stacks=((80, (LayerSpec("gqa", "swiglu"),)),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
