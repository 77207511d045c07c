"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B]: Qwen1.5 architecture — 32L d4096
MHA with QKV bias, SwiGLU d_ff 13440, 92k vocab, long-context rope theta."""

from .base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92_416,
    stacks=((32, (LayerSpec("gqa", "swiglu"),)),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
