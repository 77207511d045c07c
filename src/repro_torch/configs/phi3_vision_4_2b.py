"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct]: phi3-mini
backbone (32L d3072 MHA, SwiGLU d_ff 8192) + CLIP vision frontend.

Per assignment the modality frontend is a STUB: input_specs() provides 576
precomputed patch embeddings (CLIP ViT-L/14 @ 336px -> 24x24 patches) that
are linearly projected and prepended to the text tokens."""

from .base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32_064,
    stacks=((32, (LayerSpec("gqa", "swiglu"),)),),
    frontend="vision",
    frontend_tokens=576,
    rope_theta=10_000.0,
)
