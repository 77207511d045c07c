"""musicgen-medium [arXiv:2306.05284]: 48L d1536 decoder-only over EnCodec
tokens (vocab 2048), LayerNorm + GELU.

Per assignment the EnCodec/conditioning frontend is a STUB: input_specs()
provides 256 precomputed conditioning-frame embeddings prepended to the
codec-token sequence; the codec tokens themselves are ordinary vocabulary
ids (the delay-pattern interleave is a data-layout choice upstream)."""

from .base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    stacks=((48, (LayerSpec("gqa", "gelu"),)),),
    norm="ln",
    frontend="audio",
    frontend_tokens=256,
    rope_theta=10_000.0,
)
