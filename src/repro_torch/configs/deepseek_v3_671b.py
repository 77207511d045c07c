"""deepseek-v3-671b [arXiv:2412.19437]: 61L d7168, MLA (128 heads), 1 shared
+ 256 routed top-8 fine-grained experts (d_ff 2048); first 3 layers dense.

MTP (multi-token prediction) is a training-objective add-on in the paper;
the backbone compiled here is the standard next-token path (see DESIGN.md
§Arch-applicability)."""

from .base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,            # dense prefix FFN width
    vocab=129_280,
    stacks=(
        (3, (LayerSpec("mla", "swiglu"),)),
        (58, (LayerSpec("mla", "moe"),)),
    ),
    moe_experts=256,
    moe_top_k=8,
    moe_shared=1,
    moe_d_ff=2048,
    mla_q_rank=1536,
    mla_kv_rank=512,
    mla_nope_dim=128,
    mla_rope_dim=64,
    mla_v_dim=128,
    rope_theta=10_000.0,
)
