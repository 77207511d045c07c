"""xlstm-350m [arXiv:2405.04517]: 24 blocks d1024, xLSTM[7:1] — one sLSTM per
seven mLSTM blocks; no separate FFN (blocks carry internal 2x expansion).
Recurrent state is O(1) per token => runs the long_500k cell."""

from .base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50_304,
    stacks=(
        (3, (LayerSpec("slstm", "none"),) + tuple(
            LayerSpec("mlstm", "none") for _ in range(7)
        )),
    ),
    xlstm_d_inner=2048,
    xlstm_chunk=64,
    subquadratic=True,
    tie_embeddings=True,
)
