"""The optimizer of the port's trainer (the port of ``repro.optim``)."""

from .adamw import AdamWConfig, adamw_init, adamw_update
from .compression import compress_int8, decompress_int8, ef_compress_gradients
from .schedule import cosine_schedule

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "compress_int8",
    "decompress_int8",
    "ef_compress_gradients",
]
