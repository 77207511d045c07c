from .pipeline import DataConfig, TokenStream, make_batches, synthetic_stream

__all__ = ["DataConfig", "TokenStream", "make_batches", "synthetic_stream"]
