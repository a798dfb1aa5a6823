from .pipeline import DataConfig, TokenPipeline, synthetic_stream

__all__ = ["DataConfig", "TokenPipeline", "synthetic_stream"]
