"""repro_torch.data — deterministic sharded token pipeline with prefetch."""

from .pipeline import DataConfig, SyntheticTokenPipeline

__all__ = ["DataConfig", "SyntheticTokenPipeline"]
