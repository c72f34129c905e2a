from .pipeline import PipelineConfig, Prefetcher, SyntheticLM
__all__ = ["PipelineConfig", "Prefetcher", "SyntheticLM"]
