"""Data pipeline with Cheetah DISTINCT-dedup + FILTER pruning stages."""
from .pipeline import PipelineStats, TokenPipeline
