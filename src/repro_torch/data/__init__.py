"""Deterministic data pipelines of the port (mirrors ``repro.data``):
numpy batches, byte-equal to the reference's, keyed by (seed, step, row)."""
from repro_torch.data.prompts import PromptPipeline
from repro_torch.data.tokens import TokenPipeline

__all__ = ["TokenPipeline", "PromptPipeline"]
