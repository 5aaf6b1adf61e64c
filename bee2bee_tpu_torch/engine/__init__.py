"""Serving engine of the PyTorch port: engine, scheduler, sampling, paged
pool bookkeeping and tokenizers."""

from .engine import EngineConfig, GenerationResult, InferenceEngine

__all__ = ["EngineConfig", "GenerationResult", "InferenceEngine"]
