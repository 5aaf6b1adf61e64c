"""Serving engine of the PyTorch port: engine, scheduler, sampling, paged
pool bookkeeping, drafters and tokenizers."""

from .drafter import DraftModel, DrafterLoadError
from .engine import EngineConfig, GenerationResult, InferenceEngine

__all__ = ["DraftModel", "DrafterLoadError", "EngineConfig", "GenerationResult",
           "InferenceEngine"]

# engine modules of the JAX package that the node layer reaches and the
# port does not have yet: importing one of these names raises by name
_UNPORTED = {
    "StageRunner": ("a pipeline stage worker (engine/stage_runner.py)", 13),
}


def __getattr__(name):
    if name in _UNPORTED:
        from ..unported import unported

        raise unported(*_UNPORTED[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
