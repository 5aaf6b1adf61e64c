"""Model configs, parameters and the transformer core of the PyTorch port."""

from .config import CONFIGS, ModelConfig, get_config

__all__ = ["CONFIGS", "ModelConfig", "get_config"]
