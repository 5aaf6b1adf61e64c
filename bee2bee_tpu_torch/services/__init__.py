"""Serving backends of the PyTorch port."""

from .base import BaseService, ServiceError
from .cuda import CUDAService

__all__ = ["BaseService", "CUDAService", "ServiceError"]
