"""Serving backends of the PyTorch port: the `BaseService` contract with
the CUDA engine backend, the Ollama proxy, the remote HF Inference API
and a fake for tests (``bee2bee_tpu/services/__init__.py``'s set, with
``CUDAService`` in the place of ``TPUService``)."""

from .base import BaseService, ServiceError
from .cuda import CUDAService
from .fake import FakeService


def __getattr__(name):
    # OllamaService/RemoteService pull in requests: lazy, as in the JAX
    # package
    if name == "OllamaService":
        from .ollama import OllamaService

        return OllamaService
    if name == "RemoteService":
        from .remote import RemoteService

        return RemoteService
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["BaseService", "CUDAService", "FakeService", "ServiceError"]
