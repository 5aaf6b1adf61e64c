"""bee2bee-tpu on PyTorch and CUDA: the serving path of ``bee2bee_tpu``
ported to an NVIDIA H100.

The JAX package ``bee2bee_tpu`` stays the reference; this package imports
nothing of it and never imports jax. Plain tensor code is PyTorch; the
TPU kernels on the path are hand-written CUDA kernels for Hopper
(``csrc/``), built with nvcc on first use. Entry points run on the CUDA
card unless the caller passes ``device="cpu"``, where the kernels' plain
PyTorch versions run instead.

Heavy submodules are imported lazily, so ``import bee2bee_tpu_torch``
stays cheap.
"""

__version__ = "0.1.0"

_LAZY = {
    "CUDAService": ("bee2bee_tpu_torch.services.cuda", "CUDAService"),
    "InferenceEngine": ("bee2bee_tpu_torch.engine.engine", "InferenceEngine"),
    "EngineConfig": ("bee2bee_tpu_torch.engine.engine", "EngineConfig"),
    "get_config": ("bee2bee_tpu_torch.models.config", "get_config"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["CUDAService", "EngineConfig", "InferenceEngine", "get_config", "__version__"]
