"""Attention ops of the PyTorch port: each op is a hand-written CUDA kernel
for CUDA tensors and its plain PyTorch version for CPU tensors."""

from .flash import flash_attention, flash_attention_ref
from .ragged import ragged_paged_attention, ragged_paged_attention_ref

__all__ = [
    "flash_attention",
    "flash_attention_ref",
    "ragged_paged_attention",
    "ragged_paged_attention_ref",
]
