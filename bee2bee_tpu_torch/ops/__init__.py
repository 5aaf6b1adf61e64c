"""Attention ops of the PyTorch port: each op is a hand-written CUDA kernel
for CUDA tensors and its plain PyTorch version for CPU tensors."""

from .ragged import ragged_paged_attention, ragged_paged_attention_ref

__all__ = ["ragged_paged_attention", "ragged_paged_attention_ref"]
