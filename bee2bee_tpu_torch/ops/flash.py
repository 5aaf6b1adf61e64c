"""Flash attention over contiguous K/V: tiled causal or non-causal GQA
attention of a [B, T] query chunk against [B, S] keys and values.

The port of ``bee2bee_tpu/ops/flash.py``'s ``flash_attention`` with the
same signature and layout. Two implementations of one function:

- the CUDA kernel ``csrc/flash_attention.cu`` (Hopper, ``sm_90a``; the
  ragged kernel's row-per-warp design over contiguous K/V), launched for
  CUDA tensors; it replaces the TPU kernel ``_flash_kernel``;
- ``flash_attention_ref``, the plain PyTorch version: explicit mask and an
  f32 softmax. The wrapper takes it for CPU tensors only; the tests hold
  it against the JAX kernel, and the card's smoke run holds the kernel
  against it.

Semantics, shared by all three: query t of row b sits at position
``offset[b] + t``; causal attention sees key position p iff ``p <= pos``,
non-causal attention sees every key (and ignores the offset); GQA head h
reads kv head ``h // (H // Hkv)``; a query that sees nothing (an empty
decode row at offset -1) gets 0, not NaN. The contract is
``offset + T <= S``: past it the JAX kernel attends the zeros it pads K/V
with, while the port has no keys there. ``block_q``/``block_k`` are
tiling hints only, except that a non-causal call must have S divisible by
the key block, as in the JAX function.

No path of either package calls this op today: the engines attend through
the ragged paged op (ops/ragged.py).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .ragged import _DTYPE_CODE, _HEAD_DIMS, NEG_INF, row_offsets

_SOURCE = "flash_attention.cu"


def _check_block_k(S: int, causal: bool, block_k: int) -> None:
    """The JAX function's one shape rule: non-causal attention cannot pad
    the keys, so S must be a multiple of the key block."""
    bk = min(block_k, max(S, 8))
    if not causal and S % bk:
        raise ValueError("non-causal flash requires S divisible by block_k")


def flash_attention_ref(
    q,  # [B, T, H, hd]
    k,  # [B, S, Hkv, hd]
    v,  # [B, S, Hkv, hd]
    offset=None,  # int, [] or [B]: position of q[:, 0] (None = 0)
    causal: bool = True,
    sm_scale: float | None = None,
):
    """The plain PyTorch version: explicit mask, f32 softmax. Returns
    [B, T, H*hd] in q's dtype."""
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, T, Hkv, G, hd)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k.float()) * sm_scale
    if causal:
        off = row_offsets(offset, B, q.device).long()
        qpos = off[:, None] + torch.arange(T, device=q.device)[None, :]
        vis = torch.arange(S, device=q.device)[None, None, :] <= qpos[:, :, None]
        vis = vis[:, None, None]  # [B, 1, 1, T, S]: over kv heads and groups
        s = torch.where(vis, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(vis, torch.exp(s - m), 0.0)
    else:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgts,bskd->btkgd", p / torch.where(l == 0, 1.0, l), v.float())
    return o.reshape(B, T, H * hd).to(q.dtype)


def _check_kernel_args(q, k, v, off):
    B, T, H, hd = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernel: dtype {q.dtype} (float32 or bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel: k/v dtype {k.dtype}/{v.dtype} != {q.dtype}")
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(
            f"flash kernel: k/v {tuple(k.shape)}/{tuple(v.shape)} do not match "
            f"q {tuple(q.shape)}"
        )
    if hd not in _HEAD_DIMS:
        raise ValueError(f"flash kernel: head_dim {hd} not in {_HEAD_DIMS}")
    if H % k.shape[2]:
        raise ValueError(f"flash kernel: {H} heads over {k.shape[2]} kv heads")
    for name, t in (("q", q), ("k", k), ("v", v), ("offset", off)):
        if t.device != q.device:
            raise ValueError(f"flash kernel: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash kernel: {name} is not contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel: {name} is not 16-byte aligned")


def _kernel_fn():
    """The kernel's C entry point, built and bound on first use."""
    from ._build import load

    fn = load(_SOURCE).b2b_flash_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
    return fn


def flash_attention(
    q,  # [B, T, H, hd]
    k,  # [B, S, Hkv, hd]
    v,  # [B, S, Hkv, hd]
    offset=None,  # int, [] or [B] int32: position of q[:, 0] (None = 0)
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
    sm_scale: float | None = None,
):
    """Tiled attention over contiguous K/V; returns [B, T, H*hd]. CUDA
    tensors launch the kernel (and count the launch in
    ``flash_attention.launches``); CPU tensors take the plain version.
    Anything else raises — there is no fallback from the card."""
    B, T, H, hd = q.shape
    S = k.shape[1]
    _check_block_k(S, causal, block_k)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, offset, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    off = row_offsets(offset, B, q.device)
    _check_kernel_args(q, k, v, off)
    out = torch.empty((B, T, H * hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    err = _kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), off.data_ptr(), out.data_ptr(),
        B, T, S, H, k.shape[2], hd, int(bool(causal)),
        float(sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash kernel launch failed: cuda error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
