"""Flash attention over contiguous K/V: tiled causal or non-causal GQA
attention of a [B, T] query chunk against [B, S] keys and values.

The port of ``bee2bee_tpu/ops/flash.py``'s ``flash_attention`` with the
same signature and layout. Two implementations of one function:

- three CUDA kernels in ``csrc/flash_attention.cu`` (Hopper, ``sm_90a``)
  for CUDA tensors, which together replace the TPU kernel
  ``_flash_kernel``: the tensor-core tile kernel (the ragged prefill
  kernel's design over contiguous K/V) for bf16 at head_dim 64, 96 and 128,
  and in its head_dim-256 form (``tile_hd256``: Q resident in shared
  memory, 32-key tiles); its f32 form (both products in 3xTF32) for f32
  at every head_dim; and the row-per-warp kernel, which the rule no longer
  names (it stays for timing the others against). ``flash_kernel`` names
  the kernel the rule picks;
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


# each kernel's launch counter (on flash_attention), the query type of
# each kernel built for one (the row kernel takes both) and the head_dims
# each is built for
_COUNTERS = {"row": "launches", "tile": "tile_launches",
             "tile_hd256": "hd256_tile_launches", "tile_f32": "f32_tile_launches"}
_KERNEL_DTYPES = {"tile": torch.bfloat16, "tile_hd256": torch.bfloat16,
                  "tile_f32": torch.float32}
_KERNEL_HEAD_DIMS = {"tile": (64, 96, 128), "tile_hd256": (256,),
                     "tile_f32": _HEAD_DIMS, "row": _HEAD_DIMS}


def use_tile_kernel(dtype, hd: int) -> bool:
    """The dispatch rule: bf16 and f32 at a head_dim the tile kernels are
    built for (64, 96, 128, 256) go to the tensor-core tile kernel of their
    type; anything else reaches the row kernel, whose checks refuse it."""
    return dtype in _KERNEL_DTYPES.values() and hd in _HEAD_DIMS


def flash_kernel(dtype, hd: int) -> str:
    """The kernel the dispatch rule names: "tile" (bf16 at head_dim 64, 96
    and 128), "tile_hd256" (bf16 at 256), "tile_f32" (f32) or "row"."""
    if not use_tile_kernel(dtype, hd):
        return "row"
    if dtype == torch.float32:
        return "tile_f32"
    return "tile_hd256" if hd == 256 else "tile"


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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel: {name} is not 16-byte aligned")


_ENTRIES = {"row": "b2b_flash_attention", "tile": "b2b_flash_attention_tile",
            "tile_hd256": "b2b_flash_attention_tile",
            "tile_f32": "b2b_flash_attention_tile_f32"}


def _kernel_fn(kernel: str):
    """The C entry point of ``kernel`` (a name ``flash_kernel`` gives),
    built and bound on first use."""
    from ._build import load

    fn = getattr(load(_SOURCE), _ENTRIES[kernel])
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        # pointers, shapes, sm_scale, [the row kernel's dtype code], stream
        dtype_code = [ctypes.c_int] if kernel == "row" else []
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float]
                       + dtype_code + [ctypes.c_void_p])
    return fn


def _launch_kernel(q, k, v, off, causal: bool, sm_scale: float, kernel: str):
    """Launch ``kernel`` (a name ``flash_kernel`` gives) on checked
    arguments and count the launch."""
    B, T, H, hd = q.shape
    if _KERNEL_DTYPES.get(kernel, q.dtype) != q.dtype:
        raise TypeError(f"flash {kernel} kernel: {q.dtype} queries")
    if hd not in _KERNEL_HEAD_DIMS[kernel]:
        raise ValueError(f"flash {kernel} kernel: head_dim {hd} "
                         f"(built for {_KERNEL_HEAD_DIMS[kernel]})")
    out = torch.empty((B, T, H * hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    args = [
        q.data_ptr(), k.data_ptr(), v.data_ptr(), off.data_ptr(), out.data_ptr(),
        B, T, k.shape[1], H, k.shape[2], hd, int(bool(causal)), float(sm_scale),
    ]
    if kernel == "row":
        args.append(_DTYPE_CODE[q.dtype])
    err = _kernel_fn(kernel)(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash {kernel} kernel launch failed: cuda error {err}")
    counter = _COUNTERS[kernel]
    setattr(flash_attention, counter, getattr(flash_attention, counter) + 1)
    return out


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
    tensors launch the kernel ``flash_kernel`` names (and count the launch
    in ``flash_attention.tile_launches`` for the bf16 tile kernel,
    ``.hd256_tile_launches`` for its head_dim-256 form,
    ``.f32_tile_launches`` for its f32 form, ``.launches`` for the row
    kernel); CPU tensors take the plain version. Anything else raises —
    there is no fallback from the card, nor from one kernel to another."""
    B, T, H, hd = q.shape
    S = k.shape[1]
    _check_block_k(S, causal, block_k)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, offset, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    off = row_offsets(offset, B, q.device)
    _check_kernel_args(q, k, v, off)
    return _launch_kernel(
        q, k, v, off, causal,
        sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd),
        kernel=flash_kernel(q.dtype, hd),
    )


flash_attention.launches = 0  # row kernel
flash_attention.tile_launches = 0  # tile kernel, bf16
flash_attention.hd256_tile_launches = 0  # its head_dim-256 form
flash_attention.f32_tile_launches = 0  # tile kernel, f32 form
# the names of every counter above (see ops/ragged.py: LAUNCH_COUNTERS)
LAUNCH_COUNTERS = tuple(_COUNTERS.values())
