"""Ragged paged attention: causal GQA attention of a [B, T] query chunk,
read straight from the paged KV pool through per-row block tables.

The port of ``bee2bee_tpu/ops/ragged.py``'s ``ragged_paged_attention``
with the same ABI. Two implementations of one function:

- the CUDA kernel ``csrc/ragged_attention.cu`` (Hopper, ``sm_90a``),
  launched for CUDA tensors; it replaces the TPU kernel ``_ragged_kernel``;
- ``ragged_paged_attention_ref``, the plain PyTorch version: it gathers
  the mapped pages into a ``[B, MB*BS]`` view, builds the mask from the
  offsets and the window and takes an f32 softmax. The wrapper takes it
  for CPU tensors only; the tests hold it against the JAX kernel, and the
  card's smoke run holds the kernel against it.

Semantics, shared by both (and by the JAX kernel): queries fold to rows
of (kv head, GQA group g major, chunk position t minor); query t of row b
sits at position ``offset[b] + t`` and sees key position p iff
``p <= pos`` and, with a window w > 0, ``p > pos - w``. ``logit_softcap``
caps the scaled scores with tanh BEFORE the mask. A query that sees no
key gets 0, not NaN: a dead batch row whose stale offset points nowhere
must stay finite. Table entries past a row's live extent point at the
null block 0, whose content is garbage by design; causality masks it.

The bf16 pool only: the int8 pool variant of the JAX kernel
(``k_scale``/``v_scale``) and its mesh wrapper are not ported yet.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30  # the masked-score fill of the JAX kernels (ops/flash.py)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
_BLOCK_SIZES = (8, 16, 32)
_SOURCE = "ragged_attention.cu"


def _window_int(window) -> int:
    """The per-call window as a python int (0 = full causal). A tensor
    window is read on the host; the engine passes python ints."""
    if window is None:
        return 0
    if isinstance(window, torch.Tensor):
        return int(window.reshape(-1)[0])
    return int(window)


def row_offsets(offset, B: int, device) -> torch.Tensor:
    """[B] int32 offsets on ``device`` from a python int, a 0-d or a [B]
    tensor (None = 0)."""
    if offset is None:
        offset = 0
    if not isinstance(offset, torch.Tensor):
        return torch.full((B,), int(offset), dtype=torch.int32, device=device)
    off = offset.to(device=device, dtype=torch.int32).reshape(-1)
    return off.expand(B).contiguous() if off.numel() == 1 else off.contiguous()


def ragged_paged_attention_ref(
    q,  # [B, T, H, hd]
    k_pool,  # [Hkv, NB, BS, hd]
    v_pool,  # [Hkv, NB, BS, hd]
    block_tables,  # [B, MB] int: pool block ids per row (0 = null block)
    offset,  # int, [] or [B]: position of q[:, 0]
    window=None,  # int or [1] tensor: sliding window, None/0 = full causal
    sm_scale: float | None = None,
    logit_softcap: float = 0.0,
):
    """The plain PyTorch version: gathered view, explicit mask, f32
    softmax. Returns [B, T, H*hd] in q's dtype."""
    B, T, H, hd = q.shape
    Hkv, _, BS, _ = k_pool.shape
    MB = block_tables.shape[1]
    G = H // Hkv
    S = MB * BS
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    win = _window_int(window)
    tables = block_tables.to(device=q.device, dtype=torch.long)
    # [Hkv, B, MB, BS, hd] -> [B, Hkv, S, hd]
    kg = k_pool[:, tables].reshape(Hkv, B, S, hd).transpose(0, 1).float()
    vg = v_pool[:, tables].reshape(Hkv, B, S, hd).transpose(0, 1).float()
    # [B, T, Hkv, G, hd] -> [B, Hkv, G*T, hd]: head h = kvh*G + g
    qf = q.reshape(B, T, Hkv, G, hd).permute(0, 2, 3, 1, 4).reshape(B, Hkv, G * T, hd)
    s = torch.einsum("bkrd,bksd->bkrs", qf.float(), kg) * sm_scale
    if logit_softcap:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    off = row_offsets(offset, B, q.device).long()
    qpos = off[:, None] + torch.arange(T, device=q.device).repeat(G)[None, :]
    kvpos = torch.arange(S, device=q.device)
    vis = kvpos[None, None, :] <= qpos[:, :, None]  # [B, G*T, S]
    if win > 0:
        vis = vis & (kvpos[None, None, :] > qpos[:, :, None] - win)
    vis = vis[:, None]  # broadcast over kv heads
    s = torch.where(vis, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkrs,bksd->bkrd", p, vg) / torch.where(l == 0, 1.0, l)
    # [B, Hkv, G, T, hd] -> [B, T, H*hd]
    o = o.reshape(B, Hkv, G, T, hd).permute(0, 3, 1, 2, 4)
    return o.reshape(B, T, H * hd).to(q.dtype)


def _check_kernel_args(q, k_pool, v_pool, block_tables, off):
    B, T, H, hd = q.shape
    Hkv, _, BS, _ = k_pool.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"ragged kernel: dtype {q.dtype} (float32 or bfloat16)")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(
            f"ragged kernel: pool dtype {k_pool.dtype}/{v_pool.dtype} != "
            f"query dtype {q.dtype}"
        )
    if k_pool.shape != v_pool.shape or k_pool.shape[3] != hd:
        raise ValueError(
            f"ragged kernel: pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
            f"do not match head_dim {hd}"
        )
    if hd not in _HEAD_DIMS:
        raise ValueError(f"ragged kernel: head_dim {hd} not in {_HEAD_DIMS}")
    if BS not in _BLOCK_SIZES:
        raise ValueError(f"ragged kernel: block size {BS} not in {_BLOCK_SIZES}")
    if H % Hkv:
        raise ValueError(f"ragged kernel: {H} heads over {Hkv} kv heads")
    if block_tables.dtype != torch.int32 or block_tables.shape[0] != B:
        raise ValueError("ragged kernel: block_tables must be int32 [B, MB]")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("offset", off)):
        if t.device != q.device:
            raise ValueError(f"ragged kernel: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"ragged kernel: {name} is not contiguous")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"ragged kernel: {name} is not 16-byte aligned")


def _kernel_fn():
    """The kernel's C entry point, built and bound on first use."""
    from ._build import load

    fn = load(_SOURCE).b2b_ragged_paged_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
    return fn


def _launch_kernel(q, k_pool, v_pool, block_tables, off, win, sm_scale, softcap):
    B, T, H, hd = q.shape
    Hkv, NB, BS, _ = k_pool.shape
    MB = block_tables.shape[1]
    out = torch.empty((B, T, H * hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    err = _kernel_fn()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), off.data_ptr(), out.data_ptr(),
        B, T, H, Hkv, NB, MB, BS, hd, win, float(sm_scale), float(softcap),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"ragged kernel launch failed: cuda error {err}")
    ragged_paged_attention.launches += 1
    return out


def ragged_paged_attention(
    q,  # [B, T, H, hd]
    k_pool,  # [Hkv, NB, BS, hd] — per-layer slice of the paged pool
    v_pool,  # [Hkv, NB, BS, hd]
    block_tables,  # [B, MB] int32: pool block ids per row (0 = null block)
    offset,  # int, [] or [B] int32: position of q[:, 0]
    window=None,  # int or [1] tensor: sliding window; None/0 = full causal
    sm_scale: float | None = None,
    logit_softcap: float = 0.0,
):
    """Causal attention for a [B, T] chunk over the paged pool; returns
    [B, T, H*hd]. T=1 is decode, T=K+1 a verify chunk, T=bucket a prefill
    chunk. CUDA tensors launch the kernel (and count the launch in
    ``ragged_paged_attention.launches``); CPU tensors take the plain
    version. Anything else raises — there is no fallback from the card."""
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(
            q, k_pool, v_pool, block_tables, offset, window, sm_scale,
            logit_softcap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention: no kernel for {q.device}")
    hd = q.shape[-1]
    off = row_offsets(offset, q.shape[0], q.device)
    _check_kernel_args(q, k_pool, v_pool, block_tables, off)
    return _launch_kernel(
        q, k_pool, v_pool, block_tables, off, _window_int(window),
        sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd),
        float(logit_softcap or 0.0),
    )


ragged_paged_attention.launches = 0
