"""Ragged paged attention: causal GQA attention of a [B, T] query chunk,
read straight from the paged KV pool through per-row block tables.

The port of ``bee2bee_tpu/ops/ragged.py``'s ``ragged_paged_attention``
with the same ABI. Two implementations of one function:

- three CUDA kernels (Hopper, ``sm_90a``) for CUDA tensors, which together
  replace the TPU kernel ``_ragged_kernel``: the split-K decode kernel
  ``csrc/ragged_decode_attention.cu`` for bf16 decode (T = 1) at a
  head_dim it is built for (64, 128); the tensor-core tile kernel
  ``csrc/ragged_prefill_attention.cu`` for bf16 chunks of at least
  ``T_MIN`` queries at those head_dims; and the row-per-warp kernel
  ``csrc/ragged_attention.cu`` for everything else (f32, head_dim 256).
  ``use_decode_kernel`` and ``use_tile_kernel`` are the rule, and
  ``ragged_kernel`` names the kernel they pick;
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

Both pool forms of the JAX kernel: the pool in q's type, and the int8
pool with ``k_scale``/``v_scale`` [Hkv, NB] f32 (one scale per kv head
and block). An int8 page is dequantized in f32 and rounded to q's type
before the dots, as the JAX kernel does. The wrapper counts each
kernel's launches per pool form apart: ``launches`` and
``int8_launches`` for the row kernel, ``prefill_launches`` and
``int8_prefill_launches`` for the tile kernel, ``decode_launches`` and
``int8_decode_launches`` for the decode kernel (one call launches its two
CUDA kernels, the split walk and the merge, and counts 1). The mesh wrapper
(``make_ragged_attn_fn``'s ``shard_map``) is not ported yet.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

NEG_INF = -1e30  # the masked-score fill of the JAX kernels (ops/flash.py)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
_BLOCK_SIZES = (8, 16, 32)
_SOURCE = "ragged_attention.cu"
_PREFILL_SOURCE = "ragged_prefill_attention.cu"
_DECODE_SOURCE = "ragged_decode_attention.cu"
# the tile kernel's instantiations: head_dim 256 would hold 192
# accumulator and fragment registers a lane
_TILE_HEAD_DIMS = (64, 128)
# the decode kernel's, for the same reason
_DECODE_HEAD_DIMS = (64, 128)
# the shortest chunk the tile kernel takes. On the H100 it beat the row
# kernel at every chunk length timed, T = 1 included (chip_smoke.py's
# crossover lines, PERF.md); decode (T = 1) has its own split-K kernel
T_MIN = 2
# keys of one staged tile of the decode kernel (kKeys in its source): a
# split holds whole tiles
DECODE_TILE_KEYS = 64
# the most tiles a split walks: longer walks leave SMs idle at B=8, shorter
# ones add blocks and partials where the grid already fills the card
DECODE_MAX_SPLIT_TILES = 4


def use_tile_kernel(dtype, T: int, hd: int) -> bool:
    """The dispatch rule of prefill and verify chunks: bf16 chunks of at
    least T_MIN queries at a head_dim the tile kernel is built for go to
    the tensor-core tile kernel."""
    return dtype == torch.bfloat16 and T >= T_MIN and hd in _TILE_HEAD_DIMS


def use_decode_kernel(dtype, T: int, hd: int) -> bool:
    """The dispatch rule of decode: bf16 queries, one a row (T = 1), at a
    head_dim the split-K decode kernel is built for. It takes no case that
    ``use_tile_kernel`` takes."""
    return dtype == torch.bfloat16 and T == 1 and hd in _DECODE_HEAD_DIMS


def ragged_kernel(dtype, T: int, hd: int) -> str:
    """The kernel the dispatch rule names: "decode", "tile" or "row" (f32
    queries, head_dim 256)."""
    if use_decode_kernel(dtype, T, hd):
        return "decode"
    return "tile" if use_tile_kernel(dtype, T, hd) else "row"


@functools.lru_cache(maxsize=1024)  # one entry a (batch, table width) bucket
def decode_splits(B: int, Hkv: int, MB: int, BS: int, n_sm: int) -> tuple[int, int]:
    """The decode kernel's split plan, from host-known shapes only (never
    the offsets, which live on the card): (splits, pages per split). Each
    (batch row, kv head) walks its MB-page table in ``splits`` blocks of
    whole key tiles, at most DECODE_MAX_SPLIT_TILES each and as many as
    keep the grid at one block per SM or more; the splits cover the table
    exactly (none starts past it). A split past a row's frontier costs one
    small empty partial on the card."""
    tile_pages = max(1, DECODE_TILE_KEYS // BS)
    tiles = -(-MB // tile_pages)
    per = max(1, min(DECODE_MAX_SPLIT_TILES, B * Hkv * tiles // n_sm))
    return -(-tiles // per), per * tile_pages


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _check_scales(k_scale, v_scale) -> bool:
    """True for the int8 form; one scale without the other raises."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("quantized pool needs BOTH k_scale and v_scale")
    return k_scale is not None


def _gathered(pool, scale, tables, dtype):
    """[B, Hkv, MB*BS, hd] f32 view of the rows' pages; an int8 page is
    dequantized with its (kv head, block) scale in f32, then rounded to
    ``dtype`` (the JAX kernel's ``(k * scale).astype(q.dtype)``)."""
    Hkv, _, BS, hd = pool.shape
    B, MB = tables.shape
    g = pool[:, tables]  # [Hkv, B, MB, BS, hd]
    if scale is not None:
        g = (g.float() * scale[:, tables][..., None, None]).to(dtype)
    return g.reshape(Hkv, B, MB * BS, hd).transpose(0, 1).float()


def ragged_paged_attention_ref(
    q,  # [B, T, H, hd]
    k_pool,  # [Hkv, NB, BS, hd]
    v_pool,  # [Hkv, NB, BS, hd]
    block_tables,  # [B, MB] int: pool block ids per row (0 = null block)
    offset,  # int, [] or [B]: position of q[:, 0]
    window=None,  # int or [1] tensor: sliding window, None/0 = full causal
    sm_scale: float | None = None,
    logit_softcap: float = 0.0,
    k_scale=None,  # [Hkv, NB] f32: scales of an int8 pool
    v_scale=None,  # [Hkv, NB] f32
):
    """The plain PyTorch version: gathered (and, for an int8 pool,
    dequantized) view, explicit mask, f32 softmax. Returns [B, T, H*hd]
    in q's dtype."""
    _check_scales(k_scale, v_scale)
    B, T, H, hd = q.shape
    Hkv, _, BS, _ = k_pool.shape
    MB = block_tables.shape[1]
    G = H // Hkv
    S = MB * BS
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    win = _window_int(window)
    tables = block_tables.to(device=q.device, dtype=torch.long)
    kg = _gathered(k_pool, k_scale, tables, q.dtype)
    vg = _gathered(v_pool, v_scale, tables, q.dtype)
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


def _check_kernel_args(q, k_pool, v_pool, block_tables, off, k_scale, v_scale):
    B, T, H, hd = q.shape
    Hkv, NB, BS, _ = k_pool.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"ragged kernel: dtype {q.dtype} (float32 or bfloat16)")
    pool_dtype = q.dtype if k_scale is None else torch.int8
    if k_pool.dtype != pool_dtype or v_pool.dtype != pool_dtype:
        raise TypeError(
            f"ragged kernel: pool dtype {k_pool.dtype}/{v_pool.dtype}, "
            f"expected {pool_dtype} for {q.dtype} queries"
            + (" with scales" if k_scale is not None else "")
        )
    scales = ()
    if k_scale is not None:
        scales = (("k_scale", k_scale), ("v_scale", v_scale))
        for name, t in scales:
            if t.dtype != torch.float32 or tuple(t.shape) != (Hkv, NB):
                raise ValueError(
                    f"ragged kernel: {name} must be float32 [{Hkv}, {NB}], "
                    f"got {t.dtype} {tuple(t.shape)}"
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
                    ("block_tables", block_tables), ("offset", off), *scales):
        if t.device != q.device:
            raise ValueError(f"ragged kernel: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"ragged kernel: {name} is not contiguous")
    # the tile and decode kernels copy q in 16-byte pieces too
    aligned = [("k_pool", k_pool), ("v_pool", v_pool)]
    if ragged_kernel(q.dtype, T, hd) != "row":
        aligned.append(("q", q))
    for name, t in aligned:
        if t.data_ptr() % 16:
            raise ValueError(f"ragged kernel: {name} is not 16-byte aligned")


def _kernel_fn():
    """The row kernel's C entry point, built and bound on first use."""
    from ._build import load

    fn = load(_SOURCE).b2b_ragged_paged_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
    return fn


def _prefill_fn():
    """The tile kernel's C entry point, built and bound on first use."""
    from ._build import load

    fn = load(_PREFILL_SOURCE).b2b_ragged_prefill_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
    return fn


def _decode_fn():
    """The decode kernel's C entry point, built and bound on first use."""
    from ._build import load

    fn = load(_DECODE_SOURCE).b2b_ragged_decode_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
    return fn


# each kernel's launch counter (on ragged_paged_attention), bf16 pool form;
# the int8 pool form's carries an "int8_" prefix
_COUNTERS = {"row": "launches", "tile": "prefill_launches",
             "decode": "decode_launches"}


def _launch_kernel(q, k_pool, v_pool, block_tables, off, win, sm_scale, softcap,
                   k_scale, v_scale, kernel: str):
    """Launch ``kernel`` ("decode", "tile" or "row") on checked arguments
    and count the launch."""
    B, T, H, hd = q.shape
    Hkv, NB, BS, _ = k_pool.shape
    MB = block_tables.shape[1]
    out = torch.empty((B, T, H * hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    quantized = k_scale is not None
    ptrs = (
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        block_tables.data_ptr(), off.data_ptr(), out.data_ptr(),
    )
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if kernel == "decode":
        splits, pages = decode_splits(B, Hkv, MB, BS, _sm_count(q.device.index))
        # f32 partials: the unnormalised output and (m, l) of every split.
        # Freed on return: the caching allocator hands it out again only to
        # work queued after both kernels on this stream
        part = torch.empty(B * H * splits * (hd + 2), dtype=torch.float32,
                           device=q.device)
        err = _decode_fn()(*ptrs, part.data_ptr(), B, H, Hkv, NB, MB, BS, hd, win,
                           splits, pages, float(sm_scale), float(softcap), stream)
    else:
        args = (*ptrs, B, T, H, Hkv, NB, MB, BS, hd, win, float(sm_scale),
                float(softcap))
        if kernel == "tile":
            err = _prefill_fn()(*args, stream)
        else:
            err = _kernel_fn()(*args, _DTYPE_CODE[q.dtype], stream)
    if err:
        raise RuntimeError(f"ragged {kernel} kernel launch failed: cuda error {err}")
    counter = ("int8_" if quantized else "") + _COUNTERS[kernel]
    setattr(ragged_paged_attention, counter,
            getattr(ragged_paged_attention, counter) + 1)
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
    k_scale=None,  # [Hkv, NB] f32: scales of an int8 pool; both or neither
    v_scale=None,  # [Hkv, NB] f32
):
    """Causal attention for a [B, T] chunk over the paged pool; returns
    [B, T, H*hd]. T=1 is decode, T=K+1 a verify chunk, T=bucket a prefill
    chunk. With ``k_scale``/``v_scale`` the pools are int8. CUDA tensors
    launch the kernel ``ragged_kernel`` names (and count the launch in
    ``ragged_paged_attention.decode_launches`` / ``.int8_decode_launches``
    for the decode kernel, ``.prefill_launches`` /
    ``.int8_prefill_launches`` for the tile kernel, ``.launches`` /
    ``.int8_launches`` for the row kernel); CPU tensors take the plain
    version. Anything else raises — there is no fallback from the card,
    nor from one kernel to another."""
    _check_scales(k_scale, v_scale)
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(
            q, k_pool, v_pool, block_tables, offset, window, sm_scale,
            logit_softcap, k_scale, v_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention: no kernel for {q.device}")
    hd = q.shape[-1]
    off = row_offsets(offset, q.shape[0], q.device)
    _check_kernel_args(q, k_pool, v_pool, block_tables, off, k_scale, v_scale)
    return _launch_kernel(
        q, k_pool, v_pool, block_tables, off, _window_int(window),
        sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd),
        float(logit_softcap or 0.0), k_scale, v_scale,
        kernel=ragged_kernel(q.dtype, q.shape[1], hd),
    )


# row kernel: pool in q's dtype / int8 pool with scales
ragged_paged_attention.launches = 0
ragged_paged_attention.int8_launches = 0
# tile kernel: bf16 pool / int8 pool with scales
ragged_paged_attention.prefill_launches = 0
ragged_paged_attention.int8_prefill_launches = 0
# decode kernel: bf16 pool / int8 pool with scales
ragged_paged_attention.decode_launches = 0
ragged_paged_attention.int8_decode_launches = 0
