"""The transformer core of the PyTorch port: the llama family's forward
over the paged KV pool.

The port of ``bee2bee_tpu/models/core.py``'s block-tables path, kept
function for function where that helps a reader find the counterpart
(``_norm``, ``_rope``, ``_activate``, ``_mlp``, ``embed_tokens``,
``transformer_block``, ``final_logits``, ``forward``,
``make_layer_window``, ``init_paged_pool``, ``matmul_params_per_token``).
What differs from the JAX package:

- Parameters are a plain dict of tensors whose ``"layers"`` entry is a
  LIST of per-layer dicts (models/params.py): the layer loop is a python
  loop, not a scan. Weights keep the JAX layout ``[in, out]`` and
  project as ``x @ w``.
- The pool is updated IN PLACE: ``forward`` scatters each chunk's K/V
  into the pool tensors it was given (the JAX engine donates the pool
  and gets a new one back; here the returned pool is the same object).
- Attention is always the ragged paged op (ops/ragged.py) reading the
  pool directly: no gathered view, no dense path. An int8 pool
  (``init_paged_pool(dtype=torch.int8)``) quantizes each chunk's K/V on
  write (``_quantized_page_write``) and hands the op its scales.
- Only the llama architecture runs: rmsnorm, "half" rope without
  scaling, gated silu MLP, GQA, tied or untied head, plus the score
  switches the kernel carries (sliding window with its per-layer
  alternation, attention softcap, score scale). Any other switch raises
  NotImplementedError by name (``check_supported``) instead of computing
  something else.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.ragged import ragged_paged_attention, row_offsets
from .config import ModelConfig

Params = dict


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError naming every config switch this port
    does not implement yet."""
    missing = []
    if cfg.pos_embedding != "rope":
        missing.append(f"pos_embedding={cfg.pos_embedding!r}")
    if cfg.norm != "rmsnorm":
        missing.append(f"norm={cfg.norm!r}")
    if cfg.activation != "silu":
        missing.append(f"activation={cfg.activation!r}")
    for flag in ("use_bias", "qkv_bias", "mlp_bias", "lm_head_bias", "qk_norm",
                 "post_norms", "no_pre_norms", "parallel_block",
                 "embedding_norm", "embedding_scale"):
        if getattr(cfg, flag):
            missing.append(flag)
    if cfg.is_moe:
        missing.append("MoE (n_experts)")
    if cfg.rope_scaling is not None:
        missing.append(f"rope_scaling={cfg.rope_scaling[0]!r}")
    if cfg.rotary_pct < 1.0 or cfg.rope_style != "half":
        missing.append("partial/interleaved rotary")
    if cfg.local_rope_theta is not None:
        missing.append("local_rope_theta")
    if cfg.logits_softcap:
        missing.append("logits_softcap")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port does not implement "
            f"{', '.join(missing)} yet"
        )


def matmul_params_per_token(cfg: ModelConfig) -> int:
    """Matmul weight elements each token position streams through one
    forward (the ``2·N`` FLOPs model): q/k/v/o projections, the gated MLP
    (3 matrices), the lm head; for MoE the router plus the active
    experts. Embedding lookup, norms and rope are left out."""
    D, F_, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = D * (H * hd) + 2 * D * (Hkv * hd) + (H * hd) * D
    gated = cfg.activation in ("silu", "geglu")
    mlp_one = (3 if gated else 2) * D * F_
    if cfg.is_moe:
        mlp = D * cfg.n_experts + cfg.n_experts_per_tok * mlp_one
    else:
        mlp = mlp_one
    return L * (attn + mlp) + D * cfg.vocab_size


# ---------------------------------------------------------------- ops


def _norm(x, p, cfg: ModelConfig):
    """RMSNorm in f32, cast back to x's dtype, THEN scaled (the JAX order:
    core._norm)."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + cfg.norm_eps)
    return xf.to(x.dtype) * p["scale"]


def rope_angles(positions, theta: float, rot: int):
    """(cos, sin) [B, T, 1, rot/2] in f32 for positions [B, T]. Computed
    once per forward and shared by every layer."""
    freqs = 1.0 / (
        theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                               device=positions.device) / rot)
    )
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _rope(x, cos, sin):
    """"half"-style rotary embedding of x [B, T, H, hd] in f32, cast back
    to x's dtype (core._rope with rot == hd and no scaling)."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _activate(up, gate, cfg: ModelConfig):
    return F.silu(gate) * up


def _mlp(x, p, cfg: ModelConfig):
    return _activate(x @ p["w_up"], x @ p["w_gate"], cfg) @ p["w_down"]


# ------------------------------------------------------- reusable blocks


def embed_tokens(params: Params, cfg: ModelConfig, input_ids):
    """Token embedding. input_ids [B, T]."""
    return F.embedding(input_ids, params["tok_embed"])


def transformer_block(lp: Params, cfg: ModelConfig, x, rope, attend):
    """One pre-norm block. lp: one layer's params; x [B, T, D]; rope the
    forward's (cos, sin); ``attend(q, k, v) -> [B, T, H*hd]`` writes this
    chunk's K/V into the pool and attends over it (forward builds it)."""
    B, T, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cos, sin = rope
    h = _norm(x, lp["ln1"], cfg)
    a = lp["attn"]
    q = _rope((h @ a["wq"]).view(B, T, H, hd), cos, sin)
    k = _rope((h @ a["wk"]).view(B, T, Hkv, hd), cos, sin)
    v = (h @ a["wv"]).view(B, T, Hkv, hd)
    x = x + attend(q, k, v) @ a["wo"]
    return x + _mlp(_norm(x, lp["ln2"], cfg), lp["mlp"], cfg)


def final_logits(params: Params, cfg: ModelConfig, x):
    """Final norm + LM head, f32 logits."""
    x = _norm(x, params["final_norm"], cfg)
    if cfg.tie_embeddings:
        logits = x @ params["tok_embed"].T
    else:
        logits = x @ params["lm_head"]
    return logits.float()


def _quantized_page_write(pool, scale, blk, slot, wslot, xT):
    """Quantize-on-write scatter for ONE layer of an int8 paged pool, in
    place: the port of ``core._quantized_page_write`` (symmetric amax at
    (kv head, page) granularity, a running max over the page's tenancy).

    ``pool`` [Hkv, NB, BS, hd] int8 and ``scale`` [Hkv, NB] f32 are
    updated in place; ``blk``/``slot`` [B, T] the position -> (page, slot)
    map with the null redirects applied; ``wslot`` [B, T] each position's
    index into the chunk's page window (``positions // BS - offset //
    BS``); ``xT`` [Hkv, B, T, hd] the chunk's K or V, head-major.

    The same f32 operations in the same order as the JAX function, with
    one difference: the JAX code requantizes the touched pages only when
    some page's scale grew (a ``lax.cond``); a branch here would be a host
    sync per layer, so the touched pages are ALWAYS requantized.
    ``rint(int8 * 1.0)`` is exact, so a page whose scale did not grow keeps
    its bytes. Only slots not yet written can differ: a page whose scale
    is still 0 (fresh, touched by an all-zero write) is zeroed here where
    JAX keeps its stale bytes. No reader sees such a slot before it is
    written. The null block's scale only grows (redirected writes reduce
    into it): garbage by design, masked by every reader. Rows may READ the
    same blocks (a prefix hit maps the cached prompt's full blocks into
    its table), but they never WRITE one another's: a borrower's writes
    below its match are redirected by the write floor, and its partial
    block is a copy it owns (engine/scheduler.py). So a page this writes
    belongs to one row, and the page window repeats only the null block
    (tests/test_torch_prefix.py watches every write)."""
    Hkv, NB, BS, hd = pool.shape
    B, T = blk.shape
    # a T-position chunk at any slot offset straddles at most P pages
    P = (T + BS - 2) // BS + 1
    xf = xT.float()
    amax = xf.abs().amax(dim=-1) * (1.0 / 127.0)  # [Hkv, B, T]
    # scatter-MAX per (kv head, page): duplicate pages reduce
    cand = torch.zeros((Hkv, NB), dtype=torch.float32, device=pool.device)
    cand.scatter_reduce_(
        1, blk.reshape(1, -1).expand(Hkv, -1), amax.reshape(Hkv, -1), "amax"
    )
    new_scale = torch.maximum(scale, cand)
    safe = torch.where(new_scale > 0.0, new_scale, 1.0)
    # dedup the touched pages into the [B, P] window (slots touched only
    # by redirected positions keep the null block 0)
    pg_blk = torch.zeros((B, P), dtype=torch.long, device=pool.device)
    pg_blk.scatter_reduce_(1, wslot, blk, "amax")
    # requantize their content under the grown scale: ratio 1 where the
    # scale held, < 1 where it grew, 0 for a page whose scale was 0
    ratio = scale / safe
    pages = pool[:, pg_blk].float()  # [Hkv, B, P, BS, hd]
    pool[:, pg_blk] = torch.clamp(
        torch.round(pages * ratio[:, pg_blk][..., None, None]), -127, 127
    ).to(torch.int8)
    # quantize the chunk under the new scales into its slots
    pool[:, blk, slot] = torch.clamp(
        torch.round(xf / safe[:, blk][..., None]), -127, 127
    ).to(torch.int8)
    scale.copy_(new_scale)


# ---------------------------------------------------------------- forward


def make_layer_window(cfg: ModelConfig):
    """Layer index -> the sliding window the ragged op gets (0 = full
    causal): every layer for a plain window, the residue pattern for the
    gemma-2/3 local/global alternation (core.is_sliding_layer's rule)."""
    w = int(cfg.sliding_window or 0)
    if not (w and cfg.sliding_window_every > 1):
        return lambda idx: w
    residues = set(cfg.sliding_window_residues)
    every = cfg.sliding_window_every
    return lambda idx: w if idx % every in residues else 0


@torch.no_grad()
def forward(
    params: Params,
    cfg: ModelConfig,
    input_ids,  # [B, T] integer
    pool,  # {"k", "v"}: [L, Hkv, NB, BS, hd] (+ int8 "k_scale", "v_scale"
    #        [L, Hkv, NB]) — updated in place
    offset,  # int, [] or [B] int32: position of input_ids[:, 0]
    block_tables,  # [B, MB] int32: pool block ids per row (0 = null block)
    paged_write_floor=None,  # int: drop pool WRITES below this position
    paged_write_ceil=None,  # int: drop pool WRITES at/after this position
    attn_fn=ragged_paged_attention,
    logits_index=None,  # [B] chunk positions: logits there only
):
    """Run a [B, T] token chunk over the paged pool. Returns
    (logits [B, T, V] f32, pool) — or [B, 1, V] at ``logits_index``.

    Row b's position p lives at pool slot (block_tables[b, p // BS],
    p % BS) of every kv head. The chunk's K/V are scattered there IN
    PLACE in every layer, then ``attn_fn`` (ops/ragged.py's ABI) reads
    the pool directly. Positions whose page lies past the table, below
    ``paged_write_floor`` or at/after ``paged_write_ceil`` write into the
    null block 0 instead: the floor keeps shared prefix blocks read-only,
    the ceil drops a prefill bucket's padded tail. The null block is
    garbage by design and every reader masks it by causality.
    An int8 pool carries ``k_scale``/``v_scale``: each layer quantizes
    the chunk's K/V on write (``_quantized_page_write``) and passes the
    layer's scales to ``attn_fn``.
    ``attn_fn`` defaults to the dispatching op (kernel on the card, plain
    version on the CPU); passing ``ragged_paged_attention_ref`` runs the
    plain version on any device."""
    check_supported(cfg)
    quantized = "k_scale" in pool
    if pool["k"].dtype == torch.int8 and not quantized:
        raise ValueError(
            "int8 KV pool requires its k_scale/v_scale arrays "
            "(init_paged_pool(dtype=torch.int8))"
        )
    B, T = input_ids.shape
    device = input_ids.device
    off = row_offsets(offset, B, device)
    positions = off[:, None].long() + torch.arange(T, device=device)[None, :]
    bt = block_tables.to(device=device, dtype=torch.int32).contiguous()
    BS = pool["k"].shape[3]
    MB = bt.shape[1]
    page = positions // BS
    blk = torch.gather(bt, 1, page.clamp(max=MB - 1)).long()
    redirect = page >= MB
    if paged_write_floor is not None:
        redirect |= positions < paged_write_floor
    if paged_write_ceil is not None:
        redirect |= positions >= paged_write_ceil
    blk = blk.masked_fill(redirect, 0)
    slot = positions % BS
    wslot = page - (off.long() // BS)[:, None]  # the chunk's page window

    rope = rope_angles(positions, cfg.rope_theta, cfg.rotary_dim)
    window = make_layer_window(cfg)
    sm_scale = 1.0 / math.sqrt(cfg.attn_scale or cfg.head_dim)
    softcap = float(cfg.attn_logit_softcap or 0.0)

    x = embed_tokens(params, cfg, input_ids)
    for i, lp in enumerate(params["layers"]):
        kp, vp = pool["k"][i], pool["v"][i]

        def attend(q, k, v, kp=kp, vp=vp, i=i):
            # pool layer [Hkv, NB, BS, hd]: the (blk, slot) index pair
            # after the head slice takes a [Hkv, B, T, hd] update
            kT, vT = k.permute(2, 0, 1, 3), v.permute(2, 0, 1, 3)
            if quantized:
                ks, vs = pool["k_scale"][i], pool["v_scale"][i]
                _quantized_page_write(kp, ks, blk, slot, wslot, kT)
                _quantized_page_write(vp, vs, blk, slot, wslot, vT)
                return attn_fn(q, kp, vp, bt, off, window(i), sm_scale, softcap,
                               k_scale=ks, v_scale=vs)
            kp[:, blk, slot] = kT.to(kp.dtype)
            vp[:, blk, slot] = vT.to(vp.dtype)
            return attn_fn(q, kp, vp, bt, off, window(i), sm_scale, softcap)

        x = transformer_block(lp, cfg, x, rope, attend)
    if logits_index is not None:
        idx = torch.as_tensor(logits_index, device=device).long().reshape(B)
        x = x[torch.arange(B, device=device), idx][:, None]
    return final_logits(params, cfg, x), pool


def init_paged_pool(cfg: ModelConfig, num_blocks: int, block_size: int,
                    dtype=torch.bfloat16, device=None):
    """The paged KV block pool {"k", "v"}: [L, Hkv, num_blocks,
    block_size, hd], zeroed. Block 0 is the engine's reserved null block.
    Head-major like the JAX pool, so a (kv head, block) page is one
    contiguous [block_size, hd] tile the kernel loads with 16-byte loads.

    With ``dtype=torch.int8`` the pages hold quantized K/V and the dict
    grows ``k_scale``/``v_scale`` [L, Hkv, num_blocks] f32, one symmetric
    scale per (kv head, page), zeroed (= the page holds nothing; the
    scheduler zeroes a block's entries again whenever it hands the block
    out)."""
    if dtype not in (torch.bfloat16, torch.float32, torch.float16, torch.int8):
        raise NotImplementedError(f"paged pool dtype {dtype}")
    shape = (cfg.n_layers, cfg.n_kv_heads, num_blocks, block_size, cfg.head_dim)
    pool = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }
    if dtype == torch.int8:
        sshape = (cfg.n_layers, cfg.n_kv_heads, num_blocks)
        pool["k_scale"] = torch.zeros(sshape, dtype=torch.float32, device=device)
        pool["v_scale"] = torch.zeros(sshape, dtype=torch.float32, device=device)
    return pool
