"""The transformer core of the PyTorch port: the llama family's forward
over the paged KV pool.

The port of ``bee2bee_tpu/models/core.py``'s block-tables path, kept
function for function where that helps a reader find the counterpart
(``_norm``, ``scale_rope_freqs``, ``_qk_rmsnorm``, ``_rope``,
``is_sliding_layer``,
``_activate``, ``_mlp``, ``_moe``, ``_attention``,
``embed_tokens``, ``transformer_block``, ``final_logits``, ``forward``,
``matmul``, ``_lora_rows``, ``lora_matmul``, ``attn_mask``,
``make_layer_mask``, ``make_layer_window``, ``init_cache``,
``init_paged_pool``, ``matmul_params_per_token``).
What differs from the JAX package:

- Parameters are a plain dict of tensors whose ``"layers"`` entry is a
  LIST of per-layer dicts (models/params.py): the layer loop is a python
  loop, not a scan. Weights keep the JAX layout ``[in, out]`` and
  project through ``matmul``: ``x @ w`` for a dense weight; an int8
  weight-only quantized one (models/quant.py), the JAX layout {"q", "s"},
  goes through the int8-weight GEMM (ops/int8_gemm.py: the kernel on the
  card, its plain version, the JAX formula, on the CPU). Projections that
  share an input (wq, wk, wv; w_up, w_gate) go through ``matmul_group``:
  with int8 weights, one launch for the group.
- Multi-LoRA serving: every projection goes through ``lora_matmul``,
  which adds each batch row's low-rank delta from the adapter pool's
  stacked factors (adapters/pool.py), as the JAX function does: the
  factors are gathered per row by slot id and the rank-r products run in
  f32.
- The pool is updated IN PLACE: ``forward`` scatters each chunk's K/V
  into the pool tensors it was given (the JAX engine donates the pool
  and gets a new one back; here the returned pool is the same object).
- With block tables, attention is always the ragged paged op
  (ops/ragged.py) reading the pool directly: no gathered view. An int8
  pool (``init_paged_pool(dtype=torch.int8)``) quantizes each chunk's
  K/V on write (``_quantized_page_write``) and hands the op its scales.
- Without block tables the cache is RECTANGULAR (``init_cache``, [L, B,
  S, Hkv, hd]): each row's chunk is written at [offset, offset+T) and the
  dense ``_attention`` (plain torch, as JAX computes it with XLA ops)
  reads the whole row under ``make_layer_mask``. Only the model drafter
  (engine/drafter.py) runs it; an int8 rectangular cache is refused, as
  in JAX. The no-cache forward is not ported.
- The llama architecture runs, with qwen2's q/k/v biases and the
  head-wise q/k RMSNorm of qwen3 and gemma-3 (both by key presence in the
  layer's params, as JAX applies them): rmsnorm, "half" rope (unscaled,
  or with the "linear", "llama3" or "yarn" frequency scaling; yarn's
  attention factor scales the rotated block in f32 before the cast, as in
  JAX), gated silu or geglu MLP, GQA, tied or untied head, plus the score
  switches the kernel carries (sliding window with its per-layer
  alternation, attention softcap, score scale). The gemma family's
  switches run too: the embedding scale sqrt(d_model) in x's dtype,
  gemma-2/3's post-norms on the attention and MLP outputs, gemma-3's
  dual rope (sliding layers rotate with ``local_rope_theta`` unscaled,
  global layers with ``rope_theta`` and its scaling) and the final logit
  softcap. So does the gpt2 block (gpt2, gpt-bigcode): learned positions
  (no rope), layernorm with or without its bias, the non-gated tanh or erf
  gelu MLP, and biases on q/k/v/o and on the MLP (``b_up``, ``b_down``),
  each by key presence. Any other switch raises NotImplementedError by
  name (``check_supported``) instead of computing something else.
- Mixture-of-experts layers (mixtral, qwen3_moe: a layer with ``"moe"``)
  run the routed product (``_moe``, ops/moe.py): the router as a plain
  product in x's type, the device-side plan (JAX's top-k tie rule, the
  softmax over the k, and for ``moe_impl="routed"`` JAX's per-group
  capacity drops), one launch of the grouped expert GEMM for w_gate and
  w_up, ``_activate``, one for w_down, and the weighted sum. Each expert
  runs only on its rows, where JAX's default ``_moe`` runs every expert on
  every token and weights the unpicked ones by 0: the same function.
- Learned positions are clamped into the table, [0, P - 1], before the
  lookup (``embed_tokens``): JAX's ``jnp.take`` returns NaN rows past the
  table and wraps -1 to the last row, where ``F.embedding`` fails on the
  CPU and asserts on the card, which kills the process's CUDA context. The
  served path feeds such positions only where no token is emitted (a dead
  row at offset -1, a decode window past a row's budget; the capacity
  re-anchor keeps every prefill window inside max_seq_len), so the emitted
  tokens are JAX's.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..ops.int8_gemm import int8_weight_matmul, int8_weight_matmul_group
from ..ops.moe import moe_combine, moe_expert_matmul, moe_plan, routed_capacity
from ..ops.ragged import ragged_paged_attention, row_offsets
from .config import ModelConfig

Params = dict


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError naming every config switch this port
    does not implement yet."""
    missing = []
    if cfg.pos_embedding not in ("rope", "learned"):
        missing.append(f"pos_embedding={cfg.pos_embedding!r}")
    if cfg.norm not in ("rmsnorm", "layernorm"):
        missing.append(f"norm={cfg.norm!r}")
    if cfg.activation not in ("silu", "geglu", "gelu", "gelu_exact"):
        missing.append(f"activation={cfg.activation!r}")
    for flag in ("mlp_bias", "lm_head_bias", "qk_norm_full",
                 "no_pre_norms", "parallel_block", "embedding_norm"):
        if getattr(cfg, flag):
            missing.append(flag)
    if cfg.rope_scaling is not None and cfg.rope_scaling[0] not in ("linear", "llama3",
                                                                    "yarn"):
        missing.append(f"rope_scaling={cfg.rope_scaling[0]!r}")
    if cfg.rotary_pct < 1.0 or cfg.rope_style != "half":
        missing.append("partial/interleaved rotary")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port does not implement "
            f"{', '.join(missing)} yet (ROADMAP.md queue A item 11)"
        )


def matmul_params_per_token(cfg: ModelConfig) -> int:
    """Matmul weight elements each token position streams through one
    forward (the ``2·N`` FLOPs model): q/k/v/o projections, the MLP (3
    matrices gated, 2 not), the lm head; for MoE the router plus the active
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
    """RMSNorm or LayerNorm in f32, cast back to x's dtype, THEN scaled,
    then the bias added where ``p`` carries one (the JAX order:
    core._norm)."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + cfg.norm_eps)
    else:
        xf = F.layer_norm(xf, xf.shape[-1:], eps=cfg.norm_eps)
    out = xf.to(x.dtype) * p["scale"]
    if "bias" in p:
        out = out + p["bias"]
    return out


def scale_rope_freqs(freqs, scaling: tuple | None, theta: float | None = None,
                     rot: int | None = None):
    """Frequency-domain RoPE scaling (cfg.rope_scaling), the port of the
    JAX function's three branches in the same f32 order.

    "linear": every frequency divided by the factor (position
    interpolation). "llama3" (llama-3.1+): wavelengths longer than the
    original context / low_freq_factor get the full division, those
    shorter than original / high_freq_factor stay, the band between
    interpolates. "yarn" (NTK-by-parts): a linear ramp over the rotary
    DIMENSIONS between full interpolation and none, its bounds from the
    beta_fast / beta_slow rotations at the original context (theta and
    rot required). Yarn's attention factor is applied in ``_rope``."""
    if scaling is None:
        return freqs
    if scaling[0] == "linear":
        return freqs / scaling[1]
    if scaling[0] == "yarn":
        if theta is None or rot is None:
            raise ValueError("yarn rope scaling needs theta and rot (the ramp bounds "
                             "are dimension- and base-dependent)")
        _, factor, _af, beta_fast, beta_slow, orig, truncate = scaling

        def corr_dim(n_rot):
            return (rot * math.log(orig / (n_rot * 2 * math.pi))) / (2 * math.log(theta))

        low, high = corr_dim(beta_fast), corr_dim(beta_slow)
        if truncate:
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0), min(high, rot - 1)
        if low == high:
            high += 0.001
        ramp = torch.clamp(
            (torch.arange(rot // 2, dtype=torch.float32, device=freqs.device) - low)
            / (high - low), 0.0, 1.0)
        extrap = 1.0 - ramp  # 1 = keep the base frequency (extrapolation)
        return (freqs / factor) * (1.0 - extrap) + freqs * extrap
    _, factor, low_f, high_f, orig = scaling
    low_wavelen = orig / low_f
    high_wavelen = orig / high_f
    wavelen = 2.0 * math.pi / freqs
    smooth = (orig / wavelen - low_f) / (high_f - low_f)
    smoothed = (1.0 - smooth) * freqs / factor + smooth * freqs
    return torch.where(
        wavelen > low_wavelen, freqs / factor,
        torch.where(wavelen < high_wavelen, freqs, smoothed),
    )


def _qk_rmsnorm(x, scale, eps: float):
    """Per-head RMSNorm over head_dim (qwen3's q_norm / k_norm): x [B, T,
    H, hd], scale [hd] shared across heads; in f32, cast back to x's
    dtype, THEN scaled (core._qk_rmsnorm)."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return xf.to(x.dtype) * scale


def rope_freqs(cfg: ModelConfig, device=None, local: bool = False):
    """The [rot/2] f32 rotary frequencies of ``cfg``, scaled (``local``:
    gemma-3's sliding layers' frequencies, ``local_rope_theta`` unscaled):
    computed once per (theta, rotary dims, scaling, device) and kept, so a
    forward, and a captured root's replay, only reads them. The first
    forward on a device is eager (a root's capture follows its warm-up),
    so the kept tensor never lives in a graph's pool: this holds for the
    llama3, the yarn and the local tensors alike."""
    if local:
        return _rope_freqs(cfg.local_rope_theta, cfg.rotary_dim, None,
                           torch.device(device or "cpu"))
    return _rope_freqs(cfg.rope_theta, cfg.rotary_dim, cfg.rope_scaling,
                       torch.device(device or "cpu"))


@functools.lru_cache(maxsize=None)
def _rope_freqs(theta: float, rot: int, scaling: tuple | None, device: torch.device):
    freqs = 1.0 / (
        theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot)
    )
    return scale_rope_freqs(freqs, scaling, theta=theta, rot=rot)


def rope_angles(positions, cfg: ModelConfig, local: bool = False):
    """(cos, sin, attention factor) for positions [B, T]: cos and sin [B,
    T, 1, rot/2] in f32, and yarn's attention factor (a float) or None;
    ``local``: gemma-3's sliding layers' (``rope_freqs``), never scaled.
    Computed once per forward and shared by every layer of its kind."""
    freqs = rope_freqs(cfg, positions.device, local)
    angles = positions[..., None].float() * freqs
    scaling = None if local else cfg.rope_scaling
    factor = scaling[2] if scaling is not None and scaling[0] == "yarn" else None
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :], factor


def is_sliding_layer(cfg: ModelConfig, idx: int) -> bool:
    """Does layer ``idx`` window (core.is_sliding_layer): its index mod
    ``sliding_window_every`` is one of ``sliding_window_residues``
    (gemma-2: residue 0 mod 2; gemma-3: residues 0..4 mod 6)."""
    return idx % cfg.sliding_window_every in cfg.sliding_window_residues


def make_layer_rope(cfg: ModelConfig, positions):
    """Layer index -> its ``rope_angles`` triple (JAX's ``rope_flag``):
    with ``local_rope_theta`` (gemma-3) the sliding layers rotate with the
    local frequencies, unscaled, the global layers with ``rope_theta`` and
    its scaling; every other rope config shares one triple. Without rope
    (learned positions) every layer gets None."""
    if cfg.pos_embedding != "rope":
        return lambda idx: None
    glob = rope_angles(positions, cfg)
    if cfg.local_rope_theta is None:
        return lambda idx: glob
    loc = rope_angles(positions, cfg, local=True)
    return lambda idx: loc if is_sliding_layer(cfg, idx) else glob


def _rope(x, rope):
    """"half"-style rotary embedding of x [B, T, H, hd] in f32 (core._rope
    with rot == hd): ``rope`` is ``rope_angles``' triple. Yarn's attention
    factor multiplies the rotated block in f32, then the cast back to x's
    dtype (JAX's order)."""
    cos, sin, factor = rope
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if factor is not None:
        out = out * factor
    return out.to(x.dtype)


def _activate(up, gate, cfg: ModelConfig):
    if cfg.activation == "geglu":  # gemma: tanh-approximated gelu of the gate
        return F.gelu(gate, approximate="tanh") * up
    if cfg.activation == "silu":
        return F.silu(gate) * up
    if cfg.activation == "gelu_exact":  # the erf form, non-gated
        return F.gelu(up)
    return F.gelu(up, approximate="tanh")  # gpt2, bigcode: non-gated


def matmul(x, w):
    """x @ w where w may be an int8 weight-only quantized subtree {"q":
    int8 [in, out], "s": f32 [out]}: the JAX formula ``(x @
    q.astype(x.dtype)) * s.astype(x.dtype)`` through the int8-weight GEMM
    (its plain version on the CPU)."""
    if isinstance(w, dict):
        return int8_weight_matmul(x, w)
    return x @ w


def matmul_group(x, ws):
    """``[matmul(x, w) for w in ws]`` for weights that share x (wq, wk, wv;
    w_up, w_gate): int8 weights go through ONE launch of the
    int8-weight GEMM (ops/int8_gemm.py), as a fused product would; any
    other weight takes ``matmul`` one by one."""
    if all(isinstance(w, dict) for w in ws):
        return int8_weight_matmul_group(x, list(ws))
    return [matmul(x, w) for w in ws]


def _lora_rows(ab, ids, scale):
    """Gather one layer's per-ROW adapter factors: ``ab`` is the pool's
    stacked {"a": [N, din, r], "b": [N, r, dout]} slice for this layer,
    ``ids`` [B] each row's pool slot (0 = the reserved null adapter,
    all-zero factors), ``scale`` [N] each slot's alpha/rank scaling.
    Returns (a [B, din, r], b [B, r, dout], s [B])."""
    return ab["a"].index_select(0, ids), ab["b"].index_select(0, ids), scale[ids]


def lora_matmul(x, w, name, lora):
    """The multi-adapter serving hook around ``matmul``: base projection
    plus each row's low-rank delta ``s * (x @ A) @ B``. ``lora`` is None
    (plain matmul) or {"ab": per-layer target dict, "ids": [B] int64,
    "scale": [N] f32}; a target absent from the pool passes through
    untouched. Rows mapped to slot 0 gather the null adapter's zero
    factors, so adapter-less rows in a mixed batch add exact zeros. The
    rank-r products run in f32 like merge_lora's delta, then cast back; x
    is [B, T, din] (the batch dim is the row identity)."""
    return _with_lora(matmul(x, w), x, name, lora)


def _with_lora(out, x, name, lora):
    """``out`` (the base projection of x) plus each row's delta of target
    ``name`` (``lora_matmul``'s second half)."""
    ab = None if lora is None else lora["ab"].get(name)
    if ab is None:
        return out
    a, b, s = _lora_rows(ab, lora["ids"], lora["scale"])
    h = torch.bmm(x.float(), a.float())
    delta = torch.bmm(h, b.float())
    return out + (delta * s[:, None, None]).to(out.dtype)


def _mlp(x, p, cfg: ModelConfig, lora=None):
    """The dense MLP by key presence (JAX ``_mlp``): gated where ``p`` has
    ``w_gate`` (one grouped product for w_up and w_gate), ``b_up`` added
    before the activation, ``b_down`` after ``w_down``."""
    gated = "w_gate" in p
    outs = matmul_group(x, (p["w_up"], p["w_gate"]) if gated else (p["w_up"],))
    up = _with_lora(outs[0], x, "w_up", lora)
    if "b_up" in p:
        up = up + p["b_up"]
    gate = _with_lora(outs[1], x, "w_gate", lora) if gated else None
    out = lora_matmul(_activate(up, gate, cfg), p["w_down"], "w_down", lora)
    if "b_down" in p:
        out = out + p["b_down"]
    return out


def _moe(x, p, cfg: ModelConfig):
    """The routed mixture-of-experts MLP (JAX ``_moe``, and ``_moe_routed``
    with ``cfg.moe_impl == "routed"``): router logits ``(x @ router)`` in
    x's type, then f32; the plan (ops/moe.py ``moe_plan``: top k by JAX's
    tie rule, softmax over the k, the capacity drops of the routed impl);
    w_up and w_gate over each expert's rows in one launch, ``_activate``,
    w_down; each token's k outputs weighted and summed (``moe_combine``).
    x [B, T, D] -> [B, T, D]."""
    B, T, D = x.shape
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    x2 = x.reshape(B * T, D)
    logits = (x2 @ p["router"]).float()
    capacity = None
    if cfg.moe_impl == "routed":
        capacity = routed_capacity(B * T, k, E, cfg.moe_group_size, cfg.moe_capacity_factor)
    plan = moe_plan(logits, k, capacity, dtype=x.dtype)
    gated = "w_gate" in p
    outs = moe_expert_matmul(x2, plan.tok, plan,
                             [p["w_up"], p["w_gate"]] if gated else [p["w_up"]])
    h = _activate(outs[0], outs[1] if gated else None, cfg)
    y = moe_expert_matmul(h, None, plan, [p["w_down"]])[0]
    return moe_combine(y, plan, x.dtype).view(B, T, D)


def _attention(q, k, v, mask, cfg: ModelConfig):
    """Dense attention (core._attention): q [B, T, H, hd]; k, v [B, S,
    Hkv, hd]; mask [B, 1, T, S] bool. Scores in f32, softmax, the
    probabilities cast to v's dtype."""
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    q = q.reshape(B, T, Hkv, group, hd)
    logits = torch.einsum("btkgh,bskh->bkgts", q, k).float()
    logits = logits / math.sqrt(cfg.attn_scale or hd)
    if cfg.attn_logit_softcap:  # tanh cap BEFORE masking
        c = cfg.attn_logit_softcap
        logits = torch.tanh(logits / c) * c
    logits = torch.where(mask[:, :, None, :, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v)
    return out.reshape(B, T, H * hd)


# ------------------------------------------------------- reusable blocks


def embed_tokens(params: Params, cfg: ModelConfig, input_ids, positions=None):
    """Token (+ learned-position) embedding. input_ids, positions [B, T].
    gemma scales it by sqrt(d_model) rounded to the embedding's dtype
    first, as JAX multiplies by ``jnp.asarray(sqrt(d_model), x.dtype)``
    (in bf16 sqrt(3584) is 59.75, not 59.866). Learned positions are
    clamped into the table before the lookup (the module docstring says
    why)."""
    x = F.embedding(input_ids, params["tok_embed"])
    if cfg.embedding_scale:
        x = x * _in_dtype(math.sqrt(cfg.d_model), x.dtype)
    if cfg.pos_embedding == "learned":
        table = params["pos_embed"]
        x = x + F.embedding(positions.clamp(0, table.shape[0] - 1), table)
    return x


@functools.lru_cache(maxsize=None)
def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a python float: a tensor times
    it rounds once, as a product of two ``dtype`` values does."""
    return torch.tensor(value, dtype=dtype).item()


def transformer_block(lp: Params, cfg: ModelConfig, x, rope, attend, lora=None):
    """One pre-norm block. lp: one layer's params; x [B, T, D]; rope the
    layer's ``rope_angles`` triple (``make_layer_rope``; None: learned
    positions, no rotation); ``attend(q, k, v)
    -> [B, T, H*hd]`` writes this chunk's K/V into the pool and attends
    over it (forward builds it); ``lora`` one layer's adapter arguments
    (``lora_matmul``) or None. The q/k/v biases and the head-wise q/k
    norms apply where the layer's params carry them (JAX's rule: by key
    presence), and so does gpt2's output bias ``bo`` (after ``wo`` and its
    LoRA delta); with ``cfg.post_norms`` (gemma-2/3) ``ln1_post`` norms the
    attention output (after ``wo`` and its LoRA delta) and ``ln2_post``
    the MLP output before each joins the residual. A layer with ``"moe"``
    runs the routed experts (``_moe``) where others run ``_mlp``."""
    B, T, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = _norm(x, lp["ln1"], cfg)
    a = lp["attn"]
    q, k, v = (_with_lora(out, h, name, lora) for out, name in
               zip(matmul_group(h, (a["wq"], a["wk"], a["wv"])), ("wq", "wk", "wv")))
    if "bq" in a:  # qwen2, gpt2: q/k/v biases after the (LoRA) projection
        q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
    q, k, v = q.view(B, T, H, hd), k.view(B, T, Hkv, hd), v.view(B, T, Hkv, hd)
    if "q_norm" in a:  # qwen3: head-wise RMSNorm before rope
        q = _qk_rmsnorm(q, a["q_norm"], cfg.norm_eps)
        k = _qk_rmsnorm(k, a["k_norm"], cfg.norm_eps)
    if rope is not None:
        q, k = _rope(q, rope), _rope(k, rope)
    attn_out = lora_matmul(attend(q, k, v), a["wo"], "wo", lora)
    if "bo" in a:
        attn_out = attn_out + a["bo"]
    if cfg.post_norms:
        attn_out = _norm(attn_out, lp["ln1_post"], cfg)
    x = x + attn_out
    h = _norm(x, lp["ln2"], cfg)
    mlp_out = _moe(h, lp["moe"], cfg) if "moe" in lp else _mlp(h, lp["mlp"], cfg, lora)
    if cfg.post_norms:
        mlp_out = _norm(mlp_out, lp["ln2_post"], cfg)
    return x + mlp_out


def final_logits(params: Params, cfg: ModelConfig, x):
    """Final norm + LM head, f32 logits; gemma-2's softcap ``tanh(logits /
    c) * c`` in f32, after the cast."""
    x = _norm(x, params["final_norm"], cfg)
    if cfg.tie_embeddings:
        logits = x @ params["tok_embed"].T
    else:
        logits = x @ params["lm_head"]
    logits = logits.float()
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    return logits


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


def attn_mask(cfg: ModelConfig, positions, S: int, window="cfg"):
    """The cached mask (core.attn_mask with S given): [B, 1, T, S] over
    cache positions, s visible to query t iff s <= pos(t), and with a
    sliding window only the last W positions (s > pos(t) - W).
    ``window`` overrides cfg.sliding_window (None = full causal)."""
    w = cfg.sliding_window if window == "cfg" else window
    s_idx = torch.arange(S, device=positions.device)[None, None, :]
    q_pos = positions[:, :, None]
    mask = s_idx <= q_pos
    if w:
        mask = mask & (s_idx > q_pos - w)
    return mask[:, None, :, :]


def make_layer_mask(cfg: ModelConfig, positions, S: int):
    """Layer index -> its cached mask (core.make_layer_mask at start 0):
    the gemma-2/3 local/global alternation by the same residue rule as
    ``make_layer_window``; other configs get one mask for every layer."""
    mask = attn_mask(cfg, positions, S)
    if not (cfg.sliding_window and cfg.sliding_window_every > 1):
        return lambda idx: mask
    mask_full = attn_mask(cfg, positions, S, window=None)
    return lambda idx: mask if is_sliding_layer(cfg, idx) else mask_full


def make_layer_window(cfg: ModelConfig):
    """Layer index -> the sliding window the ragged op gets (0 = full
    causal): every layer for a plain window, the residue pattern for the
    gemma-2/3 local/global alternation (``is_sliding_layer``)."""
    w = int(cfg.sliding_window or 0)
    if not (w and cfg.sliding_window_every > 1):
        return lambda idx: w
    return lambda idx: w if is_sliding_layer(cfg, idx) else 0


@torch.no_grad()
def forward(
    params: Params,
    cfg: ModelConfig,
    input_ids,  # [B, T] integer
    pool,  # {"k", "v"}: [L, Hkv, NB, BS, hd] (+ int8 "k_scale", "v_scale"
    #        [L, Hkv, NB]) — updated in place
    offset,  # int, [] or [B] int32: position of input_ids[:, 0]
    block_tables=None,  # [B, MB] int32: pool block ids per row (0 = null
    #                     block); None = ``pool`` is a rectangular cache
    paged_write_floor=None,  # int: drop pool WRITES below this position
    paged_write_ceil=None,  # int: drop pool WRITES at/after this position
    attn_fn=ragged_paged_attention,
    logits_index=None,  # [B] chunk positions: logits there only
    adapters=None,  # multi-LoRA serving (adapters/pool.py): stacked pool
    # factors {target: {"a": [L, N, din, r], "b": [L, N, r, dout]}}
    adapter_ids=None,  # [B] int64: each row's pool slot (0 = no adapter)
    adapter_scales=None,  # [N] f32: per-slot alpha/rank scaling
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
    plain version on any device.

    With ``adapters`` every projection adds each row's LoRA delta
    (``lora_matmul``): the per-row slot ids and the slot scales are
    batch-constant, each layer reads its own [N, ...] slice of the
    stacks. Without, the forward is the adapter-free one.

    Without ``block_tables``, ``pool`` is a rectangular cache
    (``init_cache``): see ``_forward_rect``."""
    check_supported(cfg)
    if block_tables is None:
        return _forward_rect(params, cfg, input_ids, pool, offset)
    lora_for = _lora_for(adapters, adapter_ids, adapter_scales, input_ids.device)
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

    rope = make_layer_rope(cfg, positions)
    window = make_layer_window(cfg)
    sm_scale = 1.0 / math.sqrt(cfg.attn_scale or cfg.head_dim)
    softcap = float(cfg.attn_logit_softcap or 0.0)

    x = embed_tokens(params, cfg, input_ids, positions)
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

        x = transformer_block(lp, cfg, x, rope(i), attend, lora_for(i))
    if logits_index is not None:
        idx = torch.as_tensor(logits_index, device=device).long().reshape(B)
        x = x[torch.arange(B, device=device), idx][:, None]
    return final_logits(params, cfg, x), pool


def _lora_for(adapters, adapter_ids, adapter_scales, device):
    """Layer index -> that layer's ``lora_matmul`` arguments (None without
    adapters)."""
    if adapters is None:
        return lambda i: None
    ids = torch.as_tensor(adapter_ids, device=device).long().reshape(-1)
    scale = torch.as_tensor(adapter_scales, device=device).float()
    return lambda i: {
        "ab": {t: {"a": ab["a"][i], "b": ab["b"][i]} for t, ab in adapters.items()},
        "ids": ids, "scale": scale,
    }


def _forward_rect(params: Params, cfg: ModelConfig, input_ids, cache, offset):
    """The rectangular-cache branch of core.forward: each row's chunk K/V
    go to cache positions [offset, offset+T) in place (the start clamped
    so the chunk fits, as ``lax.dynamic_update_slice`` clamps it), then
    ``_attention`` reads the whole row [0, S) under the causal mask of the
    unclamped positions. Returns (logits [B, T, V] f32, cache)."""
    if cache["k"].dtype == torch.int8:
        raise ValueError(
            "int8 KV cache requires the paged pool with its "
            "k_scale/v_scale scale arrays (init_paged_pool dtype=int8 "
            "+ block_tables); the rectangular cache has no quantized path"
        )
    B, T = input_ids.shape
    device = input_ids.device
    S = cache["k"].shape[2]
    off = row_offsets(offset, B, device).long()
    steps = torch.arange(T, device=device)[None, :]
    positions = off[:, None] + steps
    rows = torch.arange(B, device=device)[:, None]
    write = off.clamp(0, S - T)[:, None] + steps
    rope = make_layer_rope(cfg, positions)
    mask = make_layer_mask(cfg, positions, S)
    x = embed_tokens(params, cfg, input_ids, positions)
    for i, lp in enumerate(params["layers"]):
        ck, cv = cache["k"][i], cache["v"][i]

        def attend(q, k, v, ck=ck, cv=cv, i=i):
            ck[rows, write] = k.to(ck.dtype)
            cv[rows, write] = v.to(cv.dtype)
            return _attention(q, ck, cv, mask(i), cfg)

        x = transformer_block(lp, cfg, x, rope(i), attend)
    return final_logits(params, cfg, x), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int | None = None,
               dtype=torch.bfloat16, device=None):
    """A fixed-capacity rectangular KV cache {"k", "v"}: [L, B, S, Hkv,
    hd], zeroed (core.init_cache). The model drafter's cache; the serving
    engine's is the paged pool."""
    S = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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
