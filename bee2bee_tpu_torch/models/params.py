"""Parameters of the PyTorch port: random init and the carry-over of the
JAX package's parameter tree.

The schema is the JAX package's (``bee2bee_tpu/models/core.py``
``init_params``) for the llama path, as a plain dict of tensors, with the
layers as a LIST of per-layer dicts (the JAX engine's unstacked form):

  tok_embed [V, D]; pos_embed [P, D] (learned positions only, P =
  max_seq_len); final_norm {scale [D] (+ bias [D])}; lm_head [D, V]
  (untied only)
  layers[i]:
    ln1 {scale [D]}, ln2 {scale [D]}
      + gemma-2/3 (cfg.post_norms): ln1_post {scale [D]}, ln2_post {scale [D]}
      + a layernorm with cfg.norm_bias: bias [D] in each
    attn {wq [D, H*hd], wk [D, Hkv*hd], wv [D, Hkv*hd], wo [H*hd, D]}
      + qwen2, gpt2 (cfg.qkv_bias, cfg.use_bias): bq [H*hd], bk [Hkv*hd],
        bv [Hkv*hd]; gpt2 (cfg.use_bias) also bo [D]
      + qwen3, gemma-3 (cfg.qk_norm): q_norm [hd], k_norm [hd] (head-wise)
    mlp {w_up [D, F], w_down [F, D]} + w_gate [D, F] (gated activations)
      + gpt2 (cfg.use_bias): b_up [F], b_down [D]
    or, in a mixture-of-experts model (mixtral, qwen3_moe), in place of mlp:
    moe {router [D, E], w_up [E, D, F], w_down [E, F, D]} + w_gate [E, D, F]

Weights keep the JAX layout ``[in, out]`` and project as ``x @ w``; no
transpose into ``nn.Linear``'s ``[out, in]`` happens anywhere, so a tensor
carried across from JAX is the same matrix, element for element. An int8
weight-only quantized weight (models/quant.py) is the JAX subtree
{"q": int8 [in, out], "s": f32 [out]}; ``params_from_numpy`` carries it
across as it is (int8 stays int8, the scales f32), and the int8-weight
GEMM reads it in that layout; an int8 expert stack is {"q": int8 [E, in,
out], "s": f32 [E, out]} on every side. A random
init for an int8 engine (``init_params(quantize=True)``) quantizes each
projection on the device as it is drawn, and each expert stack expert by
expert, so the init never holds more than the int8 model plus one dense
tensor.

``params_to_numpy`` is the inverse: the JAX schema with the layers
stacked ``[L, ...]`` (the canonical layout of the piece manifest and of
``models/loader.save_native``), numpy leaves on the host. A bf16
tensor goes out as its 16-bit pattern in ``pieces.HOST_BF16``, whose piece
dtype string is "bfloat16", so no ml_dtypes is needed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..pieces import HOST_BF16, dtype_name
from .config import ModelConfig
from .core import check_supported
from .quant import (
    empty_quantized_stack, quantize_expert_into, quantize_weight_torch,
)


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                dtype=torch.bfloat16, quantize: bool = False) -> dict:
    """Random-init parameters with the JAX schema and scales (normal
    draws times 1/sqrt(fan_in); embeddings 0.02; norms ones), drawn from
    ``generator`` straight on ``device`` in ``dtype``, one tensor at a
    time — the largest single draw is one layer's [D, F] matrix, never a
    stacked [L, D, F] one. The draws differ from jax.random's by
    construction; parity tests carry the JAX tree across instead
    (params_from_numpy). As in JAX, every bias starts at zeros, the norm
    scales at ones, and the position table is drawn like the token
    table."""
    check_supported(cfg)
    D, F_, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def normal(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        t = torch.randn(shape, generator=generator, device=device, dtype=dtype)
        return t.mul_(scale)

    def weight(shape):  # a projection: quantized as drawn with ``quantize``
        t = normal(shape)
        if not quantize:
            return t
        qw = quantize_weight_torch(t)
        del t
        return qw

    def experts(shape):  # an [E, in, out] stack, one expert's draw at a time
        if quantize:
            qw = empty_quantized_stack(shape, device)
            for e in range(shape[0]):
                quantize_expert_into(qw, e, normal(shape[1:]))
            return qw
        out = torch.empty(shape, dtype=dtype, device=device)
        for e in range(shape[0]):
            out[e] = normal(shape[1:])
        return out

    def ones(n):
        return torch.ones((n,), device=device, dtype=dtype)

    def zeros(n):
        return torch.zeros((n,), device=device, dtype=dtype)

    def attn():
        a = {
            "wq": weight((D, H * hd)),
            "wk": weight((D, Hkv * hd)),
            "wv": weight((D, Hkv * hd)),
            "wo": weight((H * hd, D)),
        }
        if cfg.qkv_bias or cfg.use_bias:
            a.update(bq=zeros(H * hd), bk=zeros(Hkv * hd), bv=zeros(Hkv * hd))
        if cfg.qk_norm:
            a.update(q_norm=ones(hd), k_norm=ones(hd))
        if cfg.use_bias:  # qwen2 (qkv_bias) has no output-projection bias
            a["bo"] = zeros(D)
        return a

    def norm():
        if cfg.norm == "layernorm" and cfg.norm_bias:
            return {"scale": ones(D), "bias": zeros(D)}
        return {"scale": ones(D)}

    def mlp():
        m = {"w_up": weight((D, F_)), "w_down": weight((F_, D))}
        if cfg.activation in ("silu", "geglu"):
            m["w_gate"] = weight((D, F_))
        if cfg.use_bias:
            m.update(b_up=zeros(F_), b_down=zeros(D))
        return m

    def moe():  # JAX's key order: router, w_up, w_down, then w_gate
        E = cfg.n_experts
        m = {"router": normal((D, E)), "w_up": experts((E, D, F_)),
             "w_down": experts((E, F_, D))}
        if cfg.activation in ("silu", "geglu"):
            m["w_gate"] = experts((E, D, F_))
        return m

    def layer():
        lp = {"ln1": norm(), "attn": attn(), "ln2": norm(),
              **({"moe": moe()} if cfg.is_moe else {"mlp": mlp()})}
        if cfg.post_norms:
            lp.update(ln1_post=norm(), ln2_post=norm())
        return lp

    params = {"tok_embed": normal((V, D), 0.02)}
    if cfg.pos_embedding == "learned":
        params["pos_embed"] = normal((cfg.max_seq_len, D), 0.02)
    params["layers"] = [layer() for _ in range(cfg.n_layers)]
    params["final_norm"] = norm()
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V))
    return params


def _to_tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if dtype_name(a) == "bfloat16":  # ml_dtypes or HOST_BF16: torch has no
        # numpy bf16, so the bits go across as int16
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        a = np.ascontiguousarray(a)
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
    return t.to(device=device, dtype=dtype)


def _map(fn, tree, quantized=None):
    """``fn`` over every leaf; a quantized {"q", "s"} subtree goes to
    ``quantized`` instead (default: ``fn`` on each leaf)."""
    if isinstance(tree, dict):
        if quantized is not None and "q" in tree and "s" in tree:
            return quantized(tree)
        return {k: _map(fn, v, quantized) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None,
                      dtype=torch.float32) -> dict:
    """Carry the JAX package's parameter tree across: ``tree`` holds numpy
    arrays (``jax.device_get(engine.params)``), with the layers either
    stacked ``[L, ...]`` (core.init_params) or as a per-layer list
    (core.unstack_layers). Returns the port's parameters on ``device`` in
    ``dtype``, same layout ([in, out] weights), layers as a list."""
    check_supported(cfg)
    layers = tree["layers"]
    # an int8 weight keeps its int8 q and f32 scales: only dense leaves
    # take ``dtype``
    def carry(qw):
        return {"q": _to_tensor(qw["q"], device, torch.int8),
                "s": _to_tensor(qw["s"], device, torch.float32)}

    if isinstance(layers, (list, tuple)):
        per_layer = list(layers)
    else:
        per_layer = [
            _map(lambda a, i=i: np.asarray(a)[i], layers)
            for i in range(cfg.n_layers)
        ]
    if len(per_layer) != cfg.n_layers:
        raise ValueError(
            f"{len(per_layer)} layers in the tree, {cfg.name} has {cfg.n_layers}"
        )

    def conv(a):
        return _to_tensor(a, device, dtype)

    out = {k: _map(conv, v, carry) for k, v in tree.items() if k != "layers"}
    out["layers"] = [_map(conv, lp, carry) for lp in per_layer]
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(HOST_BF16)
    return t.numpy()


def _stack(trees: list):
    """One tree of np.stack'ed leaves from per-layer trees of one schema."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees, axis=0)


def params_to_numpy(params: dict) -> dict:
    """The port's parameters as the JAX package's tree: layers stacked
    ``[L, ...]``, every leaf a host numpy array, int8 weights as {"q": int8
    [in, out], "s": f32 [out]}, bf16 as HOST_BF16 bits."""
    def leaf_tree(node):
        if isinstance(node, dict):
            return {k: leaf_tree(v) for k, v in node.items()}
        return _host(node)

    out = {k: leaf_tree(v) for k, v in params.items() if k != "layers"}
    out["layers"] = _stack([leaf_tree(lp) for lp in params["layers"]])
    return out
