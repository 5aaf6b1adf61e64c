"""Checkpoint export for the PyTorch port: the port's parameters as an
HF-layout safetensors checkpoint with its ``config.json``.

The llama half of ``bee2bee_tpu/models/export.py``: ``write_safetensors``,
``_export_llama_state``, ``_export_gpt2_state``, ``_export_bigcode_state``,
the llama and mixture-of-experts branches of ``hf_config_dict`` (model
types ``llama`` and ``mistral``, with ``rope_scaling``; ``mixtral`` and
``qwen3_moe``) and ``export_hf``. The card's machine
has neither jax nor the ``safetensors`` package, so the smoke and the
round-trip tests write their checkpoints with these. Every other family raises by name (ROADMAP.md queue A item
15; their converters are item 11). Two additions: the tensors may be torch
tensors (bf16 is written from its 16-bit pattern, as the JAX writer
writes ml_dtypes arrays), and ``export_hf(max_shard_bytes=...)`` writes
HF's sharded layout (``model-0000i-of-0000n.safetensors`` and
``model.safetensors.index.json``), which the loader reads file by file.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..pieces import dtype_name
from ..unported import unported
from .config import ModelConfig
from .loader import _NORM_NAMES, _POST_NORM_NAMES
from .params import _host

_DTYPE_NAMES = {
    "float32": "F32",
    "float16": "F16",
    "bfloat16": "BF16",
    "int64": "I64",
    "int32": "I32",
    "uint8": "U8",
    "bool": "BOOL",
}
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _np(a) -> np.ndarray:
    """A host array of a tensor or array (bf16 as its 16-bit pattern)."""
    return _host(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _spec(a) -> tuple[str, list, int]:
    """(dtype name, shape, bytes) of a tensor or array, without a copy."""
    if isinstance(a, torch.Tensor):
        return str(a.dtype).removeprefix("torch."), list(a.shape), a.numel() * a.element_size()
    arr = np.asarray(a)
    return dtype_name(arr), list(arr.shape), arr.nbytes


def write_safetensors(path, tensors: dict, metadata: dict[str, str] | None = None) -> None:
    """Minimal safetensors writer (header JSON + raw buffers), the inverse
    of loader._read_safetensors. The header comes from the shapes first,
    then each tensor's bytes are written in turn: the host holds one
    tensor's copy at a time."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = metadata
    offset = 0
    for name, a in tensors.items():
        dname, shape, nbytes = _spec(a)
        dt = _DTYPE_NAMES.get(dname)
        if dt is None:
            raise ValueError(f"unsupported export dtype {dname} for {name!r}")
        header[name] = {"dtype": dt, "shape": shape,
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for a in tensors.values():
            f.write(np.ascontiguousarray(_np(a)).tobytes())


def _export_llama_state(params, cfg: ModelConfig, dtype) -> dict[str, torch.Tensor]:
    """Inverse of loader._convert_llama: [in, out] back to HF [out, in]
    (the transpose on the tensor's own device) and the gemma (1 + w) fold
    undone. qwen2's q/k/v biases, the q/k norms of qwen3 and gemma-3 and
    gemma-2/3's four block norms go out under their HF names (the
    converter's inverse); ``hf_config_dict`` still refuses those families
    (item 15), so ``export_hf`` writes none of them. An ``moe`` layer goes
    out under qwen3_moe's names where the layer has q/k norms, else
    mixtral's (JAX ``_export_llama_state``), one [out, in] tensor an
    expert."""
    off = 1.0 if cfg.norm_plus_one else 0.0
    t = lambda a: a.to(dtype).t().contiguous()
    norm = lambda a: (a.float() - off).to(dtype)
    state = {
        "model.embed_tokens.weight": params["tok_embed"].to(dtype),
        "model.norm.weight": norm(params["final_norm"]["scale"]),
    }
    if not cfg.tie_embeddings:
        state["lm_head.weight"] = t(params["lm_head"])
    names = _POST_NORM_NAMES if cfg.post_norms else _NORM_NAMES
    for i, lp in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        ffn = "moe" if cfg.is_moe else "mlp"
        if set(lp) != {"attn", ffn, *(ours for ours, _ in names)} or any(
                isinstance(w, dict) for w in (*lp["attn"].values(), *lp[ffn].values())):
            raise unported(f"exporting layer {i} of {cfg.name} with {sorted(lp)} "
                           f"(int8 or a family beside plain llama)", 15)
        for ours, hf in names:
            state[p + f"{hf}.weight"] = norm(lp[ours]["scale"])
        for ours, hf in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"), ("wo", "o_proj")):
            state[p + f"self_attn.{hf}.weight"] = t(lp["attn"][ours])
        for ours, hf in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            if ours in lp["attn"]:
                state[p + f"self_attn.{hf}.bias"] = lp["attn"][ours].to(dtype)
        for key in ("q_norm", "k_norm"):
            if key in lp["attn"]:
                state[p + f"self_attn.{key}.weight"] = norm(lp["attn"][key])
        if cfg.is_moe:
            state.update(_export_moe(p, lp["moe"], "q_norm" in lp["attn"], cfg, t))
            continue
        for ours, hf in (("w_gate", "gate_proj"), ("w_up", "up_proj"), ("w_down", "down_proj")):
            state[p + f"mlp.{hf}.weight"] = t(lp["mlp"][ours])
    return state


def _export_moe(p: str, moe: dict, qwen3: bool, cfg: ModelConfig, t) -> dict:
    """One layer's router and experts under qwen3_moe's names (``qwen3``)
    or mixtral's (w1 gate, w3 up, w2 down), in JAX's key order."""
    if qwen3:
        base, names = "mlp", (("w_gate", "gate_proj"), ("w_down", "down_proj"),
                              ("w_up", "up_proj"))
    else:
        base, names = "block_sparse_moe", (("w_gate", "w1"), ("w_down", "w2"), ("w_up", "w3"))
    out = {f"{p}{base}.gate.weight": t(moe["router"])}
    for e in range(cfg.n_experts):
        for ours, hf in names:
            out[f"{p}{base}.experts.{e}.{hf}.weight"] = t(moe[ours][e])
    return out


def _dense_layers(params, cfg: ModelConfig, keys: set) -> None:
    """Refuse (item 15) layers whose keys are not ``keys`` or that hold an
    int8 weight: the HF layouts are dense."""
    for i, lp in enumerate(params["layers"]):
        if set(lp) != keys or any(isinstance(w, dict) for w in (*lp["attn"].values(),
                                                                 *lp["mlp"].values())):
            raise unported(f"exporting layer {i} of {cfg.name} with {sorted(lp)} "
                           f"(int8 or another family)", 15)


def _export_gpt2_state(params, cfg: ModelConfig, dtype) -> dict[str, torch.Tensor]:
    """Inverse of loader._convert_gpt2 (JAX ``_export_gpt2_state``, key for
    key): Conv1D [in, out] as the port holds it, q/k/v re-fused into
    c_attn on the out dim, and ``lm_head.weight`` written beside the tied
    ``wte`` as transformers expects."""
    _dense_layers(params, cfg, {"ln1", "ln2", "attn", "mlp"})
    c = lambda a: a.to(dtype).contiguous()
    state = {
        "transformer.wte.weight": c(params["tok_embed"]),
        "transformer.wpe.weight": c(params["pos_embed"]),
        "transformer.ln_f.weight": c(params["final_norm"]["scale"]),
        "transformer.ln_f.bias": c(params["final_norm"]["bias"]),
        "lm_head.weight": c(params["tok_embed"]),
    }
    for i, lp in enumerate(params["layers"]):
        p = f"transformer.h.{i}."
        a, m = lp["attn"], lp["mlp"]
        state.update(_gpt2_norms(p, lp, c))
        state[p + "attn.c_attn.weight"] = c(torch.cat([a["wq"], a["wk"], a["wv"]], dim=1))
        state[p + "attn.c_attn.bias"] = c(torch.cat([a["bq"], a["bk"], a["bv"]]))
        state.update({p + "attn.c_proj.weight": c(a["wo"]), p + "attn.c_proj.bias": c(a["bo"]),
                      p + "mlp.c_fc.weight": c(m["w_up"]), p + "mlp.c_fc.bias": c(m["b_up"]),
                      p + "mlp.c_proj.weight": c(m["w_down"]),
                      p + "mlp.c_proj.bias": c(m["b_down"])})
    return state


def _gpt2_norms(prefix: str, lp: dict, c) -> dict:
    """A gpt2-block layer's two layernorms under their HF names."""
    return {f"{prefix}{hf}.{hf_key}": c(lp[ours][key])
            for ours, hf in (("ln1", "ln_1"), ("ln2", "ln_2"))
            for hf_key, key in (("weight", "scale"), ("bias", "bias"))}


def _export_bigcode_state(params, cfg: ModelConfig, dtype) -> dict[str, torch.Tensor]:
    """Inverse of loader._convert_bigcode: nn.Linear [out, in]; c_attn the
    query block, then k, then v on the out dim (multi_query, JAX
    ``_export_bigcode_state`` key for key and bit for bit), or packed per
    head as HF's ``view(H, 3·hd)`` reads it where every head has its own
    k/v (JAX writes thirds there, which its own loader reads per head)."""
    _dense_layers(params, cfg, {"ln1", "ln2", "attn", "mlp"})
    c = lambda a: a.to(dtype).contiguous()
    t = lambda a: a.to(dtype).t().contiguous()
    H, hd, D = cfg.n_heads, cfg.head_dim, cfg.d_model
    state = {
        "transformer.wte.weight": c(params["tok_embed"]),
        "transformer.wpe.weight": c(params["pos_embed"]),
        "transformer.ln_f.weight": c(params["final_norm"]["scale"]),
        "transformer.ln_f.bias": c(params["final_norm"]["bias"]),
        "lm_head.weight": c(params["tok_embed"]) if cfg.tie_embeddings
        else t(params["lm_head"]),
    }
    for i, lp in enumerate(params["layers"]):
        p = f"transformer.h.{i}."
        a, m = lp["attn"], lp["mlp"]
        state.update(_gpt2_norms(p, lp, c))
        ws = [t(a[k]) for k in ("wq", "wk", "wv")]
        bs = [c(a[k]) for k in ("bq", "bk", "bv")]
        if cfg.n_kv_heads == H:  # per head: [H, 3, hd] rows
            w = torch.stack([x.reshape(H, hd, D) for x in ws], 1).reshape(3 * H * hd, D)
            b = torch.stack([x.reshape(H, hd) for x in bs], 1).reshape(3 * H * hd)
        else:
            w, b = torch.cat(ws, dim=0), torch.cat(bs)
        state.update({p + "attn.c_attn.weight": w, p + "attn.c_attn.bias": b,
                      p + "attn.c_proj.weight": t(a["wo"]), p + "attn.c_proj.bias": c(a["bo"]),
                      p + "mlp.c_fc.weight": t(m["w_up"]), p + "mlp.c_fc.bias": c(m["b_up"]),
                      p + "mlp.c_proj.weight": t(m["w_down"]),
                      p + "mlp.c_proj.bias": c(m["b_down"])})
    return state


def hf_config_dict(cfg: ModelConfig) -> dict:
    """A transformers-compatible config.json: the llama branch of the JAX
    function (``llama``, or ``mistral`` with a sliding window) and its MoE
    branch (``qwen3_moe`` with q/k norms, else ``mixtral``), the same keys
    and the same ``rope_scaling`` dicts."""
    family = (
        "alibi" if cfg.pos_embedding == "alibi"
        else "learned-position" if cfg.pos_embedding == "learned"
        else "parallel-block" if cfg.parallel_block
        else "layernorm" if cfg.norm != "rmsnorm"
        else "partial-rotary" if cfg.rotary_pct < 1.0
        else "gemma" if cfg.norm_plus_one
        else "qwen3" if cfg.qk_norm and not cfg.is_moe
        else "qwen2" if cfg.qkv_bias
        else None
    )
    if family is not None:
        raise unported(f"exporting the {family} family ({cfg.name})", 15)
    base = {
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.d_model,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.d_ff,
        "max_position_embeddings": cfg.max_seq_len,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "head_dim": cfg.head_dim,
    }
    if cfg.sliding_window is not None:
        base["sliding_window"] = cfg.sliding_window
    if cfg.rope_scaling is not None:  # linear or llama3: the core runs no other
        if cfg.rope_scaling[0] == "linear":
            base["rope_scaling"] = {"rope_type": "linear",
                                    "factor": cfg.rope_scaling[1]}
        else:
            _, f, lo, hi, orig = cfg.rope_scaling
            base["rope_scaling"] = {
                "rope_type": "llama3", "factor": f,
                "low_freq_factor": lo, "high_freq_factor": hi,
                "original_max_position_embeddings": orig,
            }
    if cfg.is_moe and cfg.qk_norm:
        out = {"model_type": "qwen3_moe", "architectures": ["Qwen3MoeForCausalLM"],
               "num_experts": cfg.n_experts, "num_experts_per_tok": cfg.n_experts_per_tok,
               "moe_intermediate_size": cfg.d_ff,
               # the routing renormalises the top-k weights: transformers must too
               "norm_topk_prob": True, "decoder_sparse_step": 1, "mlp_only_layers": [],
               **base}
        if cfg.sliding_window is not None:
            out["use_sliding_window"] = True
        return out
    if cfg.is_moe:
        return {"model_type": "mixtral", "architectures": ["MixtralForCausalLM"],
                "num_local_experts": cfg.n_experts,
                "num_experts_per_tok": cfg.n_experts_per_tok, **base}
    if cfg.sliding_window is not None:
        return {"model_type": "mistral", "architectures": ["MistralForCausalLM"], **base}
    return {"model_type": "llama", "architectures": ["LlamaForCausalLM"], **base}


def export_hf(params, cfg: ModelConfig, out_dir, dtype: str = "float32",
              max_shard_bytes: int | None = None) -> Path:
    """Write ``out_dir/model.safetensors`` + ``config.json`` in the HF layout.
    With ``max_shard_bytes`` the tensors fill ``model-0000i-of-0000n.
    safetensors`` files in order, a new file before a tensor that would
    take one past the limit, and ``model.safetensors.index.json`` maps each
    tensor to its file. Round-trips through models/loader."""
    cfg_json = hf_config_dict(cfg)  # refuses other families before any work
    state = _export_llama_state(params, cfg, _TORCH_DTYPES[dtype])
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    meta = {"format": "pt", "exported_by": "bee2bee_tpu_torch"}
    shards: list[dict] = [{}]
    size = 0
    for name, t in state.items():
        nbytes = t.numel() * t.element_size()
        if max_shard_bytes and shards[-1] and size + nbytes > max_shard_bytes:
            shards.append({})
            size = 0
        shards[-1][name] = t
        size += nbytes
    if len(shards) == 1:
        write_safetensors(out / "model.safetensors", state, metadata=meta)
    else:
        n = len(shards)
        weight_map = {}
        for i, shard in enumerate(shards, 1):
            fname = f"model-{i:05d}-of-{n:05d}.safetensors"
            write_safetensors(out / fname, shard, metadata=meta)
            weight_map.update({name: fname for name in shard})
        total = sum(t.numel() * t.element_size() for t in state.values())
        (out / "model.safetensors.index.json").write_text(json.dumps(
            {"metadata": {"total_size": total}, "weight_map": weight_map}, indent=2))
    (out / "config.json").write_text(json.dumps(cfg_json, indent=2))
    return out
