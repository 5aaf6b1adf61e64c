"""Checkpoint loading for the PyTorch port: a local HF checkpoint or a
native piece checkpoint into the port's parameters (models/params.py).

The port of ``bee2bee_tpu/models/loader.py``. Everything is offline: a
path must exist locally, nothing downloads. What it keeps and what
differs:

- ``_read_safetensors``: the same minimal reader (header JSON, then one
  seek and read per tensor, so host memory grows one tensor at a time),
  into torch tensors. BF16 goes straight into ``torch.bfloat16`` from its
  16-bit pattern with no f32 widening: the values equal JAX's widened ones
  bit for bit, at half the host memory.
- ``_load_hf_state`` reads sharded ``*.safetensors``, else
  ``pytorch_model*.bin`` through ``torch.load(weights_only=True)``; the
  tensors keep their stored dtype.
- ``_convert_llama``, ``_convert_phi3``, ``_convert_gpt2`` (Conv1D,
  already [in, out]) and ``_convert_bigcode`` (nn.Linear; multi-query or
  per-head packed c_attn) map HF names into the port's layout (layers as
  a list of per-layer dicts). Every other family's converter raises by
  name (ROADMAP.md queue A item 11) and never computes something else; so
  do llama-branch tensors the port's core has no slot for (biased norms;
  experts under a config without them). qwen2's q/k/v biases and the q/k
  norms of qwen3 and gemma-3 load by key presence, as in JAX; with
  ``cfg.post_norms`` (gemma-2/3) the four norms take gemma-2's names, and
  gemma's (1 + w) norms are folded to w + 1 in f32. A mixture-of-experts
  config loads mixtral's (``block_sparse_moe.gate``, ``experts.N.w1`` /
  ``w3`` / ``w2``) or qwen3_moe's (``mlp.gate``, ``mlp.experts.N.gate_proj``
  / ``up_proj`` / ``down_proj``) tensors into the layer's ``moe`` tree, as
  JAX's loader does: the router [D, E] and each stack [E, in, out], the
  experts' transposed views stacked on the host (one copy of each stack).
- **Where the transpose runs.** HF linear weights are ``[out, in]``, the
  port's ``[in, out]``. The converters return transposed *views*;
  ``to_device`` uploads each tensor as it lies (its strides kept, one
  host-to-device copy of the stored bytes), casts it on the device and
  makes it contiguous there: on the card the transpose is a device copy
  (about 2 x 16 GB of HBM traffic for llama-3-8b in bf16, some
  milliseconds), and the host never copies a weight.
- ``load_checkpoint(host=True)`` keeps those views on the host, for an
  int8 engine: ``to_device(quantize=True)`` then uploads and quantizes
  tensor by tensor, so the dense model never sits on the device whole.
- ``save_native`` / ``load_native`` write and read the JAX package's
  native format (``bee2bee_manifest.json``, ``model_config.json`` and
  content-addressed ``pieces/``); the port's manifest splits tensors above
  the frame budget (pieces.py), which the JAX reader concatenates.
  ``mesh_axes`` other than empty raise (item 14).
- ``_flatten`` / ``_unflatten`` go between the port's parameters and the
  canonical flat layout, ``{"layers/attn/wq": [L, ...]}``: the layers
  stacked, the manifest's and the JAX package's layout
  (``params.params_to_numpy``).
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from ..device import resolve_device
from ..unported import unported
from .config import ModelConfig, config_for_checkpoint
from .params import params_from_numpy, params_to_numpy
from .quant import QUANT_SUFFIXES, quantize_weight_torch

_ST_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def _read_safetensors(path: Path) -> dict[str, torch.Tensor]:
    """Minimal safetensors reader (header JSON + raw buffers) into CPU
    tensors of the stored dtype; no safetensors package needed."""
    out = {}
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n).decode("utf-8"))
        base = 8 + n
        for name, spec in header.items():
            if name == "__metadata__":
                continue
            dtype = _ST_DTYPES.get(spec["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: tensor {name!r} has dtype {spec['dtype']!r}, "
                                 f"which the reader does not take")
            start, end = spec["data_offsets"]
            if end == start:
                out[name] = torch.empty(spec["shape"], dtype=dtype)
                continue
            f.seek(base + start)
            buf = bytearray(end - start)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: tensor {name!r} is truncated")
            out[name] = torch.frombuffer(buf, dtype=dtype).reshape(spec["shape"])
    return out


def _load_hf_state(path: Path) -> dict[str, torch.Tensor]:
    state: dict[str, torch.Tensor] = {}
    st_files = sorted(path.glob("*.safetensors"))
    if st_files:
        for f in st_files:
            state.update(_read_safetensors(f))
        return state
    bins = sorted(path.glob("pytorch_model*.bin"))
    if bins:
        for f in bins:
            state.update(torch.load(f, map_location="cpu", weights_only=True))
        return state
    raise FileNotFoundError(f"no safetensors or pytorch_model.bin under {path}")


def _convert_phi3(state, cfg: ModelConfig) -> dict:
    """HF Phi-3 names -> the port's layout. Architecturally phi-3 is a
    llama-style model; only the packing differs: qkv_proj fuses [q | k | v]
    on the out dim and gate_up_proj fuses [gate | up]. Un-fuse (views)
    into llama key names and delegate to _convert_llama."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    F = cfg.d_ff
    unfused: dict[str, torch.Tensor] = {}
    for k, v in state.items():
        if k.endswith(".self_attn.qkv_proj.weight"):
            base = k.replace("qkv_proj", "{}")
            unfused[base.format("q_proj")] = v[: H * hd]
            unfused[base.format("k_proj")] = v[H * hd: (H + K) * hd]
            unfused[base.format("v_proj")] = v[(H + K) * hd:]
        elif k.endswith(".mlp.gate_up_proj.weight"):
            unfused[k.replace("gate_up_proj", "gate_proj")] = v[:F]
            unfused[k.replace("gate_up_proj", "up_proj")] = v[F:]
        else:
            unfused[k] = v
    return _convert_llama(unfused, cfg)


# llama-branch tensors the port's core has no slot for: the JAX converter
# loads them (biased norms)
_NO_SLOT = ("input_layernorm.bias",)
# the expert tensors of the two MoE families (only an MoE config has a slot)
_EXPERT_KEYS = ("block_sparse_moe.", "mlp.experts.", "mlp.gate.weight")

# HF norm names -> the port's, in the gemma-2/3 layout (cfg.post_norms):
# post_attention_layernorm is the attention OUTPUT's norm there, and the
# pre-MLP norm is pre_feedforward_layernorm
_POST_NORM_NAMES = (("ln1", "input_layernorm"), ("ln1_post", "post_attention_layernorm"),
                    ("ln2", "pre_feedforward_layernorm"),
                    ("ln2_post", "post_feedforward_layernorm"))
_NORM_NAMES = (("ln1", "input_layernorm"), ("ln2", "post_attention_layernorm"))


def _convert_llama(state, cfg: ModelConfig) -> dict:
    """HF Llama/Mistral/Qwen2/Qwen3/Gemma/Gemma2/Gemma3 names -> the port's
    layout. Weights come back as transposed views ([out, in] -> [in,
    out]); ``to_device`` makes them contiguous on the device. q/k/v biases
    and q/k norms are loaded where the checkpoint has them (JAX
    ``loader.py`` keys on layer 0's, as here); the block norms take the
    gemma-2 names with ``cfg.post_norms`` (``_POST_NORM_NAMES``)."""
    pre = "model." if any(k.startswith("model.") for k in state) else ""
    for k in state:
        if any(s in k for s in _NO_SLOT):
            raise unported(f"{cfg.name}: checkpoint tensor {k!r} (a llama-branch "
                           f"family beside plain llama)", 11)
        if not cfg.is_moe and any(s in k for s in _EXPERT_KEYS):
            raise ValueError(f"{cfg.name}: checkpoint tensor {k!r} is an expert's, and "
                             f"the config has no experts")
    # gemma stores rmsnorm weights as (1 + w): the +1 folds in here, in f32
    norm_off = 1.0 if cfg.norm_plus_one else 0.0
    raw = lambda k: state[pre + k]
    norm = lambda k: raw(k).float() + norm_off if norm_off else raw(k)
    t = lambda k: raw(k).t()
    names = _POST_NORM_NAMES if cfg.post_norms else _NORM_NAMES
    layers = [
        {
            **{ours: {"scale": norm(f"layers.{i}.{hf}.weight")} for ours, hf in names},
            "attn": {
                "wq": t(f"layers.{i}.self_attn.q_proj.weight"),
                "wk": t(f"layers.{i}.self_attn.k_proj.weight"),
                "wv": t(f"layers.{i}.self_attn.v_proj.weight"),
                "wo": t(f"layers.{i}.self_attn.o_proj.weight"),
            },
            **({"moe": _moe_layer(pre, state, cfg, i)} if cfg.is_moe else {"mlp": {
                "w_up": t(f"layers.{i}.mlp.up_proj.weight"),
                "w_down": t(f"layers.{i}.mlp.down_proj.weight"),
                "w_gate": t(f"layers.{i}.mlp.gate_proj.weight"),
            }}),
        }
        for i in range(cfg.n_layers)
    ]
    if pre + "layers.0.self_attn.q_proj.bias" in state:  # qwen2: q/k/v-only bias
        for i, lp in enumerate(layers):
            for ours, theirs in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
                lp["attn"][ours] = raw(f"layers.{i}.self_attn.{theirs}.bias")
    if pre + "layers.0.self_attn.q_norm.weight" in state:  # qwen3 / gemma-3
        # gemma-3's q/k norms are zero-centred like its other norms: the +1
        # folds here too (qwen3: norm_off is 0)
        for i, lp in enumerate(layers):
            for key in ("q_norm", "k_norm"):
                lp["attn"][key] = norm(f"layers.{i}.self_attn.{key}.weight")
    params = {"tok_embed": raw("embed_tokens.weight"), "layers": layers,
              "final_norm": {"scale": norm("norm.weight")}}
    if not cfg.tie_embeddings:
        lm = state.get("lm_head.weight")
        params["lm_head"] = (lm if lm is not None else raw("embed_tokens.weight")).t()
    return params


def _moe_layer(pre: str, state, cfg: ModelConfig, i: int) -> dict:
    """Layer ``i``'s ``moe`` tree from mixtral's or qwen3_moe's names (JAX
    ``loader.py``: mixtral's w1 / w3 / w2 are gate / up / down): the router
    as a transposed view, each expert stack [E, in, out] stacked on the
    host from the experts' transposed views."""
    if f"{pre}layers.0.block_sparse_moe.gate.weight" in state:
        base, router, names = "block_sparse_moe", "block_sparse_moe.gate", ("w1", "w3", "w2")
    else:
        base, router, names = "mlp", "mlp.gate", ("gate_proj", "up_proj", "down_proj")
    t = lambda k: state[pre + k].t()  # noqa: E731

    def stack(w):
        return torch.stack([t(f"layers.{i}.{base}.experts.{e}.{w}.weight")
                            for e in range(cfg.n_experts)])

    gate, up, down = names
    return {"router": t(f"layers.{i}.{router}.weight"), "w_up": stack(up),
            "w_down": stack(down), "w_gate": stack(gate)}


def _gpt2_common(g, cfg: ModelConfig, layer_attn, t) -> dict:
    """The parts gpt2 and gpt-bigcode share: the norms, c_proj and the MLP
    by their HF names (``t`` maps a stored weight to [in, out]), with
    ``layer_attn(i)`` giving layer i's {wq, wk, wv, bq, bk, bv}."""
    layers = []
    for i in range(cfg.n_layers):
        h = f"h.{i}."
        attn = layer_attn(i)
        attn.update(wo=t(g(h + "attn.c_proj.weight")), bo=g(h + "attn.c_proj.bias"))
        layers.append({
            "ln1": {"scale": g(h + "ln_1.weight"), "bias": g(h + "ln_1.bias")},
            "attn": attn,
            "ln2": {"scale": g(h + "ln_2.weight"), "bias": g(h + "ln_2.bias")},
            "mlp": {"w_up": t(g(h + "mlp.c_fc.weight")), "b_up": g(h + "mlp.c_fc.bias"),
                    "w_down": t(g(h + "mlp.c_proj.weight")),
                    "b_down": g(h + "mlp.c_proj.bias")},
        })
    return {"tok_embed": g("wte.weight"), "pos_embed": g("wpe.weight"), "layers": layers,
            "final_norm": {"scale": g("ln_f.weight"), "bias": g("ln_f.bias")}}


def _gpt2_getter(state):
    pre = "transformer." if any(k.startswith("transformer.") for k in state) else ""
    return lambda k: state[pre + k]


def _convert_gpt2(state, cfg: ModelConfig) -> dict:
    """HF GPT-2 names -> the port's layout. Conv1D stores [in, out]
    already: c_attn [D, 3D] splits into q, k, v by thirds of its out dim
    (views, no copy)."""
    g = _gpt2_getter(state)
    D = cfg.d_model

    def layer_attn(i):
        w, b = g(f"h.{i}.attn.c_attn.weight"), g(f"h.{i}.attn.c_attn.bias")
        return {"wq": w[:, :D], "wk": w[:, D:2 * D], "wv": w[:, 2 * D:],
                "bq": b[:D], "bk": b[D:2 * D], "bv": b[2 * D:]}

    return _gpt2_common(g, cfg, layer_attn, lambda a: a)


def _convert_bigcode(state, cfg: ModelConfig) -> dict:
    """HF GPT-BigCode (starcoder, santacoder) names -> the port's layout:
    gpt2's names over nn.Linear [out, in] weights. c_attn packs [D +
    2·kv] on its out dim: with ``multi_query`` the query block, then one k
    head, then one v head; with ``multi_query=False`` q/k/v per head (HF's
    ``view(H, 3·hd)``), which a split into thirds would scramble."""
    g = _gpt2_getter(state)
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    kv = cfg.n_kv_heads * hd

    def layer_attn(i):
        w, b = g(f"h.{i}.attn.c_attn.weight"), g(f"h.{i}.attn.c_attn.bias")
        if cfg.n_kv_heads == H:
            wr, br = w.reshape(H, 3, hd, D), b.reshape(H, 3, hd)
            parts = [(wr[:, j].reshape(H * hd, D).t(), br[:, j].reshape(H * hd))
                     for j in range(3)]
        else:
            parts = [(w[:D].t(), b[:D]), (w[D:D + kv].t(), b[D:D + kv]),
                     (w[D + kv:].t(), b[D + kv:])]
        (wq, bq), (wk, bk), (wv, bv) = parts
        return {"wq": wq, "wk": wk, "wv": wv, "bq": bq, "bk": bk, "bv": bv}

    out = _gpt2_common(g, cfg, layer_attn, lambda a: a.t())
    if not cfg.tie_embeddings:
        lm = state.get("lm_head.weight")
        out["lm_head"] = (lm if lm is not None else g("wte.weight")).t()
    return out


def _is_bigcode(state, cfg: ModelConfig) -> bool:
    """A ``.c_attn.`` checkpoint is gpt-bigcode where the config is MQA/GQA
    or the first c_attn weight is not Conv1D's [D, 3D] (the JAX loader's
    test)."""
    w0 = next(v for k, v in state.items() if k.endswith("attn.c_attn.weight"))
    return cfg.n_kv_heads != cfg.n_heads or w0.shape[0] != cfg.d_model


# the JAX loader's detection order (loader.load_checkpoint): the key that
# names each family's layout, and the family
_FAMILIES = (
    (".c_attn.", "gpt2 / gpt-bigcode"),
    (".mlp.fc1.", "phi"),
    ("word_embeddings_layernorm", "bloom"),
    (".attn.Wqkv.", "mpt"),
    (".self_attention.query_key_value.", "falcon"),
    (".attention.query_key_value.", "gpt-neox"),
    (".self_attn.qkv_proj.", "phi3"),
    (".mlp.fc_in.", "gpt-j"),
)


def _cast_rule(key: str, t: torch.Tensor, dtype) -> torch.dtype:
    """Integer payloads pass through, int8 scales ``s`` stay f32, the rest
    take ``dtype``."""
    if not t.is_floating_point():
        return t.dtype
    return torch.float32 if key == "s" else dtype


def to_device(params: dict, device, dtype=torch.bfloat16, quantize: bool = False,
              stats: dict | None = None) -> dict:
    """Upload a host parameter tree tensor by tensor: each one as it lies
    (a transposed view keeps its strides), cast on the device
    (``_cast_rule``), made contiguous there. With ``quantize`` each
    QUANT_SUFFIXES weight is quantized and packed for the int8-weight GEMM
    as soon as it lands, so the device holds one dense weight beside the
    int8 ones. The top-level tensors (embeddings, head) go first, so the
    largest transpose runs on an almost empty device. ``stats`` (a dict)
    gets the seconds of the copies and of the device work."""
    device = resolve_device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    clock = {"h2d_s": 0.0, "device_s": 0.0, "bytes": 0}

    def up(key, t, path):
        t0 = time.perf_counter()
        d = t.to(device)
        if stats is not None:
            sync()
        t1 = time.perf_counter()
        d = d.to(_cast_rule(key, d, dtype)).contiguous()
        if quantize and path.endswith(QUANT_SUFFIXES):
            d = quantize_weight_torch(d)
        if stats is not None:
            sync()
        clock["h2d_s"] += t1 - t0
        clock["device_s"] += time.perf_counter() - t1
        clock["bytes"] += t.numel() * t.element_size()
        return d

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        return up(path.rsplit("/", 1)[-1], node, path)

    out = {k: None for k in params}
    for k, v in params.items():
        if k != "layers":
            out[k] = walk(v, k)
    out["layers"] = [walk(lp, "layers") for lp in params["layers"]]
    if stats is not None:
        stats.update(clock)
    return out


def load_checkpoint(path, cfg: ModelConfig, dtype=torch.bfloat16, device=None,
                    host: bool = False, stats: dict | None = None) -> dict:
    """Load a LOCAL checkpoint directory into the port's parameters on
    ``device`` (None: the card) in ``dtype``.

    Accepts a dir with *.safetensors / pytorch_model*.bin (HF layout) or a
    dir written by ``save_native``. ``host=True`` returns the host tree
    unconverted (views of the read tensors, their stored dtype) for
    ``to_device``. ``stats`` gets ``read_s`` and ``to_device``'s fields."""
    path = Path(path)
    if (path / "bee2bee_manifest.json").exists():
        return load_native(path, cfg, dtype=dtype, device=device, host=host,
                           stats=stats)
    t0 = time.perf_counter()
    state = _load_hf_state(path)
    if stats is not None:
        stats["read_s"] = time.perf_counter() - t0
    family = next((f for key, f in _FAMILIES if any(key in k for k in state)), None)
    if family == "phi3":
        params = _convert_phi3(state, cfg)
    elif family == "gpt2 / gpt-bigcode":
        params = (_convert_bigcode if _is_bigcode(state, cfg) else _convert_gpt2)(state, cfg)
    elif family is not None:
        raise unported(f"loading a {family} checkpoint ({path})", 11)
    else:
        params = _convert_llama(state, cfg)
    if host:
        return params
    return to_device(params, device, dtype, stats=stats)


# ---- native format: content-addressed pieces + manifest ---------------------


def save_native(params, cfg: ModelConfig, path, mesh_axes: dict[str, int] | None = None):
    """Write ``params`` in the native format: the flat layout's pieces
    (split to the frame budget), the manifest and the config."""
    from ..pieces import build_shard_manifest, save_pieces

    if mesh_axes:
        raise unported(f"save_native with mesh_axes={mesh_axes!r}", 14)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    flat = _flatten(params)
    manifest, blobs = build_shard_manifest(cfg.name, flat, {k: () for k in flat}, {})
    save_pieces(list(blobs.values()), path / "pieces")
    (path / "bee2bee_manifest.json").write_text(manifest.to_json())
    (path / "model_config.json").write_text(json.dumps(cfg.__dict__, default=str))
    return manifest


def load_native(path, cfg: ModelConfig | None = None, dtype=torch.bfloat16,
                device=None, host: bool = False, stats: dict | None = None) -> dict:
    """Read a native checkpoint (the port's or the JAX package's): every
    piece hash-verified, split tensors concatenated; ``cfg`` defaults to
    the checkpoint's own ``model_config.json``."""
    from ..pieces import ShardManifest, reassemble

    path = Path(path)
    t0 = time.perf_counter()
    manifest = ShardManifest.from_json((path / "bee2bee_manifest.json").read_text())
    blobs = {p.sha256: (path / "pieces" / p.sha256).read_bytes() for p in manifest.pieces}
    cfg = cfg or config_for_checkpoint(path)
    params = params_from_numpy(_unflatten(reassemble(manifest, blobs)), cfg, "cpu", None)
    if stats is not None:
        stats["read_s"] = time.perf_counter() - t0
    if host:
        return params
    return to_device(params, device, dtype, stats=stats)


def _flatten(params, prefix="") -> dict:
    """{"a/b/c": array} of a tree; the port's parameters (layers as a list)
    go through ``params_to_numpy`` first, so the layers come out stacked."""
    if isinstance(params.get("layers"), list):
        params = params_to_numpy(params)
    out = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out
