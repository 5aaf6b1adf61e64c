"""LoRA adapters over the frozen base model: the half that serving uses.

The port of ``bee2bee_tpu/train/lora.py`` minus training: ``LoraConfig``,
the target map (``adapter_target_io``), the per-model and per-shape
validation (typed ``AdapterLoadError``), ``merge_lora`` (the serve-time
merge, W + scaling * A @ B) and the versioned ``.npz`` format
(``save_adapters`` / ``load_adapters``), byte-compatible with the JAX
package's, so one file serves both packages. ``LoraTrainer`` raises by
name (ROADMAP.md queue A item 15).

What differs: the port's parameters keep their layers as a list of
per-layer dicts (models/params.py), so ``merge_lora`` merges layer by
layer, each delta in f32 on the weight's own device; the adapters
themselves keep the JAX layout {target: {"a": [L, in, r], "b": [L, r,
out]}}, as numpy arrays or tensors.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch

from ..models.config import ModelConfig
from ..unported import unported
from ..utils import sha256_hex

# weights that can take an adapter: attention projections + MLP matmuls
ATTN_TARGETS = ("wq", "wk", "wv", "wo")
MLP_TARGETS = ("w_gate", "w_up", "w_down")


@dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    # alpha/rank scaling (the LoRA paper's convention: delta = alpha/r * AB)
    alpha: float = 16.0
    # which projections get adapters; q+v is the paper's sweet spot
    targets: tuple = ("wq", "wv")
    # init std of A (B is zero-init so training starts at the base model)
    init_std: float = 0.02

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank

    def __post_init__(self):
        bad = set(self.targets) - set(ATTN_TARGETS) - set(MLP_TARGETS)
        if bad:
            raise ValueError(
                f"unknown LoRA targets {sorted(bad)}; "
                f"known: {ATTN_TARGETS + MLP_TARGETS}"
            )
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")


def _group(target: str) -> str:
    return "attn" if target in ATTN_TARGETS else "mlp"


def validate_targets(cfg: ModelConfig, lcfg: LoraConfig) -> None:
    """Per-MODEL target check, run before any load: MoE models keep their
    MLP weights under an expert dim (unsupported for adapters), and
    non-gated MLPs have no w_gate."""
    mlp_t = [t for t in lcfg.targets if t in MLP_TARGETS]
    if cfg.is_moe and mlp_t:
        raise ValueError(
            f"LoRA MLP targets {mlp_t} unsupported on MoE model "
            f"{cfg.name!r} (expert weights are [L, E, ...]); use attention "
            f"targets {ATTN_TARGETS}"
        )
    if "w_gate" in lcfg.targets and cfg.activation not in ("silu", "geglu"):
        raise ValueError(
            f"target 'w_gate' does not exist on {cfg.name!r} "
            f"(activation={cfg.activation!r} is not gated)"
        )


def _as_f32(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


def merge_lora(base_params: dict, adapters: dict, lcfg: LoraConfig) -> dict:
    """Base params with each targeted weight replaced by W + s*(A@B): the
    delta in f32 on the weight's device, the sum cast back to the weight's
    type (the JAX serve-path merge, layer by layer). Returns a new dict
    whose untouched tensors are the base's own; a quantized base raises
    (merge before quantizing, as the engine does)."""
    params = dict(base_params)
    layers = [dict(lp) for lp in params["layers"]]
    for t, ab in adapters.items():
        g = _group(t)
        for i, lp in enumerate(layers):
            grp = lp[g] = dict(lp[g])
            w = grp[t]
            if isinstance(w, dict):
                raise ValueError(
                    f"merge_lora: layer {i} {g}/{t} is int8-quantized; merge "
                    "the adapter into the dense weights before quantizing"
                )
            a = _as_f32(ab["a"][i], w.device)
            b = _as_f32(ab["b"][i], w.device)
            delta = (a @ b) * lcfg.scaling
            grp[t] = (w.float() + delta).to(w.dtype)
    params["layers"] = layers
    return params


class LoraTrainer:
    """Adapter-only training over a frozen base: not ported."""

    def __init__(self, *args, **kwargs):
        raise unported("LoRA training (train/lora.py LoraTrainer)", 15)


class AdapterLoadError(ValueError):
    """Typed adapter load/validation failure: a corrupt file, a tampered
    tensor, or factors whose shapes don't match the declared LoraConfig.
    Raised host-side at load/validate time, so a bad adapter is a clean
    error to the one caller, never a shape crash inside a serving step."""


# adapter .npz layout version. v2 adds the per-tensor sha256 manifest
# (__meta_sha256, pieces.py discipline); v1 files (no version key) load
# without verification for backward compatibility.
ADAPTER_FORMAT_VERSION = 2


def adapter_target_io(cfg: ModelConfig) -> dict:
    """{target: (din, dout)} against the base layout: THE one copy of the
    per-target shape map, shared by shape validation and the serving
    pool's factor stacks (adapters/pool.py)."""
    D, H, Hkv, hd, F = (
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    )
    return {
        "wq": (D, H * hd), "wk": (D, Hkv * hd), "wv": (D, Hkv * hd),
        "wo": (H * hd, D),
        "w_gate": (D, F), "w_up": (D, F), "w_down": (F, D),
    }


def validate_adapter_shapes(cfg: ModelConfig, adapters, lcfg: LoraConfig,
                            max_rank: int | None = None) -> None:
    """Check every A/B factor against the base layout implied by `cfg` and
    the rank/targets `lcfg` declares. AdapterLoadError on any mismatch —
    the typed gate every consumer (engine merge, AdapterPool.load, mesh
    fetch) runs before factors go anywhere near the device."""
    try:
        validate_targets(cfg, lcfg)
    except ValueError as e:
        raise AdapterLoadError(str(e)) from e
    io = adapter_target_io(cfg)
    if set(adapters) != set(lcfg.targets):
        raise AdapterLoadError(
            f"adapter targets {sorted(adapters)} != declared "
            f"{sorted(lcfg.targets)}"
        )
    if max_rank is not None and lcfg.rank > max_rank:
        raise AdapterLoadError(
            f"adapter rank {lcfg.rank} exceeds pool rank {max_rank}"
        )
    for t, ab in adapters.items():
        din, dout = io[t]
        a_shape = tuple(getattr(ab.get("a"), "shape", ()))
        b_shape = tuple(getattr(ab.get("b"), "shape", ()))
        if a_shape != (cfg.n_layers, din, lcfg.rank):
            raise AdapterLoadError(
                f"adapter {t!r}: A shape {a_shape} != "
                f"{(cfg.n_layers, din, lcfg.rank)} for {cfg.name!r}"
            )
        if b_shape != (cfg.n_layers, lcfg.rank, dout):
            raise AdapterLoadError(
                f"adapter {t!r}: B shape {b_shape} != "
                f"{(cfg.n_layers, lcfg.rank, dout)} for {cfg.name!r}"
            )


def _flatten(tree, prefix="") -> dict[str, np.ndarray]:
    """{"a": {"b": x}} -> {"a/b": numpy x} (tensors come to the host)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def save_adapters(path, adapters, lora_cfg: LoraConfig) -> None:
    """One .npz with the adapter arrays + a versioned manifest: the
    LoraConfig needed to merge (rank/alpha/targets) and a per-tensor
    sha256 map, so load_adapters turns a corrupt or tampered file into a
    typed AdapterLoadError instead of garbage weights."""
    flat = _flatten(adapters)
    hashes = {
        k: sha256_hex(np.ascontiguousarray(v).tobytes()) for k, v in flat.items()
    }
    flat["__meta_version"] = np.int64(ADAPTER_FORMAT_VERSION)
    flat["__meta_rank"] = np.int64(lora_cfg.rank)
    flat["__meta_alpha"] = np.float64(lora_cfg.alpha)
    flat["__meta_targets"] = np.array(",".join(lora_cfg.targets))
    flat["__meta_sha256"] = np.array(json.dumps(hashes, separators=(",", ":")))
    np.savez(path, **flat)


def load_adapters(path, model_cfg: ModelConfig | None = None) -> tuple[dict, LoraConfig]:
    """Load + verify an adapter .npz (numpy arrays). v2 files carry a
    per-tensor sha256 manifest that is checked tensor by tensor; with
    ``model_cfg`` the factor shapes are validated against the base layout
    too. Any mismatch is a typed AdapterLoadError."""
    try:
        with np.load(path, allow_pickle=False) as z:
            files = set(z.files)
            missing = {"__meta_rank", "__meta_alpha", "__meta_targets"} - files
            if missing:
                raise AdapterLoadError(
                    f"{path}: not an adapter file (missing {sorted(missing)})"
                )
            lcfg = LoraConfig(
                rank=int(z["__meta_rank"]),
                alpha=float(z["__meta_alpha"]),
                targets=tuple(str(z["__meta_targets"]).split(",")),
            )
            flat = {k: z[k] for k in z.files if not k.startswith("__meta_")}
            version = int(z["__meta_version"]) if "__meta_version" in files else 1
            if version >= 2:
                hashes = json.loads(str(z["__meta_sha256"]))
                if set(hashes) != set(flat):
                    raise AdapterLoadError(
                        f"{path}: manifest names {sorted(hashes)} != "
                        f"tensors {sorted(flat)}"
                    )
                for k, arr in flat.items():
                    got = sha256_hex(np.ascontiguousarray(arr).tobytes())
                    if got != hashes[k]:
                        raise AdapterLoadError(
                            f"{path}: tensor {k!r} hash mismatch "
                            f"({got[:12]} != {hashes[k][:12]})"
                        )
    except AdapterLoadError:
        raise
    except ValueError as e:  # LoraConfig validation (bad rank/targets)
        raise AdapterLoadError(f"{path}: {e}") from e
    except Exception as e:  # zipfile/np.load corruption
        raise AdapterLoadError(f"{path}: unreadable adapter file: {e}") from e
    adapters = _unflatten(flat)
    if model_cfg is not None:
        validate_adapter_shapes(model_cfg, adapters, lcfg)
    return adapters, lcfg
