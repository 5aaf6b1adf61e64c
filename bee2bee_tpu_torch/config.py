"""Node configuration: dataclass defaults, JSON persistence, env precedence.

Capability parity with reference config (bee2bee/config.py:11-47):
persisted `~/.bee2bee_tpu/config.json`, env > file > defaults precedence
(reference config.py:35-42). Extended with TPU-specific knobs (mesh shape,
dtype, batch size) that the reference has no analogue for.

PyTorch port: a copy of ``bee2bee_tpu/config.py`` with the import root
rewritten to ``bee2bee_tpu_torch``; comments that cited the JAX package's
change history or the reference checkout's path are trimmed.
``NodeConfig.attention`` defaults to ``"auto"`` (the ragged kernels),
``engine_config()`` builds the port's ``EngineConfig`` (no ``paged`` field)
and refuses a mesh shape by name.
"""

from __future__ import annotations

import os
from dataclasses import asdict, dataclass, field, fields

from .unported import unported
from .utils import data_file, load_json, save_json

CONFIG_FILE = "config.json"

# env var name -> config field
_ENV_MAP = {
    "BEE2BEE_BOOTSTRAP": "bootstrap_url",
    "BEE2BEE_HOST": "host",
    "BEE2BEE_PORT": "port",
    "BEE2BEE_API_PORT": "api_port",
    "BEE2BEE_ANNOUNCE_HOST": "announce_host",
    "BEE2BEE_ANNOUNCE_PORT": "announce_port",
    "BEE2BEE_API_KEY": "api_key",
    "BEE2BEE_MESH_SHAPE": "mesh_shape",
    "BEE2BEE_DTYPE": "dtype",
    "BEE2BEE_MAX_BATCH": "max_batch_size",
    "BEE2BEE_ATTENTION": "attention",
    "BEE2BEE_PREFILL_CHUNK": "prefill_chunk",
    "BEE2BEE_PREFIX_CACHE": "prefix_cache_entries",
    "BEE2BEE_PAGED": "paged",
    "BEE2BEE_KV_BLOCK_SIZE": "kv_block_size",
    "BEE2BEE_KV_POOL_BLOCKS": "kv_pool_blocks",
    "BEE2BEE_KV_QUANT": "kv_quant",
    "BEE2BEE_SPEC": "spec_tokens",
    "BEE2BEE_DRAFTER": "drafter",
    "BEE2BEE_ADAPTERS": "adapters",
    "BEE2BEE_MAX_ADAPTERS": "max_adapters",
    "BEE2BEE_QUANTIZE": "quantize",
    "BEE2BEE_AUTO_NAT": "auto_nat",
    "BEE2BEE_DHT_PORT": "dht_port",
    "BEE2BEE_DHT_BOOTSTRAP": "dht_bootstrap",
}

_INT_FIELDS = {
    "port", "api_port", "announce_port", "max_batch_size", "max_seq_len",
    "dht_port", "prefill_chunk", "prefix_cache_entries", "kv_block_size",
    "kv_pool_blocks", "spec_tokens", "max_adapters",
}
_BOOL_FIELDS = {"auto_nat", "paged", "kv_quant"}


@dataclass
class NodeConfig:
    """Flat config for one mesh node (serving + networking + compute)."""

    # networking (reference config.py:11-17 defaults)
    bootstrap_url: str = "ws://127.0.0.1:4003"
    host: str = "0.0.0.0"
    port: int = 4003
    api_port: int = 4002
    announce_host: str | None = None
    announce_port: int | None = None
    api_key: str | None = None
    # NAT auto-forwarding on startup (reference p2p_runtime.py:204-261);
    # default off: datacenter TPU hosts don't need it, and it touches the
    # router. Enable via config or BEE2BEE_AUTO_NAT=1.
    auto_nat: bool = False
    # compute (TPU-native additions)
    mesh_shape: str = ""  # e.g. "data:1,model:8" — empty = all devices on model axis
    dtype: str = "bfloat16"
    # attention impl: auto | flash — both the ragged paged op (the CUDA
    # kernel on the card). The JAX package's dense and sp forms are not
    # ported (EngineConfig refuses them)
    attention: str = "auto"
    # chunked prefill size (0 = whole-prompt buckets); bounds dense
    # prefill score memory for long prompts (EngineConfig.prefill_chunk)
    prefill_chunk: int = 0
    # prompt prefix cache entries (0 = off): chat turns resend the whole
    # transcript; cached prompt K/V makes turn N+1 prefill only the delta
    prefix_cache_entries: int = 0
    # weight-only quantization: "none" | "int8" (halves decode HBM traffic)
    quantize: str = "none"
    # DEPRECATED no-op (kept so BEE2BEE_PAGED / stored configs parse):
    # the paged block pool is now the engine's only cache layout
    paged: bool = False
    kv_block_size: int = 16  # tokens per pool block (EngineConfig knob)
    # int8 KV pool: pages stored int8 with per-page-per-head scales,
    # dequantized inside the attention kernels — ~2x resident sessions
    # at fixed HBM (BEE2BEE_KV_QUANT / --kv-quant; bf16 pool default)
    kv_quant: bool = False
    # self-speculative decoding: draft up to this many tokens per step
    # by n-gram lookup over the request's own prompt+output and verify
    # them in one batched forward (BEE2BEE_SPEC / --spec; 0 = off —
    # EngineConfig.spec_tokens)
    spec_tokens: int = 0
    # model-tier speculative drafter (BEE2BEE_DRAFTER / --drafter):
    # "" = n-gram tier only; "mesh" = drafts stream from a draft-role
    # peer (BEE2BEE_DISAGG=draft); any other value = a registry model
    # name or checkpoint path loaded resident beside the target. On a
    # draft-role node this names the model the DraftServer hosts.
    # Requires spec_tokens > 0 (EngineConfig.drafter)
    drafter: str = ""
    # batched multi-LoRA serving (adapters/): comma-separated
    # name=path.npz adapters preloaded into the engine's hot-swap pool
    # AND published as pieces manifests on the DHT (BEE2BEE_ADAPTERS /
    # serve-tpu --adapters); empty = none preloaded
    adapters: str = ""
    # adapter pool slots (BEE2BEE_MAX_ADAPTERS): 0 = multi-adapter
    # serving off unless --adapters is given, which implies 8
    max_adapters: int = 0
    # total pool blocks; 0 = default sizing (exhaustion impossible). An
    # explicit smaller value trades HBM for admission backpressure
    # (EngineConfig.kv_pool_blocks)
    kv_pool_blocks: int = 0
    max_batch_size: int = 8  # continuous-batching rows (EngineConfig.max_batch)
    max_seq_len: int = 2048
    max_new_tokens: int = 2048  # reference default (services.py:28)
    price_per_token: float = 0.0
    # DHT for weight distribution (kademlia UDP when installed; reference
    # dht.py:25-38): listen port + comma-separated host:port bootstrap peers
    dht_port: int = 8468
    dht_bootstrap: str = ""
    extra: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return asdict(self)

    def engine_config(self):
        """The EngineConfig this node config implies — the ONE place the
        NodeConfig→engine knob mapping (and its 0-means-disabled sentinel
        for prefill_chunk) lives. The port's EngineConfig has no ``paged``
        field (the deprecated no-op is not passed), and a mesh shape has no
        engine to shard over yet."""
        from .engine.engine import EngineConfig

        if parse_mesh_shape(self.mesh_shape):
            raise unported(f"mesh_shape={self.mesh_shape!r} (a sharded engine)", 14)
        return EngineConfig(
            max_seq_len=self.max_seq_len,
            dtype=self.dtype,
            max_batch=self.max_batch_size,
            attention=self.attention,
            prefill_chunk=self.prefill_chunk or None,
            prefix_cache_entries=self.prefix_cache_entries,
            quantize=self.quantize,
            cache_dtype="int8" if self.kv_quant else "bfloat16",
            kv_block_size=self.kv_block_size,
            kv_pool_blocks=self.kv_pool_blocks or None,
            spec_tokens=self.spec_tokens,
            drafter=self.drafter,
            # --adapters implies a pool even when no slot count was set:
            # the operator clearly wants multi-adapter serving
            max_adapters=self.max_adapters or (8 if self.adapters else 0),
        )


def load_config() -> NodeConfig:
    """defaults <- config.json <- env (highest precedence)."""
    raw = load_json(data_file(CONFIG_FILE), default={}) or {}
    known = {f.name for f in fields(NodeConfig)}
    kwargs = {k: v for k, v in raw.items() if k in known}
    cfg = NodeConfig(**kwargs)
    for env_name, field_name in _ENV_MAP.items():
        val = os.environ.get(env_name)
        if val is not None and val != "":
            if field_name in _INT_FIELDS:
                try:
                    val = int(val)
                except ValueError:
                    continue
            elif field_name in _BOOL_FIELDS:
                val = val.lower() in ("1", "true", "yes", "on")
            setattr(cfg, field_name, val)
    return cfg


def save_config(cfg: NodeConfig) -> None:
    save_json(data_file(CONFIG_FILE), cfg.to_dict())


def get_bootstrap_url() -> str:
    return load_config().bootstrap_url


def set_bootstrap_url(url: str) -> None:
    cfg = load_config()
    cfg.bootstrap_url = url
    save_config(cfg)


def parse_mesh_shape(spec: str) -> dict[str, int]:
    """Parse "data:1,model:8" → {"data": 1, "model": 8}. Empty → {}."""
    out: dict[str, int] = {}
    if not spec:
        return out
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, n = part.partition(":")
        out[name.strip()] = int(n)
    return out
