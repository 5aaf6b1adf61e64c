"""Adapter paging over the mesh: publish/fetch LoRA factors as sha256-
verified pieces manifests on the DHT.

One ShardManifest per adapter (every tensor a replicated, content-
addressed piece), announced under the namespaced manifest key
``adapter/<base>/<name>``, pieces served over the mesh's binary piece
frames with per-piece sha256 verified before anything reaches a pool.
The LoraConfig rides as one extra JSON piece (``__lora_cfg__``), so a
fetching node can validate rank/targets (train/lora.
validate_adapter_shapes) BEFORE factors go near its AdapterPool.

The port of ``bee2bee_tpu/adapters/distrib.py``: the same keys, pieces
and config blob (hashlib only), so an adapter one package publishes the
other fetches. It keeps its own copy of the JAX ``meshnet/weights.py``
provider dial (``_peer_for_addr``).
"""

from __future__ import annotations

import asyncio
import json
import logging

import numpy as np

from ..pieces import ShardManifest, build_shard_manifest, piece_array
from ..train.lora import (
    AdapterLoadError,
    LoraConfig,
    _flatten,
    _unflatten,
    validate_adapter_shapes,
)
from ..utils import sha256_hex

logger = logging.getLogger("bee2bee_tpu_torch.adapters")

_CFG_PIECE = "__lora_cfg__"
FETCH_CONCURRENCY = 8


def adapter_key(base_model: str, name: str) -> str:
    """The DHT manifest key for one adapter. '/' never appears in model
    or adapter names (clamp_adapter_name), so keys cannot alias."""
    return f"adapter/{base_model}/{name}"


def _cfg_blob(lcfg: LoraConfig) -> bytes:
    return json.dumps(
        {"rank": lcfg.rank, "alpha": lcfg.alpha, "targets": list(lcfg.targets)},
        separators=(",", ":"),
    ).encode("utf-8")


def _cfg_from_blob(blob: bytes) -> LoraConfig:
    try:
        obj = json.loads(blob.decode("utf-8"))
        return LoraConfig(
            rank=int(obj["rank"]), alpha=float(obj["alpha"]),
            targets=tuple(obj["targets"]),
        )
    except Exception as e:  # noqa: BLE001 — malformed publisher blob
        raise AdapterLoadError(f"malformed adapter config piece: {e}") from e


async def _peer_for_addr(node, addr: str) -> str | None:
    """Resolve a DHT provider addr to a connected peer_id (dialing it if
    new). Per-(node, addr) lock: concurrent piece fetches must not open N
    parallel sockets to the same provider."""
    locks = node.__dict__.setdefault("_weights_dial_locks", {})
    lock = locks.setdefault(addr, asyncio.Lock())
    async with lock:
        for pid, info in node.peers.items():
            if info.get("addr") == addr:
                return pid
        if await node.connect_bootstrap(addr):
            for _ in range(100):
                for pid, info in node.peers.items():
                    if info.get("addr") == addr:
                        return pid
                await node.clock.sleep(0.05)
    return None


async def publish_adapter(node, dht, base_model: str, name: str,
                          adapters: dict, lcfg: LoraConfig):
    """Shard one adapter into content-addressed pieces, seed the node's
    piece store, and announce manifest + providers on the DHT. Returns
    the ShardManifest. Every FETCHING node validates before its pool."""
    key = adapter_key(base_model, name)
    flat = {k: np.asarray(v, np.float32) for k, v in _flatten(adapters).items()}
    flat[_CFG_PIECE] = np.frombuffer(_cfg_blob(lcfg), dtype=np.uint8)
    # every piece replicated (mesh_axes={}) and whole: rank-r factors never
    # shard, and the JAX adapter fetch reads one piece per tensor
    manifest, blobs = build_shard_manifest(key, flat, {k: () for k in flat}, {},
                                           split_to_frame=False)
    for digest, blob in blobs.items():
        node.piece_store[digest] = blob
    node.manifests[key] = manifest
    await dht.announce_manifest(key, manifest.to_json(), node.addr)
    sem = asyncio.Semaphore(FETCH_CONCURRENCY)

    async def announce(piece):
        async with sem:
            await dht.announce_piece(piece.sha256, node.addr)

    await asyncio.gather(*(announce(p) for p in manifest.pieces))
    logger.info(
        "published adapter %s: %d pieces, %.2f MiB",
        key, len(manifest.pieces), manifest.total_bytes / 2**20,
    )
    return manifest


async def fetch_adapter(node, dht, base_model: str, name: str,
                        model_cfg=None) -> tuple[dict, LoraConfig]:
    """Fetch one adapter's manifest + pieces from mesh providers; returns
    (adapters tree of numpy arrays, LoraConfig), hash-verified and — when
    ``model_cfg`` is given — shape-validated (typed AdapterLoadError
    otherwise)."""
    key = adapter_key(base_model, name)
    rec = await dht.get_manifest(key)
    if rec is None:
        raise UnknownAdapterManifest(f"no adapter manifest on the DHT for {key!r}")
    manifest = ShardManifest.from_json(rec["manifest"])

    sem = asyncio.Semaphore(FETCH_CONCURRENCY)
    blobs: dict[str, bytes] = {}

    async def fetch(piece):
        local = node.get_piece(piece.sha256)
        if local is not None:
            blobs[piece.sha256] = local
            return
        providers = await dht.find_providers(piece.sha256)
        addrs = [p["addr"] for p in providers] or [rec.get("addr")]
        last_err: Exception | None = None
        async with sem:
            for addr in addrs:
                if not addr:
                    continue
                try:
                    pid = await _peer_for_addr(node, addr)
                    if pid is None:
                        continue
                    blobs[piece.sha256] = await node.request_piece(pid, piece.sha256)
                    return
                except Exception as e:  # noqa: BLE001 — next provider
                    last_err = e
        raise RuntimeError(
            f"no provider served adapter piece {piece.sha256[:12]} for {piece.param}"
        ) from last_err

    results = await asyncio.gather(
        *(fetch(p) for p in manifest.pieces), return_exceptions=True
    )
    errors = [r for r in results if isinstance(r, BaseException)]
    if errors:
        raise errors[0]

    flat: dict[str, np.ndarray] = {}
    cfg_blob: bytes | None = None
    for p in manifest.pieces:
        data = blobs[p.sha256]
        if sha256_hex(data) != p.sha256:
            raise AdapterLoadError(
                f"adapter piece corrupt for {p.param} ({p.sha256[:12]})"
            )
        if p.param == _CFG_PIECE:
            cfg_blob = data
            continue
        flat[p.param] = piece_array(data, p)
    if cfg_blob is None:
        raise AdapterLoadError(f"adapter manifest {key!r} has no config piece")
    lcfg = _cfg_from_blob(cfg_blob)
    adapters = _unflatten(flat)
    if model_cfg is not None:
        validate_adapter_shapes(model_cfg, adapters, lcfg)
    return adapters, lcfg


class UnknownAdapterManifest(KeyError):
    """No manifest for the requested adapter anywhere on the DHT — the
    typed 'this adapter does not exist in the mesh' verdict (the serving
    path maps it to unknown_adapter / 404)."""

    def __str__(self):
        return self.args[0] if self.args else "unknown adapter manifest"
