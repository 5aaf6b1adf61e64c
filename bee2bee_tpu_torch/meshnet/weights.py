"""Mesh weight distribution: DHT announce -> piece fetch -> serve.

The port of ``bee2bee_tpu/meshnet/weights.py``:

- A serving node **publishes**: its parameters in the canonical flat
  layout (layers stacked ``[L, ...]``, ``models/loader._flatten``) become
  content-addressed pieces (``pieces.build_shard_manifest``, each tensor
  above the frame budget split into shards), the blobs enter the node's
  piece store, and the manifest and one provider record per piece go onto
  the DHT, announced in batches.
- A joining peer **fetches**: the manifest from the DHT, then every piece
  from its providers over the mesh's binary piece frames
  (``node.request_piece``, sha256-verified on arrival and again in
  ``pieces.reassemble``), the shards concatenated, and builds a
  ``CUDAService`` on the card with zero local checkpoint. A piece no
  provider serves fails the join with its name.

The same manifest, keys and piece bytes as the JAX package, so a port
node joins from a JAX publisher and a JAX node from a port publisher.
Differences: only the whole-model fetch (``coords=None``) runs; a
coordinate fetch and a publish with ``mesh_axes`` are tensor-parallel
serving (ROADMAP.md queue A item 14). ``model`` may be a ``ModelConfig``
as well as a registry name, for a configuration the registry does not
hold (the manifest key is its ``name``); the fetched tree must have its
shapes (``params_from_numpy`` refuses another layer count).
"""

from __future__ import annotations

import asyncio
import logging

from ..unported import unported

logger = logging.getLogger("bee2bee_tpu_torch.weights")

FETCH_CONCURRENCY = 8


async def publish_model_weights(node, dht, model_cfg, params,
                                mesh_axes: dict[str, int] | None = None):
    """Piece ``params`` (the port's layout), seed the node's piece store,
    announce the manifest and the providers on the DHT. Returns the
    ShardManifest."""
    from ..models.loader import _flatten
    from ..pieces import build_shard_manifest

    if mesh_axes:
        raise unported(f"publishing weights sharded over mesh_axes={mesh_axes!r}", 14)
    loop = asyncio.get_running_loop()

    def build():
        flat = _flatten(params)
        return build_shard_manifest(model_cfg.name, flat, {k: () for k in flat}, {})

    manifest, blobs = await loop.run_in_executor(None, build)
    for digest, blob in blobs.items():
        node.piece_store[digest] = blob
    node.manifests[model_cfg.name] = manifest

    await dht.announce_manifest(model_cfg.name, manifest.to_json(), node.addr)
    # announces are independent: batch them instead of one DHT RTT per piece
    sem = asyncio.Semaphore(FETCH_CONCURRENCY)

    async def announce(piece):
        async with sem:
            await dht.announce_piece(
                piece.sha256,
                node.addr,
                mesh_axis=piece.mesh_axis,
                shard_index=piece.shard_index,
            )

    await asyncio.gather(*(announce(p) for p in manifest.pieces))
    logger.info(
        "published %s: %d pieces, %.1f MiB",
        model_cfg.name, len(manifest.pieces), manifest.total_bytes / 2**20,
    )
    return manifest


async def _peer_for_addr(node, addr: str) -> str | None:
    """Resolve a DHT provider addr to a connected peer_id (dialing it if
    new). Per-(node, addr) lock: concurrent piece fetches must not open N
    parallel sockets to the same provider — the peer table only dedups
    after the hello round-trip."""
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


async def fetch_model_from_mesh(node, dht, model, coords: dict[str, int] | None = None,
                                stats: dict | None = None):
    """Fetch the manifest and every piece from mesh providers and rebuild
    the whole flat tree. Returns (model_cfg, flat {path: np.ndarray}),
    hash-verified. ``stats`` gets the seconds of the fetch and of the
    verify + assemble step, and the bytes."""
    import time

    from ..models.config import resolve_model_config
    from ..pieces import ShardManifest, reassemble

    if coords is not None:
        raise unported(f"fetching the pieces of mesh coordinates {coords!r}", 14)
    cfg = resolve_model_config(model)
    t0 = time.perf_counter()
    rec = await dht.get_manifest(cfg.name)
    if rec is None:
        raise RuntimeError(f"no manifest on the DHT for model {cfg.name!r}")
    manifest = ShardManifest.from_json(rec["manifest"])

    sem = asyncio.Semaphore(FETCH_CONCURRENCY)
    blobs: dict[str, bytes] = {}

    async def fetch(piece):
        local = node.get_piece(piece.sha256)
        if local is not None:
            blobs[piece.sha256] = local
            return
        providers = await dht.find_providers(piece.sha256, piece.shard_index)
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
                except Exception as e:  # noqa: BLE001 — try the next provider
                    last_err = e
        raise RuntimeError(
            f"no provider served piece {piece.sha256[:12]} for {piece.param}"
        ) from last_err

    results = await asyncio.gather(
        *(fetch(p) for p in manifest.pieces), return_exceptions=True
    )
    errors = [r for r in results if isinstance(r, BaseException)]
    if errors:  # every sibling has finished — no orphaned transfers
        raise errors[0]
    t1 = time.perf_counter()
    flat = await asyncio.get_running_loop().run_in_executor(
        None, reassemble, manifest, blobs)
    if stats is not None:
        stats.update(fetch_s=t1 - t0, assemble_s=time.perf_counter() - t1,
                     bytes=manifest.total_bytes, pieces=len(manifest.pieces))
    return cfg, flat


async def serve_model_from_mesh(node, dht, model, engine_config=None,
                                price_per_token: float = 0.0, device=None,
                                stats: dict | None = None):
    """The full join: fetch the pieces, build the engine on ``device``
    (None: the card) and its CUDAService, announce it. Integer payloads
    pass through, int8 scales stay f32, the rest take the engine's dtype
    (``params_from_numpy``'s rule)."""
    from ..device import resolve_device
    from ..engine.engine import DTYPES, EngineConfig, InferenceEngine
    from ..models.loader import _unflatten
    from ..models.params import params_from_numpy
    from ..services.cuda import CUDAService

    device = resolve_device(device)
    cfg, flat = await fetch_model_from_mesh(node, dht, model, stats=stats)
    engine_config = engine_config or EngineConfig()

    def build_engine():
        params = params_from_numpy(_unflatten(flat), cfg, device,
                                   DTYPES[engine_config.dtype])
        return InferenceEngine(cfg, params, engine_config=engine_config, device=device)

    engine = await asyncio.get_running_loop().run_in_executor(None, build_engine)
    svc = CUDAService(cfg.name, price_per_token=price_per_token, engine=engine,
                      device=engine.device)
    await node.announce_service(svc)
    return svc
