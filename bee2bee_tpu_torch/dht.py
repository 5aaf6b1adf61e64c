"""DHT: key-value store + piece-provider announce/lookup.

Capability parity with reference dht (bee2bee/dht.py:6-64):
Kademlia-backed when the optional `kademlia` package is importable, in-memory
fallback otherwise. Provider records carry mesh-coordinate metadata so piece
lookup can prefer a provider that holds the exact shard for a requester's
mesh position (TPU-native extension; see pieces.ShardManifest).

PyTorch port: a copy of ``bee2bee_tpu/dht.py`` with the import root rewritten to
``bee2bee_tpu_torch``; comments that cited the JAX package's change history or the
reference checkout's path are trimmed.
"""

from __future__ import annotations

import json
import time
from typing import Any


class InMemoryDHT:
    """Single-process fallback store (reference dht.py:6-13)."""

    def __init__(self):
        self._store: dict[str, Any] = {}

    async def set(self, key: str, value: Any) -> None:
        self._store[key] = value

    async def get(self, key: str) -> Any:
        return self._store.get(key)

    def stop(self) -> None:
        self._store.clear()


class DHTNode:
    """DHT facade with graceful fallback (reference dht.py:17-64)."""

    def __init__(self, port: int = 8468):
        self.port = port
        self.server: Any = None
        self.fallback: InMemoryDHT | None = None
        self.started = False

    async def start(self, bootstrap: list[tuple[str, int]] | None = None) -> None:
        try:
            from kademlia.network import Server  # optional dep

            self.server = Server()
            await self.server.listen(self.port)
            if bootstrap:
                await self.server.bootstrap(bootstrap)
        except Exception:
            self.server = None
            self.fallback = InMemoryDHT()
        self.started = True

    async def stop(self) -> None:
        if self.server is not None:
            try:
                self.server.stop()
            except Exception:
                pass
            self.server = None
        if self.fallback is not None:
            self.fallback.stop()
            self.fallback = None
        self.started = False

    async def set(self, key: str, value: Any) -> None:
        if not self.started:
            await self.start()
        if self.server is not None:
            await self.server.set(key, json.dumps(value))
        else:
            await self.fallback.set(key, value)

    async def get(self, key: str) -> Any:
        if not self.started:
            await self.start()
        if self.server is not None:
            raw = await self.server.get(key)
            return json.loads(raw) if raw is not None else None
        return await self.fallback.get(key)

    # -- piece providers (reference dht.py:53-64, extended with shard coords) --

    async def announce_piece(
        self,
        piece_hash: str,
        node_addr: str,
        mesh_axis: str | None = None,
        shard_index: int | None = None,
    ) -> None:
        key = f"piece:{piece_hash}"
        providers = await self.get(key) or []
        rec = {
            "addr": node_addr,
            "mesh_axis": mesh_axis,
            "shard_index": shard_index,
            "ts": time.time(),
        }
        providers = [p for p in providers if p.get("addr") != node_addr]
        providers.append(rec)
        await self.set(key, providers)

    async def find_providers(
        self, piece_hash: str, shard_index: int | None = None
    ) -> list[dict]:
        providers = await self.get(f"piece:{piece_hash}") or []
        if shard_index is not None:
            exact = [p for p in providers if p.get("shard_index") == shard_index]
            if exact:
                return exact
        return providers

    async def announce_manifest(self, model: str, manifest_json: str, node_addr: str) -> None:
        """Publish a ShardManifest under its model name so joining peers can
        discover the piece set for a serving group."""
        await self.set(f"manifest:{model}", {"manifest": manifest_json, "addr": node_addr})

    async def get_manifest(self, model: str) -> dict | None:
        return await self.get(f"manifest:{model}")
