"""Global registry client: node liveness/models/metrics upserts to a Supabase
REST `active_nodes` table, or a cluster entrypoint relay (reference
registry.py:10-69 + SUPABASE_SCHEMA.sql:66-76). Enabled iff env creds are
present; all failures are soft (the mesh works without a registry).

PyTorch port: a copy of ``bee2bee_tpu/registry.py`` with the import root rewritten to
``bee2bee_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time

logger = logging.getLogger("bee2bee_tpu_torch.registry")

SYNC_INTERVAL_S = 30.0


class RegistryClient:
    def __init__(
        self,
        supabase_url: str | None = None,
        supabase_key: str | None = None,
        entrypoint: str | None = None,
    ):
        self.supabase_url = supabase_url or os.environ.get("SUPABASE_URL") or os.environ.get(
            "VITE_SUPABASE_URL"
        )
        self.supabase_key = supabase_key or os.environ.get("SUPABASE_ANON_KEY") or os.environ.get(
            "VITE_SUPABASE_ANON_KEY"
        )
        self.entrypoint = entrypoint or os.environ.get("BEE2BEE_ENTRYPOINT")
        self.mode = (
            "supabase"
            if (self.supabase_url and self.supabase_key)
            else ("entrypoint" if self.entrypoint else None)
        )

    @property
    def enabled(self) -> bool:
        return self.mode is not None

    def _node_record(self, node) -> dict:
        models = []
        for svc in node.local_services.values():
            models.extend(svc.get_metadata().get("models", []))
        return {
            "node_id": node.peer_id,
            "address": node.addr,
            "region": node.region,
            "models": models,
            "metrics": node.status()["metrics"],
            "api_port": node.api_port,
            "last_seen": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        }

    async def sync_node(self, node) -> bool:
        """One upsert; returns success. Soft-fails on any network error."""
        if not self.enabled:
            return False
        import httpx

        record = self._node_record(node)
        try:
            async with httpx.AsyncClient(timeout=10) as client:
                if self.mode == "supabase":
                    r = await client.post(
                        f"{self.supabase_url.rstrip('/')}/rest/v1/active_nodes",
                        json=record,
                        headers={
                            "apikey": self.supabase_key,
                            "Authorization": f"Bearer {self.supabase_key}",
                            "Content-Type": "application/json",
                            # upsert-on-conflict (reference registry.py:62-66)
                            "Prefer": "resolution=merge-duplicates",
                        },
                    )
                else:
                    r = await client.post(
                        f"{self.entrypoint.rstrip('/')}/register", json=record
                    )
                return r.status_code < 300
        except Exception as e:
            logger.debug("registry sync failed: %s", e)
            return False

    async def fetch_nodes(self) -> list[dict]:
        """Read the global mesh (bridge.js syncGlobalMesh equivalent)."""
        if self.mode != "supabase":
            return []
        import httpx

        try:
            async with httpx.AsyncClient(timeout=10) as client:
                r = await client.get(
                    f"{self.supabase_url.rstrip('/')}/rest/v1/active_nodes",
                    params={"select": "*"},
                    headers={
                        "apikey": self.supabase_key,
                        "Authorization": f"Bearer {self.supabase_key}",
                    },
                )
                if r.status_code < 300:
                    return r.json()
        except Exception as e:
            logger.debug("registry fetch failed: %s", e)
        return []

    def _client(self):
        """Long-lived AsyncClient for per-request paths (record_message
        runs per generation — a fresh pool + TLS handshake each time would
        sit on the serving hot path). Lazy; closed via aclose()."""
        import httpx

        if getattr(self, "_http", None) is None or self._http.is_closed:
            self._http = httpx.AsyncClient(timeout=10)
        return self._http

    async def aclose(self):
        if getattr(self, "_http", None) is not None and not self._http.is_closed:
            await self._http.aclose()

    async def record_message(
        self,
        node_id: str,
        tokens: int,
        role: str = "assistant",
        cost: float = 0.0,
        user_id: str | None = None,
    ) -> bool:
        """Token + cost accounting insert into the `messages` table (the
        web gateway's per-generation accounting — reference index.js:65-86
        writes user_id/cost rows; cost here is the node-computed
        price_per_token x tokens from services/base.py result_dict)."""
        if self.mode != "supabase":
            return False
        try:
            row = {
                "node_id": node_id,
                "content": "[metric log]",
                "role": role,
                "tokens": int(tokens),
                "cost": float(cost or 0.0),
            }
            if user_id:
                row["user_id"] = user_id
            r = await self._client().post(
                f"{self.supabase_url.rstrip('/')}/rest/v1/messages",
                json=row,
                headers={
                    "apikey": self.supabase_key,
                    "Authorization": f"Bearer {self.supabase_key}",
                    "Content-Type": "application/json",
                },
            )
            return r.status_code < 300
        except Exception as e:
            logger.debug("registry message write failed: %s", e)
            return False

    async def sync_loop(self, node, interval_s: float = SYNC_INTERVAL_S):
        while True:
            await self.sync_node(node)
            await asyncio.sleep(interval_s)
