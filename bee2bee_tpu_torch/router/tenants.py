"""Tenant identity and per-tenant serving policy: the part the engine
scheduler reads.

A copy of ``TenantSpec``, ``parse_tenant_config`` and
``load_tenant_config`` from ``bee2bee_tpu/router/tenants.py``, with the
``load_json_source`` of ``bee2bee_tpu/utils.py`` and the adapter-name
clamp of ``bee2bee_tpu/adapters/__init__.py`` they call (the port imports
nothing of the JAX package). The scheduler takes its WDRR weights from
this config, so the same ``BEE2BEE_TENANTS`` value weighs tenants alike
in both packages. API-key resolution (``TenantRegistry``) waits for the
node's gateway.

Config source: ``BEE2BEE_TENANTS`` (inline JSON object or a path to one),
validated loudly at load — a mis-typed tenant config must fail the engine
at construction, not silently rate-limit the wrong customer later.
Shape::

    {"acme":  {"api_key": "k-acme", "weight": 4,
               "rate_tokens_per_min": 60000},
     "hobby": {"api_key": "k-hobby", "weight": 1}}

Unconfigured identity clamps to the ``default`` tenant (weight 1, no
budget).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any

DEFAULT_TENANT = "default"
# adapter names key metric labels and DHT keys (the JAX package's
# adapters.MAX_ADAPTER_NAME)
MAX_ADAPTER_NAME = 64


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's identity + serving policy."""

    name: str
    api_key: str | None = None
    weight: float = 1.0
    # token budget: sustained refill rate (0 = unlimited) and burst size
    # (0 = one minute of sustained rate)
    rate_tokens_per_min: float = 0.0
    burst_tokens: float = 0.0
    # default LoRA adapter: a request from this tenant that names none
    # serves under this one. None = base.
    adapter: str | None = None

    @property
    def rate_tokens_per_s(self) -> float:
        return self.rate_tokens_per_min / 60.0

    @property
    def burst(self) -> float:
        return self.burst_tokens or self.rate_tokens_per_min


_ALLOWED_KEYS = frozenset(
    {"api_key", "weight", "rate_tokens_per_min", "burst_tokens", "adapter"}
)


def load_json_source(source: str | None, env_var: str, opener: str = "{") -> Any:
    """The inline-JSON-or-file-path config convention: `source` wins, else
    the env var; a value starting with `opener` parses inline, anything
    else is a path read and parsed. Returns None when no source is
    configured at all; parse/read errors raise."""
    raw = source if source is not None else os.environ.get(env_var)
    if not raw:
        return None
    text = raw.strip()
    if not text.startswith(opener):
        text = Path(text).read_text()
    return json.loads(text)


def _clamp_adapter_name(name) -> str | None:
    """An adapter claim → a sane name or None. ':' is the model separator
    and '/' the DHT key separator — a name containing either could alias
    another adapter's key."""
    if not isinstance(name, str) or not name:
        return None
    if len(name) > MAX_ADAPTER_NAME or ":" in name or "/" in name:
        return None
    return name


def parse_tenant_config(obj) -> dict[str, TenantSpec]:
    """Validate a {name: spec} mapping; raises ValueError on junk."""
    if not isinstance(obj, dict):
        raise ValueError(f"tenant config must be a JSON object, got {type(obj).__name__}")
    out: dict[str, TenantSpec] = {}
    seen_keys: set[str] = set()
    for name, spec in obj.items():
        if not name or not isinstance(spec, dict):
            raise ValueError(f"tenant {name!r}: spec must be an object")
        unknown = set(spec) - _ALLOWED_KEYS
        if unknown:
            raise ValueError(f"tenant {name!r}: unknown keys {sorted(unknown)}")
        weight = float(spec.get("weight", 1.0))
        if weight <= 0:
            raise ValueError(f"tenant {name!r}: weight must be > 0")
        rate = float(spec.get("rate_tokens_per_min", 0.0))
        burst = float(spec.get("burst_tokens", 0.0))
        if rate < 0 or burst < 0:
            raise ValueError(f"tenant {name!r}: budgets must be >= 0")
        key = spec.get("api_key")
        if key is not None:
            key = str(key)
            if key in seen_keys:
                # key → tenant resolution would be ambiguous: the first
                # match would silently absorb the second tenant's traffic
                raise ValueError(f"tenant {name!r}: api_key reused by another tenant")
            seen_keys.add(key)
        adapter = spec.get("adapter")
        if adapter is not None:
            if _clamp_adapter_name(str(adapter)) is None:
                # a malformed default would turn every request from this
                # tenant into a typed 404
                raise ValueError(f"tenant {name!r}: invalid adapter name {adapter!r}")
            adapter = str(adapter)
        out[str(name)] = TenantSpec(
            name=str(name), api_key=key, weight=weight,
            rate_tokens_per_min=rate, burst_tokens=burst,
            adapter=adapter,
        )
    return out


def load_tenant_config(source: str | None = None) -> dict[str, TenantSpec]:
    """Tenant specs from `source`, the ``BEE2BEE_TENANTS`` env var (inline
    JSON object, or a path to a JSON file), or empty (no tenants)."""
    data = load_json_source(source, "BEE2BEE_TENANTS")
    return parse_tenant_config(data) if data is not None else {}
