"""Tenant identity and per-tenant serving policy.

One declarative config maps API keys to tenant names and carries each
tenant's fairness weight and token budget; the SAME config feeds every
consumer — API-key resolution (api.py auth), the admission controller's
WDRR weights and token buckets (router/admission.py), and the engine
scheduler's tenant queues (engine/scheduler.py) — so a weight change
cannot drift between layers.

Config source: ``BEE2BEE_TENANTS`` (inline JSON object or a path to one),
validated loudly at load like ``BEE2BEE_SLO_CONFIG`` — a mis-typed tenant
config must fail the node at construction, not silently rate-limit the
wrong customer later. Shape::

    {"acme":  {"api_key": "k-acme", "weight": 4,
               "rate_tokens_per_min": 60000},
     "hobby": {"api_key": "k-hobby", "weight": 1}}

Unconfigured identity clamps to the ``default`` tenant (weight 1, no
budget): tenant names become METRIC LABELS and WDRR queue keys, so the
set must stay bounded by configuration, never by what a peer or client
claims on the wire.

PyTorch port: a copy of ``bee2bee_tpu/router/tenants.py`` with the import root rewritten to
``bee2bee_tpu_torch``.
"""

from __future__ import annotations

import hmac
from dataclasses import dataclass

from ..utils import load_json_source

DEFAULT_TENANT = "default"


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
    # default LoRA adapter (adapters/): a request from this tenant that
    # names no adapter (plain base model id, no `adapter` field) serves
    # under this one — the one-base-many-tenants mapping. None = base.
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
            from ..adapters import clamp_adapter_name

            if clamp_adapter_name(str(adapter)) is None:
                # same clamp as the wire: a malformed default would turn
                # every request from this tenant into a typed 404
                raise ValueError(
                    f"tenant {name!r}: invalid adapter name {adapter!r}"
                )
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


class TenantRegistry:
    """Resolved tenant table: API-key → name, weights, budgets."""

    def __init__(self, specs: dict[str, TenantSpec] | None = None):
        self.specs = dict(specs or {})

    def resolve_key(self, api_key: str | None) -> str | None:
        """Tenant name for a presented API key (constant-time compares —
        the key is the SDK-facing credential), or None when no tenant
        claims it."""
        if not api_key:
            return None
        enc = lambda s: s.encode("utf-8", "surrogateescape")
        for spec in self.specs.values():
            if spec.api_key and hmac.compare_digest(enc(api_key), enc(spec.api_key)):
                return spec.name
        return None

    def api_keys(self) -> list[str]:
        return [s.api_key for s in self.specs.values() if s.api_key]

    def clamp(self, name) -> str:
        """Wire-supplied tenant claim → a configured name or ``default``.
        Tenant names key metric labels and WDRR queues; an unconfigured
        claim must not mint a new series."""
        if isinstance(name, str) and name in self.specs:
            return name
        return DEFAULT_TENANT

    def weight(self, name: str) -> float:
        spec = self.specs.get(name)
        return spec.weight if spec else 1.0

    def default_adapter(self, name: str) -> str | None:
        """The tenant's configured default LoRA adapter (adapters/), or
        None for the base model. Applied only when the request itself
        names no adapter — an explicit model="<base>:<name>" wins."""
        spec = self.specs.get(name)
        return spec.adapter if spec else None

    def weights(self) -> dict[str, float]:
        return {name: s.weight for name, s in self.specs.items()}

    def budgets(self) -> dict[str, tuple[float, float]]:
        """{tenant: (rate tokens/s, burst tokens)} for budgeted tenants."""
        return {
            name: (s.rate_tokens_per_s, s.burst)
            for name, s in self.specs.items()
            if s.rate_tokens_per_min > 0
        }
