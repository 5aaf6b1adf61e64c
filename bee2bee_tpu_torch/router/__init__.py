"""SLO-aware front door: routing policy, admission control, tenant fairness.

The serving-side consumer of the mesh health plane (health.py): routes on
gossiped telemetry digests instead of the reference's static cheapest/
lowest-latency sort, sheds load with typed 429/503 + Retry-After before a
node melts, and enforces per-tenant weighted fairness from the API key
down to the engine scheduler's queue. See docs/SERVING.md.

PyTorch port: a copy of ``bee2bee_tpu/router/__init__.py`` with the import root rewritten to
``bee2bee_tpu_torch``.
"""

from .admission import (
    AdmissionConfig,
    AdmissionController,
    AdmissionReject,
    AdmissionTicket,
    load_admission_config,
    paged_pool_free_fraction,
    pool_exhaust_eta,
)
from .fairness import WdrrQueue
from .policy import (
    RouterPolicy,
    RouterWeights,
    load_router_weights,
    static_sort,
)
from .prefixmap import PrefixTracker, match_depth, prompt_prefix_hashes
from .tenants import (
    DEFAULT_TENANT,
    TenantRegistry,
    TenantSpec,
    load_tenant_config,
    parse_tenant_config,
)

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "AdmissionReject",
    "AdmissionTicket",
    "DEFAULT_TENANT",
    "PrefixTracker",
    "RouterPolicy",
    "RouterWeights",
    "TenantRegistry",
    "TenantSpec",
    "WdrrQueue",
    "load_admission_config",
    "load_router_weights",
    "load_tenant_config",
    "match_depth",
    "paged_pool_free_fraction",
    "pool_exhaust_eta",
    "parse_tenant_config",
    "prompt_prefix_hashes",
    "static_sort",
]
