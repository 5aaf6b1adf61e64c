"""Tenant fairness for the port's scheduler: the WDRR submit queue and
the tenant config it takes its weights from (copies of
``bee2bee_tpu/router/fairness.py`` and of the part of
``bee2bee_tpu/router/tenants.py`` the engine scheduler reads)."""

from .fairness import WdrrQueue
from .tenants import TenantSpec, load_tenant_config, parse_tenant_config

__all__ = ["TenantSpec", "WdrrQueue", "load_tenant_config", "parse_tenant_config"]
