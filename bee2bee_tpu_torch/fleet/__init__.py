"""Elastic fleet control loop (ROADMAP round-3 item 3).

The health plane (health.py) gossips SLO burn rates and pool/bubble
gauges, drain + live migration (meshnet/migrate.py) can empty a node
without dropping a token, and weights publish→DHT→fetch can cold-start a
replica — this package closes the loop. One controller per operator
scope, elected via a TTL'd lease gossiped as a schema-declared protocol
frame, watches the fleet aggregates and turns them into replica
lifecycle actions:

- **scale OUT** when fast-burn is fleet-wide and sustained: activate a
  standby replica (weight prefetch via the node's provision hook), run a
  warm-up generation probe, and only then flip it router-eligible — a
  half-provisioned replica never receives traffic;
- **scale IN** when headroom is sustained across the slow window: pick
  the telemetry-worst eligible node and invoke the existing
  drain+migrate path, converting the drained node back to a warm
  standby.

Every action is hysteresis-guarded (sustain windows, cooldowns, min/max
replica bounds, one in-flight action at a time), journaled to the flight
recorder as typed ``fleet:*`` incidents, and chaos-proof: a controller
death or network split never strands a draining node — the next leader
(deterministic takeover when the lease lapses) adopts or rolls back
orphaned actions. See docs/ROBUSTNESS.md "Elastic fleet control".

PyTorch port: a copy of ``bee2bee_tpu/fleet/__init__.py`` with the import root rewritten to
``bee2bee_tpu_torch``.
"""

from .controller import (
    FleetConfig,
    FleetController,
    load_fleet_config,
    parse_fleet_config,
)
from .lease import LeaseKeeper, LeaseView

__all__ = [
    "FleetConfig",
    "FleetController",
    "LeaseKeeper",
    "LeaseView",
    "load_fleet_config",
    "parse_fleet_config",
]
