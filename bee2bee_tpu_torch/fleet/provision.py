"""Standby provisioning: the scale-OUT half of the control loop.

A standby replica is a mesh node whose telemetry digest advertises
``fleet_state: "standby"`` — it is connected and gossiping but the
router (router/policy.py) and the migration plane exclude it from every
traffic decision. Scaling out walks it through three states, and the
ordering IS the robustness contract:

1. **activate** — a ``fleet_action`` flips it to ``warming`` and runs
   the node's ``fleet_provision_cb`` (real deployments: weight prefetch
   via pieces/DHT, ``meshnet.weights.serve_model_from_mesh``; tests and
   the bench boot a service in-process). Warming is still
   router-excluded.
2. **probe** — the controller drives a real warm-up generation through
   the ordinary p2p serving path (``request_generation``). This is the
   gate: a replica that cannot serve one generation never becomes
   eligible, no matter what its digest claims.
3. **flip eligible** — only after the probe passes, ``set_state active``
   clears the fleet state and the next gossip makes the replica
   routable.

Any failure rolls the node back to ``standby`` (never left ``warming``
— an orphaned warming node would otherwise be invisible capacity) and
journals a ``fleet:provision_failed`` incident. A controller that dies
mid-provision leaves the node warming; the successor's orphan scan
(controller.py) re-runs the probe and completes or rolls back.

PyTorch port: a copy of ``bee2bee_tpu/fleet/provision.py`` with the import root rewritten to
``bee2bee_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import logging

logger = logging.getLogger("bee2bee_tpu_torch.fleet")


def _model_matches(model: str | None, models) -> bool:
    """The mesh's fuzzy model-match rule (node.local_service_for)."""
    if model is None:
        return True
    return any(
        model.lower() in str(m).lower() or str(m).lower() in model.lower()
        for m in models or []
    )


class Provisioner:
    """Scale-out orchestration for one FleetController. Separated so the
    chaos harness (meshnet/chaos.py ChaosController) can fault exactly
    the probe seam without touching the decision loop."""

    def __init__(self, controller):
        self.controller = controller

    @property
    def node(self):
        return self.controller.node

    @property
    def config(self):
        return self.controller.config

    # ------------------------------------------------------------- picking

    def pick_standby(self, digests: dict[str, dict]) -> str | None:
        """Deterministic standby pick: the smallest peer id advertising
        ``fleet_state: "standby"`` in a FRESH digest. Determinism matters
        for the takeover story — a successor re-deciding the same fleet
        state picks the same node."""
        cands = sorted(
            pid
            for pid, d in digests.items()
            if isinstance(d, dict)
            and d.get("fleet_state") == "standby"
            and not d.get("draining")
            and pid != self.node.peer_id
        )
        return cands[0] if cands else None

    # ------------------------------------------------------------ scale out

    async def scale_out(self, target: str, adopted: bool = False) -> tuple[bool, str]:
        """Walk one standby to router-eligible: activate → await the
        service advertisement → warm-up probe → flip active. With
        ``adopted`` (orphan-scan path) the node is already warming from a
        dead controller's attempt — skip straight to the probe. Returns
        (ok, detail); the node is back in ``standby`` on every failure."""
        cfg = self.config
        ctrl = self.controller
        if not adopted:
            ctrl.set_action_phase("activating")
            ack = await ctrl.send_action(
                target, "activate",
                timeout=cfg.ack_timeout_s + cfg.settle_timeout_s,
                **({"model": cfg.model} if cfg.model else {}),
            )
            if not ack.get("ok"):
                # activate failed node-side: the target already reverted
                # itself to standby (the action handler's contract)
                return False, f"activate failed: {ack.get('error')}"
        ctrl.set_action_phase("probing")
        if not await self._await_service(target):
            await ctrl.send_action(target, "set_state", state="standby")
            return False, "service never advertised within settle window"
        ok, detail = await self.probe(target)
        if not ok:
            await ctrl.send_action(target, "set_state", state="standby")
            return False, detail
        ack = await ctrl.send_action(target, "set_state", state="active")
        if not ack.get("ok"):
            await ctrl.send_action(target, "set_state", state="standby")
            return False, f"flip to active failed: {ack.get('error')}"
        return True, detail

    async def probe(self, target: str) -> tuple[bool, str]:
        """The warm-up generation gate, via the ordinary serving path.
        The chaos harness wraps exactly this method."""
        cfg = self.config
        clock = self.controller.clock
        try:
            t0 = clock.monotonic()
            result = await self.node.request_generation(
                target,
                cfg.probe_prompt,
                model=cfg.model,
                max_new_tokens=cfg.probe_tokens,
                temperature=0.0,
                timeout=cfg.probe_timeout_s,
            )
            if not isinstance(result, dict) or result.get("error"):
                return False, f"probe error: {(result or {}).get('error')}"
            ms = (clock.monotonic() - t0) * 1000.0
            return True, f"probe ok in {ms:.0f}ms"
        except Exception as e:  # noqa: BLE001 — a failed probe is a verdict
            return False, f"probe failed: {e}"

    async def _await_service(self, target: str) -> bool:
        """Wait (bounded) for the activated node's service announce to
        land in our provider table — the probe needs a service name to
        address."""
        cfg = self.config
        clock = self.controller.clock
        deadline = clock.monotonic() + cfg.settle_timeout_s
        while clock.monotonic() < deadline:
            svcs = self.node.providers.get(target) or {}
            for meta in list(svcs.values()):
                if _model_matches(cfg.model, meta.get("models")):
                    return True
            await clock.sleep(0.05)
        return False
