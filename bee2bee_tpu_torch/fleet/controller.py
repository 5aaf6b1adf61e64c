"""FleetController: burn-rate-driven scale-out/in with chaos-proof leasing.

One controller per operator scope holds the TTL'd lease (lease.py) and,
on the node's monitor cadence, turns the health plane's fleet aggregates
(health.controller_aggregates over the gossiped digests — the same data
``/mesh/health`` serves) into replica lifecycle actions:

- **scale OUT** when fast-burn is fleet-wide (``burn_quorum`` of the
  eligible replicas report a burning/tripped SLO brief) and *sustained*
  (``out_sustain_ticks`` consecutive ticks): pick a standby, activate →
  probe → flip eligible (provision.py — never eligible before the probe
  passes);
- **scale IN** when headroom is sustained across the slow window
  (``in_sustain_ticks`` ticks of zero burning replicas + low batch fill
  + low queue wait): pick the telemetry-WORST eligible node (the
  router's own penalty scorer, inverted) and invoke the existing
  drain+migrate path, finishing by converting the drained node to a
  warm standby — the fleet breathes instead of discarding capacity.

Hysteresis guards every action: sustain streaks, per-direction
cooldowns (any completed action refreshes both — no out/in flapping),
min/max replica bounds, and ONE in-flight action at a time. Every
decision (noops included) lands in a bounded journal served at
``GET /fleet``; every action outcome is a typed ``fleet:*`` incident
bundle in the flight recorder.

Chaos-proofing is structural, not bolted on: the in-flight action rides
the lease gossip, every leader tick re-scans the fleet for orphaned
state (a peer left ``draining`` or ``warming`` by a dead or partitioned
predecessor) and adopts or rolls it back, and replica actions are
epoch-gated at the target so a split-brain loser cannot drain nodes.
``tests/test_fleet.py`` pins the matrix via ChaosController.

PyTorch port: a copy of ``bee2bee_tpu/fleet/controller.py`` with the import root rewritten to
``bee2bee_tpu_torch``; comments that cited the JAX package's change history or the
reference checkout's path are trimmed.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
from collections import deque
from dataclasses import asdict, dataclass, fields

from .. import protocol
from ..clock import get_clock
from ..health import controller_aggregates
from ..metrics import get_registry
from ..utils import load_json_source, new_id
from .lease import LeaseKeeper
from .provision import Provisioner, _model_matches

logger = logging.getLogger("bee2bee_tpu_torch.fleet")

# decision/action observability. Label sets are closed (decision kinds
# and action kinds below), so cardinality is bounded.
_C_DECISIONS = get_registry().counter(
    "fleet.decisions", "controller decisions by kind (noop included)"
)
_C_ACTIONS = get_registry().counter(
    "fleet.actions", "completed controller actions by kind and outcome"
)
_G_LEADER = get_registry().gauge(
    "fleet.leader", "1 while this node holds the controller lease"
)
_G_REPLICAS = get_registry().gauge(
    "fleet.eligible_replicas", "router-eligible serving replicas (leader view)"
)


@dataclass(frozen=True)
class FleetConfig:
    """Controller knobs (``BEE2BEE_FLEET_CONFIG``, inline JSON or a
    path — the SLO/tenants/admission/router convention, validated
    loudly at construction)."""

    scope: str = "default"
    model: str | None = None      # serving scope; None = any service
    min_replicas: int = 1
    max_replicas: int = 8
    burn_quorum: float = 0.5      # fraction of eligible replicas burning
    # that counts as "fleet-wide" (one hot node is a routing problem, not
    # a capacity problem)
    out_sustain_ticks: int = 2    # consecutive burning ticks before out
    in_sustain_ticks: int = 6     # consecutive headroom ticks before in
    # (ticks ride the ping cadence: the slow direction is deliberately
    # several times the fast one, Google-SRE multi-window style)
    headroom_fill_max: float = 0.35
    headroom_queue_p95_ms: float = 250.0
    # pool-occupancy trend forecast: scale out when the
    # observatory's trend digest projects some eligible replica's paged
    # pool exhausting within this horizon (aggregates' pool_eta_s, from
    # the gossiped pool_free_frac slope) — capacity arrives BEFORE the
    # instantaneous burn does, instead of only reacting to it. Same
    # sustain/cooldown/standby ladder as the burn path; 0 disables.
    pool_eta_out_s: float = 120.0
    scale_out_cooldown_s: float = 30.0
    scale_in_cooldown_s: float = 120.0
    ack_timeout_s: float = 10.0       # fleet_action round-trip bound
    settle_timeout_s: float = 30.0    # activate → service advertised
    probe_timeout_s: float = 60.0     # warm-up generation bound
    probe_tokens: int = 4
    probe_prompt: str = "fleet warm-up probe"
    action_timeout_s: float = 120.0   # whole-action bound (drain quiesce)
    lease_ttl_s: float | None = None  # None → 3 × the node's ping cadence
    claim_stagger_s: float | None = None  # None → lease_ttl / 3 per rank


def parse_fleet_config(obj) -> FleetConfig:
    if not isinstance(obj, dict):
        raise ValueError(
            f"fleet config must be a JSON object, got {type(obj).__name__}"
        )
    known = {f.name for f in fields(FleetConfig)}
    unknown = set(obj) - known
    if unknown:
        raise ValueError(f"fleet config: unknown keys {sorted(unknown)}")
    kwargs = {}
    for k, v in obj.items():
        if k in ("scope", "model", "probe_prompt"):
            kwargs[k] = None if v is None else str(v)
            continue
        if v is None and k in ("lease_ttl_s", "claim_stagger_s"):
            kwargs[k] = None
            continue
        kwargs[k] = int(v) if k in (
            "min_replicas", "max_replicas", "out_sustain_ticks",
            "in_sustain_ticks", "probe_tokens",
        ) else float(v)
        if kwargs[k] < 0:
            raise ValueError(f"fleet config: {k} must be >= 0")
    cfg = FleetConfig(**kwargs)
    if cfg.min_replicas > cfg.max_replicas:
        raise ValueError("fleet config: min_replicas > max_replicas")
    if not 0.0 < cfg.burn_quorum <= 1.0:
        raise ValueError("fleet config: burn_quorum must be in (0, 1]")
    return cfg


def load_fleet_config(source: str | None = None) -> FleetConfig:
    data = load_json_source(source, "BEE2BEE_FLEET_CONFIG")
    return parse_fleet_config(data) if data is not None else FleetConfig()


class FleetController:
    """Lives on EVERY node (the lease keeper and the action handler must
    — any node can be commanded); only ``enabled`` nodes compete for the
    lease and run the decision loop. ``tick()`` rides the node's monitor
    loop (the ping cadence) and is directly callable for deterministic
    tests."""

    # journal decision kinds (closed set — the counter label)
    D_NOOP = "noop"
    D_SCALE_OUT = "scale_out"
    D_SCALE_IN = "scale_in"
    D_ADOPT = "adopt"
    D_ROLLBACK = "rollback"
    D_INFLIGHT = "inflight"
    D_PAUSED = "paused"
    D_OVERRIDE = "override"

    def __init__(self, node, enabled: bool | None = None,
                 config: FleetConfig | None = None):
        self.node = node
        if enabled is None:
            env = (os.environ.get("BEE2BEE_FLEET") or "").strip().lower()
            enabled = env in ("1", "true", "on", "controller")
        self.enabled = bool(enabled)
        # load_fleet_config raises on malformed BEE2BEE_FLEET_CONFIG —
        # same fail-at-construction contract as the SLO/router configs
        self.config = config or load_fleet_config()
        ttl = self.config.lease_ttl_s or 3.0 * node.ping_interval_s
        # the node's injected clock drives every fleet timer: lease TTLs,
        # action deadlines, cooldowns, drain polls (clock.py seam)
        self.clock = getattr(node, "clock", None) or get_clock()
        self.lease = LeaseKeeper(
            ttl_s=ttl, scope=self.config.scope, clock=self.clock
        )
        self.provisioner = Provisioner(self)
        self.is_leader = False
        self.epoch = 0
        self.paused = False
        self.decisions: deque[dict] = deque(maxlen=64)
        self.stats = {
            "takeovers": 0, "stepdowns": 0, "scale_out": 0, "scale_in": 0,
            "provision_failed": 0, "adopted": 0, "rolled_back": 0,
            "actions_failed": 0,
        }
        self._action: dict | None = None
        self._action_task: asyncio.Task | None = None
        # rid → (target peer, ws the action went out on, future): the
        # ack is only accepted from the addressed peer (see on_ack)
        self._acks: dict[str, tuple[str, object, asyncio.Future]] = {}
        self._burn_streak = 0
        self._headroom_streak = 0
        self._last_out = float("-inf")
        self._last_in = float("-inf")
        self._last_agg: dict = {}

    # ------------------------------------------------------- frame handlers

    @staticmethod
    def _advertises_controller(digest) -> bool:
        """THE controller-eligibility predicate — shared by the frame
        authorization gate (_controller_sender) and the takeover
        ranking (_claim_rank): the set a target obeys must be exactly
        the set that competes for the lease."""
        return bool(isinstance(digest, dict) and digest.get("fleet_controller"))

    def _controller_sender(self, pid: str) -> bool:
        """May this peer speak for the control plane at all? Leadership
        is restricted to controller-ELIGIBLE nodes (they advertise
        ``fleet_controller`` in their gossiped digest — the same set
        _claim_rank ranks), so a plain serving peer cannot claim a
        reign or command replicas no matter what epoch it invents. The
        mesh has no cryptographic identities — a peer that falsely
        advertises eligibility can still compete (Byzantine peers are
        out of scope) — but the bar matches the takeover protocol's own."""
        return self._advertises_controller(self.node.health.fresh().get(pid))

    async def on_lease(self, ws, data: dict) -> None:
        """FLEET_LEASE from a peer. Identity comes from the CONNECTION
        (like telemetry gossip): a peer can only claim the lease for
        itself, never forge another node's reign — and only a
        controller-eligible peer's claim counts at all."""
        pid = await self.node._peer_for(ws)
        if pid is None or data.get("holder") != pid:
            return
        if not self._controller_sender(pid):
            # benign on first contact (the lease broadcast can beat the
            # sender's first telemetry frame by one gossip round), but
            # an operator chasing "why does this node ignore the
            # leader" needs the drop to be visible
            logger.debug(
                "lease claim from %s dropped: no fresh controller-"
                "eligible digest for the sender yet", pid,
            )
            return
        view = self.lease.observe(data)
        if (
            self.is_leader
            and view is not None
            and view.fresh()
            and view.holder != self.node.peer_id
        ):
            # the ordering picked the rival: split-brain resolves the
            # moment the loser sees the winning frame
            self._step_down(f"superseded by {view.holder} epoch {view.epoch}")

    async def on_action(self, ws, data: dict) -> None:
        """FLEET_ACTION target side: apply one replica-lifecycle command
        from the (epoch-verified) lease holder, then gossip promptly so
        the fleet converges on the new state within one tick."""
        node = self.node
        rid = data.get("rid")
        act = data.get("action")
        # identity comes from the CONNECTION, exactly like on_lease: the
        # leader always issues its own actions over its own link, so a
        # frame whose claimed holder is not the sending peer is a forgery.
        # Drop it before lease.observe — a forged (holder, epoch) would
        # otherwise both command this node and poison its epoch floor.
        pid = await self.node._peer_for(ws)
        if pid is None or data.get("holder") != pid:
            return
        # and only a controller-ELIGIBLE peer may command at all: a
        # serving peer self-claiming an invented high epoch under its
        # own (connection-verified) identity must not drain the fleet
        # either. Typed nack — the refusal should be debuggable at the
        # sender, unlike the silent forgery drop above.
        if not self._controller_sender(pid):
            await self._ack(ws, rid, ok=False, error="not_controller")
            return
        if not self.lease.authorizes(data.get("holder"), data.get("epoch")):
            await self._ack(ws, rid, ok=False, error="stale_epoch")
            return
        # an authorized command also teaches us the claimant's reign —
        # relevant when the action arrives before its lease gossip
        self.lease.observe({
            "holder": data.get("holder"), "epoch": data.get("epoch"),
            "ttl_s": self.lease.ttl_s,
        })
        try:
            info = None
            if act == "drain":
                info = await node.begin_drain(wait=False, source="fleet")
            elif act == "undrain":
                node.end_drain()
            elif act == "to_standby":
                # scale-in completion: drained → warm standby. Order
                # matters — the standby state lands in the same digest
                # the drain flag leaves, so there is no eligible gap.
                node.fleet_state = "standby"
                node.end_drain()
            elif act == "activate":
                node.fleet_state = "warming"
                cb = getattr(node, "fleet_provision_cb", None)
                if cb is not None:
                    await cb(data.get("model"))
            elif act == "set_state":
                state = data.get("state")
                if state not in ("standby", "warming", "active"):
                    raise ValueError(f"unknown fleet state {state!r}")
                node.fleet_state = None if state == "active" else state
            else:
                raise ValueError(f"unknown fleet action {act!r}")
            node.recorder.record(
                "fleet_action", action=act, holder=data.get("holder"),
                epoch=data.get("epoch"),
            )
            with contextlib.suppress(Exception):
                await node.gossip_telemetry()
            await self._ack(ws, rid, ok=True, info=info)
        except Exception as e:  # noqa: BLE001 — the verdict is the reply
            if act == "activate":
                # a failed provision must not leave the node warming
                node.fleet_state = "standby"
            logger.exception("fleet action %s failed", act)
            await self._ack(ws, rid, ok=False, error=str(e))

    async def on_ack(self, ws, data: dict) -> None:
        entry = self._acks.get(data.get("rid"))
        if entry is None:
            return
        target, sent_ws, fut = entry
        # the ack must come from the peer the action was addressed to —
        # a peer that learns (or guesses) a rid cannot forge another
        # node's completion. The EXACT connection the action went out on
        # also counts: a mid-action hello rebind (dual-dial convergence)
        # re-registers the target onto a new ws while its genuine ack
        # rides the old link, and a completed drain booked as refused
        # would be worse than the (already-flagged) rebind itself.
        if ws is not sent_ws:
            pid = await self.node._peer_for(ws)
            if pid != target:
                return
        if not fut.done():
            fut.set_result({k: v for k, v in data.items() if k != "type"})

    async def _ack(self, ws, rid, ok: bool, error: str | None = None,
                   info: dict | None = None) -> None:
        with contextlib.suppress(Exception):
            await self.node._send(ws, protocol.msg(
                protocol.FLEET_ACK,
                rid=rid,
                ok=ok,
                **({"error": error} if error else {}),
                **({"info": info} if info else {}),
            ))

    async def send_action(self, target: str, action: str,
                          timeout: float | None = None, **fields) -> dict:
        """One epoch-stamped command to a peer; returns its ack payload
        (or a local error dict — callers branch on ``ok``)."""
        info = self.node.peers.get(target)
        if info is None:
            return {"ok": False, "error": f"peer {target} unknown"}
        rid = new_id("fla")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._acks[rid] = (target, info["ws"], fut)
        try:
            await self.node._send(info["ws"], protocol.msg(
                protocol.FLEET_ACTION,
                rid=rid,
                action=action,
                epoch=self.epoch,
                holder=self.node.peer_id,
                **fields,
            ))
            return await self.clock.wait_for(
                fut, timeout or self.config.ack_timeout_s
            )
        except asyncio.TimeoutError:
            return {"ok": False, "error": f"no ack from {target}"}
        except Exception as e:  # noqa: BLE001 — typed verdict, not a raise
            return {"ok": False, "error": str(e)}
        finally:
            self._acks.pop(rid, None)  # meshlint: ignore[ML-R003] -- rid-keyed ack futures: each awaiter registers and pops only its own rid

    # ---------------------------------------------------------------- tick

    async def tick(self, now: float | None = None) -> None:
        """One control-loop step. Never throws (the monitor loop hosts
        it); directly callable for deterministic tests."""
        try:
            await self._tick(self.clock.time() if now is None else now)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — the loop must outlive one bad tick
            logger.exception("fleet tick failed")

    async def _tick(self, now: float) -> None:
        if self.is_leader:
            cur = self.lease.current(now)
            if cur is not None and cur.holder != self.node.peer_id:
                self._step_down(
                    f"superseded by {cur.holder} epoch {cur.epoch}"
                )
            else:
                await self._broadcast_lease(now)
        elif self.enabled and not self.paused:
            await self._maybe_claim(now)
        _G_LEADER.set(1.0 if self.is_leader else 0.0)
        if not self.is_leader:
            return
        if self.paused:
            self._journal(now, self.D_PAUSED, "controller paused by operator", {})
            return
        digests = self.fleet_digests()
        agg = controller_aggregates(digests, serving=self.serving_peers())
        self._last_agg = agg
        _G_REPLICAS.set(float(agg.get("eligible", 0)))
        if self._action is not None:
            self._check_action_timeout(now)
            if self._action is not None:
                self._journal(
                    now, self.D_INFLIGHT,
                    f"{self._action['kind']} on {self._action.get('target')}"
                    f" ({self._action.get('phase')})",
                    agg,
                )
            return
        if self._adopt_orphans(now, agg, digests):
            return
        decision, reason, target = self._decide(now, agg, digests)
        self._journal(now, decision, reason, agg)
        if decision == self.D_SCALE_OUT:
            self._start_action("scale_out", target,
                               self._run_scale_out(target))
        elif decision == self.D_SCALE_IN:
            self._start_action("scale_in", target,
                               self._run_scale_in(target))

    # ------------------------------------------------------------ the lease

    async def _maybe_claim(self, now: float) -> None:
        lapsed = self.lease.lapsed_for(now)
        if lapsed is None:
            return
        rank = self._claim_rank()
        stagger = self.config.claim_stagger_s or self.lease.ttl_s / 3.0
        if lapsed < rank * stagger:
            return
        self.epoch = self.lease.highest_epoch + 1
        self.is_leader = True
        self.stats["takeovers"] += 1
        self.lease.observe(self._lease_frame(), now)
        self.node.recorder.incident(
            "fleet:takeover",
            detail=f"claimed lease epoch {self.epoch} "
                   f"(lapsed {lapsed:.1f}s, rank {rank})",
            node=self.node.peer_id,
        )
        await self._broadcast_lease(now)

    def _claim_rank(self) -> int:
        """This node's position among the live controller-eligible peers
        (fresh digests advertising ``fleet_controller``), sorted by peer
        id — the deterministic takeover order."""
        pids = {self.node.peer_id}
        for pid, d in self.node.health.fresh().items():
            if self._advertises_controller(d):
                pids.add(pid)
        return sorted(pids).index(self.node.peer_id)

    def _lease_frame(self, released: bool = False) -> dict:
        action = None
        if self._action is not None:
            action = {
                k: self._action.get(k)
                for k in ("kind", "target", "phase", "rid")
            }
        return protocol.msg(
            protocol.FLEET_LEASE,
            holder=self.node.peer_id,
            epoch=self.epoch,
            ttl_s=self.lease.ttl_s,
            scope=self.config.scope,
            **({"action": action} if action else {}),
            **({"released": True} if released else {}),
        )

    async def _broadcast_lease(self, now: float | None = None) -> None:
        frame = self._lease_frame()
        self.lease.observe(frame, now)  # refresh our own reign locally
        with contextlib.suppress(Exception):
            await self.node.broadcast(frame)

    def _step_down(self, why: str) -> None:
        if not self.is_leader:
            return
        self.is_leader = False
        self.stats["stepdowns"] += 1
        _G_LEADER.set(0.0)
        self._cancel_action(f"stepdown: {why}")
        self.node.recorder.incident(
            "fleet:stepdown", detail=why, node=self.node.peer_id
        )

    async def release(self) -> None:
        """Clean shutdown (node.stop): zero the TTL so followers take
        over immediately instead of waiting out the lapse."""
        if not self.is_leader:
            return
        self.is_leader = False
        self._cancel_action("node stopping")
        with contextlib.suppress(Exception):
            await self.node.broadcast(self._lease_frame(released=True))

    # ------------------------------------------------------------ decisions

    def fleet_digests(self) -> dict[str, dict]:
        """The controller's input: our own live digest plus every FRESH
        peer digest. Stale digests are already gone (HealthStore.fresh),
        so a dead node can never trigger a scale action."""
        return {
            self.node.peer_id: self.node.telemetry_digest(),
            **self.node.health.fresh(),
        }

    def serving_peers(self) -> set[str]:
        """Peers that advertise a service in scope (plus self when it
        serves locally) — the replica universe the aggregates count."""
        cfg = self.config
        out = set()
        for pid, svcs in list(self.node.providers.items()):
            for meta in list(svcs.values()):
                if _model_matches(cfg.model, meta.get("models")):
                    out.add(pid)
                    break
        for svc in list(self.node.local_services.values()):
            if _model_matches(cfg.model, svc.get_metadata().get("models")):
                out.add(self.node.peer_id)
                break
        return out

    def _decide(self, now: float, agg: dict, digests: dict):
        cfg = self.config
        eligible = int(agg.get("eligible") or 0)
        burning = int(agg.get("burning") or 0)
        fleet_burning = (
            eligible > 0
            and float(agg.get("burning_frac") or 0.0) >= cfg.burn_quorum
        )
        # pool-occupancy forecast (aggregates' pool_eta_s, derived from
        # the gossiped trend digests): projected exhaustion inside the
        # horizon is scale-out pressure NOW, not when the burn lands
        pool_eta = agg.get("pool_eta_s")
        forecast_low = (
            eligible > 0
            and cfg.pool_eta_out_s > 0
            and pool_eta is not None
            and float(pool_eta) <= cfg.pool_eta_out_s
        )
        headroom = (
            eligible > 0
            and burning == 0
            and not forecast_low
            and float(agg.get("fill_mean") or 0.0) <= cfg.headroom_fill_max
            and float(agg.get("queue_p95_max") or 0.0)
            <= cfg.headroom_queue_p95_ms
        )
        self._burn_streak = (
            self._burn_streak + 1 if (fleet_burning or forecast_low) else 0
        )
        self._headroom_streak = self._headroom_streak + 1 if headroom else 0
        # REPAIR before load-following: a crashed replica's digest goes
        # stale and simply vanishes from the aggregates — it reports no
        # burn, so the burn path alone would idle warm standbys through
        # a total outage. min_replicas is a floor to restore, not just a
        # scale-in bound; no sustain window (the capacity is already
        # gone), only the cooldown guards re-provision thrash.
        if eligible < cfg.min_replicas:
            if now - self._last_out < cfg.scale_out_cooldown_s:
                return (self.D_NOOP,
                        "below min_replicas but in scale-out cooldown", None)
            target = self.provisioner.pick_standby(digests)
            if target is None:
                return (self.D_NOOP,
                        f"eligible {eligible} below min_replicas but no "
                        "standby available", None)
            return (self.D_SCALE_OUT,
                    f"eligible {eligible} below min_replicas "
                    f"{cfg.min_replicas} — repairing", target)
        if self._burn_streak >= cfg.out_sustain_ticks:
            if eligible >= cfg.max_replicas:
                return self.D_NOOP, "scale-out pressure but at max_replicas", None
            if now - self._last_out < cfg.scale_out_cooldown_s:
                return self.D_NOOP, "scale-out pressure but in cooldown", None
            target = self.provisioner.pick_standby(digests)
            if target is None:
                return self.D_NOOP, "scale-out pressure but no standby available", None
            if fleet_burning:
                reason = (
                    f"fast-burn fleet-wide for {self._burn_streak} ticks "
                    f"({burning}/{eligible} replicas burning)"
                )
            else:
                reason = (
                    f"pool-occupancy forecast: exhaustion in ~{pool_eta}s "
                    f"on {agg.get('pool_eta_peer')} (horizon "
                    f"{cfg.pool_eta_out_s}s, {self._burn_streak} ticks)"
                )
            return self.D_SCALE_OUT, reason, target
        if self._headroom_streak >= cfg.in_sustain_ticks:
            if eligible <= cfg.min_replicas:
                return self.D_NOOP, "headroom but at min_replicas", None
            if now - self._last_in < cfg.scale_in_cooldown_s:
                return self.D_NOOP, "headroom but in scale-in cooldown", None
            target = self._pick_worst(agg, digests)
            if target is None:
                return self.D_NOOP, "headroom but no remote drain candidate", None
            return (
                self.D_SCALE_IN,
                f"headroom sustained for {self._headroom_streak} ticks",
                target,
            )
        return (
            self.D_NOOP,
            f"streaks burn={self._burn_streak}/{cfg.out_sustain_ticks} "
            f"headroom={self._headroom_streak}/{cfg.in_sustain_ticks}",
            None,
        )

    def _pick_worst(self, agg: dict, digests: dict) -> str | None:
        """The telemetry-worst REMOTE eligible replica: highest router
        penalty wins removal (the exact inverse of the routing pick, so
        scaling in removes the node traffic likes least). The controller
        never drains its own node — a leader mid-self-drain is the chaos
        case, not the steady state."""
        cands = []
        for pid in agg.get("eligible_ids") or []:
            if pid == self.node.peer_id:
                continue
            d = digests.get(pid)
            peer = self.node.peers.get(pid) or {}
            score, _ = self.node.router.score(
                {"provider_id": pid, "local": False},
                d, peer.get("rtt_ms"), 0.0, [],
            )
            cands.append((score, pid))
        if not cands:
            return None
        # worst score first; peer id breaks ties deterministically
        cands.sort(key=lambda t: (-t[0], t[1]))
        return cands[0][1]

    def _journal(self, now: float, decision: str, reason: str, agg: dict) -> None:
        entry = {
            "ts": round(now, 3),
            "leader": self.node.peer_id,
            "epoch": self.epoch,
            "decision": decision,
            "reason": reason,
            "eligible": agg.get("eligible"),
            "burning": agg.get("burning"),
            "standby": len(agg.get("standby") or []),
            "draining": len(agg.get("draining") or []),
        }
        self.decisions.append(entry)
        _C_DECISIONS.inc(decision=decision)
        self.node.recorder.record("fleet_decision", **entry)

    # -------------------------------------------------------------- actions

    def set_action_phase(self, phase: str) -> None:
        if self._action is not None:
            self._action["phase"] = phase

    def _start_action(self, kind: str, target: str | None, coro) -> None:
        self._action = {
            "kind": kind, "target": target, "phase": "starting",
            "rid": new_id("flact"), "started": self.clock.time(),
        }
        self._action_task = self.node._spawn(coro)

    def _finish_action(self, ok: bool, incident_kind: str, detail: str) -> None:
        action = self._action or {}
        now = self.clock.time()
        # ANY completed action refreshes BOTH cooldowns: a scale-out
        # immediately followed by a scale-in (or vice versa) is flapping
        # by definition
        self._last_out = now
        self._last_in = now
        self._burn_streak = 0
        self._headroom_streak = 0
        _C_ACTIONS.inc(
            kind=action.get("kind") or "unknown",
            outcome="ok" if ok else "failed",
        )
        if not ok:
            self.stats["actions_failed"] += 1
        self.node.recorder.incident(
            incident_kind, detail=detail, node=self.node.peer_id,
            extra={k: action.get(k) for k in ("kind", "target", "rid")},
        )
        self._action = None
        self._action_task = None

    def _cancel_action(self, why: str) -> None:
        if self._action_task is not None and not self._action_task.done():
            self._action_task.cancel()
        if self._action is not None:
            logger.warning("fleet action %s abandoned: %s", self._action, why)
        self._action = None
        self._action_task = None

    def _check_action_timeout(self, now: float) -> None:
        action = self._action
        if action is None:
            return
        # generous outer bound: the per-phase timeouts inside the action
        # coroutines normally finish it first — this catches a wedged task
        budget = (
            self.config.action_timeout_s
            + self.config.settle_timeout_s
            + self.config.probe_timeout_s
        )
        if now - action.get("started", now) > budget:
            # cancel the task but keep self._action until _finish_action
            # books it — the counter label and the incident extra must
            # attribute the timeout to its kind/target, not "unknown"
            if self._action_task is not None and not self._action_task.done():
                self._action_task.cancel()
            self._action_task = None
            logger.warning(
                "fleet action %s exceeded its wall-clock budget", action
            )
            self._finish_action(
                False, "fleet:action_failed",
                f"{action.get('kind')} on {action.get('target')} timed out",
            )

    async def _run_scale_out(self, target: str, adopted: bool = False) -> None:
        try:
            ok, detail = await self.provisioner.scale_out(
                target, adopted=adopted
            )
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — a bug fails the action, typed
            ok, detail = False, f"scale-out crashed: {e!r}"
            logger.exception("scale-out crashed")
        if ok:
            self.stats["scale_out"] += 1  # meshlint: ignore[ML-R003] -- atomic counter bump: no read of stats spans an await
            self._finish_action(
                True, "fleet:scale_out",
                f"replica {target} probed and flipped eligible ({detail})",
            )
        else:
            self.stats["provision_failed"] += 1
            self._finish_action(
                False, "fleet:provision_failed",
                f"replica {target} not eligible: {detail}",
            )

    async def _run_scale_in(self, target: str, adopted: bool = False) -> None:
        try:
            cfg = self.config
            if not adopted:
                self.set_action_phase("draining")
                ack = await self.send_action(target, "drain")
                if not ack.get("ok"):
                    self._finish_action(
                        False, "fleet:action_failed",
                        f"drain of {target} refused: {ack.get('error')}",
                    )
                    return
            self.set_action_phase("awaiting_drain")
            quiet = await self._await_drained(target, cfg.action_timeout_s)
            if not quiet:
                # never strand a draining node: roll it back to eligible
                await self.send_action(target, "undrain")
                self.stats["rolled_back"] += 1
                self._finish_action(
                    False, "fleet:action_failed",
                    f"drain of {target} never quiesced; rolled back",
                )
                return
            if target not in self.node.peers:
                self.stats["scale_in"] += 1
                self._finish_action(
                    True, "fleet:scale_in", f"{target} drained and left the mesh"
                )
                return
            ack = await self.send_action(target, "to_standby")
            if ack.get("ok"):
                self.stats["scale_in"] += 1
                self._finish_action(
                    True, "fleet:scale_in",
                    f"{target} drained and converted to standby",
                )
            else:
                await self.send_action(target, "undrain")
                self.stats["rolled_back"] += 1
                self._finish_action(
                    False, "fleet:action_failed",
                    f"standby conversion of {target} failed: {ack.get('error')}",
                )
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001
            logger.exception("scale-in crashed")
            with contextlib.suppress(Exception):
                await self.send_action(target, "undrain")
            self._finish_action(
                False, "fleet:action_failed", f"scale-in crashed: {e!r}"
            )

    async def _await_drained(self, target: str, timeout_s: float) -> bool:
        """Drain quiescence: the target's FRESH digest shows draining
        with no live rows (`engine.active_rows` zero or absent — a
        model-free node has no gauge), or the peer left the mesh."""
        deadline = self.clock.monotonic() + timeout_s
        poll = min(0.1, self.lease.ttl_s / 10.0)
        while self.clock.monotonic() < deadline:
            if target not in self.node.peers:
                return True
            d = self.node.health.fresh().get(target)
            if isinstance(d, dict) and d.get("draining"):
                rows = (d.get("gauge") or {}).get("engine.active_rows")
                if not rows:
                    return True
            await self.clock.sleep(poll)
        return False

    async def _run_rollback(self, target: str) -> None:
        try:
            ack = await self.send_action(target, "undrain")
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001
            ack = {"ok": False, "error": repr(e)}
        self.stats["rolled_back"] += 1
        self._finish_action(
            bool(ack.get("ok")), "fleet:drain_rollback",
            f"orphaned drain of {target} rolled back "
            f"(fleet needs capacity): {ack.get('error') or 'ok'}",
        )

    def _adopt_orphans(self, now: float, agg: dict, digests: dict) -> bool:
        """Any leader tick with no in-flight action scans for state a
        dead/partitioned predecessor left behind: a DRAINING peer (its
        scale-in died mid-flight) is adopted to completion — or rolled
        back when the fleet is burning and needs the capacity — and a
        WARMING peer (a provision died between activate and the probe)
        is re-probed to eligibility or returned to standby. This is what
        makes a controller death survivable: the state machine lives in
        the fleet's digests, not in the dead process."""
        cfg = self.config
        for pid in sorted(digests):
            if pid == self.node.peer_id:
                continue
            d = digests[pid]
            if not isinstance(d, dict):
                continue
            if d.get("draining"):
                if d.get("drain_source") != "fleet":
                    # an OPERATOR's deliberate drain (POST /admin/drain):
                    # not ours to reconcile — undraining it would reopen
                    # traffic on a node about to be killed, and adopting
                    # it would mutate fleet state the operator never
                    # asked for. The router already excludes it.
                    continue
                need_capacity = (
                    int(agg.get("burning") or 0) > 0
                    or int(agg.get("eligible") or 0) < cfg.min_replicas
                )
                if need_capacity:
                    self._journal(
                        now, self.D_ROLLBACK,
                        f"orphaned drain on {pid}: fleet needs capacity",
                        agg,
                    )
                    self._start_action(
                        "rollback", pid, self._run_rollback(pid)
                    )
                else:
                    self.stats["adopted"] += 1
                    self._journal(
                        now, self.D_ADOPT, f"adopting orphaned drain on {pid}",
                        agg,
                    )
                    self.node.recorder.incident(
                        "fleet:drain_adopted",
                        detail=f"completing predecessor's drain of {pid}",
                        node=self.node.peer_id,
                    )
                    self._start_action(
                        "scale_in", pid, self._run_scale_in(pid, adopted=True)
                    )
                return True
            if d.get("fleet_state") == "warming":
                self.stats["adopted"] += 1
                self._journal(
                    now, self.D_ADOPT,
                    f"adopting orphaned warm-up on {pid} (re-probing)",
                    agg,
                )
                self.node.recorder.incident(
                    "fleet:warmup_adopted",
                    detail=f"re-probing predecessor's half-provisioned {pid}",
                    node=self.node.peer_id,
                )
                self._start_action(
                    "scale_out", pid, self._run_scale_out(pid, adopted=True)
                )
                return True
        return False

    # ------------------------------------------------------------- override

    async def override(self, action: str, target: str | None = None) -> dict:
        """Manual override (POST /fleet/override, admin-only): pause /
        resume the loop anywhere; force a scale action on the leader —
        hysteresis is bypassed, the probe gate and one-in-flight are
        NOT."""
        now = self.clock.time()
        if action == "pause":
            self.paused = True
            self._journal(now, self.D_OVERRIDE, "paused by operator", {})
            return {"ok": True, "paused": True}
        if action == "resume":
            self.paused = False
            self._journal(now, self.D_OVERRIDE, "resumed by operator", {})
            return {"ok": True, "paused": False}
        if action not in ("scale_out", "scale_in"):
            return {"ok": False, "error": f"unknown override {action!r}"}
        if not self.is_leader:
            cur = self.lease.current(now)
            return {
                "ok": False, "error": "not_leader",
                "leader": cur.holder if cur else None,
            }
        if self._action is not None:
            return {"ok": False, "error": "action_in_flight",
                    "action": dict(self._action)}
        digests = self.fleet_digests()
        agg = controller_aggregates(digests, serving=self.serving_peers())
        if action == "scale_out":
            # an explicit target must actually BE a standby: "activate"
            # on an already-serving replica would flip it warming
            # (router-excluded mid-traffic) and a failed probe would
            # demote healthy capacity to standby
            if target is not None and (
                (digests.get(target) or {}).get("fleet_state") != "standby"
            ):
                return {"ok": False,
                        "error": f"{target} is not a fresh standby replica"}
            target = target or self.provisioner.pick_standby(digests)
            if target is None:
                return {"ok": False, "error": "no standby available"}
            self._journal(now, self.D_OVERRIDE, f"forced scale_out {target}", agg)
            self._start_action("scale_out", target, self._run_scale_out(target))
        else:
            # an explicit drain target must be an eligible remote
            # replica — draining a standby (or this node) is not a
            # scale-in, it is an outage
            if target is not None and (
                target == self.node.peer_id
                or target not in (agg.get("eligible_ids") or [])
            ):
                return {"ok": False,
                        "error": f"{target} is not a remote eligible replica"}
            target = target or self._pick_worst(agg, digests)
            if target is None:
                return {"ok": False, "error": "no remote drain candidate"}
            self._journal(now, self.D_OVERRIDE, f"forced scale_in {target}", agg)
            self._start_action("scale_in", target, self._run_scale_in(target))
        return {"ok": True, "action": dict(self._action)}

    # --------------------------------------------------------------- status

    def status(self) -> dict:
        """The ``GET /fleet`` payload."""
        now = self.clock.time()
        return {
            "node": self.node.peer_id,
            "enabled": self.enabled,
            "paused": self.paused,
            "is_leader": self.is_leader,
            "epoch": self.epoch,
            "scope": self.config.scope,
            "lease": self.lease.describe(now),
            "action": dict(self._action) if self._action else None,
            "aggregates": dict(self._last_agg),
            "decisions": list(self.decisions)[-20:],
            "stats": dict(self.stats),
            "config": asdict(self.config),
        }
