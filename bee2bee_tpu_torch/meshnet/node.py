"""P2PNode: one WebSocket mesh node.

Wire-compatible with the reference's message set (p2p_runtime.py:460-470 and
the JS bridge's subset, bridge.js:163-223): hello / peer_list / ping / pong /
service_announce / gen_request / gen_chunk / gen_success / gen_error /
gen_result / piece_request / piece_data. Reference defects deliberately fixed
(SURVEY §7 step 4):

- **gen_success vs gen_result asymmetry** (reference only resolves futures on
  gen_result, p2p_runtime.py:467,660): here the result handler accepts all of
  gen_success/gen_result/gen_error.
- **blocking execute in the event loop** (reference calls svc.execute inline,
  p2p_runtime.py:624): service execution runs in a thread executor.
- **unlocked _pending_requests** (p2p_runtime.py:794-796): guarded.
- **piece transfer stubs** (p2p_runtime.py:675-683): fully implemented, with
  binary tensor frames instead of JSON for piece payloads.

Cross-peer pipeline serving (task/result + part_load/part_forward, the
reference's worker protocol node.py:48-294) lives in meshnet/pipeline.py
(StageTaskMixin) and is wired into the dispatch table here.

PyTorch port: a copy of ``bee2bee_tpu/meshnet/node.py`` with the import root
rewritten to ``bee2bee_tpu_torch``; comments that cited the JAX package's
change history or the reference checkout's path are trimmed. Adapter paging
imports its names from ``..adapters`` (adapters/distrib.py, the pool).
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import json
import logging
import os
from pathlib import Path
from typing import Any, Callable

from .. import protocol
from ..clock import Clock, resolve_clock
from ..adapters import AdapterPoolBusy, clamp_adapter_name, split_model_adapter
from ..fleet import FleetController
from ..health import HealthStore, SloTracker, build_digest, get_recorder, load_slo_config
from ..joinlink import generate_join_link, parse_join_link
from ..metrics import get_registry
from ..obs import Observatory
from ..pieces import ShardManifest
from ..router import (
    AdmissionController,
    AdmissionReject,
    PrefixTracker,
    RouterPolicy,
    TenantRegistry,
    load_admission_config,
    load_tenant_config,
    paged_pool_free_fraction,
    pool_exhaust_eta,
    static_sort,
)
from ..tracing import extract_trace, get_tracer, inject_trace, use_trace_ctx
from ..transport import Transport, resolve_transport
from ..utils import (
    MetricsAggregator,
    get_lan_ip,
    get_system_metrics,
    log_task_exception,
    new_id,
    pump_queue_until,
    sha256_hex,
)
from .migrate import MigrationManager
from .pipeline import StageDead, StageTaskMixin

logger = logging.getLogger("bee2bee_tpu_torch.mesh")

REQUEST_TIMEOUT_S = 300.0  # reference p2p_runtime.py:831
PING_INTERVAL_S = 15.0
# dial-side redial of lost peers. The reference reconnects its worker every
# 2 s forever (node.py:286-289) and its JS bridge every 5 s (bridge.js:83-95);
# here: exponential backoff from 2 s capped at 30 s, giving up after 5 min for
# ordinary peers (a departed peer is not coming back) while bootstrap addrs
# retry forever (losing the bootstrap strands the node outside the mesh).
RECONNECT_INITIAL_S = 2.0
RECONNECT_MAX_S = 30.0
RECONNECT_WINDOW_S = 300.0
# spawned gen/task handlers per connection before the reader processes
# inline (TCP backpressure); sized past any engine/session batch depth
MAX_CONCURRENT_SERVES_PER_CONN = 32

# mesh wire accounting (metrics.py): frames/bytes by op, both directions.
# The op label is bounded by MESSAGE_TYPES (+ "tensor" for binary sends,
# whose op would cost a header decode to learn), so cardinality is fixed.
_C_FRAMES_SENT = get_registry().counter("mesh.frames_sent", "frames sent by op")
_C_BYTES_SENT = get_registry().counter("mesh.bytes_sent", "payload bytes sent by op")
_C_FRAMES_RECV = get_registry().counter(
    "mesh.frames_recv", "frames received by op"
)
_C_BYTES_RECV = get_registry().counter(
    "mesh.bytes_recv", "payload bytes received by op"
)
# per-op bound-series caches for the frame counters above (hot path —
# see _send_raw/_reader); bounded because ops are clamped to the
# protocol type set before lookup
_FRAME_SENT_INCS: dict[str, tuple] = {}
_FRAME_RECV_INCS: dict[str, tuple] = {}
_C_RELAY_HOPS = get_registry().counter(
    "mesh.relay_hops", "gen_requests forwarded through the swarm relay"
)
_C_GOSSIP_SUPPRESSED = get_registry().counter(
    "mesh.gossip_suppressed",
    "telemetry broadcasts skipped by delta suppression (unchanged digest)",
)
# generation outcome counters: the event stream the gen_error_rate SLO
# objective (health.DEFAULT_SLO_CONFIG) burns against. Counted at
# _execute_local — the one funnel every locally-served generation
# (HTTP /chat, /v1, p2p gen_request, relay target) passes through.
_C_GEN_REQUESTS = get_registry().counter(
    "gen.requests", "generations served by local services"
)
_C_GEN_ERRORS = get_registry().counter(
    "gen.errors", "locally-served generations that raised"
)

# received frame ops worth a flight-recorder ring entry: failures and
# membership changes — the events an incident bundle needs for context.
# Pings/pongs/chunks would drown the ring in weather.
_NOTABLE_OPS = frozenset(
    {protocol.GEN_ERROR, protocol.TASK_ERROR, protocol.GOODBYE, protocol.HELLO}
)


def _frame_bytes(raw: str | bytes) -> int:
    """Wire size of a RECEIVED frame: foreign peers may send non-ASCII
    JSON, where len() of the decoded str would undercount the bytes. Our
    own sends never need this — protocol.encode uses json.dumps with its
    ensure_ascii default, so outgoing text frames are pure ASCII and
    len(raw) is already the exact wire byte count."""
    return len(raw) if isinstance(raw, bytes) else len(raw.encode("utf-8"))


class P2PNode(StageTaskMixin):
    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 0,
        region: str = "default",
        node_id: str | None = None,
        announce_host: str | None = None,
        announce_port: int | None = None,
        api_port: int | None = None,
        piece_dir: str | Path | None = None,
        accept_stages: bool = True,  # advertise pipeline-stage capacity in
        # hello: failover re-placement prefers peers that said yes (set
        # False on client-only nodes that must never host model layers)
        disagg_role: str | None = None,  # "prefill" | "decode" | None —
        # disaggregated serving role (BEE2BEE_DISAGG): a prefill node
        # hands freshly prefilled generations to decode-designated peers
        # via KV migration; a decode node advertises itself as the target
        fleet_state: str | None = None,  # "standby" | None (eligible) —
        # elastic fleet role (BEE2BEE_FLEET_STATE): a standby replica is
        # connected and gossiping but router-excluded until the fleet
        # controller activates + probes it (fleet/provision.py)
        fleet_controller: bool | None = None,  # compete for the fleet
        # controller lease (BEE2BEE_FLEET=controller); every node still
        # keeps a lease view and obeys epoch-gated fleet actions
        clock: Clock | None = None,  # time seam (clock.py): None = the
        # process-global clock. Everything this node constructs (health
        # store, SLO tracker, lease, admission) inherits it, so a
        # simulation's virtual clock drives the WHOLE control plane
        transport: Transport | None = None,  # I/O seam (transport.py):
        # None = real websockets, falling back to the wscompat loopback
        # shim — the historical behavior, now as backend selection
    ):
        self.clock = resolve_clock(clock)
        self.transport = resolve_transport(transport)
        self.host = host
        self.accept_stages = accept_stages
        self.port = port
        self.region = region
        self.peer_id = node_id or new_id("node")
        self.announce_host = announce_host
        self.announce_port = announce_port
        self.api_port = api_port

        self.peers: dict[str, dict] = {}  # peer_id -> {ws, addr, metrics, ...}
        self.providers: dict[str, dict] = {}  # peer_id -> {svc_name: meta}
        self.local_services: dict[str, Any] = {}
        self.stage_runners: dict[str, Any] = {}  # model -> StageRunner (pipeline.py)
        self.stage_next: dict[str, str] = {}  # model -> next stage's peer_id (relay)
        self.stage_bursts: dict[str, dict] = {}  # ring decode accumulators (last stage)
        self.throughput = MetricsAggregator()

        # health plane (health.py): per-peer telemetry digests gossiped on
        # the ping cadence; SLO burn-rate tracking over the local registry;
        # the process-global incident flight recorder. ping_interval_s is
        # an attribute so tests shrink the cadence without monkeypatching.
        self.ping_interval_s = PING_INTERVAL_S
        # gossip delta suppression (scaling fix, bench.py fleet_sim): on
        # the monitor cadence an UNCHANGED digest is only re-broadcast
        # every gossip_refresh_ticks ticks. The HealthStore TTL is 3
        # ticks, so a refresh every 2 keeps every peer's view fresh while
        # a steady-state fleet drops ~half its telemetry frames — and, at
        # N peers per node, N× that many decodes fleet-wide. Direct
        # gossip_telemetry() calls (tests, smoke gates, fleet actions)
        # always send; only the monitor loop passes tick=True.
        self.gossip_delta_enabled = True
        self.gossip_refresh_ticks = 2
        self._gossip_fp: str | None = None
        self._gossip_ticks_since_send = 0
        # pings carry a full get_system_metrics() sample (psutil + jax
        # device introspection). One sample per TICK is the scaling fix
        # (it used to run per PEER); large in-process sims turn it off
        # entirely — FakeService control planes have nothing to report
        self.ping_metrics_enabled = True
        self.health = HealthStore(ttl_s=3 * self.ping_interval_s, clock=self.clock)
        self.recorder = get_recorder()
        # load_slo_config raises on a malformed BEE2BEE_SLO_CONFIG — a
        # mis-typed SLO must fail the node at construction, not route on
        # garbage later
        self.slo = SloTracker(
            objectives=load_slo_config(), on_trip=self._on_slo_trip,
            clock=self.clock,
        )
        # fleet observatory (obs/): retained time-series on its own
        # sampling loop + trend watchdog. The trend digest it derives
        # rides the TELEMETRY gossip (telemetry_digest), the history
        # rides /metrics/history. BEE2BEE_OBS=0 disables the sampling
        # loop (the ring stays empty; every surface reports absence);
        # BEE2BEE_OBS_CADENCE_S overrides the 5 s default.
        self.obs_enabled = (os.environ.get("BEE2BEE_OBS") or "").strip() != "0"
        try:
            obs_cadence = float(
                os.environ.get("BEE2BEE_OBS_CADENCE_S") or 0
            ) or None
        except ValueError:
            obs_cadence = None
        self.obs = Observatory(
            node=self, clock=self.clock,
            **({"cadence_s": obs_cadence} if obs_cadence else {}),
        )

        # SLO-aware front door (router/): tenant identity + budgets from
        # BEE2BEE_TENANTS, telemetry-scored provider picking, and typed
        # 429/503 admission at both ingress surfaces. All three loaders
        # raise on malformed config — same fail-at-construction contract
        # as the SLO config above.
        self.tenants = TenantRegistry(load_tenant_config())
        self.router = RouterPolicy()
        self.prefixes = PrefixTracker()
        # live generation migration (meshnet/migrate.py): graceful drain,
        # disaggregated prefill→decode handoff, migration-based failover.
        # `draining` gates admission (typed 503) and rides the telemetry
        # digest so RouterPolicy stops routing here. `drain_source`
        # ("operator" | "fleet") rides alongside it: the fleet
        # controller's orphan scan reconciles only drains ITS OWN kind
        # started — an operator's deliberate /admin/drain is never
        # undrained or converted to standby out from under them.
        self.draining = False
        self.drain_source: str | None = None
        role = (
            disagg_role
            if disagg_role is not None
            else (os.environ.get("BEE2BEE_DISAGG") or "").strip().lower()
        ) or None
        if role not in (None, "prefill", "decode", "draft"):
            raise ValueError(
                f"disagg_role must be 'prefill', 'decode', 'draft' or "
                f"unset, got {role!r}"
            )
        self.disagg_role = role
        self.migration = MigrationManager(self)
        # mesh-tiered speculative decoding (meshnet/draft.py): a draft-role
        # node hosts the DraftServer (enable_draft_server at boot); serving
        # nodes whose engine runs the mesh drafter tier get a DraftClient
        # bound in add_service
        self.draft_server = None
        self.draft_client = None
        # peer ids EVER greeted (never pruned — only their first hello
        # re-anchors the lease boot grace, see _handle_hello)
        self._greeted: set[str] = set()
        # elastic fleet control (fleet/): lease bookkeeping + the
        # epoch-gated action handler live on EVERY node; only enabled
        # controllers compete for the lease and run the decision loop
        fstate = (
            fleet_state
            if fleet_state is not None
            else (os.environ.get("BEE2BEE_FLEET_STATE") or "").strip().lower()
        ) or None
        if fstate in ("active", "eligible"):
            fstate = None
        if fstate not in (None, "standby", "warming"):
            raise ValueError(
                f"fleet_state must be 'standby', 'warming' or unset, got {fstate!r}"
            )
        self.fleet_state = fstate
        self.fleet_provision_cb = None  # async (model) -> None: boots the
        # local service on activate (weights publish→DHT→fetch in real
        # deployments — meshnet.weights.serve_model_from_mesh)
        self.fleet = FleetController(self, enabled=fleet_controller)
        self.admission = AdmissionController(
            config=load_admission_config(),
            weights=self.tenants.weights(),
            budgets=self.tenants.budgets(),
            # this node's OWN burn state (not the process-global registry):
            # the monitor loop refreshes it on the ping cadence. A WARMING
            # fleet replica reports no burn: the router excludes it from
            # all routed traffic, so the only request it legitimately
            # sees is the controller's warm-up probe — and shedding the
            # probe that would relieve a fleet-wide burn (cold-start TTFT
            # spikes trip the SLO exactly then) would deadlock scale-out.
            # Queue/pool bounds still apply, same carve-out shape as
            # migration imports.
            slo_burn=lambda: (
                0.0 if self.fleet_state == "warming"
                else self.slo.max_fast_burn()
            ),
            pool_free_fraction=paged_pool_free_fraction,
            # pool-growth forecast (engine/introspect.py): sheds
            # pool_exhausted while Retry-After still buys the client
            # something, instead of waiting for the free-fraction floor
            pool_eta=pool_exhaust_eta,
            draining=lambda: self.draining,
            clock=self.clock,
        )

        # piece store: hash -> bytes (optionally spilled to piece_dir)
        self.piece_store: dict[str, bytes] = {}
        self.piece_dir = Path(piece_dir) if piece_dir else None
        self.manifests: dict[str, ShardManifest] = {}
        # weight/adapter distribution DHT (dht.DHTNode); the runtime (or a
        # test) attaches it — None means adapter paging falls back to
        # "resident adapters only" (ensure_adapter can't fetch)
        self.dht = None
        self._adapter_fetch_locks: dict[str, asyncio.Lock] = {}

        self._server = None
        self._lock = asyncio.Lock()  # guards peers/providers
        self._pending_lock = asyncio.Lock()  # guards _pending/_chunk_cbs
        self._pending: dict[str, asyncio.Future] = {}
        # request/task id -> the ws its reply rides on: a dropped
        # connection rejects its pending futures immediately instead of
        # stranding callers until their timeout (stage chains: 120 s)
        self._pending_ws: dict[str, Any] = {}
        self._chunk_cbs: dict[str, Callable[[str], None]] = {}
        self._tasks: list[asyncio.Task] = []
        self._serving: dict[Any, int] = {}  # ws -> in-flight spawned serves
        self._stopped = False
        self.started_at: float | None = None

        # auto-reconnect state (dial side only: the listener side of a lost
        # connection waits for the dialer to come back, so exactly one end
        # redials). Attributes, not module constants, so tests can shrink
        # the backoff without monkeypatching the module.
        self.reconnect_enabled = True
        self.reconnect_initial_s = RECONNECT_INITIAL_S
        self.reconnect_max_s = RECONNECT_MAX_S
        self.reconnect_window_s = RECONNECT_WINDOW_S
        self._dial_addr_by_ws: dict[Any, str] = {}  # outbound ws -> addr dialed
        self._dialing: set[str] = set()  # addrs with a dial in flight (dedup)
        self._pid_by_ws: dict[Any, str] = {}  # ws -> peer_id (O(1) _peer_for)
        # sockets our hello has gone out on (dial-time or as a reply). A
        # hello arriving on a ws NOT in this set must be answered even if
        # the peer is already known — the sender's end of that link stays
        # unidentified until our hello lands on it (a dual-dial winner or
        # post-drop redial left mute is a permanent half-open link; found
        # by the interleaving fuzzer, simnet.fuzz churn schedule 4)
        self._helloed_ws: set = set()
        self._pong_raw: tuple | None = None  # (ts, raw) last-encoded pong
        # scheme-less host:port — the wss→ws fallback changes the scheme of
        # the addr actually dialed, and a bootstrap peer must keep its
        # retry-forever status across that downgrade
        self._bootstrap_addrs: set[str] = set()
        # addr -> goodbye time. Entries expire after reconnect_window_s:
        # suppression only needs to outlive any redial loop for that addr,
        # and an unbounded set would leak on a churny public mesh
        self._departed: dict[str, float] = {}
        self._reconnecting: set[str] = set()

    @staticmethod
    def _addr_key(addr: str) -> str:
        return addr.split("://", 1)[-1]

    def _mark_departed(self, addr: str) -> None:
        now = self.clock.time()
        self._departed = {
            a: t for a, t in self._departed.items()
            if now - t < self.reconnect_window_s
        }
        self._departed[addr] = now

    def _is_departed(self, addr: str) -> bool:
        t = self._departed.get(addr)
        return t is not None and self.clock.time() - t < self.reconnect_window_s

    def _spawn(self, coro) -> asyncio.Task:
        """Track a background task: strong ref until done, self-pruning on
        completion (a churny mesh would otherwise grow _tasks without
        bound), exception surfaced through the task log instead of dying
        with the GC's "never retrieved" warning."""
        task = asyncio.create_task(coro)
        self._tasks.append(task)
        task.add_done_callback(self._reap_task)
        return task

    def _reap_task(self, task: asyncio.Task) -> None:
        if task in self._tasks:
            self._tasks.remove(task)
        log_task_exception(task)

    # ------------------------------------------------------------ lifecycle

    @property
    def addr(self) -> str:
        host = self.announce_host or (get_lan_ip() if self.host in ("0.0.0.0", "::") else self.host)
        port = self.announce_port or self.port
        # announce_scheme: "wss" when a TLS-terminating tunnel fronts us
        # (cloudflared — tunnel.apply_to_node); peers dial wss directly
        scheme = getattr(self, "announce_scheme", None) or "ws"
        return f"{scheme}://{host}:{port}"

    def join_link(self) -> str:
        return generate_join_link(self.peer_id, [self.addr])

    async def start(self):
        # the migration scheduler hook (a foreign thread) schedules async
        # work onto this loop — capture it once at boot
        self._loop = asyncio.get_running_loop()
        self._server = await self.transport.serve(
            self._handle_connection,
            self.host,
            self.port,
            max_size=protocol.MAX_FRAME,  # reference's 32 MiB cap
        )
        if self.port == 0:  # resolve ephemeral port
            self.port = next(iter(self._server.sockets)).getsockname()[1]
        self.started_at = self.clock.time()
        # the lease boot grace counts from JOINING the mesh, not from
        # construction — a slow build (first jit compile) must not eat it
        self.fleet.lease.reset_boot_grace(self.started_at)
        self._spawn(self._monitor_loop())
        if self.obs_enabled:
            self._spawn(self.obs.run(lambda: self._stopped))
        logger.info("node %s listening on %s", self.peer_id, self.addr)
        return self

    async def stop(self):
        self._stopped = True
        # a stopping leader releases its lease (zero TTL) so a follower
        # takes over immediately instead of waiting out the lapse
        with contextlib.suppress(Exception):
            await self.fleet.release()
        # fail outstanding migrations typed before sockets go away
        self.migration.close()
        if self.draft_server is not None:
            self.draft_server.close()
        if self.draft_client is not None:
            self.draft_client.close()
        # say goodbye and close sockets FIRST — cancelling reader tasks
        # first would purge the peer table before anything gets closed,
        # leaving outbound connections dangling on the remote side
        async with self._lock:
            peers = list(self.peers.values())
            self.peers.clear()
            self.providers.clear()
            self._pid_by_ws.clear()
        for info in peers:
            with contextlib.suppress(Exception):
                await info["ws"].send(protocol.encode(protocol.msg(protocol.GOODBYE, peer_id=self.peer_id)))
                await info["ws"].close()
        # iterate copies: _spawn's done-callbacks remove finished tasks from
        # self._tasks, which would skip entries mid-iteration
        for t in list(self._tasks):
            t.cancel()
        for t in list(self._tasks):
            with contextlib.suppress(asyncio.CancelledError):
                await t
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        async with self._pending_lock:
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(RuntimeError("node_stopped"))
            self._pending.clear()
            self._pending_ws.clear()
            self._chunk_cbs.clear()

    # ------------------------------------------------------------ connections

    async def _handle_connection(self, ws):
        """Inbound connection: read messages until close."""
        try:
            await self._reader(ws)
        except (self.transport.exceptions.ConnectionClosed, OSError):
            pass  # unclean peer death is normal mesh weather
        finally:
            await self._drop_peer(ws)

    async def _connect_peer(self, addr: str) -> bool:
        async with self._lock:
            if any(p.get("addr") == addr for p in self.peers.values()):
                return True
        if addr == self.addr:
            return False
        # in-flight dedup (scaling fix): during a join burst the same addr
        # arrives from several peer_lists before the first dial's hello-ack
        # registers the peer — without this, every mention opens another
        # socket and the remote logs an identity_rebind incident per extra
        # dial. The entry lives until _drop_peer (the peers-table check
        # above takes over once the ack lands), so a dropped link redials.
        if addr in self._dialing:
            return True
        self._dialing.add(addr)
        try:
            ws = await self.transport.dial(
                addr, max_size=protocol.MAX_FRAME, open_timeout=10
            )
        except Exception as e:
            self._dialing.discard(addr)  # meshlint: ignore[ML-R003] -- claim-release dedup: addr claimed before the dial await, released only by its claimant
            # wss→ws fallback mirrors the reference (p2p_runtime.py:353-361)
            if addr.startswith("wss://"):
                return await self._connect_peer("ws://" + addr[6:])
            logger.warning("connect %s failed: %s", addr, e)
            return False
        self._dial_addr_by_ws[ws] = addr  # meshlint: ignore[ML-R003] -- ws-keyed: each socket object has exactly one writer (its dialer/reader)
        self._departed.pop(addr, None)  # meshlint: ignore[ML-R003] -- last-writer-wins by design: a fresh dial resets a past goodbye
        try:
            await self._send(ws, self._hello_msg())
            self._helloed_ws.add(ws)  # meshlint: ignore[ML-R003] -- ws-keyed: each socket's hello lifecycle has one writer (its dialer or its reader), and set add/discard are atomic on the loop
        except Exception as e:
            # peer accepted the socket but died before hello (mid-shutdown):
            # treat as a failed dial, not a raise — _reconnect_loop must see
            # False and keep backing off, and the dial record must not leak
            self._dial_addr_by_ws.pop(ws, None)
            self._dialing.discard(addr)
            with contextlib.suppress(Exception):
                await ws.close()
            logger.warning("hello to %s failed: %s", addr, e)
            return False

        async def run_reader():
            try:
                await self._reader(ws)
            except (self.transport.exceptions.ConnectionClosed, OSError):
                pass  # unclean drop: _drop_peer schedules the redial
            finally:
                await self._drop_peer(ws)

        self._spawn(run_reader())
        return True

    async def connect_bootstrap(self, link_or_addr: str) -> bool:
        """Join the mesh via a ws:// addr or a join link."""
        if "://" in link_or_addr and link_or_addr.split("://")[0] not in ("ws", "wss"):
            info = parse_join_link(link_or_addr)
            for addr in info["bootstrap_addrs"]:
                if await self._connect_peer(addr):
                    self._bootstrap_addrs.add(self._addr_key(addr))
                    return True
            return False
        if await self._connect_peer(link_or_addr):
            self._bootstrap_addrs.add(self._addr_key(link_or_addr))
            return True
        return False

    async def _reader(self, ws):
        async for raw in ws:
            try:
                if isinstance(raw, bytes):
                    data, tensors = protocol.decode_binary(raw)
                    data["_tensors"] = tensors
                else:
                    data = protocol.decode(raw)
            except ValueError as e:
                logger.warning("bad frame from peer: %s", e)
                continue
            op = data.get("type")
            if op not in protocol.MESSAGE_TYPES:
                # the type string is PEER-CONTROLLED: clamping unknown ops
                # to one bucket keeps the label set (and the series table)
                # bounded no matter what a hostile peer sends
                op = "other"
            incs = _FRAME_RECV_INCS.get(op)
            if incs is None:  # bounded: op clamped above (see _send_raw)
                incs = _FRAME_RECV_INCS[op] = (
                    _C_FRAMES_RECV.bind(op=op),
                    _C_BYTES_RECV.bind(op=op),
                )
            incs[0]()
            incs[1](_frame_bytes(raw))
            if op in _NOTABLE_OPS:  # frame-op events land in the incident ring
                self.recorder.record(
                    "frame", op=op, peer=data.get("peer_id"),
                    error=data.get("error"),
                )
            try:
                await self._on_message(ws, data)
            except Exception:
                logger.exception("handler error for %s", data.get("type"))

    async def _drop_peer(self, ws):
        # migrations riding this connection fail typed NOW (the fallback
        # ladder re-prefills elsewhere instead of waiting out a timeout)
        self.migration.on_ws_drop(ws)
        # mesh drafter: re-pick another draft peer or degrade typed
        if self.draft_client is not None:
            self.draft_client.on_ws_drop(ws)
        async with self._lock:
            dead = [pid for pid, info in self.peers.items() if info["ws"] is ws]
            for pid in dead:
                self.peers.pop(pid, None)
                self.providers.pop(pid, None)
            self._pid_by_ws.pop(ws, None)
        self._helloed_ws.discard(ws)
        for pid in dead:
            logger.info("peer %s disconnected", pid)
        # fail fast anything awaiting a reply on this connection — the
        # reply can no longer arrive, and callers would otherwise hang
        # until their own timeout
        async with self._pending_lock:
            orphaned = [k for k, w in self._pending_ws.items() if w is ws]
            for key in orphaned:
                self._pending_ws.pop(key, None)
                fut = self._pending.get(key)
                if fut and not fut.done():
                    # typed: a stage chain awaiting this reply classifies
                    # the loss as a DEAD stage (StageDead subclasses
                    # RuntimeError, so non-pipeline callers are unchanged)
                    fut.set_exception(
                        StageDead("peer connection lost mid-request")
                    )
        # we dialed this connection: redial unless the peer said goodbye
        # (or we are shutting down). Inbound connections are the remote
        # dialer's job to restore.
        dial_addr = self._dial_addr_by_ws.pop(ws, None)
        if dial_addr:
            self._dialing.discard(dial_addr)  # a future dial is legitimate
        if (
            dial_addr
            and self.reconnect_enabled
            and not self._stopped
            and not self._is_departed(dial_addr)
            and dial_addr not in self._reconnecting
        ):
            self._spawn(self._reconnect_loop(dial_addr))

    async def _reconnect_loop(self, addr: str):
        """Redial `addr` with exponential backoff. Bootstrap addrs retry
        until stop(); ordinary peers give up after reconnect_window_s."""
        if addr in self._reconnecting:
            return
        self._reconnecting.add(addr)
        try:
            delay = self.reconnect_initial_s
            deadline = (
                None
                if self._addr_key(addr) in self._bootstrap_addrs
                else self.clock.time() + self.reconnect_window_s
            )
            while not self._stopped:
                await self.clock.sleep(delay)
                if self._stopped or self._is_departed(addr):
                    return
                if await self._connect_peer(addr):
                    logger.info("reconnected to %s", addr)
                    return
                if deadline is not None and self.clock.time() >= deadline:
                    logger.info("giving up reconnecting to %s", addr)
                    return
                delay = min(delay * 2, self.reconnect_max_s)
        finally:
            self._reconnecting.discard(addr)  # meshlint: ignore[ML-R003] -- claim-release dedup set: claimed before the backoff loop, released in finally

    # ------------------------------------------------------------ sending

    async def _send(self, ws, message: dict | bytes):
        raw = message if isinstance(message, bytes) else protocol.encode(message)
        # pre-encoded binary tensor frames would cost a header decode to
        # attribute; they count under one "tensor" op instead
        op = message.get("type") if isinstance(message, dict) else "tensor"
        await self._send_raw(ws, raw, op)

    async def _send_raw(self, ws, raw: str | bytes, op):
        if op not in protocol.MESSAGE_TYPES and op != "tensor":
            op = "other"  # keep the label set bounded (see _listen)
        # bound per-op series (metrics.Counter.bind): this runs per frame
        # on the wire, and re-resolving the label key each time was a
        # visible slice of a large fleet's gossip tick. Bounded: op is
        # clamped to the protocol's type set just above.
        incs = _FRAME_SENT_INCS.get(op)
        if incs is None:
            incs = _FRAME_SENT_INCS[op] = (
                _C_FRAMES_SENT.bind(op=op),
                _C_BYTES_SENT.bind(op=op),
            )
        incs[0]()
        # len(raw) IS the wire size here: bytes frames trivially, and text
        # frames because protocol.encode emits pure-ASCII JSON (see
        # _frame_bytes) — no re-encode on the send hot path
        incs[1](len(raw))
        await ws.send(raw)

    async def broadcast(self, message: dict):
        async with self._lock:
            targets = [info["ws"] for info in self.peers.values()]
        if not targets:
            return 0
        # scaling fix (sim-measured, bench.py fleet_sim): encode ONCE and
        # fan the raw frame out. The old per-peer _send re-ran
        # protocol.encode per recipient, which made each gossip tick cost
        # O(peers) JSON serializations per node — O(N²) encodes fleet-wide
        # for a frame whose bytes are identical at every peer.
        raw = protocol.encode(message)
        op = message.get("type")
        results = await asyncio.gather(
            *(self._send_raw(ws, raw, op) for ws in targets),
            return_exceptions=True,
        )
        return sum(1 for r in results if not isinstance(r, Exception))

    # ------------------------------------------------------------ hello/gossip

    def _hello_msg(self) -> dict:
        return protocol.msg(
            protocol.HELLO,
            peer_id=self.peer_id,
            addr=self.addr,
            region=self.region,
            # same gate as the ping sample: sims run engine-less control
            # planes, and a psutil snapshot's digits would make hello
            # frame sizes differ between same-seed replays
            metrics=get_system_metrics(self.throughput)
            if self.ping_metrics_enabled
            else {},
            services={n: s.get_metadata() for n, s in self.local_services.items()},
            api_port=self.api_port,
            api_host=self.announce_host or get_lan_ip(),
            accepts_stages=self.accept_stages,
        )

    # type -> handler ATTRIBUTE NAME: dispatch goes through getattr on
    # every message so chaos tooling (and tests) can monkeypatch a
    # node's `_handle_*` method and be seen immediately — while the
    # table itself is built once, not per frame (scaling fix: the old
    # per-message dict literal re-created 26 bound methods per frame,
    # a measurable slice of a large fleet's gossip tick)
    _HANDLER_NAMES = {
        protocol.HELLO: "_handle_hello",
        protocol.PEER_LIST: "_handle_peer_list",
        protocol.PING: "_handle_ping",
        protocol.PONG: "_handle_pong",
        protocol.SERVICE_ANNOUNCE: "_handle_service_announce",
        protocol.GEN_REQUEST: "_handle_gen_request",
        protocol.GEN_CHUNK: "_handle_gen_chunk",
        protocol.GEN_SUCCESS: "_handle_gen_result",
        protocol.GEN_RESULT: "_handle_gen_result",
        protocol.GEN_ERROR: "_handle_gen_result",
        protocol.PIECE_REQUEST: "_handle_piece_request",
        protocol.PIECE_DATA: "_handle_piece_data",
        protocol.PIECE_HAVE: "_handle_piece_have",
        protocol.GOODBYE: "_handle_goodbye",
        protocol.TELEMETRY: "_handle_telemetry",
        protocol.KV_EXPORT: "_handle_kv_export",
        protocol.KV_BLOCKS: "_handle_kv_blocks",
        protocol.KV_IMPORT_ACK: "_handle_kv_import_ack",
        protocol.FLEET_LEASE: "_handle_fleet_lease",
        protocol.FLEET_ACTION: "_handle_fleet_action",
        protocol.FLEET_ACK: "_handle_fleet_ack",
        protocol.ADAPTER_ANNOUNCE: "_handle_adapter_announce",
        protocol.DRAFT_REQUEST: "_handle_draft_request",
        protocol.DRAFT_RESULT: "_handle_draft_result",
        protocol.TASK: "_handle_task",
        protocol.RESULT: "_handle_result",
        protocol.TASK_ERROR: "_handle_result",
    }

    async def _on_message(self, ws, data: dict):
        name = self._HANDLER_NAMES.get(data.get("type"))
        handler = getattr(self, name) if name else None
        if handler is None:
            logger.debug("unknown message type %r", data.get("type"))
            return
        # Serving handlers run as tasks so one long generation (or stage
        # forward) never blocks this connection's reader — that's what lets
        # concurrent gen_requests batch into one PipelineSession/engine
        # batch, and lets a stage worker overlap tasks for different
        # requests (pipeline microbatching). Bounded per connection: past
        # the cap the handler runs inline, so the reader stops pulling
        # frames and TCP backpressure paces a flooding peer instead of
        # unbounded tasks/threads. Everything else stays inline:
        # gen_chunk/result ordering is part of the streaming contract.
        # FLEET_ACTION joins the spawned set: an `activate` runs the
        # node's provision hook (weight fetch — slow), and the reader
        # must keep pumping pings/telemetry meanwhile
        if data.get("type") in (
            protocol.GEN_REQUEST, protocol.TASK, protocol.FLEET_ACTION
        ):
            if self._serving.get(ws, 0) >= MAX_CONCURRENT_SERVES_PER_CONN:
                await handler(ws, data)
                return
            self._serving[ws] = self._serving.get(ws, 0) + 1

            def _served(_t, ws=ws):
                left = self._serving.get(ws, 1) - 1
                if left <= 0:
                    self._serving.pop(ws, None)
                else:
                    self._serving[ws] = left

            self._spawn(handler(ws, data)).add_done_callback(_served)
            return
        await handler(ws, data)

    async def _handle_hello(self, ws, data):
        pid = data.get("peer_id")
        if not pid or pid == self.peer_id:
            return
        known = False
        async with self._lock:
            prev = self.peers.get(pid)
            known = prev is not None
            # identity is HELLO-claimed, not cryptographic: a hello that
            # rebinds a peer id away from a LIVE connection is either a
            # simultaneous dual-dial converging or an impersonation
            # attempt (docs/ROBUSTNESS.md scopes the fleet control
            # plane's guarantees to this identity model) — allow it for
            # the former, but never silently
            live_rebind = (
                prev is not None
                and prev.get("ws") is not ws
                and self.clock.time() - prev.get("last_seen", 0.0)
                <= 3 * self.ping_interval_s
            )
            # dual-dial tie-break: when both sides dialed each other
            # concurrently, each holds one outbound and one inbound
            # connection to the same peer — and "latest hello wins" lets
            # the two ends settle on DIFFERENT sockets. Pongs echo on
            # whatever socket the ping rode, so liveness stays green,
            # but every identity-resolved inbound frame (telemetry,
            # fleet ops, tasks) resolves `_peer_for() -> None` and is
            # dropped forever: a silent half-deaf link (found by the
            # simnet split-brain scenario). Both ends instead keep the
            # connection DIALED BY THE LOWER peer id — a rule each side
            # can evaluate locally (dialed-by-me ⇔ in _dial_addr_by_ws)
            # with the same result — and close the loser.
            loser_ws = None
            if live_rebind:
                new_out = ws in self._dial_addr_by_ws
                old_out = prev.get("ws") in self._dial_addr_by_ws
                if new_out != old_out:
                    keep_out = self.peer_id < pid
                    loser_ws = ws if old_out == keep_out else prev.get("ws")
            if loser_ws is ws:
                # canonical registration survives on the previous socket;
                # this hello still proves liveness and may carry services
                prev["health"] = "online"
                prev["last_seen"] = self.clock.time()
                services = data.get("services") or {}
                if services:
                    self.providers.setdefault(pid, {}).update(services)
            else:
                if prev is not None and prev.get("ws") is not ws:
                    self._pid_by_ws.pop(prev.get("ws"), None)
                self._pid_by_ws[ws] = pid
                self.peers[pid] = {
                    "ws": ws,
                    "addr": data.get("addr"),
                    "region": data.get("region"),
                    "metrics": data.get("metrics") or {},
                    "api_port": data.get("api_port"),
                    "api_host": data.get("api_host"),
                    # failover replacement candidates rank by this (pre-taxonomy
                    # peers omit it → still eligible, just deprioritized)
                    "accepts_stages": bool(data.get("accepts_stages")),
                    "health": "online",
                    "last_seen": self.clock.time(),
                    "rtt_ms": prev.get("rtt_ms") if prev else None,
                }
                services = data.get("services") or {}
                if services:
                    self.providers.setdefault(pid, {}).update(services)
            peer_addrs = [p["addr"] for p in self.peers.values() if p.get("addr")]
        if loser_ws is not None:
            # the losing socket's dialer will short-circuit its redial:
            # _connect_peer sees the peer already registered by addr
            logger.info("dual-dial with %s converged; closing extra link", pid)
            with contextlib.suppress(Exception):
                await loser_ws.close()
        elif live_rebind:
            logger.warning(
                "hello rebinds %s away from a live connection", pid
            )
            self.recorder.incident(
                "mesh:identity_rebind",
                detail=f"hello re-registered {pid} over a new connection "
                       "while its previous link was live",
                node=self.peer_id,
            )
        if not known:
            if pid not in self._greeted:
                # first contact with a NEVER-seen peer re-anchors the
                # lease boot grace (while no lease has ever been
                # observed): a node whose bootstrap dial stalled past
                # one TTL after start() must not claim the instant it
                # finally joins — it owes the incumbent's gossip one
                # full TTL of listening first. The ever-greeted set
                # keeps a flapping link (drop + re-hello faster than
                # one TTL) from deferring the first election forever.
                self._greeted.add(pid)
                self.fleet.lease.reset_boot_grace()
        # reply whenever OUR hello has never gone out on THIS socket:
        # first contact, or a hello from an already-known peer over a new
        # link (a dual-dial winner we only ever helloed on the loser we
        # closed, or a redial after a one-sided drop). Replying only on
        # first contact leaves those links mute — the other end never
        # receives our hello, never registers us, and the link stays
        # half-open forever while this end keeps serving a live
        # registration (found by the interleaving fuzzer: simnet.fuzz
        # churn scenario, a dual-dial loser's FIN racing the winner's
        # hello). No ping-pong: our reply lands on a socket the peer has
        # already helloed on, so the peer stays quiet.
        if not known or ws not in self._helloed_ws:
            self._helloed_ws.add(ws)
            await self._send(ws, self._hello_msg())
            await self._send(ws, protocol.msg(protocol.PEER_LIST, peers=peer_addrs))

    async def _handle_peer_list(self, ws, data):
        # prefilter against already-connected / in-flight addrs ONCE per
        # list (scaling fix): during a join burst every edge handshake
        # carries a full peer list, so spawning a dial task per mention —
        # each redoing an O(peers) scan under the lock — is O(N³) work
        # fleet-wide. One set build per list makes the steady-state cost
        # of a redundant peer list O(N) and spawns only genuinely new dials.
        addrs = data.get("peers") or []
        async with self._lock:
            connected = {p.get("addr") for p in self.peers.values()}
        # connect concurrently off the reader task: a serial await here would
        # stall all message processing on this connection for up to
        # open_timeout per dead address in a churned peer list
        for addr in addrs:
            if (
                addr
                and addr != self.addr
                and addr not in connected
                and addr not in self._dialing
            ):
                self._spawn(self._connect_peer_quiet(addr))

    async def _connect_peer_quiet(self, addr: str):
        with contextlib.suppress(Exception):
            await self._connect_peer(addr)

    async def _handle_ping(self, ws, data):
        pid = await self._peer_for(ws)
        if pid and data.get("metrics"):
            async with self._lock:
                if pid in self.peers:
                    self.peers[pid]["metrics"] = data["metrics"]
                    self.peers[pid]["last_seen"] = self.clock.time()
        # a pong's bytes are a pure function of the echoed ts, and a ping
        # burst from one sender tick shares its ts — one-slot encode cache
        # (cache-miss cost is a tuple compare, so the unsynchronized
        # production case loses nothing)
        ts = data.get("ts")
        cached = self._pong_raw
        if cached is None or cached[0] != ts:
            cached = (ts, protocol.encode(protocol.msg(protocol.PONG, ts=ts)))
            self._pong_raw = cached
        await self._send_raw(ws, cached[1], protocol.PONG)

    async def _handle_pong(self, ws, data):
        pid = await self._peer_for(ws)
        ts = data.get("ts")
        if pid and isinstance(ts, (int, float)):
            rtt = (self.clock.time() - ts) * 1000.0
            async with self._lock:
                if pid in self.peers:
                    self.peers[pid]["rtt_ms"] = round(rtt, 2)
                    self.peers[pid]["health"] = "online"
                    self.peers[pid]["last_seen"] = self.clock.time()

    async def _handle_service_announce(self, ws, data):
        svc, meta = data.get("service"), data.get("meta") or {}
        pid = await self._peer_for(ws)
        if pid and svc:
            async with self._lock:
                self.providers.setdefault(pid, {})[svc] = meta

    async def _handle_goodbye(self, ws, data):
        # clean departure: suppress the redial loop for this address —
        # EXCEPT for bootstrap addrs, whose goodbye is normally a graceful
        # restart (stop() sends GOODBYE): losing the bootstrap forever on
        # every deploy would strand the node outside the mesh
        addr = self._dial_addr_by_ws.get(ws)
        if addr and self._addr_key(addr) not in self._bootstrap_addrs:
            self._mark_departed(addr)
        # a clean departure also retires the peer's health digest at once;
        # an UNCLEAN drop keeps it until the staleness TTL, so a flapping
        # peer's last reading survives the reconnect window
        pid = await self._peer_for(ws)
        if pid:
            self.health.drop(pid)
        await self._drop_peer(ws)

    # ------------------------------------------------------------ health plane

    def telemetry_digest(self) -> dict:
        """This node's gossip digest: the metrics-registry summary
        (health.build_digest) plus node-local context the registry can't
        see — peer RTTs and the latest SLO brief."""
        digest = build_digest()
        # sync snapshot of the peer table (same pattern as peer_for_addr):
        # safe on the loop thread, and list() guards executor callers
        rtts = {
            pid: info.get("rtt_ms")
            for pid, info in list(self.peers.items())
            if info.get("rtt_ms") is not None
        }
        if rtts:
            digest["peer_rtt_ms"] = rtts
        slo = self.slo.brief()
        if slo:
            digest["slo"] = slo
        # prefix-cache locality hints (router/prefixmap.py): the chained
        # leading-block hashes of recently-served prompts, so peers can
        # route repeat prefixes here and hit the CoW prefix cache
        prefixes = self.prefixes.advertised()
        if prefixes:
            digest["prefix_hashes"] = prefixes
        # KV-pool identity: cache dtype + effective
        # capacity ride the digest, KEYED BY SERVICE (a node may host a
        # bf16-pool and an int8-pool engine side by side), so
        # /mesh/health and the router can see WHICH peers run the
        # doubled int8 pool — the raw block-count gauges alone can't say
        # what a block's bytes buy
        kv_info = {}
        for name, svc in list(self.local_services.items()):
            eng = getattr(svc, "engine", None)
            if eng is not None:
                try:
                    kv_info[str(name)] = eng.kv_info
                except Exception:  # noqa: BLE001 — telemetry must not
                    # fail the gossip loop on an engine mid-teardown
                    pass
        if kv_info:
            digest["kv"] = kv_info
        # adapter residency (adapters/): the router's placement input —
        # a peer already holding the requested adapter skips the fetch +
        # pool churn, so RouterPolicy credits it (never past an outright
        # loaded node, same tolerance discipline as the prefix bonus)
        adapter_info = {}
        for name, svc in list(self.local_services.items()):
            eng = getattr(svc, "engine", None)
            if eng is not None:
                try:
                    resident = eng.resident_adapters()
                except Exception:  # noqa: BLE001 — telemetry never throws
                    resident = []
                if resident:
                    adapter_info[str(name)] = resident
        if adapter_info:
            digest["adapters"] = adapter_info
        # drain state rides the digest so RouterPolicy excludes draining
        # peers on the same gossip the rest of the scoring reads; the
        # disagg role is how prefill nodes find decode-designated targets
        if self.draining:
            digest["draining"] = True
            if self.drain_source:
                digest["drain_source"] = self.drain_source
        if self.disagg_role:
            digest["disagg_role"] = self.disagg_role
        # elastic fleet (fleet/): a standby/warming replica advertises
        # its state so routers and the migration plane exclude it, and
        # controller-eligible nodes advertise themselves so takeover
        # ranks are computed over the LIVE controller set
        if self.fleet_state:
            digest["fleet_state"] = self.fleet_state
        if self.fleet.enabled:
            digest["fleet_controller"] = True
        # trend digest (obs/): window mean + relative slope + anomaly
        # flags per retained series — what the router's degrading
        # penalty and the controller's pool forecast read off peers
        trend = self.obs.trend_digest()
        if trend is not None:
            digest["trend"] = trend
        return digest

    async def gossip_telemetry(self, tick: bool = False) -> int:
        """Broadcast this node's digest as one TELEMETRY frame; returns the
        number of peers reached. Rides the ping cadence (_monitor_loop) but
        is callable directly (tests, smoke gates) for deterministic gossip.

        tick=True applies delta suppression (see __init__): an unchanged
        digest is skipped until gossip_refresh_ticks ticks have passed
        since the last send. The fingerprint excludes the "ts" stamp and
        the per-peer RTT block — both are measurement noise that changes
        on EVERY tick (RTT jitters by design), and either would defeat
        the comparison forever. Peers still get fresh RTTs on each
        refresh tick, so RTT staleness is bounded at gossip_refresh_ticks
        ticks; anything operationally actionable (counters, gauges,
        histograms, draining/fleet state) re-gossips immediately. The
        "trend" block is excluded for the same reason — its window means
        drift a little every sample by construction, and including it
        would re-defeat the suppression the fleet_sim bench exists to
        hold — so trend staleness at peers is bounded by the same
        gossip_refresh_ticks deal RTTs get."""
        digest = self.telemetry_digest()
        if tick and self.gossip_delta_enabled:
            body = {
                k: v for k, v in digest.items()
                if k not in ("ts", "peer_rtt_ms", "trend")
            }
            fp = json.dumps(body, sort_keys=True, default=str)
            if (
                fp == self._gossip_fp
                and self._gossip_ticks_since_send + 1 < self.gossip_refresh_ticks
            ):
                self._gossip_ticks_since_send += 1
                _C_GOSSIP_SUPPRESSED.inc()
                return 0
            self._gossip_fp = fp
            self._gossip_ticks_since_send = 0
        return await self.broadcast(
            protocol.msg(
                protocol.TELEMETRY,
                peer_id=self.peer_id,
                digest=digest,
            )
        )

    async def _handle_telemetry(self, ws, data):
        # identity comes from the CONNECTION (hello handshake), not the
        # frame's peer_id claim — a peer cannot overwrite another peer's
        # digest by lying in the payload
        pid = await self._peer_for(ws)
        digest = data.get("digest")
        if pid and isinstance(digest, dict):
            self.health.update(pid, digest)

    def _on_slo_trip(self, objective, entry: dict) -> None:
        """SloTracker trip hook: snapshot an incident bundle. The kind is
        per-objective (bounded by the configured objective list) so one
        burning objective's cooldown never masks a different one."""
        self.recorder.incident(
            "slo:" + objective.name,
            detail=f"burn rate fast={entry.get('burn_rate_fast')} "
                   f"slow={entry.get('burn_rate_slow')}",
            node=self.peer_id,
            extra=entry,
        )

    def peer_for_addr(self, addr: str) -> str | None:
        """peer_id for a dialed OR announced address (scheme-insensitive).
        A dialed peer may announce a different host than we dialed
        (loopback dial vs LAN announce), so both are checked.

        Sync on purpose (callers aren't async) — safe because a sync
        method on the loop thread can't interleave with the async
        mutators; the list() snapshot keeps it safe even if a future
        refactor calls this from an executor thread."""
        key = self._addr_key(addr)
        for pid, info in list(self.peers.items()):
            dial = self._dial_addr_by_ws.get(info.get("ws"))
            if dial and self._addr_key(dial) == key:
                return pid
            if info.get("addr") and self._addr_key(info["addr"]) == key:
                return pid
        return None

    async def _peer_for(self, ws) -> str | None:
        # reverse map maintained by _handle_hello/_drop_peer/stop
        # (scaling fix): this runs for EVERY ping/pong/telemetry receipt,
        # and the old linear peers scan made each gossip tick O(peers²)
        # per node — the dominant per-tick cost at fleet scale
        async with self._lock:
            pid = self._pid_by_ws.get(ws)
            if pid is not None and self.peers.get(pid, {}).get("ws") is ws:
                return pid
            # slow path: direct writes into node.peers (tests, chaos
            # tooling) bypass the map — fall back to the scan and repair
            for pid, info in self.peers.items():
                if info["ws"] is ws:
                    self._pid_by_ws[ws] = pid
                    return pid
        return None

    # ------------------------------------------------------------ services

    def add_service(self, svc) -> None:
        self.local_services[svc.name] = svc
        # ONE tenant-weight source: an engine-backed service's scheduler
        # adopts this node's resolved registry (its constructor only
        # env-seeds the same config; a runtime-replaced TenantRegistry
        # would otherwise drift from the engine's WDRR weights)
        sched = getattr(getattr(svc, "engine", None), "scheduler", None)
        if sched is not None and hasattr(sched, "set_tenant_weights"):
            sched.set_tenant_weights(self.tenants.weights())
        # live-migration hook: drain/handoff/pool-pressure rows leave via
        # this node's migration plane (no-op for engine-less services)
        self.migration.wire_scheduler(svc)
        # mesh drafter tier (BEE2BEE_DRAFTER=mesh): bind the scheduler's
        # MeshDrafter to this node's transport so drafts stream from a
        # draft-role peer (wire_scheduler above already forced the lazy
        # scheduler into existence for engine-backed services)
        md = getattr(sched, "mesh_drafter", None)
        if md is not None:
            from .draft import DraftClient

            if self.draft_client is None:
                self.draft_client = DraftClient(self)
            self.draft_client.bind(md)

    def enable_draft_server(self, model: str, spec_tokens: int = 6,
                            **kw) -> None:
        """Host the drafter program on this node (the `draft` disagg
        role). Loads the draft model NOW so a bad spec fails the node
        typed at boot, never at the first frame."""
        from .draft import DraftServer

        self.draft_server = DraftServer(
            self, model, spec_tokens=spec_tokens, **kw
        )

    async def _handle_draft_request(self, ws, data):
        srv = self.draft_server
        if srv is None:
            # not a draft node (stale gossip routed here): typed refusal
            # — the client books a failure and degrades to its local tier
            if not data.get("done"):
                await self._send(ws, protocol.msg(
                    protocol.DRAFT_RESULT,
                    rid=str(data.get("rid") or ""), error="no_drafter",
                ))
            return
        pid = await self._peer_for(ws)
        srv.submit(ws, pid or "?", data)

    async def _handle_draft_result(self, ws, data):
        if self.draft_client is not None:
            self.draft_client.deliver(data)

    async def announce_service(self, svc) -> int:
        self.add_service(svc)
        return await self.broadcast(
            protocol.msg(protocol.SERVICE_ANNOUNCE, service=svc.name, meta=svc.get_metadata())
        )

    async def announce_adapters(self, svc) -> int:
        """Broadcast the service's CURRENT adapter residency (hot-swap
        fetch/evict) so peers' provider tables track the per-adapter
        model names without waiting for a re-hello."""
        meta = svc.get_metadata()
        return await self.broadcast(protocol.msg(
            protocol.ADAPTER_ANNOUNCE,
            peer_id=self.peer_id,
            service=svc.name,
            adapters=meta.get("adapters") or [],
            models=meta.get("models") or [],
        ))

    async def _handle_adapter_announce(self, ws, data):
        # like telemetry: identity comes from the CONNECTION, not the
        # frame's peer_id claim
        pid = await self._peer_for(ws)
        svc = data.get("service")
        names = data.get("adapters")
        if not pid or not svc or not isinstance(names, list):
            return
        async with self._lock:
            meta = self.providers.setdefault(pid, {}).setdefault(str(svc), {})
            meta["adapters"] = [str(n) for n in names[:64]]
            models = data.get("models")
            if isinstance(models, list) and models:
                meta["models"] = [str(m) for m in models[:256]]

    async def ensure_adapter(self, svc, name: str) -> bool:
        """Resolve one adapter for an engine-backed service: already
        resident → True; otherwise PAGE it in over the mesh (DHT manifest
        → sha256-verified pieces → AdapterPool, LRU-evicting a cold
        adapter) without restarting the engine, then re-announce
        residency. False = unknown adapter (the caller answers the typed
        404 / unknown_adapter). AdapterPoolBusy propagates — every slot
        pinned by in-flight rows is BACKPRESSURE on a valid adapter, and
        collapsing it to False would tell the client a published adapter
        does not exist (a 404 an SDK will never retry). Concurrent
        requests for the same adapter share one fetch via a per-name
        lock."""
        engine = getattr(svc, "engine", None)
        if engine is None or getattr(engine, "adapter_pool", None) is None:
            return False
        if engine.has_adapter(name):
            return True
        if self.dht is None:
            return False
        lock = self._adapter_fetch_locks.setdefault(name, asyncio.Lock())
        try:
            async with lock:
                if engine.has_adapter(name):
                    return True
                base = engine.model_cfg.name
                from ..adapters import (  # adapters/distrib.py
                    UnknownAdapterManifest,
                    fetch_adapter,
                )

                try:
                    with get_tracer().span(
                        "adapter.fetch", adapter=name, model=base
                    ):
                        adapters, lcfg = await fetch_adapter(
                            self, self.dht, base, name,
                            model_cfg=engine.model_cfg,
                        )
                        # load on an executor: the device write +
                        # validation must not park the mesh reader loop
                        await asyncio.get_running_loop().run_in_executor(
                            None,
                            lambda: engine.load_adapter(name, adapters, lcfg),
                        )
                except UnknownAdapterManifest:
                    # nobody published this name: the typed-404 case, not
                    # an infrastructure failure — no incident
                    logger.info("adapter %r: no manifest on the DHT", name)
                    return False
                except AdapterPoolBusy:
                    # transient: every slot has in-flight rows. Not a
                    # fetch failure (no incident) and NOT unknown — the
                    # caller maps it onto the pool_exhausted shed
                    raise
                except Exception as e:  # noqa: BLE001 — fetch/verify/pool
                    self.recorder.incident(
                        "adapter:fetch_failed",
                        detail=str(e),
                        node=self.peer_id,
                        extra={"adapter": name, "model": base},
                    )
                    logger.warning("adapter %r fetch failed: %s", name, e)
                    return False
                self._spawn(self.announce_adapters(svc))
                return True
        finally:
            # never let wire-chosen names accumulate state: the lock only
            # matters while a fetch is in flight. Waiters still hold their
            # reference to this lock object; a post-pop arrival creating a
            # fresh lock can at worst duplicate a fetch (benign — the
            # in-lock has_adapter re-check absorbs it).
            if not lock.locked():
                self._adapter_fetch_locks.pop(name, None)

    def list_providers(self, model: str | None = None) -> list[dict]:
        """Flatten local + remote providers (reference p2p_runtime.py:687-721)."""
        out = []
        for name, svc in self.local_services.items():
            meta = svc.get_metadata()
            out.append({"provider_id": self.peer_id, "service": name, "local": True, **meta})
        for pid, svcs in self.providers.items():
            peer = self.peers.get(pid, {})
            for name, meta in svcs.items():
                out.append(
                    {
                        "provider_id": pid,
                        "service": name,
                        "local": False,
                        "_latency": peer.get("rtt_ms"),
                        "health": peer.get("health"),
                        **meta,
                    }
                )
        if model:
            out = [
                p for p in out
                if any(model.lower() in m.lower() or m.lower() in model.lower() for m in p.get("models", []))
            ]
        return out

    def pick_provider(
        self,
        model: str | None = None,
        prompt: str | None = None,
        exclude=(),
        remote_only: bool = False,
        adapter: str | None = None,
    ) -> dict | None:
        """Telemetry-scored provider pick (router/policy.py): queue-wait,
        batch-fill headroom, paged-pool pressure, SLO burn state, RTT and
        prompt-prefix locality from the gossiped health digests. Falls
        back to the reference's static cheapest-then-lowest-latency sort
        when NO candidate has a fresh digest — the regime where nothing
        better is knowable (and where the old ``_latency or 1e9`` wart is
        contained: a never-pinged peer under the scored path gets the
        explicit unknown tier instead of permanent last place)."""
        cands = self.list_providers(model)
        if remote_only:
            cands = [p for p in cands if not p["local"]]
        if exclude:
            cands = [p for p in cands if p["provider_id"] not in exclude]
        if not cands:
            return None
        fresh = self.health.fresh()
        if not any(p["provider_id"] in fresh for p in cands if not p["local"]):
            # no live telemetry about any remote candidate: legacy sort
            # (local-only candidate lists land here too — the local node
            # needs no digest to pick itself)
            return static_sort(cands)
        local_digest = (
            self.telemetry_digest()
            if any(p["local"] for p in cands) else None
        )
        winner, _decision = self.router.pick(
            cands, fresh, local_digest=local_digest, prompt=prompt,
            adapter=adapter,
        )
        return winner

    # ------------------------------------------------------------ generation

    async def request_generation(
        self,
        provider_id: str,
        prompt: str,
        model: str | None = None,
        max_new_tokens: int = 2048,
        temperature: float = 0.7,
        stream: bool = False,
        on_chunk: Callable[[str], None] | None = None,
        timeout: float = REQUEST_TIMEOUT_S,
        extra: dict | None = None,  # sampling knobs (top_k/top_p/penalties):
        # ride the wire as plain message keys — the reference ignores
        # unknown keys, so the frame stays wire-compatible
        tenant: str | None = None,  # per-tenant identity (router/): the
        # serving node's admission bills the same tenant the gateway did
    ) -> dict:
        params = {
            "prompt": prompt,
            "max_new_tokens": max_new_tokens,
            "temperature": temperature,
            **(extra or {}),
        }
        # self-request shortcut (reference p2p_runtime.py:761-787)
        if provider_id == self.peer_id:
            svc = self.local_service_for(model)
            if svc is None:
                raise RuntimeError(f"no local service for model {model!r}")
            return await self._execute_local(svc, params, stream, on_chunk)

        async with self._lock:
            info = self.peers.get(provider_id)
            svc_name = self._remote_service_name(provider_id, model)
        if info is None:
            raise RuntimeError(f"unknown provider {provider_id!r}")

        rid = new_id("req")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        async with self._pending_lock:
            self._pending[rid] = fut
            self._pending_ws[rid] = info["ws"]
            if on_chunk:
                self._chunk_cbs[rid] = on_chunk
        try:
            with get_tracer().span(
                "gen.p2p", provider=provider_id, model=model, rid=rid
            ):
                # inject_trace: the remote hop parents its spans under this
                # gen.p2p span (relay hops chain the context onward), so
                # /trace?trace_id= fragments stitch into one timeline
                await self._send(
                    info["ws"],
                    inject_trace(protocol.msg(
                        protocol.GEN_REQUEST,
                        rid=rid,
                        prompt=prompt,
                        model=model,
                        svc=svc_name,
                        max_new_tokens=max_new_tokens,
                        max_tokens=max_new_tokens,  # reference reads this key
                        temperature=temperature,
                        stream=bool(stream or on_chunk),
                        # omitted when absent (the sampling-knob
                        # convention): a null tenant is wire noise the
                        # receiver would only clamp away
                        **({"tenant": tenant} if tenant is not None else {}),
                        **(extra or {}),
                    )),
                )
                result = await self.clock.wait_for(fut, timeout)
                # raise inside the span so remote-error results count as
                # span errors in /trace, same as timeouts do
                if isinstance(result, dict) and result.get("error"):
                    if result.get("error_kind"):
                        # a typed admission shed must SURVIVE the hop: the
                        # gateway maps this back onto 429/503+Retry-After
                        # instead of a 500 that defeats client backoff
                        raise AdmissionReject(
                            result["error_kind"],
                            float(result.get("retry_after_s") or 0.0),
                            detail=str(result["error"]),
                        )
                    raise RuntimeError(result["error"])
        except asyncio.TimeoutError:
            raise RuntimeError("request_timed_out")
        finally:
            async with self._pending_lock:
                self._pending.pop(rid, None)
                self._pending_ws.pop(rid, None)
                self._chunk_cbs.pop(rid, None)
        return result

    def local_service_for(self, model: str | None):
        """Fuzzy-match a local service for `model`; None when a specific
        model was asked for and nothing matches (the caller then falls back
        to the mesh — answering for the wrong model would be worse)."""
        if not model:
            return next(iter(self.local_services.values()), None)
        for svc in self.local_services.values():
            models = svc.get_metadata().get("models", [])
            if any(model.lower() in m.lower() or m.lower() in model.lower() for m in models):
                return svc
        return None

    @staticmethod
    def adapter_capable(svc) -> bool:
        """Can this service serve `<base>:<adapter>` model ids? Only an
        engine-backed service with an AdapterPool can — the gate that
        scopes the colon grammar: backends whose OWN model ids contain
        colons (ollama tags like "llama3:8b") must keep serving them
        verbatim."""
        engine = getattr(svc, "engine", None)
        return engine is not None and getattr(engine, "adapter_pool", None) is not None

    def service_advertising(self, model) -> object | None:
        """The local service whose metadata lists `model` VERBATIM (case-
        insensitive), or None. Deliberately stricter than the fuzzy
        local_service_for: deciding that a colon-containing id is the
        backend's own tag (not our adapter grammar) must not fuzzy-match
        "tiny-llama:acme" onto a pool-less "tiny-llama" service and
        silently serve the plain base."""
        if not isinstance(model, str):
            return None
        for svc in self.local_services.values():
            models = svc.get_metadata().get("models", [])
            if any(
                isinstance(m, str) and m.lower() == model.lower()
                for m in models
            ):
                return svc
        return None

    def _remote_service_name(self, provider_id: str, model: str | None) -> str:
        svcs = self.providers.get(provider_id, {})
        if model:
            for name, meta in svcs.items():
                if model in meta.get("models", []):
                    return name
        return next(iter(svcs), "tpu")

    async def _execute_local(self, svc, params, stream, on_chunk) -> dict:
        # SLO event accounting wraps the whole serve: every locally-served
        # generation (HTTP, /v1, p2p, relay target) funnels through here
        _C_GEN_REQUESTS.inc()
        # prefix-locality advertisement (router/prefixmap.py): what this
        # node just served is what its prefix cache plausibly holds
        self.prefixes.note(params.get("prompt"))
        try:
            return await self._execute_local_inner(svc, params, stream, on_chunk)
        except Exception:
            _C_GEN_ERRORS.inc()
            raise

    async def _execute_local_inner(self, svc, params, stream, on_chunk) -> dict:
        loop = asyncio.get_running_loop()
        with get_tracer().span(
            "gen.local", service=svc.name, stream=bool(stream or on_chunk)
        ) as span:
            # copy_context so engine spans emitted inside the worker thread
            # keep this span as their parent (run_in_executor alone drops
            # contextvars)
            ctx = contextvars.copy_context()
            if stream or on_chunk:
                import json as _json

                text_parts: list[str] = []
                final: dict = {}  # real accounting off the done line

                def feed(line: str, threadsafe: bool):
                    obj = _json.loads(line)
                    if obj.get("text"):
                        text_parts.append(obj["text"])
                        if on_chunk:
                            if threadsafe:
                                loop.call_soon_threadsafe(on_chunk, obj["text"])
                            else:
                                on_chunk(obj["text"])
                    if obj.get("done"):
                        if obj.get("tokens") is not None:
                            final["tokens"] = int(obj["tokens"])
                            final["cost"] = float(obj.get("cost") or 0.0)
                        if obj.get("timing") is not None:
                            final["timing"] = obj["timing"]
                    if obj.get("status") == "error":
                        raise RuntimeError(obj.get("message", "stream error"))

                def run_stream():
                    for line in svc.execute_stream(params):
                        feed(line, threadsafe=True)

                t0 = self.clock.time()
                stream_async = getattr(svc, "execute_stream_async", None)
                if stream_async is not None:
                    # loop-native service (e.g. PipelineService): no
                    # executor thread blocked per request — the session
                    # coroutine lives on this same loop
                    async for line in stream_async(params):
                        feed(line, threadsafe=False)
                else:
                    await loop.run_in_executor(None, ctx.run, run_stream)
                span.attrs["chunks"] = len(text_parts)
                # mesh-level throughput: real token counts ride the done
                # line when the service reports them; chars/4 (the
                # reference's estimate) is only the fallback
                est = final.get("tokens") or (
                    max(1, len("".join(text_parts)) // 4) if text_parts else 0
                )
                if est:
                    self.throughput.record(est, self.clock.time() - t0)
                out = {
                    "text": "".join(text_parts),
                    "tokens": final.get("tokens"),
                    "cost": final.get("cost"),
                    "streamed": True,
                }
                if final.get("timing") is not None:
                    out["timing"] = final["timing"]
                return out
            exec_async = getattr(svc, "execute_async", None)
            if exec_async is not None:
                result = await exec_async(params)
            else:
                result = await loop.run_in_executor(None, ctx.run, svc.execute, params)
            span.attrs["tokens"] = result.get("tokens")
            # feed the node's advertised throughput (rides pings/registry/
            # metrics — the reference FABRICATES this number, we measure
            # it). `is not None`: a 0-token completion (instant EOS,
            # max_new_tokens=0) still counts as a served request.
            if result.get("tokens") is not None:
                self.throughput.record(
                    int(result["tokens"]),
                    float(result.get("latency_ms") or 0) / 1000.0,
                )
            return result

    async def _handle_gen_request(self, ws, data):
        # adopt the requester's trace context: the gen.local / relay
        # gen.p2p spans below parent under the ORIGINATING request, so
        # every node's /trace?trace_id= fragment joins one timeline
        # (absent/malformed ctx from old peers is a no-op)
        with use_trace_ctx(extract_trace(data)):
            await self._serve_gen_request(ws, data)

    async def _serve_gen_request(self, ws, data):
        rid = data.get("rid") or data.get("task_id")
        model = data.get("model")
        # multi-adapter serving: the adapter rides either the explicit
        # `adapter` key or the "<base>:<name>" model form — one parser
        # (adapters.split_model_adapter) for every surface. The wire
        # claim is CLAMPED: an oversized/exotic string — via EITHER
        # carrier — answers the typed unknown_adapter below; it must
        # never mint metric series or DHT keys, and never silently
        # degrade to serving the plain base model.
        base_model, model_adapter = split_model_adapter(model)
        svc = self.local_services.get(data.get("svc", "")) or self.local_service_for(base_model)
        if (
            data.get("adapter") is None and model_adapter is not None
            and not self.adapter_capable(svc)
        ):
            # the colon can only mean OUR adapter grammar on a pooled
            # engine; a backend advertising the full id verbatim (ollama
            # "llama3:8b") keeps serving it whole. No verbatim match
            # keeps the split, so a pool-less engine still answers the
            # typed unknown_adapter below instead of silently serving
            # the plain base.
            verbatim = self.service_advertising(model)
            if verbatim is not None:
                svc, base_model, model_adapter = verbatim, model, None
        raw_adapter = (
            data.get("adapter")
            if data.get("adapter") is not None else model_adapter
        )
        adapter = None
        if raw_adapter is not None:
            adapter = clamp_adapter_name(raw_adapter)
            if adapter is None:
                if data.get("adapter") is None and svc is None:
                    # model-derived half on a pure relay hop: not ours
                    # to judge — forward the original id whole below and
                    # let the serving node parse it (a backend's own
                    # tags may use chars our adapter names forbid)
                    pass
                else:
                    with contextlib.suppress(Exception):
                        await self._send(ws, protocol.msg(
                            protocol.GEN_ERROR, rid=rid,
                            error="unknown_adapter: malformed adapter name",
                            error_kind="unknown_adapter",
                        ))
                    return
        mnt = data.get("max_new_tokens")
        if mnt is None:  # explicit 0 must stay 0 ("or" would turn it into 2048)
            mnt = data.get("max_tokens")
        params = {
            "prompt": data.get("prompt", ""),
            "max_new_tokens": 2048 if mnt is None else int(mnt),
            "temperature": data.get("temperature", 0.7),
        }
        protocol.copy_sampling(data, params)
        if svc is not None and adapter:
            # resolve (or PAGE IN over the DHT) before admission: a slot
            # must not sit occupied through a multi-second piece fetch
            try:
                resolved = await self.ensure_adapter(svc, adapter)
            except AdapterPoolBusy as busy:
                # valid adapter, saturated pool: the pool_exhausted shed
                # (retryable 503 twin), NEVER unknown_adapter — a 404
                # would tell the client a published adapter is gone
                with contextlib.suppress(Exception):
                    await self._send(ws, protocol.msg(
                        protocol.GEN_ERROR, rid=rid,
                        error=f"adapter_pool_busy: {busy}",
                        error_kind="pool_exhausted",
                        retry_after_s=self.admission.config.shed_retry_after_s,
                    ))
                return
            if not resolved:
                with contextlib.suppress(Exception):
                    await self._send(ws, protocol.msg(
                        protocol.GEN_ERROR, rid=rid,
                        error=f"unknown_adapter: {adapter!r} is not resident "
                              "and could not be fetched",
                        error_kind="unknown_adapter",
                    ))
                return
            params["adapter"] = adapter
        if svc is not None:
            # p2p ingress admission (router/admission.py): the frame's
            # tenant claim is clamped to a CONFIGURED name — an arbitrary
            # wire string must not mint queues or metric series
            tenant = self.tenants.clamp(data.get("tenant"))
            params["tenant"] = tenant
            try:
                ticket = await self.admission.acquire(
                    tenant, cost_tokens=params["max_new_tokens"]
                )
            except AdmissionReject as rej:
                # typed shed over the wire: error_kind + retry_after_s ride
                # the GEN_ERROR frame (declared in analysis/schema.py), the
                # p2p twin of the HTTP 429/503 + Retry-After contract
                with contextlib.suppress(Exception):
                    await self._send(ws, protocol.msg(
                        protocol.GEN_ERROR, rid=rid,
                        error=f"admission_rejected: {rej.detail}",
                        error_kind=rej.kind,
                        retry_after_s=rej.retry_after_s,
                    ))
                return
            try:
                if data.get("stream"):
                    send_q: asyncio.Queue = asyncio.Queue()

                    def on_chunk(text):
                        send_q.put_nowait(text)

                    task = asyncio.create_task(
                        self._execute_local(svc, params, True, on_chunk)
                    )
                    result = await pump_queue_until(
                        task,
                        send_q,
                        lambda text: self._send(
                            ws, protocol.msg(protocol.GEN_CHUNK, rid=rid, text=text)
                        ),
                    )
                    ticket.note_tokens(result.get("tokens") or 0)
                    await self._send(ws, protocol.msg(protocol.GEN_SUCCESS, rid=rid, **result))
                else:
                    result = await self._execute_local(svc, params, False, None)
                    ticket.note_tokens(result.get("tokens") or 0)
                    await self._send(ws, protocol.msg(protocol.GEN_SUCCESS, rid=rid, **result))
            except Exception as e:
                # a failed generation is a typed incident: snapshot the ring
                # + this request's trace (we're under use_trace_ctx, so the
                # recorder picks the trace_id off the contextvar)
                self.recorder.incident(
                    "gen_error", detail=str(e), node=self.peer_id
                )
                # the peer may be the reason we failed (died mid-stream):
                # best-effort error reply, no second exception
                with contextlib.suppress(Exception):
                    await self._send(
                        ws, protocol.msg(protocol.GEN_ERROR, rid=rid, error=f"local_error: {e}")
                    )
            finally:
                ticket.release()
            return
        # swarm relay: one extra hop through another provider
        # (reference p2p_runtime.py:634-655) — telemetry-scored like any
        # other pick, never bouncing the request back to its requester
        requester = await self._peer_for(ws)
        cand = self.pick_provider(
            model,
            prompt=params["prompt"],
            exclude={requester} if requester else (),
            remote_only=True,
            adapter=adapter,
        )
        if cand is None:
            await self._send(
                ws,
                protocol.msg(
                    protocol.GEN_RESULT, rid=rid, error="consensus_deadlock: no_node_available"
                ),
            )
            return
        _C_RELAY_HOPS.inc()
        relay_extra = protocol.copy_sampling(params, {})
        if adapter and data.get("adapter") is not None:
            # an EXPLICIT adapter claim survives the relay hop explicitly
            # — the serving node clamps/resolves it against ITS OWN pool.
            # A model-string-derived half stays inside the forwarded
            # model id instead: this relay can't know whether the far
            # node reads "llama3:8b" as its own tag or as our grammar.
            relay_extra["adapter"] = adapter
        try:
            if data.get("stream"):
                # relay the STREAM too: chunks from the far provider are
                # re-framed under our rid as they arrive — without this a
                # relayed stream request returns empty text while the
                # provider does the full paid generation
                relay_q: asyncio.Queue = asyncio.Queue()
                task = asyncio.create_task(
                    self.request_generation(
                        cand["provider_id"],
                        params["prompt"],
                        model=model,
                        max_new_tokens=params["max_new_tokens"],
                        temperature=params["temperature"],
                        stream=True,
                        on_chunk=relay_q.put_nowait,
                        extra=relay_extra,
                        # the ORIGINAL claim, unclamped: the serving node
                        # clamps against its own tenant config
                        tenant=data.get("tenant"),
                    )
                )
                result = await pump_queue_until(
                    task,
                    relay_q,
                    lambda text: self._send(
                        ws, protocol.msg(protocol.GEN_CHUNK, rid=rid, text=text)
                    ),
                )
            else:
                result = await self.request_generation(
                    cand["provider_id"],
                    params["prompt"],
                    model=model,
                    max_new_tokens=params["max_new_tokens"],
                    temperature=params["temperature"],
                    extra=relay_extra,
                    tenant=data.get("tenant"),
                )
            # the inner result carries its own rid — replace it with ours
            fwd = {k: v for k, v in result.items() if k not in ("rid", "task_id", "type")}
            await self._send(ws, protocol.msg(protocol.GEN_RESULT, rid=rid, **fwd))
        except AdmissionReject as rej:
            # the relay TARGET shed: forward the typed rejection intact
            # (error_kind + retry_after_s on GEN_RESULT, schema-declared)
            # so the originating gateway still answers 429/503 +
            # Retry-After instead of a generic relay failure
            await self._send(ws, protocol.msg(
                protocol.GEN_RESULT, rid=rid,
                error=f"relay_admission_rejected: {rej.detail}",
                error_kind=rej.kind,
                retry_after_s=rej.retry_after_s,
            ))
        except Exception as e:
            await self._send(
                ws, protocol.msg(protocol.GEN_RESULT, rid=rid, error=f"relay_link_failure: {e}")
            )

    async def _handle_gen_chunk(self, ws, data):
        rid = data.get("rid") or data.get("task_id")
        # migration resume streams ride GEN_CHUNK under the migration rid:
        # the bridge feeds the ORIGINAL request's event queue (token ids,
        # not just text) — checked first, it owns its rids exclusively
        if self.migration.feed_chunk(rid, data):
            return
        async with self._pending_lock:
            cb = self._chunk_cbs.get(rid)
        if cb and data.get("text"):
            cb(data["text"])

    async def _handle_gen_result(self, ws, data):
        rid = data.get("rid") or data.get("task_id")
        if self.migration.feed_result(rid, data):
            return
        async with self._pending_lock:
            fut = self._pending.get(rid)
        if fut and not fut.done():
            payload = {k: v for k, v in data.items() if k not in ("type",)}
            fut.set_result(payload)

    # ------------------------------------------------------- live migration

    async def _handle_kv_export(self, ws, data):
        # adopt the exporter's trace context so the import/resume spans
        # stitch under the original request's timeline
        with use_trace_ctx(extract_trace(data)):
            await self.migration.handle_export(ws, data)

    async def _handle_kv_blocks(self, ws, data):
        await self.migration.handle_blocks(ws, data)

    async def _handle_kv_import_ack(self, ws, data):
        self.migration.handle_ack(ws, data)

    async def begin_drain(self, stop: bool = False, wait: bool = True,
                          source: str = "operator") -> dict:
        """Graceful drain (POST /admin/drain): see MigrationManager.drain.
        ``source`` stamps WHO started it ("operator" | "fleet") into the
        gossiped digest — the fleet controller reconciles only its own."""
        self.drain_source = source
        return await self.migration.drain(stop=stop, wait=wait)

    def end_drain(self) -> None:
        """Cancel the draining state (fleet rollback / operator undo):
        admission re-opens and the next gossip drops the digest flag.
        Migrations already launched complete harmlessly — their rows
        left; new work lands here again."""
        self.draining = False
        self.drain_source = None

    # ------------------------------------------------------- elastic fleet

    async def _handle_fleet_lease(self, ws, data):
        await self.fleet.on_lease(ws, data)

    async def _handle_fleet_action(self, ws, data):
        await self.fleet.on_action(ws, data)

    async def _handle_fleet_ack(self, ws, data):
        await self.fleet.on_ack(ws, data)

    # ------------------------------------------------------------ pieces

    def store_piece(self, data: bytes) -> str:
        digest = sha256_hex(data)
        self.piece_store[digest] = data
        if self.piece_dir:
            from ..pieces import save_pieces

            save_pieces([data], self.piece_dir)
        return digest

    def get_piece(self, digest: str) -> bytes | None:
        data = self.piece_store.get(digest)
        if data is None and self.piece_dir:
            try:
                from ..pieces import load_piece

                data = load_piece(self.piece_dir, digest)
            except (OSError, ValueError):
                return None
        return data

    async def request_piece(self, peer_id: str, digest: str, timeout: float = 60.0) -> bytes:
        """Fetch a piece from a peer; hash-verified before returning."""
        async with self._lock:
            info = self.peers.get(peer_id)
        if info is None:
            raise RuntimeError(f"unknown peer {peer_id!r}")
        rid = new_id("piece")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        async with self._pending_lock:
            self._pending[rid] = fut
            self._pending_ws[rid] = info["ws"]
        try:
            await self._send(
                info["ws"], protocol.msg(protocol.PIECE_REQUEST, rid=rid, hash=digest)
            )
            result = await self.clock.wait_for(fut, timeout)
        finally:
            async with self._pending_lock:
                self._pending.pop(rid, None)
                self._pending_ws.pop(rid, None)
        if result.get("error"):
            raise RuntimeError(result["error"])
        data = bytes(result["_tensors"]["data"].tobytes())
        if sha256_hex(data) != digest:
            raise ValueError(f"piece {digest[:12]} failed hash verification")
        return data

    async def _handle_piece_request(self, ws, data):
        import numpy as np

        rid, digest = data.get("rid"), data.get("hash")
        blob = self.get_piece(digest) if digest else None
        if blob is None:
            await self._send(
                ws, protocol.msg(protocol.PIECE_DATA, rid=rid, hash=digest, error="piece_not_found")
            )
            return
        frame = protocol.encode_binary(
            protocol.msg(protocol.PIECE_DATA, rid=rid, hash=digest),
            {"data": np.frombuffer(blob, dtype=np.uint8)},
        )
        await self._send(ws, frame)

    async def _handle_piece_data(self, ws, data):
        rid = data.get("rid")
        async with self._pending_lock:
            fut = self._pending.get(rid)
        if fut and not fut.done():
            fut.set_result(data)

    async def _handle_piece_have(self, ws, data):
        pid = await self._peer_for(ws)
        if pid:
            async with self._lock:
                self.peers.get(pid, {}).setdefault("pieces", set()).update(
                    data.get("hashes") or []
                )

    # ------------------------------------------------------------ monitoring

    async def _monitor_loop(self):
        last_counts: dict[str, float] = {}
        while not self._stopped:
            try:
                await self.clock.sleep(self.ping_interval_s)
                async with self._lock:
                    targets = list(self.peers.items())
                now = self.clock.time()
                # one metrics sample + one encode per TICK, not per peer:
                # get_system_metrics walks psutil and jax devices (slow),
                # and the ping frame's bytes are identical at every peer
                # (scaling fix, bench.py fleet_sim). Sims with hundreds of
                # engine-less control planes disable the sample outright.
                metrics = (
                    get_system_metrics(self.throughput)
                    if self.ping_metrics_enabled and targets
                    else None
                )
                raw_ping = protocol.encode(protocol.msg(
                    protocol.PING,
                    ts=now,
                    **({"metrics": metrics} if metrics is not None else {}),
                ))
                for pid, info in targets:
                    try:
                        await self._send_raw(info["ws"], raw_ping, protocol.PING)
                    except Exception:
                        await self._drop_peer(info["ws"])
                async with self._lock:
                    for pid, info in self.peers.items():
                        if now - info.get("last_seen", now) > 3 * self.ping_interval_s:
                            info["health"] = "unreachable"
                # health plane, on the same cadence: evaluate SLO burn
                # rates (refreshes the slo.* gauges, fires trip incidents),
                # gossip the digest, and drop a metric-delta ring event
                self.slo.evaluate()
                await self.gossip_telemetry(tick=True)
                self._record_metric_deltas(last_counts)
                # elastic fleet control loop, same cadence: lease renew/
                # claim + (leaders only) one hysteresis-guarded decision
                await self.fleet.tick()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("monitor loop error")

    def _record_metric_deltas(self, last: dict[str, float]) -> None:
        """One per-tick flight-recorder event with the counter deltas that
        tell an incident's story ('what changed in the last interval') —
        never throws, like everything feeding the ring.

        The counter list spans every subsystem that can STAR in an
        incident: the serving funnel, plus (these
        predated the ring) the quantized-KV pool churn, the adapter
        pool's load/evict/request traffic, the fleet controller's
        decision/action stream, live migrations, and the retrace
        sentinel's compile/storm counters — so a bundle from any of those
        subsystems carries its own state, not just the gen funnel's. A
        compact gauge snapshot rides alongside (pool occupancy, adapter
        residency, admission pressure, fleet role): gauges have no
        deltas, but an incident reader needs the levels at the tick."""
        try:
            reg = get_registry()
            deltas: dict[str, float] = {}
            for name in (
                "gen.requests", "gen.errors", "engine.tokens_generated",
                "mesh.relay_hops", "pipeline.recoveries",
                # spec decode + quantized-KV pool CoW churn
                "engine.spec_drafted", "engine.spec_accepted",
                # adapter pool
                "adapter.pool_loads", "adapter.pool_evicted",
                "adapter.requests",
                # fleet controller + live migration
                "fleet.decisions", "fleet.actions", "mesh.migrations",
                # admission front door
                "admission.shed",
                # engine economics
                "engine.compiles", "engine.retrace_storms",
            ):
                m = reg.get(name)
                if m is None:
                    continue
                cur = m.total()
                d = cur - last.get(name, 0.0)
                last[name] = cur
                if d:
                    deltas[name] = d
            gauges: dict[str, float] = {}
            for name in (
                "engine.paged_blocks_in_use", "engine.paged_blocks_free",
                "adapter.pool_resident",
                "admission.inflight", "admission.queued",
                "fleet.leader", "fleet.eligible_replicas",
                "engine.hbm_headroom_frac", "engine.mfu",
            ):
                g = reg.get(name)
                if g is None or not g.series():
                    continue  # subsystem not running / gauge cleared
                gauges[name] = g.value()
            if deltas or gauges:
                self.recorder.record(
                    "metrics_delta", deltas=deltas, gauges=gauges
                )
        except Exception:  # noqa: BLE001 — telemetry never throws
            pass

    # ------------------------------------------------------------ status

    def status(self) -> dict:
        return {
            "peer_id": self.peer_id,
            "addr": self.addr,
            "region": self.region,
            "uptime_s": round(self.clock.time() - self.started_at, 1) if self.started_at else 0,
            "peers": len(self.peers),
            "local_services": list(self.local_services),
            "providers": sum(len(v) for v in self.providers.values()),
            "pieces": len(self.piece_store),
            "metrics": get_system_metrics(self.throughput),
        }
