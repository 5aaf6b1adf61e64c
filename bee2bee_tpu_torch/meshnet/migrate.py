"""Live generation migration: KV-block export/import over the mesh.

The production alternative to "start over" (ROADMAP item 2): a node can
ship an in-flight generation's complete recoverable state — block-table
rows, the referenced pool blocks as hashed tensor pieces, sampling
state, accepted tokens — to a scored-healthy peer, which imports the
blocks straight into its own paged pool and resumes decoding
token-for-token. No re-prefill on the happy path (pinned by the
scheduler's ``import_reprefills`` counter staying at zero). Three
consumers share the primitive:

- **graceful drain** (``drain()``, behind ``POST /admin/drain``): the
  node flips to draining (admission 503s new work typed ``draining``,
  the flag rides the telemetry digest so RouterPolicy excludes it),
  in-flight generations migrate out, and the node can exit clean with a
  GOODBYE;
- **disaggregated prefill→decode**: a prefill-designated node
  (``BEE2BEE_DISAGG=prefill``) offers every freshly prefilled row to the
  hook and ships it to a decode-designated peer — prefill compute and
  decode batching stop competing for the same chip;
- **migration-based failover**: a row the local pool can no longer grow
  (mid-decode exhaustion) migrates instead of erroring.

Wire protocol (protocol.py, analysis/schema.py): ``KV_EXPORT`` carries
the generation snapshot (scheduler ``_snapshot_meta``), the engine's
pool-compat signature and the chunk count; ``KV_BLOCKS`` frames carry
the pool blocks as binary tensor frames with per-buffer sha256 (the
pieces.py discipline — a corrupt block is refused before it touches the
target pool; an int8 pool ships its k_scale/v_scale tensors alongside
the pages at half the page bytes, hashed and verified the same way);
``KV_IMPORT_ACK`` is the target's typed verdict. The signature's
``cache_dtype`` gates layout compatibility: a bf16-pool node refuses an
int8 exporter's pages typed ``incompatible``, and the ladder then takes
the layout-free re-prefill rung — on the SAME peer if need be. The
resumed stream rides the existing GEN_CHUNK / GEN_SUCCESS / GEN_ERROR
plumbing under the migration rid, and the source BRIDGES it into the
original Request's event queue — the consumer (HTTP stream, p2p
requester) never notices the handoff.

Fallback ladder, every rung typed (docs/ROBUSTNESS.md): KV migration →
re-prefill migration (prompt + accepted recomputed on the target) → typed error to the consumer. Every failed rung
leaves a ``migration:<reason>`` incident bundle; the reason is part of
the kind, so the flight recorder's per-kind cooldown can never let one
failing path mask another (or an SLO trip).

PyTorch port: a copy of ``bee2bee_tpu/meshnet/migrate.py`` with the import root rewritten to
``bee2bee_tpu_torch``; comments that cited the JAX package's change history or the
reference checkout's path are trimmed.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import queue as _queue

import numpy as np

from .. import protocol
from ..clock import get_clock
from ..health import get_recorder
from ..metrics import get_registry
from ..router import AdmissionReject
from ..tracing import get_tracer, inject_trace
from ..utils import TaskTracker, log_task_exception, new_id, sha256_hex

logger = logging.getLogger("bee2bee_tpu_torch.migrate")

# migration observability: role in {out, in}, outcome a closed set
_C_MIGRATIONS = get_registry().counter(
    "mesh.migrations", "generation migrations by role and outcome"
)
_H_MIGRATION_MS = get_registry().histogram(
    "mesh.migration_export_ms",
    "export-to-resume-ack latency per migration (ms)",
)

# one KV_BLOCKS frame stays well under protocol.MAX_FRAME (32 MiB)
MAX_CHUNK_BYTES = 8 * 1024 * 1024

# the closed failure-reason set: every failure is incident kind
# "migration:<code>", so the recorder's per-kind cooldown is per-CAUSE —
# a burning hash_mismatch path cannot mask a pool_exhausted one, and
# none of them mask slo:* trips (different kinds entirely)
REASON_CODES = frozenset({
    "no_target",        # no scored-healthy peer serves the model
    "export_failed",    # the export frames never left / send raised
    "ack_timeout",      # the target never answered KV_IMPORT_ACK
    "hash_mismatch",    # a KV_BLOCKS piece failed sha256 verification
    "pool_exhausted",   # the target's pool couldn't host the blocks
    "incompatible",     # pool signature / snapshot validation mismatch
    "import_rejected",  # target admission (draining, shedding) said no
    "import_failed",    # the target engine failed after accepting
    "stream_lost",      # the resume stream died mid-generation
    "unrecoverable",    # every rung failed; the consumer got a typed error
})


class MigrationError(RuntimeError):
    """One failed migration rung; ``code`` indexes REASON_CODES."""

    def __init__(self, code: str, detail: str = "", target: str | None = None):
        super().__init__(detail or code)
        self.code = code if code in REASON_CODES else "import_rejected"
        self.detail = detail
        self.target = target


class _Bridge:
    """Source-side adapter: remote resume-stream frames → the ORIGINAL
    Request's event queue. Tokens run through the original ``accept()`` /
    ``text_delta()`` machinery, so stop/budget semantics and the
    UTF-8-safe incremental decode are byte-identical to a local rollout
    (the remote applies the same rules, so the two never disagree)."""

    def __init__(self, req, svc, loop):
        self.req = req
        self.svc = svc
        self.done: asyncio.Future = loop.create_future()
        self.new_tokens = 0

    def feed_chunk(self, data: dict) -> None:
        req = self.req
        if req.cancelled:
            # the consumer abandoned the stream mid-migration: stop
            # booking tokens for it. Known limitation: no cancel frame
            # reaches the target, so the remote still decodes its
            # (budget-bounded) tail — see docs/ROBUSTNESS.md.
            if req.finish is None:
                req.finish = "cancelled"
            return
        emitted: list[int] = []
        for t in data.get("tokens") or []:
            if not req.accept(int(t)):
                break
            emitted.append(int(t))
            if req.done:
                break
        self.new_tokens += len(emitted)
        if emitted and req.stream:
            req.events.put({
                "token": emitted[-1],
                "tokens": emitted,
                "text": req.text_delta(final=req.done),
            })

    def feed_result(self, data: dict) -> None:
        if self.done.done():
            return
        if data.get("error"):
            self.done.set_exception(
                MigrationError("import_failed", str(data["error"]))
            )
        else:
            self.done.set_result(data)

    def fail(self, exc: Exception) -> None:
        if not self.done.done():
            self.done.set_exception(exc)


class _PendingImport:
    """Target-side state for one in-flight KV_EXPORT."""

    __slots__ = ("rid", "ws", "gen", "svc", "expected", "chunks", "t0")

    def __init__(self, rid, ws, gen, svc, expected):
        self.rid = rid
        self.ws = ws
        self.gen = gen
        self.svc = svc
        self.expected = expected
        self.chunks: list[tuple[int, dict]] = []
        self.t0 = get_clock().monotonic()


class MigrationManager:
    """Per-node migration plane: source-side export/bridge/fallback and
    target-side import/serve, plus the drain coordinator. Lives on the
    node's event loop; the only cross-thread entry is the scheduler hook
    installed by ``wire_scheduler`` (which merely schedules loop work)."""

    def __init__(self, node, ack_timeout_s: float = 30.0,
                 bridge_timeout_s: float = 600.0):
        self.node = node
        self.clock = getattr(node, "clock", None) or get_clock()
        self.ack_timeout_s = ack_timeout_s
        self.bridge_timeout_s = bridge_timeout_s
        # bench/chaos knob: skip the KV rung and exercise re-prefill
        self.force_reprefill = False
        self._closed = False
        # source side
        self._acks: dict[str, asyncio.Future] = {}
        self._bridges: dict[str, _Bridge] = {}
        self._rid_ws: dict[str, object] = {}
        self._tasks = TaskTracker("migration")  # strong refs + crash logging
        # target side
        self._imports: dict[str, _PendingImport] = {}
        self.stats = {
            "migrated_out": 0, "migrated_in": 0, "fallback_reprefills": 0,
            "forwarded": 0, "failed": 0,
        }

    # ------------------------------------------------------------ wiring

    def wire_scheduler(self, svc) -> None:
        """Install the migration hook on an engine-backed service's
        scheduler (node.add_service calls this). The hook runs ON THE
        SCHEDULER THREAD: it only decides (target exists? loop alive?)
        and schedules the async migration; True transfers ownership of
        the request to this manager."""
        eng = getattr(svc, "engine", None)
        sch = getattr(eng, "scheduler", None) if eng is not None else None
        if sch is None:
            return
        node = self.node

        def cb(req, snap, reason) -> bool:
            loop = getattr(node, "_loop", None)
            if loop is None or loop.is_closed() or node._stopped or self._closed:
                return False
            decode_only = reason == "prefill_handoff"
            if not self.migration_targets(
                snap.get("model"), decode_only=decode_only
            ):
                return False
            kv = snap.pop("_kv", None)
            loop.call_soon_threadsafe(
                self.spawn_migration, req, svc, snap, kv, reason
            )
            return True

        sch.migrate_cb = cb
        if node.disagg_role == "prefill":
            sch.handoff_after_prefill = True

    def close(self) -> None:
        """node.stop(): fail outstanding bridges/acks so nothing awaits a
        reply that can no longer arrive."""
        self._closed = True
        err = MigrationError("stream_lost", "node stopped")
        for fut in self._acks.values():
            if not fut.done():
                fut.set_exception(err)
        for bridge in self._bridges.values():
            bridge.fail(err)
        self._imports.clear()

    # ------------------------------------------------------------ targets

    def migration_targets(self, model: str | None, exclude=(),
                          decode_only: bool = False) -> list[str]:
        """Peer ids that could host a migration: advertise a matching
        service AND have a fresh, non-draining telemetry digest (the
        "scored-healthy" requirement — a peer we know nothing about is
        not a place to ship live state).

        Called from the SCHEDULER THREAD too (the wire_scheduler hook):
        never-throw — a gossip-timing dict race must degrade to "no
        target", not escape into the scheduler loop's catch-all."""
        try:
            return self._migration_targets(model, exclude, decode_only)
        except Exception:  # noqa: BLE001
            logger.exception("migration target scan failed")
            return []

    def _migration_targets(self, model, exclude, decode_only) -> list[str]:
        fresh = self.node.health.fresh()
        out = []
        for pid, svcs in list(self.node.providers.items()):
            if pid in exclude:
                continue
            d = fresh.get(pid)
            if not isinstance(d, dict) or d.get("draining"):
                continue
            if d.get("fleet_state") in ("standby", "warming"):
                # an unprobed elastic-fleet replica must not receive
                # live state either — migrations are traffic
                continue
            if decode_only and d.get("disagg_role") != "decode":
                continue
            if d.get("disagg_role") == "draft":
                # a draft-role peer hosts ONLY the drafter model — it has
                # no target engine to resume a migrated generation on
                continue
            for meta in list(svcs.values()):
                models = [str(m) for m in (meta.get("models") or [])]
                if model is None or any(
                    model.lower() in m.lower() or m.lower() in model.lower()
                    for m in models
                ):
                    out.append(pid)
                    break
        return out

    def _pick_target(self, model: str | None, exclude: set,
                     decode_only: bool) -> str | None:
        cands = self.migration_targets(model, exclude, decode_only)
        if not cands:
            return None
        if len(cands) == 1:
            return cands[0]
        # telemetry-scored pick among the eligible set: reuse the router
        # by excluding everything that is NOT a migration candidate
        not_cands = set(self.node.providers) - set(cands)
        prov = self.node.pick_provider(
            model, remote_only=True, exclude=set(exclude) | not_cands
        )
        return prov["provider_id"] if prov is not None else cands[0]

    # ------------------------------------------------------- source side

    def spawn_migration(self, req, svc, snap: dict, kv, reason: str):
        """Entry from the scheduler hook (already on the loop)."""
        return self._tasks.spawn(
            self._migrate_with_fallback(req, svc, snap, kv, reason)
        )

    async def wait_idle(self, timeout_s: float = 60.0) -> bool:
        """Await in-flight source-side migrations (tests, drain-then-stop)."""
        deadline = self.clock.monotonic() + timeout_s
        while self._tasks and self.clock.monotonic() < deadline:
            with contextlib.suppress(Exception):
                await self.clock.wait_for(
                    asyncio.gather(*list(self._tasks), return_exceptions=True),
                    max(0.05, deadline - self.clock.monotonic()),
                )
        return not self._tasks

    async def _migrate_with_fallback(self, req, svc, snap: dict, kv,
                                     reason: str) -> str:
        """The fallback ladder. Returns the outcome: "ok" (KV rung),
        "reprefill", "forwarded" (queued request, nothing to resume) or
        "failed" (consumer got the typed error)."""
        t0 = self.clock.monotonic()
        excluded: set[str] = set()
        was_queued = not snap.get("out") and not snap.get("kv_blocks")
        with get_tracer().span(
            "mesh.migrate", reason=reason,
            accepted=len(snap.get("out") or []),
        ) as span:
            if kv is not None and not self.force_reprefill:
                try:
                    await self._migrate_once(
                        req, svc, snap, kv, reason,
                        excluded, decode_only=(reason == "prefill_handoff"),
                        t0=t0,
                    )
                    _C_MIGRATIONS.inc(role="out", outcome="ok")
                    self.stats["migrated_out"] += 1
                    span.attrs["outcome"] = "ok"
                    return "ok"
                except MigrationError as err:
                    self._incident(err, snap, reason)
                    # hash_mismatch indicts the PIECES (source/transit)
                    # and incompatible indicts the LAYOUT PAIRING (e.g. a
                    # bf16-pool peer refusing int8 pages, or a different
                    # kv_block_size) — neither indicts the target itself,
                    # so both stay eligible for the re-prefill rung,
                    # which ships token ids only and is layout-free
                    if err.target and err.code not in (
                        "hash_mismatch", "incompatible"
                    ):
                        excluded.add(err.target)
                except Exception as err:  # noqa: BLE001 — a rung bug must
                    # fall down the ladder, not escape the drain gather
                    logger.exception("KV migration rung crashed")
                    self._incident(
                        MigrationError("unrecoverable", repr(err)),
                        snap, reason,
                    )
            # a request the bridge already finished (accept() closed it;
            # only the remote's final frame was lost) needs no second
            # rung — shipping a COMPLETE generation somewhere just to
            # re-prefill and instantly retire it would be pure waste
            if req.finish is not None:
                try:
                    self._finalize(req, svc, {})
                    _C_MIGRATIONS.inc(role="out", outcome="ok")
                    self.stats["migrated_out"] += 1
                    span.attrs["outcome"] = "ok"
                    return "ok"
                except Exception:  # noqa: BLE001 — fall to the terminal
                    # path, which guards its own finalize
                    logger.exception("post-rung finalize failed")
            # re-prefill rung: the bridge may have advanced the output
            # before the stream died — re-snapshot the accepted tokens so
            # the target resumes from the true frontier, not a stale one
            try:
                snap2 = {**snap, "out": [int(t) for t in req.out_ids],
                         "kv_blocks": 0, "offset": 0, "cur": None}
                await self._migrate_once(
                    req, svc, snap2, None, reason, excluded,
                    decode_only=False, t0=t0,
                )
                if was_queued:
                    self.stats["forwarded"] += 1
                    _C_MIGRATIONS.inc(role="out", outcome="forwarded")
                    span.attrs["outcome"] = "forwarded"
                    return "forwarded"
                _C_MIGRATIONS.inc(role="out", outcome="reprefill")
                self.stats["fallback_reprefills"] += 1
                span.attrs["outcome"] = "reprefill"
                return "reprefill"
            except MigrationError as err:
                self._incident(err, snap, reason)
            except Exception as err:  # noqa: BLE001 — the consumer MUST
                # get a done event even on a manager bug
                logger.exception("migration fallback crashed")
                self._incident(
                    MigrationError("unrecoverable", repr(err)), snap, reason
                )
            # terminal: typed error, never a hung generation
            _C_MIGRATIONS.inc(role="out", outcome="failed")
            self.stats["failed"] += 1
            span.attrs["outcome"] = "failed"
            self._incident(
                MigrationError(
                    "unrecoverable",
                    f"every migration rung failed (reason={reason})",
                ),
                snap, reason,
            )
            # the consumer ALWAYS gets a done event — the no-hung-
            # generation contract. A req whose finish is already set
            # completed from the client's point of view (the bridge fed
            # every token and accept() closed it; only the remote's final
            # frame was lost): close it out as a success with the local
            # accounting instead of erroring a finished generation.
            if req.finish is not None:
                try:
                    self._finalize(req, svc, {})
                except Exception:  # noqa: BLE001 — last resort: a raw
                    # error event still unblocks the consumer
                    logger.exception("migration finalize failed")
                    req.events.put({
                        "done": True, "result": None,
                        "error": "migration_failed: finalize error",
                    })
            else:
                req.finish = "error"
                req.events.put({
                    "done": True, "result": None,
                    "error": "migration_failed: no peer could resume this "
                             "generation (see migration:* incidents)",
                })
            return "failed"

    async def _migrate_once(self, req, svc, snap: dict, kv, reason: str,
                            excluded: set, decode_only: bool, t0: float):
        """One rung: export to one target, await its typed ACK, bridge the
        resume stream to completion. Raises MigrationError."""
        target = self._pick_target(snap.get("model"), excluded, decode_only)
        if target is None:
            raise MigrationError(
                "no_target", "no scored-healthy peer serves this model"
            )
        info = self.node.peers.get(target)
        if info is None:
            raise MigrationError("no_target", f"peer {target} vanished", target)
        ws = info["ws"]
        rid = new_id("mig")
        loop = asyncio.get_running_loop()
        ack: asyncio.Future = loop.create_future()
        bridge = _Bridge(req, svc, loop)
        self._acks[rid] = ack
        self._bridges[rid] = bridge
        self._rid_ws[rid] = ws
        eng = getattr(svc, "engine", None)
        try:
            frames = self._encode_chunks(rid, kv) if kv is not None else []
            export = inject_trace(protocol.msg(
                protocol.KV_EXPORT,
                rid=rid,
                model=snap.get("model"),
                gen={k: v for k, v in snap.items() if not k.startswith("_")},
                sig=eng.migration_signature() if eng is not None else None,
                kv_chunks=len(frames),
                reason=reason,
            ))
            try:
                await self.node._send(ws, export)
                for seq, frame in enumerate(frames):
                    await self._send_chunk(ws, frame, seq)
            except Exception as err:
                raise MigrationError("export_failed", str(err), target)
            try:
                verdict = await self.clock.wait_for(ack, self.ack_timeout_s)
            except asyncio.TimeoutError:
                raise MigrationError(
                    "ack_timeout", f"no import ack from {target}", target
                )
            except MigrationError as err:
                err.target = err.target or target
                raise
            if not isinstance(verdict, dict) or not verdict.get("ok"):
                kind = (verdict or {}).get("error_kind") or "import_rejected"
                if kind not in REASON_CODES:
                    kind = "import_rejected"
                raise MigrationError(
                    kind, str((verdict or {}).get("error") or ""), target
                )
            _H_MIGRATION_MS.observe((self.clock.monotonic() - t0) * 1000.0)
            # resumed: bridge frames until the remote's final result
            try:
                wire = await self.clock.wait_for(
                    bridge.done, self.bridge_timeout_s
                )
            except asyncio.TimeoutError:
                raise MigrationError(
                    "stream_lost", "resume stream timed out", target
                )
            except MigrationError as err:
                err.target = err.target or target
                raise
            self._finalize(req, svc, wire)
        finally:
            self._acks.pop(rid, None)
            self._bridges.pop(rid, None)
            self._rid_ws.pop(rid, None)

    async def _send_chunk(self, ws, frame: bytes, seq: int) -> None:
        """One KV_BLOCKS frame — a seam chaos wraps (kill/corrupt)."""
        await self.node._send(ws, frame)

    def _encode_chunks(self, rid: str, kv: dict) -> list[bytes]:
        """Pool blocks → binary tensor frames, <= MAX_CHUNK_BYTES each,
        with per-buffer sha256 in the header (the pieces.py discipline).
        Generic over the pool's leaves: an int8 pool ships k/v pages AND
        their k_scale/v_scale tensors (block dim = axis 2 on every leaf),
        each hashed separately — a corrupt SCALE is as fatal to the
        import as a corrupt page and takes the same typed refusal."""
        arrs = {name: np.asarray(a) for name, a in kv.items()}
        nb = arrs["k"].shape[2]
        per_block = max(1, sum(a[:, :, :1].nbytes for a in arrs.values()))
        per = max(1, MAX_CHUNK_BYTES // per_block)
        frames = []
        starts = list(range(0, nb, per))
        for ci, s in enumerate(starts):
            part = {
                name: np.ascontiguousarray(a[:, :, s:s + per])
                for name, a in arrs.items()
            }
            frames.append(protocol.encode_binary(
                protocol.msg(
                    protocol.KV_BLOCKS,
                    rid=rid,
                    seq=ci,
                    done=(ci == len(starts) - 1),
                    hashes={
                        name: sha256_hex(p.tobytes())
                        for name, p in part.items()
                    },
                ),
                part,
            ))
        return frames

    def _finalize(self, req, svc, wire: dict) -> None:
        """The bridged generation finished remotely: close out the
        ORIGINAL request with a locally-built result (one decode pipeline,
        one accounting path — the consumer can't tell it migrated)."""
        if req.finish is None:
            fr = wire.get("finish_reason")
            req.finish = fr if isinstance(fr, str) and fr else "stop"
        req.timing.t_done = self.clock.monotonic()
        eng = getattr(svc, "engine", None)
        result = eng._build_result(req) if eng is not None else None
        req.events.put({"done": True, "result": result})

    def _incident(self, err: MigrationError, snap: dict, reason: str) -> None:
        get_recorder().incident(
            f"migration:{err.code}",
            detail=err.detail or err.code,
            node=self.node.peer_id,
            extra={
                "reason": reason,
                "target": err.target,
                "prompt_tokens": len(snap.get("ids") or []),
                "accepted_tokens": len(snap.get("out") or []),
            },
        )

    # ------------------------------------------------------ frame routing

    def feed_chunk(self, rid, data: dict) -> bool:
        """GEN_CHUNK router hook: True = this was a migration stream."""
        bridge = self._bridges.get(rid)
        if bridge is None:
            return False
        try:
            bridge.feed_chunk(data)
        except Exception:  # noqa: BLE001 — a bridge bug must not kill the reader
            logger.exception("migration bridge feed failed")
        return True

    def feed_result(self, rid, data: dict) -> bool:
        """GEN_SUCCESS/GEN_RESULT/GEN_ERROR router hook."""
        bridge = self._bridges.get(rid)
        if bridge is None:
            return False
        bridge.feed_result(data)
        return True

    def on_ws_drop(self, ws) -> None:
        """A connection died: fail every migration riding it (typed), and
        abandon target-side imports whose exporter is gone."""
        err = MigrationError("stream_lost", "peer connection lost")
        for rid, w in list(self._rid_ws.items()):
            if w is ws:
                fut = self._acks.get(rid)
                if fut is not None and not fut.done():
                    fut.set_exception(
                        MigrationError("stream_lost", "peer died before ack")
                    )
                bridge = self._bridges.get(rid)
                if bridge is not None:
                    bridge.fail(err)
        for rid, imp in list(self._imports.items()):
            if imp.ws is ws:
                self._imports.pop(rid, None)

    # ------------------------------------------------------- target side

    # a pending import whose exporter never finishes its chunk stream
    # (but keeps the connection alive) is abandoned after this long —
    # on_ws_drop handles the dead-connection case
    IMPORT_STALE_S = 120.0

    def _prune_stale_imports(self) -> None:
        now = self.clock.monotonic()
        for rid, imp in list(self._imports.items()):
            if now - imp.t0 > self.IMPORT_STALE_S:
                self._imports.pop(rid, None)
                logger.warning("abandoning stale KV import %s", rid)

    async def handle_export(self, ws, data: dict) -> None:
        self._prune_stale_imports()
        rid = data.get("rid")
        gen = data.get("gen")
        if not rid or not isinstance(gen, dict):
            return
        svc = (
            self.node.local_services.get(data.get("svc") or "")
            or self.node.local_service_for(data.get("model"))
        )
        eng = getattr(svc, "engine", None) if svc is not None else None
        if eng is None:
            await self._ack(ws, rid, ok=False,
                            error="no local engine serves this model",
                            error_kind="incompatible")
            return
        sig = data.get("sig")
        n_chunks = int(data.get("kv_chunks") or 0)
        if n_chunks > 0 and (
            not isinstance(sig, dict) or sig != eng.migration_signature()
        ):
            # a KV import needs a MATCHING signature: raw block bytes
            # scattering into a mismatched pool layout is silent
            # corruption, and sig-less blocks are refused outright.
            # Re-prefill imports (kv_chunks == 0) are deliberately exempt
            # — token ids are layout-free, and that rung is exactly how a
            # pool-incompatible mesh (different kv_block_size) still
            # evacuates generations.
            await self._ack(ws, rid, ok=False,
                            error="pool signature mismatch or missing",
                            error_kind="incompatible")
            return
        if n_chunks > getattr(eng, "blocks_per_row", n_chunks):
            # the chunk-count claim is wire input: each chunk carries at
            # least one block, so anything past the pool's per-row block
            # bound cannot be a legitimate export — refuse before the
            # buffering (handle_blocks bounds against this number)
            await self._ack(ws, rid, ok=False,
                            error=f"kv_chunks {n_chunks} exceeds pool bound",
                            error_kind="incompatible")
            return
        imp = _PendingImport(rid, ws, gen, svc, n_chunks)
        if n_chunks == 0:
            self._spawn_finish(imp, kv=None)
        else:
            self._imports[rid] = imp  # meshlint: ignore[ML-R003] -- rid-keyed: one import's export/blocks frames arrive on one connection reader, serialized

    def _spawn_finish(self, imp: _PendingImport, kv) -> None:
        """Admission may queue under saturation — never block the
        connection reader on it (pings/chunks must keep flowing)."""
        self._tasks.spawn(self._finish_import(imp, kv))

    async def handle_blocks(self, ws, data: dict) -> None:
        rid = data.get("rid")
        imp = self._imports.get(rid)
        if imp is None or imp.ws is not ws:
            return
        # the chunk stream is bounded by the declared count UP FRONT, not
        # only at the done frame: an exporter streaming past kv_chunks
        # (or retransmitting a seq — per-chunk hashes would still verify
        # a duplicate, silently corrupting the assembled pool image)
        # would otherwise buffer host tensors without limit
        seq = int(data.get("seq") or 0)
        if (
            len(imp.chunks) >= imp.expected
            or not 0 <= seq < imp.expected
            or any(s == seq for s, _ in imp.chunks)
        ):
            self._imports.pop(rid, None)
            await self._ack(
                ws, rid, ok=False,
                error=f"unexpected chunk seq {seq} "
                      f"({len(imp.chunks)}/{imp.expected} buffered)",
                error_kind="import_rejected",
            )
            return
        tensors = data.get("_tensors") or {}
        hashes = data.get("hashes") or {}
        names = sorted(hashes)
        if not {"k", "v"} <= set(names) or set(tensors) != set(names):
            # every shipped tensor must be hashed and every hash must
            # cover a shipped tensor — an unhashed scale (or a hashed
            # phantom) is a malformed export, not a verification pass
            self._imports.pop(rid, None)
            await self._ack(
                ws, rid, ok=False,
                error=f"chunk {seq}: tensor set {sorted(tensors)} != "
                      f"hash set {names}",
                error_kind="import_rejected",
            )
            return
        for name in names:
            arr = tensors.get(name)
            digest = hashes.get(name)
            if arr is None or digest is None or sha256_hex(
                np.ascontiguousarray(arr).tobytes()
            ) != digest:
                # a corrupt piece — page OR quantization scale — never
                # touches the pool: typed reject, the exporter's ladder
                # re-prefills elsewhere
                self._imports.pop(rid, None)
                _C_MIGRATIONS.inc(role="in", outcome="hash_mismatch")
                get_recorder().incident(
                    "migration:hash_mismatch",
                    detail=f"chunk {data.get('seq')} tensor {name!r} failed "
                           "verification",
                    node=self.node.peer_id,
                )
                await self._ack(
                    ws, rid, ok=False,
                    error=f"chunk {data.get('seq')} {name} hash mismatch",
                    error_kind="hash_mismatch",
                )
                return
        imp.chunks.append((seq, {name: tensors[name] for name in names}))
        if not data.get("done"):
            return
        self._imports.pop(rid, None)
        if len(imp.chunks) != imp.expected:
            await self._ack(
                ws, rid, ok=False,
                error=f"truncated export: {len(imp.chunks)} of "
                      f"{imp.expected} chunks",
                error_kind="import_rejected",
            )
            return
        imp.chunks.sort(key=lambda c: c[0])
        first_names = set(imp.chunks[0][1])
        if any(set(c[1]) != first_names for c in imp.chunks):
            await self._ack(
                ws, rid, ok=False,
                error="chunks disagree on tensor set",
                error_kind="import_rejected",
            )
            return
        kv = {
            name: np.concatenate([c[1][name] for c in imp.chunks], axis=2)
            for name in sorted(first_names)
        }
        self._spawn_finish(imp, kv)

    async def _finish_import(self, imp: _PendingImport, kv) -> None:
        gen = dict(imp.gen)
        # clamp the wire tenant claim like every other ingress
        tenant = self.node.tenants.clamp(gen.get("tenant"))
        gen["tenant"] = tenant
        remaining = max(
            1, int(gen.get("max_new_tokens") or 1) - len(gen.get("out") or [])
        )
        try:
            # bounded WELL below the exporter's ack_timeout_s: parking in
            # a saturated admission queue past it would make the exporter
            # give up and re-migrate elsewhere while we later decode the
            # whole generation for nobody (wait_for's cancellation runs
            # acquire's own bookkeeping/refund path)
            ticket = await self.clock.wait_for(
                self.node.admission.acquire(
                    tenant, cost_tokens=remaining, migration=True
                ),
                self.ack_timeout_s * 0.5,
            )
        except AdmissionReject as rej:
            await self._ack(imp.ws, imp.rid, ok=False, error=rej.detail,
                            error_kind=rej.kind)
            return
        except asyncio.TimeoutError:
            await self._ack(
                imp.ws, imp.rid, ok=False,
                error="no admission slot within the import window",
                error_kind="import_rejected",
            )
            return
        try:
            req = imp.svc.engine.import_generation(
                gen, kv
            )
        except Exception as err:  # noqa: BLE001 — validation is typed
            ticket.release()
            await self._ack(imp.ws, imp.rid, ok=False, error=str(err),
                            error_kind="incompatible")
            return
        self._tasks.spawn(self._serve_import(imp, req, ticket))

    def _next_event(self, req) -> dict:
        """Blocking event read with a liveness escape (runs in executor)."""
        while True:
            try:
                return req.events.get(timeout=1.0)
            except _queue.Empty:
                if self._closed or self.node._stopped:
                    return {"done": True, "result": None,
                            "error": "node stopped"}

    async def _serve_import(self, imp: _PendingImport, req, ticket) -> None:
        """Target-side pump: the imported Request's events → resume-stream
        frames back to the exporter. The ACK fires on the first event, so
        a pool-exhausted import rejects typed instead of ok-then-dying."""
        node = self.node
        rid = imp.rid
        acked = False
        prior = len(imp.gen.get("out") or [])

        async def ack_ok():
            nonlocal acked
            if not acked:
                acked = True
                await self._ack(imp.ws, rid, ok=True)
                _C_MIGRATIONS.inc(role="in", outcome="ok")
                self.stats["migrated_in"] += 1

        try:
            while True:
                ev = await asyncio.to_thread(self._next_event, req)
                if ev.get("imported"):
                    await ack_ok()
                    continue
                if ev.get("done"):
                    if ev.get("result") is None:
                        kind = ev.get("error_kind") or "import_failed"
                        detail = str(ev.get("error") or "import failed")
                        if not acked:
                            _C_MIGRATIONS.inc(role="in", outcome=kind)
                            if kind == "pool_exhausted":
                                get_recorder().incident(
                                    "migration:pool_exhausted",
                                    detail=detail, node=node.peer_id,
                                )
                            await self._ack(imp.ws, rid, ok=False,
                                            error=detail, error_kind=kind)
                        else:
                            with contextlib.suppress(Exception):
                                await node._send(imp.ws, protocol.msg(
                                    protocol.GEN_ERROR, rid=rid, error=detail,
                                ))
                        return
                    res = ev["result"]
                    await ack_ok()  # instant-finish import: ack, then done
                    ticket.note_tokens(max(0, res.new_tokens - prior))
                    with contextlib.suppress(Exception):
                        await node._send(imp.ws, protocol.msg(
                            protocol.GEN_SUCCESS,
                            rid=rid,
                            tokens=res.new_tokens,
                            finish_reason=res.finish_reason,
                            timing=dict(res.timings),
                        ))
                    return
                await ack_ok()  # fresh-submit imports have no marker event
                if ev.get("tokens"):
                    await node._send(imp.ws, protocol.msg(
                        protocol.GEN_CHUNK,
                        rid=rid,
                        text=ev.get("text") or "",
                        tokens=[int(t) for t in ev["tokens"]],
                    ))
        except Exception:  # noqa: BLE001 — exporter gone / send failed:
            # stop decoding for nobody (the row frees at the next boundary)
            req.cancelled = True
            logger.info("resume stream for %s aborted", rid, exc_info=True)
        finally:
            ticket.release()

    async def _ack(self, ws, rid, ok: bool, error: str | None = None,
                   error_kind: str | None = None) -> None:
        with contextlib.suppress(Exception):
            await self.node._send(ws, protocol.msg(
                protocol.KV_IMPORT_ACK,
                rid=rid,
                ok=ok,
                **({"error": error} if error else {}),
                **({"error_kind": error_kind} if error_kind else {}),
            ))

    def handle_ack(self, ws, data: dict) -> None:
        rid = data.get("rid")
        # the verdict must ride the connection the export went out on
        # (the target acks over the link the KV_EXPORT arrived from) —
        # a peer that learns or guesses a rid can neither fail a healthy
        # import nor fake one that never landed (fleet on_ack discipline)
        if ws is not self._rid_ws.get(rid):
            return
        fut = self._acks.get(rid)
        if fut is not None and not fut.done():
            fut.set_result({k: v for k, v in data.items() if k != "type"})

    # ------------------------------------------------------------- drain

    async def drain(self, stop: bool = False, wait: bool = True) -> dict:
        """Graceful drain (POST /admin/drain): flip to draining (admission
        503s typed, the digest advertises it, the router excludes us),
        migrate every in-flight generation to scored-healthy peers, and —
        with ``stop`` — schedule a clean GOODBYE exit once the last
        bridged stream finishes. Requests with no eligible target are
        kept local and finish here (better than erroring them).

        ``wait=True`` returns after every migrated generation COMPLETES
        (bridged stream closed — deterministic summaries for tests and
        automation with patient timeouts). ``wait=False`` returns as soon
        as the migrations are launched, with ``pending`` counting them;
        progress is visible at GET /admin/drain and the stop path still
        waits for everything."""
        node = self.node
        node.draining = True
        summary = {
            "draining": True, "migrated": 0, "reprefilled": 0,
            "forwarded": 0, "kept_local": 0, "failed": 0,
        }
        with contextlib.suppress(Exception):
            await node.gossip_telemetry()  # advertise the drain promptly
        jobs = []
        for svc in list(node.local_services.values()):
            eng = getattr(svc, "engine", None)
            # _scheduler, not .scheduler: drain must not ALLOCATE a batch
            # pool on a node that never served
            sch = getattr(eng, "_scheduler", None) if eng is not None else None
            if sch is None:
                continue
            live = sch.live_requests()
            if not live:
                continue
            if not self.migration_targets(getattr(svc, "model_name", None)):
                summary["kept_local"] += len(live)
                continue
            for req in live:
                jobs.append(self._drain_one(svc, sch, req, summary))
        if jobs:
            if wait:
                await asyncio.gather(*jobs)
            else:
                for job in jobs:
                    self._tasks.spawn(job)
                summary["pending"] = len(jobs)
        if stop:
            # NOT node._spawn: stop() cancels node tasks, and a tracked
            # task awaiting stop() would cancel itself mid-teardown
            self._stop_task = asyncio.create_task(self._stop_after_drain())
            self._stop_task.add_done_callback(log_task_exception)
        return summary

    async def _drain_one(self, svc, sch, req, summary: dict) -> None:
        snap = await asyncio.to_thread(sch.checkpoint, req)
        if snap is None:
            summary["kept_local"] += 1  # retired before the checkpoint hit
            return
        kv = snap.pop("_kv", None)
        outcome = await self._migrate_with_fallback(req, svc, snap, kv, "drain")
        key = {"ok": "migrated", "reprefill": "reprefilled",
               "forwarded": "forwarded"}.get(outcome, "failed")
        summary[key] += 1

    async def _stop_after_drain(self, timeout_s: float = 300.0) -> None:
        """Exit clean once every local row finished and every bridge
        closed: stop() sends the GOODBYE peers retire us on."""
        deadline = self.clock.monotonic() + timeout_s
        while self.clock.monotonic() < deadline:
            busy = bool(self._tasks)
            for svc in list(self.node.local_services.values()):
                eng = getattr(svc, "engine", None)
                sch = getattr(eng, "_scheduler", None) if eng is not None else None
                if sch is not None and sch.live_requests():
                    busy = True
            if not busy:
                break
            await self.clock.sleep(0.1)
        if not self.node._stopped:
            await self.node.stop()
