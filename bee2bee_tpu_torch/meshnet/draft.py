"""The mesh draft leg: a cheap peer hosts ONLY the drafter model.

``BEE2BEE_DISAGG=draft`` extends the disaggregation role vocabulary
(prefill/decode — meshnet/migrate.py) with a third program placement:
the drafter is a distinct, much smaller program than the target, so it
can live on a node with no TPU headroom at all and still pay for itself
— every accepted draft token saves the TARGET a full decode step.

Wire protocol (protocol.DRAFT_REQUEST / DRAFT_RESULT, declared in
analysis/schema.py):

- request {rid, base, tokens, k, model}: ``base`` is the context length
  the server already holds for ``rid`` and ``tokens`` the delta to
  append — steady state ships only the accepted tokens from the last
  verify verdict (a handful of ints), so frames stay tiny. ``base=0``
  resends the full context (timeout recovery, server restart);
  {rid, done:true} frees the server row at retirement.
- result {rid, pos, draft}: ``pos`` is the context length the draft
  continues from — the client (engine/spec.MeshDrafter) drops a result
  whose pos no longer matches its context, so a slow draft for an old
  position can never corrupt a row. {rid, reprime:true} asks the client
  for a full resend; {rid, error} is the server's typed failure.

PIPELINING: the client requests the NEXT draft inside the verify
verdict (MeshDrafter.observe), so the round trip runs concurrently with
the target's own next decode/verify step; propose_batch only consumes
results that already arrived. A missing draft is PENDING (the row skips
one step), a timed-out one is a miss against the row's probe budget,
and a dead peer degrades every mesh row to the LOCAL drafter tier —
typed, logged once, zero dropped generations (the scheduler's
_spec_degrade_dead). The decode loop never blocks on the network.

Server ordering: draft_request frames for a row mutate its context, so
they must apply in arrival order — the handler enqueues and ONE worker
task drains the queue sequentially, running the jit draft call in an
executor thread so the node's event loop (pings, gossip, other rows'
frames) never stalls behind a drafter forward.

PyTorch port: a copy of ``bee2bee_tpu/meshnet/draft.py`` with the import root
rewritten to ``bee2bee_tpu_torch``. The drafter (engine/drafter.py) runs on
the card unless ``device`` names another; its draft runs in the executor
thread inside a device pass (``device_gate``), so a device profile starts
and stops between drafts as between the schedulers' passes.
"""

from __future__ import annotations

import asyncio
import logging
import threading

from .. import protocol
from ..engine.introspect import device_gate
from ..metrics import get_registry

logger = logging.getLogger("bee2bee_tpu_torch.draft")

_REG = get_registry()
_C_DRAFT_SERVED = _REG.counter(
    "mesh.draft_served", "draft_request frames served by this draft node"
)
_C_DRAFT_ERRORS = _REG.counter(
    "mesh.draft_errors", "draft_request frames answered with a typed error"
)


class _SrvReq:
    """Stable-identity context holder: DraftModel keys its KV slots off
    id(req) and reads .ids/.out_ids — one of these per server row keeps
    the slot pinned across requests while the ctx list grows in place."""

    __slots__ = ("ids", "out_ids")

    def __init__(self):
        self.ids: list[int] = []
        self.out_ids: list[int] = []   # always empty; ctx lives in ids


class _SrvRow:
    __slots__ = ("req", "last_used")

    def __init__(self):
        self.req = _SrvReq()
        self.last_used = 0.0


class DraftServer:
    """Server side of the draft role: per-(peer, rid) context rows feeding
    one resident DraftModel. Constructed at boot (enable_draft_server) so
    a bad drafter spec fails the node typed at startup, not at the first
    frame."""

    def __init__(self, node, model: str, spec_tokens: int = 6,
                 max_rows: int = 8, dtype: str = "float32",
                 seed: int = 0, checkpoint_path: str | None = None,
                 drafter=None, device=None):
        from ..engine.drafter import DraftModel

        self.node = node
        self.spec_tokens = spec_tokens
        self.drafter = drafter or DraftModel(
            model, spec_tokens=spec_tokens, batch=max_rows,
            # the drafter's own positional capacity is the real bound; the
            # DraftModel caps against its config's max_seq_len internally
            target_max_seq_len=1 << 20,
            dtype=dtype, seed=seed, checkpoint_path=checkpoint_path,
            device=device,
        )
        self.max_rows = max_rows
        self._rows: dict[tuple[str, str], _SrvRow] = {}
        self._queue: asyncio.Queue = asyncio.Queue()
        self._worker: asyncio.Task | None = None
        self._closed = False
        if drafter is None:
            # compile the prime/draft roots NOW: the first real frame must
            # pay network latency only — a multi-second first-draft jit
            # compile would make every early draft stale on arrival
            warm = _SrvReq()
            warm.ids = list(range(1, 17))
            self._propose(warm)
            self.drafter.forget(warm)

    # ---------------------------------------------------------- intake
    def submit(self, ws, pid: str, msg: dict) -> None:
        """Handler entry (event loop): enqueue for the ordered worker."""
        if self._closed:
            return
        if self._worker is None or self._worker.done():
            self._worker = self.node._spawn(self._drain())
        self._queue.put_nowait((ws, pid, msg))

    async def _drain(self):
        while not self._closed:
            ws, pid, msg = await self._queue.get()
            try:
                await self._serve_one(ws, pid, msg)
            except Exception:  # noqa: BLE001 — one bad frame must not
                logger.exception("draft request failed")  # kill the worker

    def _evict_lru(self) -> None:
        if len(self._rows) < self.max_rows:
            return
        key = min(self._rows, key=lambda k: self._rows[k].last_used)
        row = self._rows.pop(key)
        self.drafter.forget(row.req)

    async def _serve_one(self, ws, pid: str, msg: dict):
        rid = str(msg.get("rid") or "")
        key = (pid, rid)
        if msg.get("done"):
            row = self._rows.pop(key, None)
            if row is not None:
                self.drafter.forget(row.req)
            return
        base = int(msg.get("base") or 0)
        tokens = [int(t) for t in (msg.get("tokens") or [])]
        row = self._rows.get(key)
        if row is None:
            if base != 0:
                # a delta for a row we don't hold (restart, LRU eviction):
                # ask for the full context instead of drafting off garbage
                await self.node._send(ws, protocol.msg(
                    protocol.DRAFT_RESULT, rid=rid, reprime=True
                ))
                return
            self._evict_lru()
            row = _SrvRow()
            self._rows[key] = row
        ctx = row.req.ids
        if base == 0:
            # full (re)send. Context is append-only on the client (prompt
            # + accepted tokens), so replacing in place keeps the KV
            # frontier the DraftModel tracks for this row valid.
            ctx[:] = tokens
        elif base == len(ctx):
            ctx.extend(tokens)
        else:
            # delta baseline mismatch (a lost frame out of order): typed
            # resync rather than silently drafting from a wrong context
            await self.node._send(ws, protocol.msg(
                protocol.DRAFT_RESULT, rid=rid, reprime=True
            ))
            return
        row.last_used = self.node.clock.monotonic()
        pos = len(ctx)
        loop = asyncio.get_running_loop()
        try:
            # the draft runs off-loop; the worker awaits it, so rows are
            # still served strictly in order
            out = await loop.run_in_executor(None, self._propose, row.req)
            draft = out.get(0) or []
            _C_DRAFT_SERVED.inc()
        except Exception as e:  # noqa: BLE001 — typed error to the client
            logger.exception("drafter compute failed")
            _C_DRAFT_ERRORS.inc()
            await self.node._send(ws, protocol.msg(
                protocol.DRAFT_RESULT, rid=rid, error=str(e) or "draft_failed"
            ))
            return
        await self.node._send(ws, protocol.msg(
            protocol.DRAFT_RESULT, rid=rid, pos=pos,
            draft=[int(t) for t in draft],
        ))

    def _propose(self, req) -> dict:
        """One draft (its host copies, replays and readback) inside a
        device pass: a device profile starts and stops between drafts."""
        with device_gate.device_pass():
            return self.drafter.propose_batch([(0, req)])

    def close(self) -> None:
        self._closed = True
        if self._worker is not None:
            self._worker.cancel()
            self._worker = None
        for row in self._rows.values():
            self.drafter.forget(row.req)
        self._rows.clear()
        self.drafter.close()


class DraftClient:
    """Client side: binds the scheduler's MeshDrafter(s) to the mesh.

    The send path runs on the SCHEDULER THREAD (MeshDrafter._submit):
    it picks the draft peer from the freshest telemetry digests, then
    hops onto the node's event loop for the actual frame send —
    fire-and-forget, the MeshDrafter's own deadline ladder covers every
    loss mode. Results and peer-loss notifications flow back in on the
    event loop (_handle_draft_result / _drop_peer)."""

    def __init__(self, node):
        self.node = node
        self._lock = threading.Lock()
        self._drafters: list = []          # bound MeshDrafter instances
        self._peer_ws = None               # cached (pid, ws)

    def bind(self, mesh_drafter) -> None:
        with self._lock:
            if mesh_drafter not in self._drafters:
                self._drafters.append(mesh_drafter)
        mesh_drafter.attach_transport(self._send_fn)

    # ------------------------------------------------- peer selection
    def _pick_peer(self):
        """(pid, ws) of a live draft-role peer, or None. Reads gossip
        state from the scheduler thread: health.fresh() locks internally
        and the peers dict is snapshotted (same discipline as
        node.peer_for_addr)."""
        fresh = self.node.health.fresh()
        peers = dict(self.node.peers)
        for pid, d in fresh.items():
            if not isinstance(d, dict) or d.get("disagg_role") != "draft":
                continue
            info = peers.get(pid)
            if info is not None and info.get("ws") is not None:
                return pid, info["ws"]
        return None

    def _send_fn(self, payload: dict) -> bool:
        """MeshDrafter transport hook (scheduler thread). False = the
        frame can never leave (no loop / no draft peer) — the drafter
        flips dead and the scheduler degrades rows to the local tier."""
        loop = getattr(self.node, "_loop", None)
        if loop is None or loop.is_closed() or self.node._stopped:
            return False
        with self._lock:
            peer = self._peer_ws
        if peer is None:
            peer = self._pick_peer()
            if peer is None:
                return False
            with self._lock:
                self._peer_ws = peer
        msg = protocol.msg(protocol.DRAFT_REQUEST, **payload)
        try:
            loop.call_soon_threadsafe(self._post, peer[1], msg)
        except RuntimeError:
            return False                    # loop closed under us
        return True

    def _post(self, ws, msg: dict) -> None:
        # on the event loop: a failed/slow send surfaces as a client-side
        # deadline miss, never as an exception into the scheduler
        self.node._spawn(self.node._send(ws, msg))

    # ------------------------------------------------- loop-side events
    def deliver(self, msg: dict) -> None:
        with self._lock:
            drafters = list(self._drafters)
        for d in drafters:
            d.deliver(msg)                  # unknown rids are ignored

    def on_ws_drop(self, ws) -> None:
        """_drop_peer hook: our draft peer's connection died. Re-pick if
        another draft-role peer is live; otherwise flip every bound
        drafter dead (typed "peer_lost") so rows degrade immediately
        instead of riding out their timeouts."""
        with self._lock:
            cached = self._peer_ws
            if cached is None or cached[1] is not ws:
                return
            self._peer_ws = None
        repick = self._pick_peer()
        if repick is not None:
            with self._lock:
                self._peer_ws = repick
            return
        with self._lock:
            drafters = list(self._drafters)
        for d in drafters:
            d.peer_lost()

    def close(self) -> None:
        with self._lock:
            self._drafters.clear()
            self._peer_ws = None
