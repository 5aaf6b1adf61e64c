"""Cross-peer pipeline serving: coordinator + worker task handlers.

BASELINE config 4 (zephyr-7b split across two peers). The reference's
coordinator never survived in its repo — only the worker loop (reference
node.py:48-294) and the protocol constants; this module implements BOTH
halves the TPU-native way:

- Workers hold a StageRunner (layers [a, b) on their own mesh) and answer
  `task` messages of kind part_load / part_forward / part_release
  (protocol.TASK_PART_LOAD/TASK_PART_FORWARD). Hidden states travel as
  binary tensor frames (protocol.encode_binary), not JSON float lists.
- `PipelineCoordinator` drives a generation: prompt ids → stage 0 →
  hidden → stage 1 → ... → logits → sample host-side → feed the token
  back through the chain at the next offset. Per-stage KV caches live on
  the workers, so each decode step moves only [B, 1, D] activations.

The coordinator is itself a mesh peer: it speaks to stage workers over
the same WebSocket connections the gossip/generation traffic uses.

Failover (docs/ROBUSTNESS.md): stage failures are typed (StageDead /
StageTimeout / StageError); on StageDead the coordinator re-places the
dead stage's layer range onto a replacement peer under a bumped stage
epoch (late traffic to/from the old occupant is refused), and in-flight
generations resume by re-prefilling prompt + accepted-so-far — the
coordinator's accepted-token stream is the recovery truth.

PyTorch port: a copy of ``bee2bee_tpu/meshnet/pipeline.py`` with the import
root rewritten to ``bee2bee_tpu_torch``; comments that cited the JAX package's
change history or the reference checkout's path are trimmed. The stage worker
imports ``StageRunner`` from ``..engine``, where it raises by name.
"""

from __future__ import annotations

import asyncio
import logging
from collections import deque
from urllib.parse import urlparse

import numpy as np

from .. import protocol
from ..clock import get_clock
from ..health import get_recorder
from ..metrics import get_registry
from ..tracing import extract_trace, get_tracer, inject_trace, use_trace_ctx
from ..utils import log_task_exception, new_id

logger = logging.getLogger("bee2bee_tpu_torch.pipeline")

# failover observability (metrics.py): the ROBUSTNESS layer's health is
# invisible without these — a mesh that fails over constantly "works"
# while burning re-prefills. kind labels are bounded by the task-kind set.
_C_STAGE_TASKS = get_registry().counter(
    "pipeline.stage_tasks", "stage tasks sent by the coordinator, by kind"
)
_C_RECOVERIES = get_registry().counter(
    "pipeline.recoveries", "coordinator recover() rebuilds"
)
_C_STAGES_REPLACED = get_registry().counter(
    "pipeline.stages_replaced", "dead stages re-placed onto new peers"
)
_C_EPOCH_BUMPS = get_registry().counter(
    "pipeline.epoch_bumps", "stage-epoch bumps (one per chain rebuild)"
)
_C_SESSION_FAILOVERS = get_registry().counter(
    "pipeline.session_failovers", "batched-session failover attempts"
)
# migration-preferring failover: when the chain is still ALIVE
# (StageTimeout/StageError, epoch unchanged), the stage KV caches hold
# every written position — resume decode in place instead of releasing
# and re-prefilling prompt+accepted. State "migrates" zero bytes: it
# stays where it is. Re-prefill remains the rung for unrecoverable state
# (StageDead: the dead stage's cache is gone with its process).
_C_RESUMES_IN_PLACE = get_registry().counter(
    "pipeline.resumes_in_place",
    "failovers resumed on live stage caches without re-prefill",
)
# worker-side stage task timing rides the telemetry digest
# (health.DIGEST_HISTOGRAMS) so a coordinator can weigh stage compute
# against hop latency when resolving the microbatch depth. The histogram
# itself is observed in engine/stage_runner.py, INSIDE the concurrency
# gate: queue/semaphore wait must not inflate the p50 the heuristic
# divides by, or a saturated worker reads as "slow compute" and the auto
# depth under-resolves exactly when more overlap would pay.

DEFAULT_STEP_TIMEOUT = 120.0
# generation-level failover policy defaults (PipelineCoordinator knobs)
DEFAULT_FAILOVER_RETRIES = 2
DEFAULT_FAILOVER_BACKOFF_S = 0.5
DEFAULT_GENERATION_DEADLINE_S = 600.0


# ----------------------------------------------------------- error taxonomy


class StageError(RuntimeError):
    """A stage worker answered TASK_ERROR: the stage is alive and
    reachable but the task failed. Retryable (bounded); never triggers
    re-placement on its own."""

    def __init__(self, message: str, peer: str | None = None,
                 stage: int | None = None):
        super().__init__(message)
        self.peer = peer
        self.stage = stage


class StageDead(StageError):
    """The stage's transport is gone (connection lost, peer unknown, or a
    mid-chain successor vanished): a reply can never arrive. Failover
    re-places the stage on a replacement peer and resumes by re-prefill."""


class StageTimeout(StageError):
    """No reply within the step timeout. The stage may be alive but
    wedged or black-holed; blame can't be localized through a relay
    chain, so timeouts retry the existing chain instead of re-placing."""


# --------------------------------------------------------------- node mixin


class StageTaskMixin:
    """Task-protocol handlers mixed into P2PNode (kept separate so the
    mesh core stays readable; node.py wires _handle_task/_handle_result
    into its dispatch table)."""

    def add_stage_runner(self, runner) -> None:
        """Host a pipeline stage (StageRunner) on this node. The mesh
        addresses runners by the COORDINATOR'S model string, which under
        `--model auto` differs from the resolved config name — register
        both so part_forward/decode_run find the runner either way."""
        self.stage_runners[runner.model_cfg.name] = runner
        requested = getattr(runner, "requested_model", None)
        if requested and requested != runner.model_cfg.name:
            self.stage_runners[requested] = runner

    async def _peer_ws(self, peer_id: str | None, what: str):
        """Resolve a peer's live ws or raise StageDead — the relay/ring
        handlers' shared lookup (one place to change if peer bookkeeping
        does). Typed so a mid-chain death classifies as `dead` at the
        origin, not as a generic task error."""
        if not peer_id:
            raise StageDead(f"{what}: peer unknown (dropped mid-task?)")
        async with self._lock:
            info = self.peers.get(peer_id)
        if info is None:
            raise StageDead(f"{what}: peer {peer_id!r} gone", peer=peer_id)
        return info["ws"]

    async def _handle_task(self, ws, data):
        # adopt the coordinator's trace context before dispatch: the
        # stage.task span (and any onward relay/ring frame this worker
        # sends, which inject_trace stamps from the contextvar) parents
        # under the request that caused it — every stage's /trace
        # fragment then stitches into the coordinator's timeline
        with use_trace_ctx(extract_trace(data)):
            with get_tracer().span(
                "stage.task", kind=data.get("kind"), model=data.get("model")
            ) as sp:
                # the stage index rides the span so the bubble-fraction
                # derivation (health.bubble_from_spans) can attribute
                # busy time per stage, not just per node
                runner = self.stage_runners.get(data.get("model"))
                if runner is not None:
                    sp.attrs["stage"] = runner.spec.stage
                await self._dispatch_task(ws, data)

    async def _dispatch_task(self, ws, data):
        kind = data.get("kind")
        task_id = data.get("task_id")

        async def fail(error: str, error_kind: str = protocol.ERR_KIND_ERROR):
            # relayed tasks report failure to the ORIGIN coordinator, not
            # the previous stage (which isn't waiting on anything)
            origin = data.get("origin_peer")
            if origin:
                try:
                    origin_ws = await self._peer_ws(origin, "task error routing")
                except RuntimeError:
                    origin_ws = None
                if origin_ws is not None:
                    await self._send(
                        origin_ws,
                        protocol.msg(
                            protocol.TASK_ERROR,
                            task_id=data.get("origin_task_id"), error=error,
                            error_kind=error_kind,
                        ),
                    )
                    return
            await self._send(
                ws, protocol.msg(protocol.TASK_ERROR, task_id=task_id,
                                 error=error, error_kind=error_kind)
            )

        try:
            if kind == protocol.TASK_PART_LOAD:
                await self._task_part_load(ws, data)
            elif kind == protocol.TASK_PART_FORWARD:
                await self._task_part_forward(ws, data)
            elif kind == protocol.TASK_PART_FORWARD_RELAY:
                await self._task_part_forward_relay(ws, data)
            elif kind == protocol.TASK_DECODE_RUN:
                await self._task_decode_run(ws, data)
            elif kind == protocol.TASK_LAYER_FORWARD_TRAIN:
                await self._task_forward_train(ws, data)
            elif kind == protocol.TASK_LAYER_BACKWARD:
                await self._task_backward(ws, data)
            elif kind == "part_release":
                runner = self.stage_runners.get(data.get("model"))
                if runner is not None:
                    runner.release(data.get("request_id"))
                await self._send(
                    ws, protocol.msg(protocol.RESULT, task_id=task_id, ok=True)
                )
            else:
                await fail(f"unknown task kind {kind!r}")
        except Exception as e:  # noqa: BLE001 — worker must answer, not die
            logger.exception("task %s failed", kind)
            await fail(
                f"{type(e).__name__}: {e}",
                protocol.ERR_KIND_DEAD if isinstance(e, StageDead)
                else protocol.ERR_KIND_ERROR,
            )

    async def _task_part_load(self, ws, data):
        from ..engine import StageRunner  # not ported: raises by name

        task_id = data.get("task_id")
        epoch = int(data.get("epoch", 0))
        existing = self.stage_runners.get(data.get("model"))
        if existing is not None and existing.matches_load(data):
            # failover idempotency: re-loading the SAME stage is a no-op
            # (no recompile) that adopts the request's epoch and re-dials
            # the relay successor below — recover() re-wires surviving
            # stages this way. max() so a straggling retry from an older
            # attempt can never downgrade the epoch.
            runner = existing
            runner.epoch = max(runner.epoch, epoch)
        else:
            loop = asyncio.get_running_loop()
            runner = await loop.run_in_executor(
                None,
                lambda: StageRunner(
                    data["model"],
                    n_stages=int(data["n_stages"]),
                    stage=int(data["stage"]),
                    checkpoint_path=data.get("checkpoint_path"),
                    max_seq_len=int(data.get("max_seq_len", 2048)),
                    dtype=data.get("dtype", "bfloat16"),
                    rng_seed=int(data.get("rng_seed", 0)),
                    quantize=data.get("quantize", "none"),
                    epoch=epoch,
                ),
            )
            self.add_stage_runner(runner)
        # relay chaining: dial the NEXT stage so hidden states can hop
        # worker→worker without bouncing through the coordinator
        relay = False
        next_addr = data.get("next_addr")
        if next_addr:
            try:
                # plain peer dial — NOT connect_bootstrap: bootstrap addrs
                # are redialed forever even after a clean GOODBYE, which
                # would chase a retired successor for the process lifetime
                if self.peer_for_addr(next_addr) or await self._connect_peer(next_addr):
                    for _ in range(50):
                        pid = self.peer_for_addr(next_addr)
                        if pid:
                            self.stage_next[data["model"]] = pid
                            relay = True
                            break
                        await self.clock.sleep(0.1)
            except Exception:  # noqa: BLE001 — relay optional; fall back
                logger.exception("next-stage dial %s failed", next_addr)
        await self._send(
            ws,
            protocol.msg(
                protocol.RESULT, task_id=task_id, ok=True,
                # relay: can this stage chain forward (last stage answers
                # the origin instead, so it chains by definition).
                # ring: did the successor dial actually succeed — the last
                # stage's wrap-around link to stage 0 enables burst decode.
                info={**runner.info,
                      "relay": relay or runner.spec.is_last,
                      "ring": relay,
                      # this stage's decode_run knows temperature/seed
                      # fields (round 5) — a coordinator must NOT route
                      # sampled requests around a ring of older stages
                      # that would silently argmax them
                      "ring_sampling": relay},
            ),
        )

    async def _run_stage_forward(self, data) -> np.ndarray:
        """Shared parse + executor dispatch for both forward task kinds:
        pull x off the binary frame, coerce offset/write_mask/gather
        (int | [B] lists — the batched session), run the stage."""
        runner = self.stage_runners.get(data.get("model"))
        if runner is None:
            raise RuntimeError(f"no stage loaded for model {data.get('model')!r}")
        epoch = data.get("epoch")
        if epoch is not None and int(epoch) != getattr(runner, "epoch", 0):
            # late traffic addressed to a replaced occupant (or a stage
            # that missed a re-load): refuse instead of corrupting caches
            raise RuntimeError(
                f"stale stage epoch {epoch} (stage now at {runner.epoch})"
            )
        x = data["_tensors"]["x"]
        offset = data.get("offset", 0)
        if not isinstance(offset, int):
            offset = np.asarray(offset, np.int32)
        mask = data.get("write_mask")
        if mask is not None:
            mask = np.asarray(mask, bool)
        gather = data.get("gather")
        if gather is not None:
            gather = np.asarray(gather, np.int32)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None,
            lambda: runner.forward(
                data["request_id"], x, offset, write_mask=mask, gather=gather
            ),
        )

    async def _task_part_forward(self, ws, data):
        out = await self._run_stage_forward(data)
        frame = protocol.encode_binary(
            # inject: the RESULT carries this worker's span context back
            # (a coordinator-side consumer can link reply to stage span)
            inject_trace(
                protocol.msg(protocol.RESULT, task_id=data.get("task_id"), ok=True)
            ),
            {"out": out},
        )
        await self._send(ws, frame)

    async def _task_part_forward_relay(self, ws, data):
        """Relay-chained forward: run this stage, then hand the output
        DIRECTLY to the next stage (or, on the last stage, answer the
        origin coordinator). Per decode step the coordinator pays one
        send + one receive instead of two round trips per stage, and
        hidden states never transit the coordinator at all."""
        # first hop (coordinator → stage 0) carries no origin fields: the
        # sender IS the origin and its task_id is the reply correlation id
        if not data.get("origin_peer"):
            sender = await self._peer_for(ws)
            if sender is None:  # a None origin would misroute the RESULT
                raise RuntimeError("relay sender unknown (dropped mid-task?)")
            data["origin_peer"] = sender
            data["origin_task_id"] = data.get("task_id")
        out = await self._run_stage_forward(data)
        runner = self.stage_runners[data["model"]]
        if runner.spec.is_last:
            origin_ws = await self._peer_ws(data.get("origin_peer"), "relay origin")
            frame = protocol.encode_binary(
                inject_trace(protocol.msg(
                    protocol.RESULT, task_id=data.get("origin_task_id"), ok=True
                )),
                {"out": out},
            )
            await self._send(origin_ws, frame)
            return
        next_ws = await self._peer_ws(
            self.stage_next.get(data["model"]), "relay next stage"
        )
        fields = {
            k: data[k]
            for k in ("model", "request_id", "offset", "write_mask", "gather",
                      "origin_peer", "origin_task_id", "epoch")
            if k in data
        }
        frame = protocol.encode_binary(
            # inject under THIS stage's span (set by _handle_task), so the
            # next stage's span parents stage-under-stage along the chain
            inject_trace(protocol.msg(
                protocol.TASK, kind=protocol.TASK_PART_FORWARD_RELAY,
                task_id=new_id("task"), **fields,
            )),
            {"x": out},
        )
        await self._send(next_ws, frame)

    async def _task_forward_train(self, ws, data):
        """Training forward: run the stage uncached, retaining activations
        for the backward (the reference's layer_forward_train worker task,
        reference node.py:99-130, realized as real stage VJP state)."""
        runner = self.stage_runners.get(data.get("model"))
        if runner is None:
            raise RuntimeError(f"no stage loaded for model {data.get('model')!r}")
        loop = asyncio.get_running_loop()
        out = await loop.run_in_executor(
            None,
            lambda: runner.forward_train(data["request_id"], data["_tensors"]["x"]),
        )
        await self._send(ws, protocol.encode_binary(
            protocol.msg(protocol.RESULT, task_id=data.get("task_id"), ok=True),
            {"out": out},
        ))

    async def _task_backward(self, ws, data):
        """Training backward: VJP against the retained activation, SGD on
        this stage's params, dX back to the coordinator (reference
        node.py:131-182's layer_backward, with real gradients)."""
        runner = self.stage_runners.get(data.get("model"))
        if runner is None:
            raise RuntimeError(f"no stage loaded for model {data.get('model')!r}")
        loop = asyncio.get_running_loop()
        dx = await loop.run_in_executor(
            None,
            lambda: runner.backward(
                data["request_id"], data["_tensors"]["dy"],
                float(data.get("lr", 1e-3)),
            ),
        )
        msg = protocol.msg(protocol.RESULT, task_id=data.get("task_id"), ok=True)
        if dx is None:  # first stage: ids take no gradient
            await self._send(ws, msg)
        else:
            await self._send(ws, protocol.encode_binary(msg, {"dx": dx}))

    _RING_FIELDS = ("model", "request_id", "offset", "k", "eos", "gather",
                    "origin_peer", "origin_task_id", "temperature", "seed",
                    "epoch")
    BURST_STALE_S = 600.0

    @staticmethod
    def _ring_sample(logits: np.ndarray, data: dict) -> int:
        """Last-stage sampling for ring bursts. Greedy is plain argmax;
        temperature>0 draws from the softmax with an rng keyed on
        (coordinator seed, token position) — the position makes each
        draw's stream unique while keeping the whole rollout reproducible
        from the seed, independent of burst size (same semantics as
        PipelineCoordinator._sample, just computed where the logits are)."""
        temp = float(data.get("temperature") or 0.0)
        if temp <= 0.0:
            return int(np.argmax(logits))
        pos = int(np.asarray(data["offset"]).reshape(-1)[0])
        rng = np.random.default_rng((int(data.get("seed") or 0), pos))
        z = logits.astype(np.float64) / max(temp, 1e-6)
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(rng.choice(len(p), p=p))

    async def _task_decode_run(self, ws, data):
        """Ring-burst decode (kind=decode_run): the coordinator sends ONE
        message for up to k tokens. Each token circulates stage0→…→last;
        the LAST stage samples (argmax, or a seeded softmax draw when the
        request carries temperature>0) and feeds the new token straight
        back to stage 0 over the ring link, accumulating the burst
        locally; the coordinator hears back once per burst, not once per
        token."""
        runner = self.stage_runners.get(data.get("model"))
        if runner is None:
            raise RuntimeError(f"no stage loaded for model {data.get('model')!r}")
        if not data.get("origin_peer"):
            sender = await self._peer_for(ws)
            if sender is None:  # a None origin would misroute the RESULT
                raise RuntimeError("ring sender unknown (dropped mid-task?)")
            data["origin_peer"] = sender
            data["origin_task_id"] = data.get("task_id")
        if runner.spec.is_first and "x" not in (data.get("_tensors") or {}):
            data["_tensors"] = {
                "x": np.asarray([[int(data["token"])]], np.int32)
            }
        data.setdefault("gather", [0])  # last stage returns [1, V]
        out = await self._run_stage_forward(data)
        nxt = self.stage_next.get(data["model"])
        if not runner.spec.is_last:
            next_ws = await self._peer_ws(nxt, "ring next stage")
            fields = {k: data[k] for k in self._RING_FIELDS if k in data}
            await self._send(next_ws, protocol.encode_binary(
                inject_trace(protocol.msg(
                    protocol.TASK, kind=protocol.TASK_DECODE_RUN,
                    task_id=new_id("task"), **fields)),
                {"x": out},
            ))
            return
        # ---- last stage: sample, accumulate, circulate or answer ----
        tok = self._ring_sample(out[0], data)
        otid = data["origin_task_id"]
        now = self.clock.time()
        for stale in [k for k, v in self.stage_bursts.items()
                      if now - v["t"] > self.BURST_STALE_S]:
            self.stage_bursts.pop(stale, None)
        burst = self.stage_bursts.setdefault(otid, {"tokens": [], "t": now})
        burst["t"] = now  # refresh: a live burst must never be reaped
        eos = data.get("eos")
        k = int(data.get("k", 1))
        stopped = eos is not None and tok == eos
        if not stopped:
            burst["tokens"].append(tok)
        if stopped or len(burst["tokens"]) >= k:
            tokens = burst["tokens"]
            self.stage_bursts.pop(otid, None)
            origin_ws = await self._peer_ws(data["origin_peer"], "ring origin")
            await self._send(origin_ws, inject_trace(protocol.msg(
                protocol.RESULT, task_id=otid, ok=True,
                tokens=tokens, stopped=stopped,
            )))
            return
        try:
            next_ws = await self._peer_ws(nxt, "ring link to stage 0")
        except RuntimeError:
            self.stage_bursts.pop(otid, None)
            raise
        fields = {key: data[key] for key in self._RING_FIELDS if key in data}
        fields["offset"] = int(np.asarray(data["offset"]).reshape(-1)[0]) + 1
        fields["token"] = tok
        await self._send(next_ws, inject_trace(protocol.msg(
            protocol.TASK, kind=protocol.TASK_DECODE_RUN,
            task_id=new_id("task"), **fields,
        )))

    async def _handle_result(self, ws, data):
        """RESULT / TASK_ERROR → resolve the matching pending future."""
        task_id = data.get("task_id")
        async with self._pending_lock:
            fut = self._pending.get(task_id)
        if fut and not fut.done():
            fut.set_result(data)

    async def run_stage_task(
        self,
        peer_id: str,
        kind: str,
        fields: dict,
        tensors: dict | None = None,
        timeout: float = DEFAULT_STEP_TIMEOUT,
        reply_from: str | None = None,  # peer whose ws carries the REPLY
        # (relay/ring: the LAST stage answers, not the stage we send to)
    ) -> dict:
        """Send one task to a peer and await its RESULT (tensors included
        under '_tensors'). Failures raise the typed taxonomy: StageDead
        (transport gone / peer unknown / worker reported a dead
        successor), StageTimeout (no reply in `timeout`), StageError (the
        worker answered TASK_ERROR)."""
        async with self._lock:
            info = self.peers.get(peer_id)
            reply_info = self.peers.get(reply_from) if reply_from else info
        if info is None:
            raise StageDead(f"unknown peer {peer_id!r}", peer=peer_id)
        if reply_info is None:
            raise StageDead(f"unknown reply peer {reply_from!r}", peer=reply_from)
        task_id = new_id("task")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        async with self._pending_lock:
            self._pending[task_id] = fut
            # the connection the reply rides on: its death means the reply
            # can never arrive — fail fast instead of waiting out the
            # timeout. (Mid-chain stage deaths are covered separately: the
            # predecessor's failed send routes a TASK_ERROR to the origin.)
            self._pending_ws[task_id] = reply_info["ws"]
        _C_STAGE_TASKS.inc(kind=kind)
        # trace_ctx rides every stage task: the worker's stage.task span
        # (and relayed hops beyond it) parents under the caller's span
        message = inject_trace(
            protocol.msg(protocol.TASK, kind=kind, task_id=task_id, **fields)
        )
        try:
            try:
                if tensors:
                    await self._send(
                        info["ws"], protocol.encode_binary(message, tensors)
                    )
                else:
                    await self._send(info["ws"], message)
            except StageError:
                raise
            except Exception as e:  # ConnectionClosed/OSError under the send
                raise StageDead(
                    f"send {kind} to {peer_id!r} failed: {e}", peer=peer_id
                ) from e
            try:
                result = await self.clock.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                raise StageTimeout(
                    f"{kind} on {peer_id!r}: no reply in {timeout:.0f}s",
                    peer=reply_from or peer_id,
                ) from None
        finally:
            async with self._pending_lock:
                self._pending.pop(task_id, None)
                self._pending_ws.pop(task_id, None)
        if result.get("type") == protocol.TASK_ERROR or result.get("error"):
            err = result.get("error") or "task failed"
            if result.get("error_kind") == protocol.ERR_KIND_DEAD:
                raise StageDead(err, peer=peer_id)
            raise StageError(err, peer=peer_id)
        return result


# ------------------------------------------------------------- coordinator


def resolve_microbatches(
    stage_addrs: list,
    stage_task_ms: list | None = None,
    hop_rtt_ms: list | None = None,
    max_depth: int = 4,
) -> int:
    """The `--microbatches auto` heuristic: microbatch overlap pays only
    when stages compute in PARALLEL, i.e. they run on different hosts —
    then group g+1's stage-0 compute genuinely overlaps group g's stage-1
    compute. Stages sharing one host contend for the same cores, so the
    M× extra wire messages buy nothing (measured on the loopback split:
    docs/PERF.md "Microbatch overlap"). Unknown topology resolves to 1 —
    never gamble hop cost on a guess.

    With telemetry the distinct-host answer graduates from the
    binary guess to a DEPTH: `stage_task_ms` (per-stage p50 task time from
    the gossiped digests' `pipeline.stage_task_ms` histogram) and
    `hop_rtt_ms` (coordinator→stage ping RTTs) give the classic pipeline
    fill bound — to keep S stages busy, the in-flight window must cover
    one token's full wall time, S·(compute + hop), at `compute` per stage:

        depth ≈ round(S · (1 + hop / compute))

    clamped to [2, max_depth] (the session clamps to max_batch again).
    Pure compute-bound stages (hop ≪ compute) resolve to the stage count;
    hop-dominated topologies ask for more in-flight chains to hide the
    wire. Absent/empty telemetry falls back to the legacy answer of 2."""
    hosts = set()
    for a in stage_addrs:
        if not a:
            return 1
        try:
            host = urlparse(a).hostname or str(a)
        except ValueError:
            return 1
        if host == "::1" or host.startswith("127."):
            # loopback aliases are all the same machine — mixed
            # localhost/127.0.0.1 worker flags must not read as two hosts
            host = "localhost"
        hosts.add(host)
    if len(hosts) < 2:
        return 1
    timings = [float(t) for t in (stage_task_ms or []) if t]
    rtts = [float(r) for r in (hop_rtt_ms or []) if r]
    if not timings or not rtts:
        return 2  # distinct hosts, no telemetry: the legacy binary guess
    compute = sorted(timings)[len(timings) // 2]  # median stage compute
    hop = sorted(rtts)[len(rtts) // 2] / 2.0  # one-way hop estimate
    depth = round(len(stage_addrs) * (1.0 + hop / max(compute, 1e-3)))
    return max(2, min(depth, max_depth))


class PipelineCoordinator:
    """Drive generation across stage workers (reference contrast:
    node.py:249-277 chains hf_part_forward hops; here the chain carries a
    KV-cached decode loop with host-side sampling at the coordinator)."""

    def __init__(
        self,
        node,
        model: str,
        stage_peers: list[str],  # peer_ids in stage order (stage i = peers[i])
        max_seq_len: int = 2048,
        dtype: str = "bfloat16",
        rng_seed: int = 0,
        quantize: str = "none",  # int8: each stage quantizes ITS slice
        step_timeout: float = DEFAULT_STEP_TIMEOUT,
        max_failover_retries: int = DEFAULT_FAILOVER_RETRIES,
        failover_backoff_s: float = DEFAULT_FAILOVER_BACKOFF_S,
        generation_deadline_s: float = DEFAULT_GENERATION_DEADLINE_S,
    ):
        self.node = node
        self.clock = getattr(node, "clock", None) or get_clock()
        self.model = model
        self.stage_peers = list(stage_peers)
        self.max_seq_len = max_seq_len
        self.dtype = dtype
        self.rng_seed = rng_seed
        self.quantize = quantize
        # failover policy (docs/ROBUSTNESS.md): bounded retries with
        # exponential backoff under a per-generation wall-clock deadline
        self.step_timeout = step_timeout
        self.max_failover_retries = max_failover_retries
        self.failover_backoff_s = failover_backoff_s
        self.generation_deadline_s = generation_deadline_s
        # stage epoch: bumped by recover(); stamped into every task so
        # late replies/relays from a replaced occupant are refused
        self.epoch = 0
        # single-flight: concurrent generations that all caught the same
        # stage failure must share ONE rebuild, not ping-pong epoch bumps
        # that invalidate each other's chains
        self._recover_lock = asyncio.Lock()
        self.checkpoint_path: str | None = None
        self.load_timeout = 600.0
        # set by load(): every stage dialed its successor, so chains can
        # relay worker→worker instead of round-tripping the coordinator
        self.relay_ok = False
        # the ring closes (last stage → stage 0): greedy decode can run
        # K-token bursts with last-stage sampling
        self.ring_ok = False
        # every stage also speaks the burst temperature/seed fields
        self.ring_sampling_ok = False
        self.ring_burst = 16  # tokens per coordinator round trip

    async def load(
        self, checkpoint_path: str | None = None, timeout: float = 600.0
    ) -> list[dict]:
        """part_load every stage concurrently; returns their stage infos.
        `timeout` covers checkpoint read + compile per stage (a 7B half
        takes minutes — far beyond the per-step default). The checkpoint
        path and timeout are remembered so recover() can rebuild a dead
        stage from the same source."""
        self.checkpoint_path = checkpoint_path
        self.load_timeout = timeout
        return await self._load_stages(timeout)

    async def _load_stages(self, timeout: float) -> list[dict]:
        """part_load all stages at the current epoch (idempotent for
        already-loaded stages — they adopt the epoch and re-dial their
        relay successor). If a long-lived worker reports a HIGHER epoch
        (it outlived a coordinator restart), adopt the max and re-load
        once so every stage agrees."""
        for _ in range(2):
            # each stage gets its successor's dial address for relay chaining
            async with self.node._lock:
                addrs = [
                    (self.node.peers.get(pid) or {}).get("addr")
                    for pid in self.stage_peers
                ]
            results = await asyncio.gather(
                *(
                    self.node.run_stage_task(
                        peer,
                        protocol.TASK_PART_LOAD,
                        {
                            "model": self.model,
                            "n_stages": len(self.stage_peers),
                            "stage": s,
                            "max_seq_len": self.max_seq_len,
                            "dtype": self.dtype,
                            "rng_seed": self.rng_seed,
                            "quantize": self.quantize,
                            "checkpoint_path": self.checkpoint_path,
                            "epoch": self.epoch,
                            # wrap-around: the LAST stage dials stage 0,
                            # closing the ring for burst decode
                            "next_addr": (
                                addrs[(s + 1) % len(self.stage_peers)]
                                if len(self.stage_peers) > 1 else None
                            ),
                        },
                        timeout=timeout,
                    )
                    for s, peer in enumerate(self.stage_peers)
                )
            )
            infos = [r.get("info", {}) for r in results]
            top = max(
                [self.epoch, *(int(i.get("epoch") or 0) for i in infos)]
            )
            if top == self.epoch:
                break
            self.epoch = top
        self.relay_ok = len(infos) > 0 and all(i.get("relay") for i in infos)
        self.ring_ok = (
            len(infos) > 1 and all(i.get("ring") for i in infos)
        )
        # sampled bursts need every stage to SPEAK the temperature/seed
        # fields; an older stage would ignore them and argmax silently
        self.ring_sampling_ok = (
            self.ring_ok and all(i.get("ring_sampling") for i in infos)
        )
        return infos

    # ------------------------------------------------------------- failover

    def stage_health(self) -> list[dict]:
        """Per-stage health off the node's existing ping bookkeeping:
        'online', 'unreachable' (3 missed pings), or 'dead' (no
        connection at all). Sync read on the loop thread — same
        justification as P2PNode.peer_for_addr."""
        out = []
        for s, pid in enumerate(self.stage_peers):
            info = self.node.peers.get(pid)
            status = "dead" if info is None else info.get("health", "online")
            out.append({"stage": s, "peer": pid, "status": status})
        return out

    def _pick_replacement(self, exclude: set[str]) -> str | None:
        """Best replacement peer for a dead stage: online peers outside
        the pipeline, capacity-advertising ones (hello's accepts_stages)
        first, then lowest RTT."""
        cands = []
        for pid, info in list(self.node.peers.items()):
            if pid in exclude or info.get("health") != "online":
                continue
            cands.append((
                0 if info.get("accepts_stages") else 1,
                info.get("rtt_ms") or float("inf"),
                pid,
            ))
        return sorted(cands)[0][2] if cands else None

    async def recover(
        self, timeout: float | None = None, observed_epoch: int | None = None,
    ) -> list[tuple[int, str]]:
        """Re-place every dead/unreachable stage on a replacement peer and
        rebuild the whole chain under a bumped stage epoch: survivors
        adopt the epoch and re-dial their relay successors (idempotent
        part_load — no recompile); replacements load the dead stage's
        layer range from the same checkpoint path (or the deterministic
        seed init). Returns [(stage, new_peer_id)] for what moved. Raises
        StageDead when a dead stage has no replacement candidate.

        Single-flight: pass `observed_epoch` (the epoch at the moment the
        failure was caught) and concurrent callers share one rebuild —
        whoever queues behind the lock finds the epoch already past its
        observation and returns immediately instead of bumping again."""
        async with self._recover_lock:
            if observed_epoch is not None and self.epoch > observed_epoch:
                return []  # another caller already rebuilt the chain
            timeout = self.load_timeout if timeout is None else timeout
            # pick a replacement for EVERY dead stage before committing
            # any of them: a no-replacement raise must leave stage_peers
            # untouched, not half-pointing at a never-loaded peer
            new_peers = list(self.stage_peers)
            replaced: list[tuple[int, str]] = []
            exclude = set(self.stage_peers) | {self.node.peer_id}
            for h in self.stage_health():
                if h["status"] == "online":
                    continue
                pid = self._pick_replacement(exclude)
                if pid is None:
                    # the ONLY raise carrying stage= — generate()'s retry
                    # loop keys "terminal, fail fast" off that
                    raise StageDead(
                        f"stage {h['stage']} ({h['peer']}) is {h['status']} "
                        "and no replacement peer is available",
                        peer=h["peer"], stage=h["stage"],
                    )
                new_peers[h["stage"]] = pid
                exclude.add(pid)
                replaced.append((h["stage"], pid))
            self.stage_peers = new_peers
            self.epoch += 1
            _C_RECOVERIES.inc()
            _C_EPOCH_BUMPS.inc()
            _C_STAGES_REPLACED.inc(len(replaced))
            await self._load_stages(timeout)
            if replaced:
                logger.info(
                    "pipeline failover: re-placed stages %s (epoch %d)",
                    replaced, self.epoch,
                )
            return replaced

    async def _chain(self, request_id: str, x: np.ndarray, offset: int) -> np.ndarray:
        """ids/hidden through every stage; returns last stage's logits.
        With relay chaining (load() dialed stage→stage links) the whole
        chain is one send + one receive at the coordinator."""
        fields = {"model": self.model, "request_id": request_id,
                  "offset": offset, "epoch": self.epoch}
        if self.relay_ok and len(self.stage_peers) > 1:
            result = await self.node.run_stage_task(
                self.stage_peers[0], protocol.TASK_PART_FORWARD_RELAY,
                fields, tensors={"x": x},
                # ONE await covers the whole chain (first prefill lazily
                # compiles every stage) — budget per stage, like the
                # per-stage path effectively did
                timeout=self.step_timeout * len(self.stage_peers),
                reply_from=self.stage_peers[-1],
            )
            return result["_tensors"]["out"]
        for peer in list(self.stage_peers):  # snapshot: replacement can rebind mid-chain
            result = await self.node.run_stage_task(
                peer, protocol.TASK_PART_FORWARD, fields, tensors={"x": x},
                timeout=self.step_timeout,
            )
            x = result["_tensors"]["out"]
        return x

    async def release(self, request_id: str, timeout: float | None = None) -> None:
        await asyncio.gather(
            *(
                self.node.run_stage_task(
                    peer,
                    "part_release",
                    {"model": self.model, "request_id": request_id},
                    timeout=self.step_timeout if timeout is None else timeout,
                )
                for peer in self.stage_peers
            ),
            return_exceptions=True,
        )

    async def generate(
        self,
        prompt_ids: list[int],
        max_new_tokens: int = 64,
        temperature: float = 0.0,
        eos_token_id: int | None = None,
        on_token=None,
        deadline_s: float | None = None,
    ) -> list[int]:
        """Greedy/temperature generation across the pipeline. Returns new
        token ids (stops at eos_token_id when given).

        Failover: a typed stage failure (StageDead/StageTimeout/
        StageError) triggers recover() — dead stages re-placed, chain
        rebuilt under a new epoch — and the generation RESUMES by
        re-prefilling prompt + accepted-so-far through the rebuilt chain
        (the coordinator holds every accepted token, so resume is exact
        for greedy decode). Bounded by max_failover_retries with
        exponential backoff under a wall-clock deadline: requests finish
        or fail fast with the typed error, never hang."""
        rid = new_id("ppreq")
        rng = np.random.default_rng(abs(hash(rid)) % (2**32))
        # left-truncate over-long prompts to what the stage caches can hold
        # (the engine's serving behavior: keep the most recent context)
        budget = self.max_seq_len - 1 - max(1, min(max_new_tokens, self.max_seq_len - 1))
        prompt_ids = list(prompt_ids)[-max(budget, 1):]
        n = len(prompt_ids)
        if n + max_new_tokens >= self.max_seq_len:
            max_new_tokens = max(0, self.max_seq_len - 1 - n)
        if max_new_tokens <= 0:
            return []
        deadline = self.clock.time() + (
            self.generation_deadline_s if deadline_s is None else deadline_s
        )
        out: list[int] = []
        # the root span of a pipeline generation: run_stage_task injects
        # its context into every stage task, so worker-side stage.task
        # spans across the mesh share this trace_id (stitched timeline)
        with get_tracer().span(
            "pipeline.generate", model=self.model,
            stages=len(self.stage_peers),
        ) as gen_span:
            try:
                return await self._generate_with_failover(
                    rid, prompt_ids, out, max_new_tokens,
                    temperature, eos_token_id, on_token, rng, deadline,
                )
            finally:
                gen_span.attrs["tokens"] = len(out)

    async def _generate_with_failover(
        self, rid, prompt_ids, out, max_new_tokens, temperature,
        eos_token_id, on_token, rng, deadline,
    ) -> list[int]:
        attempt = 0
        resume_in_place = False
        try:
            while True:
                # the epoch this attempt's chains run under: if a failure
                # lands after ANOTHER caller already rebuilt the chain,
                # recover() sees epoch > observed and coalesces to a no-op
                attempt_epoch = self.epoch
                try:
                    return await self._generate_attempt(
                        rid, prompt_ids, out, max_new_tokens, temperature,
                        eos_token_id, on_token, rng,
                        resume_in_place=resume_in_place,
                    )
                except StageError as e:
                    attempt += 1
                    remaining = deadline - self.clock.time()
                    # migration-preferring rung: an ALIVE chain (typed
                    # timeout/error, no re-placement happened, tokens
                    # accepted) keeps every stage's KV — resume decode in
                    # place. One try per generation: a second failure
                    # escalates to the release+recover+re-prefill rung
                    # (and StageDead skips straight there — a dead
                    # stage's cache is unrecoverable state).
                    resume_in_place = (
                        bool(out)
                        and not isinstance(e, StageDead)
                        and self.epoch == attempt_epoch
                        and attempt == 1
                        and attempt <= self.max_failover_retries
                        and remaining > 0
                    )
                    # flight-recorder incident BEFORE the terminal check:
                    # both a failover and a final failure leave a bundle.
                    # We're inside the pipeline.generate span, so the
                    # recorder snapshots this generation's stitched trace
                    # (every stage.task span shares its trace_id).
                    get_recorder().incident(
                        "stage_failover",
                        detail=f"{type(e).__name__}: {e}",
                        extra={
                            "attempt": attempt,
                            "accepted_tokens": len(out),
                            "model": self.model,
                            "epoch": attempt_epoch,
                            "resume_in_place": resume_in_place,
                            "terminal": attempt > self.max_failover_retries
                            or remaining <= 0,
                        },
                    )
                    if attempt > self.max_failover_retries or remaining <= 0:
                        raise
                    logger.warning(
                        "pipeline generation hit %s (%s); failover attempt "
                        "%d/%d with %d tokens accepted%s",
                        type(e).__name__, e, attempt,
                        self.max_failover_retries, len(out),
                        " (resuming in place)" if resume_in_place else "",
                    )
                    await self.clock.sleep(min(
                        self.failover_backoff_s * 2 ** (attempt - 1),
                        max(remaining, 0.0),
                    ))
                    if resume_in_place:
                        # re-check AFTER the sleep: a concurrent failover
                        # may have rebuilt the chain meanwhile — this
                        # rid's stage caches are gone on replacements, so
                        # an in-place resume would decode over garbage
                        if self.epoch != attempt_epoch:
                            resume_in_place = False
                        else:
                            _C_RESUMES_IN_PLACE.inc()
                            continue  # same rid: stage caches stay live
                    # every recovery step is capped by the REMAINING
                    # deadline budget: a wedged stage that also swallows
                    # release/part_load must not stretch time-to-failure
                    # past generation_deadline_s
                    budget = max(deadline - self.clock.time(), 1.0)
                    await self.release(  # survivors drop the old caches
                        rid, timeout=min(self.step_timeout, budget)
                    )
                    try:
                        await self.recover(
                            timeout=min(self.load_timeout,
                                        max(deadline - self.clock.time(), 1.0)),
                            observed_epoch=attempt_epoch,
                        )
                    except StageDead as rec_err:
                        if rec_err.stage is not None:
                            raise  # no replacement exists: terminal
                        # transient rebuild failure (e.g. the picked
                        # replacement died mid-load): spend the retry,
                        # the next recover() can pick another peer
                        logger.warning("recover attempt failed: %s", rec_err)
                    except StageError as rec_err:
                        logger.warning("recover attempt failed: %s", rec_err)
                    rid = new_id("ppreq")  # fresh caches on the rebuilt chain
        finally:
            await self.release(rid)

    async def _generate_attempt(
        self, rid, prompt_ids, out, max_new_tokens, temperature,
        eos_token_id, on_token, rng, resume_in_place: bool = False,
    ) -> list[int]:
        """One pass of the decode loop. `out` accumulates ACROSS attempts:
        on resume, prompt + accepted tokens re-prefill in one chain call
        and decode continues from where the failure struck.

        ``resume_in_place`` (alive-chain failover): skip the prefill —
        the stage caches under this SAME rid already hold K/V for every
        position below the frontier. Re-chaining the last accepted token
        at its own offset rewrites at most one position with identical
        values (idempotent) and yields the next sample; positions a
        half-finished step wrote past the frontier are overwritten or
        causally masked exactly like bucketed-prefill padding."""
        full = list(prompt_ids) + out
        n = len(full)
        if resume_in_place and out:
            logits = await self._chain(
                rid, np.asarray([[full[-1]]], np.int32), offset=n - 1
            )
            tok = self._sample(logits[0, -1], temperature, rng)
            return await self._decode_loop(
                rid, out, max_new_tokens, temperature, eos_token_id,
                on_token, rng, tok, offset=n,
            )
        # pow2 prompt bucket bounds worker recompiles; pad K/V past n is
        # overwritten by decode exactly when it enters the causal window
        # (same trick as the engine's bucketed prefill)
        bucket = 16
        while bucket < n:
            bucket *= 2
        bucket = min(bucket, self.max_seq_len)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = full
        logits = await self._chain(rid, padded, offset=0)
        tok = self._sample(logits[0, n - 1], temperature, rng)
        greedy = temperature is None or temperature <= 0.0
        if (self.ring_ok and max_new_tokens - len(out) > 1
                and (greedy or self.ring_sampling_ok)):
            # sampled requests ride the burst path too: the LAST stage
            # draws with an rng keyed on (seed, position), so K tokens
            # still cost one coordinator round trip (r4 was greedy-only).
            # Gated on ring_sampling_ok — an older stage would ignore
            # the temperature/seed fields and silently argmax
            return await self._generate_ring(
                rid, tok, n, max_new_tokens, eos_token_id, on_token, out,
                temperature=temperature,
                seed=int(rng.integers(2**31)),
            )
        return await self._decode_loop(
            rid, out, max_new_tokens, temperature, eos_token_id, on_token,
            rng, tok, offset=n,
        )

    async def _decode_loop(
        self, rid, out, max_new_tokens, temperature, eos_token_id,
        on_token, rng, tok, offset: int,
    ) -> list[int]:
        """The per-token chain loop, shared by the fresh-prefill and
        resume-in-place entries (tok = next unchained sample, offset =
        the cache position its K/V will occupy)."""
        while True:
            if eos_token_id is not None and tok == eos_token_id:
                break
            out.append(tok)
            if on_token is not None:
                on_token(tok)
            if len(out) >= max_new_tokens:
                break
            logits = await self._chain(
                rid, np.asarray([[tok]], np.int32), offset=offset
            )
            offset += 1
            tok = self._sample(logits[0, -1], temperature, rng)
        return out

    async def train_step(
        self,
        input_ids: np.ndarray,  # [B, T] int32
        targets: np.ndarray,  # [B, T] int32 next-token labels
        lr: float = 1e-3,
        timeout: float = DEFAULT_STEP_TIMEOUT,
    ) -> float:
        """One cross-peer pipeline TRAINING step: forward through every
        stage (each retains its activations), softmax-cross-entropy grad
        at the coordinator, backward through the stages in reverse (each
        VJPs and SGD-updates its own params). Returns the mean loss.

        The reference's coordinator-worker training protocol
        (layer_forward_train / layer_backward, reference node.py:94-182)
        over real transformer stages — the cross-PEER counterpart of the
        in-slice GPipe trainer (parallel/pipeline.py).

        Caveat: tie_embeddings=True models hold the tied weight on BOTH
        the first and last stage (extract_stage_params), so cross-peer
        training updates the two copies with their partial gradients —
        effectively untying them. Train untied configs for exact parity
        with single-process training."""
        rid = new_id("pptrain")
        # first step compiles the stage forward AND the (bigger) VJP graph
        # — budget like load() does, not like a warm decode step
        step_timeout = max(timeout, 600.0)
        try:
            with get_tracer().span(
                "pipeline.train_step", model=self.model,
                stages=len(self.stage_peers), lr=lr,
            ):
                return await self._train_step_inner(rid, input_ids, targets,
                                                    lr, step_timeout)
        finally:
            # a failed/partial step must not strand retained activations
            # on the stages that DID run forward_train
            await self.release(rid)

    async def _train_step_inner(self, rid, input_ids, targets, lr, step_timeout):
        x = np.asarray(input_ids, np.int32)
        for peer in list(self.stage_peers):  # snapshot: replacement can rebind mid-chain
            result = await self.node.run_stage_task(
                peer, protocol.TASK_LAYER_FORWARD_TRAIN,
                {"model": self.model, "request_id": rid},
                tensors={"x": x}, timeout=step_timeout,
            )
            x = result["_tensors"]["out"]
        logits = x.astype(np.float64)  # [B, T, V]
        B, T, V = logits.shape
        z = logits - logits.max(axis=-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=-1, keepdims=True)
        tgt = np.asarray(targets, np.int64).reshape(-1)
        n = B * T
        flat = p.reshape(n, V)
        loss = float(-np.log(
            np.maximum(flat[np.arange(n), tgt], 1e-30)
        ).mean())
        # grad in place: softmax minus one at the target index (no
        # [n, V] one-hot materialization)
        dlogits = flat.astype(np.float32)
        dlogits[np.arange(n), tgt] -= 1.0
        dlogits /= n
        dy = dlogits.reshape(B, T, V)
        for peer in reversed(self.stage_peers):
            result = await self.node.run_stage_task(
                peer, protocol.TASK_LAYER_BACKWARD,
                {"model": self.model, "request_id": rid, "lr": lr},
                tensors={"dy": dy}, timeout=step_timeout,
            )
            tens = result.get("_tensors") or {}
            if "dx" in tens:
                dy = tens["dx"]
        return loss

    async def _generate_ring(
        self, rid, first_tok, n, max_new_tokens, eos_token_id, on_token, out,
        temperature: float = 0.0, seed: int = 0,
    ) -> list[int]:
        """Decode in ring bursts: one coordinator round trip per K tokens
        — tokens circulate stage0→…→last→stage0 with last-stage sampling
        (TASK_DECODE_RUN: argmax, or a (seed, position)-keyed softmax draw
        for temperature>0). The caller's finally releases the stage
        caches."""
        if eos_token_id is not None and first_tok == eos_token_id:
            return out
        out.append(first_tok)
        if on_token is not None:
            on_token(first_tok)
        tok, offset = first_tok, n  # position tok's K/V takes when fed
        while len(out) < max_new_tokens:
            k = min(self.ring_burst, max_new_tokens - len(out))
            result = await self.node.run_stage_task(
                self.stage_peers[0],
                protocol.TASK_DECODE_RUN,
                {
                    "model": self.model, "request_id": rid,
                    "token": int(tok), "offset": int(offset), "k": int(k),
                    "eos": eos_token_id,
                    "temperature": float(temperature or 0.0),
                    "seed": int(seed),
                    "epoch": self.epoch,
                },
                timeout=self.step_timeout + 2.0 * k,
                reply_from=self.stage_peers[-1],
            )
            toks = result.get("tokens") or []
            for t in toks:
                out.append(t)
                if on_token is not None:
                    on_token(t)
            if result.get("stopped") or not toks:
                break
            # fed this burst: tok + toks[:-1]; toks[-1] feeds next burst
            offset += len(toks)
            tok = toks[-1]
        return out

    @staticmethod
    def _sample(logits: np.ndarray, temperature: float, rng) -> int:
        if temperature is None or temperature <= 0.0:
            return int(np.argmax(logits))
        z = logits.astype(np.float64) / max(temperature, 1e-6)
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(rng.choice(len(p), p=p))

    def _stage_telemetry(self) -> tuple[list, list]:
        """(per-stage task-time p50s, hop RTTs) for the auto-depth
        heuristic: task timings come from the stage peers' gossiped
        digests (health.HealthStore), hop latency from the node's ping
        bookkeeping. Missing readings are simply absent — the heuristic
        degrades to the binary guess."""
        store = getattr(self.node, "health", None)
        fresh = store.fresh() if store is not None else {}
        timings = []
        for pid in self.stage_peers:
            hist = ((fresh.get(pid) or {}).get("hist") or {}).get(
                "pipeline.stage_task_ms"
            ) or {}
            p50 = hist.get("p50")
            if p50:
                timings.append(float(p50))
        rtts = [
            (self.node.peers.get(pid) or {}).get("rtt_ms")
            for pid in self.stage_peers
        ]
        return timings, [float(r) for r in rtts if r]

    def session(
        self,
        max_batch: int = 8,
        n_microbatches: int | str = "auto",
        interleave: bool = True,
        inflight_window: int | None = None,
    ) -> "PipelineSession":
        """A continuous-batching session over this coordinator's stages.
        n_microbatches="auto" resolves from the stage topology plus the
        gossiped stage-task timings (resolve_microbatches): 1 on a shared
        host, else a compute-vs-hop depth (legacy 2 without telemetry)."""
        if n_microbatches in (None, "auto"):
            addrs = [
                (self.node.peers.get(pid) or {}).get("addr")
                for pid in self.stage_peers
            ]
            try:
                timings, rtts = self._stage_telemetry()
            except Exception:  # noqa: BLE001 — telemetry is advisory
                timings, rtts = [], []
            n_microbatches = resolve_microbatches(
                addrs, stage_task_ms=timings, hop_rtt_ms=rtts
            )
        return PipelineSession(
            self.node,
            self.model,
            list(self.stage_peers),
            max_batch=max_batch,
            max_seq_len=self.max_seq_len,
            dtype=self.dtype,
            n_microbatches=n_microbatches,
            relay=self.relay_ok,
            coordinator=self,  # stage failover: recover + resume rows
            step_timeout=self.step_timeout,
            # the session inherits this coordinator's failover policy —
            # max_failover_retries=0 really disables failover everywhere
            max_failovers=self.max_failover_retries,
            failover_backoff_s=self.failover_backoff_s,
            interleave=interleave,
            inflight_window=inflight_window,
        )


# ------------------------------------------------------- batched session


class _SessionReq:
    """One request inside a PipelineSession (coordinator-side row state)."""

    __slots__ = (
        "ids", "out", "n", "max_new_tokens", "temperature", "eos", "rng",
        "on_token", "future", "last_tok",
    )

    def __init__(self, ids, max_new_tokens, temperature, eos, on_token):
        self.ids = ids
        self.out: list[int] = []
        self.n = len(ids)
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.eos = eos
        self.on_token = on_token
        self.rng = np.random.default_rng(abs(hash(tuple(ids[:8]))) % (2**32))
        self.future: asyncio.Future = asyncio.get_running_loop().create_future()
        self.last_tok = 0


class _Group:
    """One microbatch group: a fixed-size row table backed by its OWN
    per-stage KV cache (request_id = ``rid``) and, under the interleaved
    scheduler, its own free-running decode task. ``len()``/iteration
    expose the row table, so callers can treat a group as its rows."""

    __slots__ = ("idx", "rows", "rid", "queue", "wake", "task",
                 "failovers", "tokens", "prefills", "reprefills", "chains")

    def __init__(self, idx: int, size: int, rid: str):
        self.idx = idx
        self.rows: list[_SessionReq | None] = [None] * size
        self.rid = rid
        self.queue: deque[_SessionReq] = deque()
        self.wake = asyncio.Event()
        self.task: asyncio.Task | None = None
        self.failovers = 0  # consecutive; reset by a successful step
        # per-group progress counters: the straggler-isolation and
        # group-scoped failover tests pin behavior on these, never on
        # racy wall-clock thresholds
        self.tokens = 0
        self.prefills = 0  # admission chains run (incl. retried admissions)
        self.reprefills = 0  # admissions of rows that already held accepted
        # tokens — the failover re-prefill cost ("zero re-prefills" pins)
        self.chains = 0

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    def active(self) -> list[int]:
        return [i for i, r in enumerate(self.rows) if r is not None]

    def free_row(self) -> int | None:
        for i, r in enumerate(self.rows):
            if r is None:
                return i
        return None

    def load(self) -> int:
        """Rows this group is responsible for (admitted + queued) — the
        admission-spread key."""
        return len(self.active()) + len(self.queue)


class PipelineSession:
    """Continuous-batching decode across pipeline stages.

    The unbatched PipelineCoordinator.generate pays a full
    coordinator→stage0→…→coordinator round trip PER TOKEN PER REQUEST —
    n_requests × n_tokens × n_stages wire hops. This session keeps ONE
    [B]-row KV cache per microbatch group per stage and drives all of a
    group's active rows through a single [B, 1] chain per decode step:
    the wire cost per step is n_stages hops REGARDLESS of how many
    requests ride in the batch — the cross-peer realization of the
    engine's continuous-batching scheduler (engine/scheduler.py).

    Mechanics:
    - admission: a new request joins the least-loaded group's queue and
      prefills into a free row with write_mask=[row] (stage caches update
      only that row) and gather=[n_i - 1] so the last stage returns
      [B, V], not the full [B, bucket, V] logits.
    - decode: x = last tokens [B, 1], per-row offsets [B], write_mask =
      active rows, gather = 0 → one chain, one sample per active row.
    - retirement: EOS / budget resolves the row's future and frees the
      row between steps; stale K/V from a previous occupant is never
      attended (positions ≥ the new row's offset sit outside the causal
      mask until decode overwrites them — the bucketed-prefill argument).

    **Interleaved scheduling (the default).** Each microbatch
    group owns an independent, free-running decode task: the moment group
    g's chain leaves stage 0, group g+1's chain can enter it — no
    per-step barrier, so a straggler group (or a long admission prefill,
    which is just another chain in that group's stream) never stalls the
    other groups' token emission. In-flight chains across groups are
    bounded by a sliding window (``inflight_window``, an asyncio
    semaphore): each group holds at most one slot at a time, so any
    window > 1 preserves straggler isolation while capping how much
    concurrent work the coordinator can pile onto a stage (whose runner
    enforces its own ``max_concurrent_forwards``). The pre-interleave
    barrier loop survives as ``interleave=False`` — the A/B baseline the
    ``pipeline_interleave`` bench rung measures bubble fraction against.

    **Group-scoped failover.** A typed stage failure rides a per-group
    ladder (see ``_on_group_failure``): epoch adoption (a concurrent
    rebuild without re-placement keeps surviving stages' caches) →
    resume-in-place on the live caches → release + rotate THIS group's
    rid, recover() the chain, and requeue only this group's rows for
    re-prefill (prompt + accepted-so-far, exact resume for greedy).
    Healthy groups keep decoding through another group's failover; they
    are evacuated only when recover() actually RE-PLACED a stage, whose
    process death took every group's caches with it. Past the bounded
    attempts the failed group's rows fail with the typed error — other
    groups are untouched.

    `stats` counts chains/steps/prefills session-wide and each group
    carries its own tokens/prefills/chains progress counters
    (``group_progress()``), so tests can assert amortization and
    straggler isolation deterministically.
    """

    def __init__(
        self,
        node,
        model: str,
        stage_peers: list[str],
        max_batch: int = 8,
        max_seq_len: int = 2048,
        dtype: str = "bfloat16",
        n_microbatches: int = 1,
        relay: bool = False,  # stage→stage links up (coordinator.load)
        coordinator=None,  # enables failover: recover() + row resume
        step_timeout: float = DEFAULT_STEP_TIMEOUT,
        max_failovers: int = DEFAULT_FAILOVER_RETRIES,
        failover_backoff_s: float = 0.2,
        # cap on one recovery's part_load round; None = the coordinator's
        # load_timeout. The failed group (and every row queued on it)
        # blocks for at most this long per failover attempt.
        failover_load_timeout: float | None = None,
        # False: the older lockstep barrier loop (admission parks
        # decode; all groups advance behind one per-step gather) — kept
        # selectable as the bench baseline for the bubble measurement
        interleave: bool = True,
        # sliding window of concurrently in-flight chains across groups;
        # None = 2 per stage (each group occupies one slot per chain)
        inflight_window: int | None = None,
    ):
        self.node = node
        self.clock = getattr(node, "clock", None) or get_clock()
        self.model = model
        self.stage_peers = stage_peers
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.dtype = dtype
        self.relay = relay and len(stage_peers) > 1
        self.coordinator = coordinator
        self.step_timeout = step_timeout
        self.max_failovers = max_failovers
        self.failover_backoff_s = failover_backoff_s
        self.failover_load_timeout = failover_load_timeout
        self.epoch = getattr(coordinator, "epoch", 0)
        self.interleave = bool(interleave)
        self.sid = new_id("ppsess")
        M = max(1, min(n_microbatches, max_batch))
        base, extra = divmod(max_batch, M)
        sizes = [s for s in (base + (1 if m < extra else 0) for m in range(M))
                 if s > 0]
        self.groups: list[_Group] = [
            _Group(i, s, self.sid if len(sizes) == 1 else f"{self.sid}:m{i}")
            for i, s in enumerate(sizes)
        ]
        if inflight_window is None:
            # cover every group (so neither scheduler is throttled by
            # default — the lockstep baseline gathers all M chains per
            # step) with 2-per-stage as the floor
            inflight_window = max(2, 2 * len(stage_peers), len(self.groups))
        self.inflight_window = max(1, int(inflight_window))
        self._window = asyncio.Semaphore(self.inflight_window)
        self._wake = asyncio.Event()
        self._task: asyncio.Task | None = None  # lockstep-mode driver
        self._closed = False
        self.stats = {
            "chains": 0, "steps": 0, "prefills": 0, "tokens": 0,
            "tasks_sent": 0,  # coordinator sends: chains x stages, or
            # chains x 1 under relay — the wire-cost metric tests assert
            "resumes_in_place": 0,  # alive-chain failovers that kept the
            # stage caches (no re-prefill) — the migration-preferred rung
            "reprefills": 0,  # failover re-prefills of rows that already
            # held accepted tokens (healthy groups must stay at zero
            # through another group's failover)
        }

    # ------------------------------------------------------------- public

    async def generate(
        self,
        prompt_ids: list[int],
        max_new_tokens: int = 64,
        temperature: float = 0.0,
        eos_token_id: int | None = None,
        on_token=None,
    ) -> list[int]:
        if self._closed:
            raise RuntimeError("session closed")
        budget = self.max_seq_len - 1 - max(
            1, min(max_new_tokens, self.max_seq_len - 1)
        )
        prompt_ids = list(prompt_ids)[-max(budget, 1):]
        n = len(prompt_ids)
        if n + max_new_tokens >= self.max_seq_len:
            max_new_tokens = max(0, self.max_seq_len - 1 - n)
        if max_new_tokens <= 0:
            return []
        req = _SessionReq(prompt_ids, max_new_tokens, temperature,
                          eos_token_id, on_token)
        # admission spread: the least-loaded group takes the new row, so
        # microbatch caches fill evenly and overlap has groups to overlap
        g = min(self.groups, key=lambda gr: (gr.load(), gr.idx))
        g.queue.append(req)
        self._ensure_running()
        g.wake.set()
        self._wake.set()
        try:
            return await req.future
        except asyncio.CancelledError:
            # abandoned consumer: shrink the budget to what's already out
            # so the row retires at the next step instead of decoding the
            # rest of its budget into a dead future
            if req in g.queue:
                g.queue.remove(req)
            req.max_new_tokens = len(req.out)
            raise

    def group_progress(self) -> list[dict]:
        """Per-group progress counters (tokens emitted, prefills run,
        chains sent, rows live/queued) — the deterministic instrument for
        'a straggler group must not stall the others'."""
        return [
            {
                "group": g.idx, "tokens": g.tokens, "prefills": g.prefills,
                "reprefills": g.reprefills,
                "chains": g.chains, "active": len(g.active()),
                "queued": len(g.queue), "failovers": g.failovers,
            }
            for g in self.groups
        ]

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        for g in self.groups:
            g.wake.set()
        tasks = [
            t for t in [self._task, *(g.task for g in self.groups)]
            if t is not None and not t.done()
        ]
        if tasks:
            _done, pending = await asyncio.wait(tasks, timeout=10.0)
            for t in pending:
                t.cancel()
        # fail whatever was still in flight — an awaiting generate() must
        # see the close, not hang until the service-layer timeout
        err = RuntimeError("pipeline session closed")
        for g in self.groups:
            for i, req in enumerate(g.rows):
                if req is not None:
                    g.rows[i] = None
                    if not req.future.done():
                        req.future.set_exception(err)
            for req in g.queue:
                if not req.future.done():
                    req.future.set_exception(err)
            g.queue.clear()
        await self._release_all()

    # ------------------------------------------------------------ internal

    def _ensure_running(self) -> None:
        loop = asyncio.get_running_loop()
        if self.interleave:
            for g in self.groups:
                if g.task is None or g.task.done():
                    g.task = loop.create_task(self._group_loop(g))
                    g.task.add_done_callback(log_task_exception)
        elif self._task is None or self._task.done():
            self._task = loop.create_task(self._lockstep_loop())
            self._task.add_done_callback(log_task_exception)

    @property
    def _any_active(self) -> bool:
        return any(g.active() for g in self.groups)

    @property
    def _any_pending(self) -> bool:
        return any(g.queue for g in self.groups)

    async def _release_rid(self, rid: str) -> None:
        try:
            await asyncio.gather(
                *(
                    self.node.run_stage_task(
                        peer, "part_release",
                        {"model": self.model, "request_id": rid},
                        timeout=self.step_timeout,
                    )
                    for peer in self.stage_peers
                ),
                return_exceptions=True,
            )
        except Exception:  # noqa: BLE001 — release is best-effort
            pass

    async def _release_all(self) -> None:
        await asyncio.gather(
            *(self._release_rid(g.rid) for g in self.groups),
            return_exceptions=True,
        )

    async def _chain(self, g: _Group, x, offsets, mask, gather) -> np.ndarray:
        # the sliding window bounds chains concurrently in flight across
        # groups — each group holds at most one slot, so a straggler
        # parks one slot, never the scheduler
        async with self._window:
            self.stats["chains"] += 1
            g.chains += 1
            fields = {
                "model": self.model,
                "request_id": g.rid,
                "offset": [int(o) for o in offsets],
                "write_mask": [bool(m) for m in mask],
                "epoch": self.epoch,
            }
            if self.relay:
                # one send, one receive: stages hand hidden states to each
                # other; the LAST stage answers us (gather rides the
                # chain). Timeout budgets per stage — one await covers the
                # whole chain
                self.stats["tasks_sent"] += 1
                result = await self.node.run_stage_task(
                    self.stage_peers[0], protocol.TASK_PART_FORWARD_RELAY,
                    {**fields, "gather": [int(g_) for g_ in gather]},
                    tensors={"x": x},
                    timeout=self.step_timeout * len(self.stage_peers),
                    reply_from=self.stage_peers[-1],
                )
                return result["_tensors"]["out"]
            for peer in self.stage_peers[:-1]:
                self.stats["tasks_sent"] += 1  # meshlint: ignore[ML-R003] -- atomic counter bump: no read of stats spans an await
                result = await self.node.run_stage_task(
                    peer, protocol.TASK_PART_FORWARD, fields,
                    tensors={"x": x}, timeout=self.step_timeout,
                )
                x = result["_tensors"]["out"]
            self.stats["tasks_sent"] += 1
            result = await self.node.run_stage_task(
                self.stage_peers[-1],
                protocol.TASK_PART_FORWARD,
                {**fields, "gather": [int(g_) for g_ in gather]},
                tensors={"x": x},
                timeout=self.step_timeout,
            )
            return result["_tensors"]["out"]  # [B, V]

    async def _admit(self, g: _Group, row: int, req: _SessionReq) -> None:
        """Masked prefill of one request into `row` of group `g`'s cache.
        A row requeued by failover carries accepted tokens in req.out:
        prefilling prompt + accepted resumes its decode exactly where the
        failure struck (offsets in _step_group are n + len(out) already).
        Under the interleaved scheduler this chain is just another chunk
        in the group's stream — other groups keep decoding through it."""
        self.stats["prefills"] += 1
        g.prefills += 1
        if req.out:
            # a requeued row resuming by re-prefill (prompt + accepted) —
            # the cost the group-scoped ladder confines to the failed group
            self.stats["reprefills"] += 1
            g.reprefills += 1
        B = len(g.rows)
        full = list(req.ids) + req.out
        n_full = len(full)
        bucket = 16
        while bucket < n_full:
            bucket *= 2
        bucket = min(bucket, self.max_seq_len)
        x = np.zeros((B, bucket), np.int32)
        x[row, :n_full] = full
        offsets = np.zeros(B, np.int32)
        mask = np.zeros(B, bool)
        mask[row] = True
        gather = np.zeros(B, np.int32)
        gather[row] = n_full - 1
        logits = await self._chain(g, x, offsets, mask, gather)
        req.last_tok = PipelineCoordinator._sample(
            logits[row], req.temperature, req.rng
        )
        g.rows[row] = req

    def _accept(self, g: _Group, req: _SessionReq, tok: int) -> bool:
        """Book one sampled token for a row; False retires the row."""
        if req.eos is not None and tok == req.eos:
            return False
        req.out.append(tok)
        self.stats["tokens"] += 1
        g.tokens += 1
        if req.on_token is not None:
            try:
                req.on_token(tok)
            except Exception:  # noqa: BLE001 — consumer bug ≠ session bug
                logger.exception("on_token callback failed")
        return len(req.out) < req.max_new_tokens

    def _retire(self, g: _Group, row: int) -> None:
        req = g.rows[row]
        g.rows[row] = None
        if not req.future.done():
            req.future.set_result(req.out)

    async def _step_group(self, g: _Group) -> None:
        """One decode step over group g's active rows (one chain)."""
        active = g.active()
        self.stats["steps"] += 1
        with get_tracer().span(
            "pipeline.step", group=g.idx, rows=len(active),
            relay=self.relay, interleave=self.interleave,
        ):
            rows = g.rows
            B = len(rows)
            x = np.zeros((B, 1), np.int32)
            offsets = np.zeros(B, np.int32)
            mask = np.zeros(B, bool)
            for i in active:
                req = rows[i]
                x[i, 0] = req.last_tok
                offsets[i] = req.n + len(req.out)
                mask[i] = True
            logits = await self._chain(
                g, x, offsets, mask, np.zeros(B, np.int32)
            )
            # re-read the active set: another group's failover may have
            # evacuated these rows mid-chain (they'll re-prefill) — the
            # stale chain's result must not book tokens for them
            for i in g.active():
                req = rows[i]
                tok = req.last_tok
                if not self._accept(g, req, tok):
                    self._retire(g, i)
                    continue
                req.last_tok = PipelineCoordinator._sample(
                    logits[i], req.temperature, req.rng
                )

    # ------------------------------------------------------------ drivers

    def _claim_admission(self, g: _Group) -> _SessionReq | None:
        """Group g's next admission: its own queue first; with a free
        row and an empty queue, STEAL a fresh request from the longest
        other queue. Submit-time assignment is a load hint, not an
        affinity contract — a request must not sit head-of-line behind
        another group's long row while this group's slot idles.
        Failover-requeued rows (accepted tokens) are never stolen: their
        re-admission is imminent once their group's recovery completes,
        and stealing them would shift re-prefill accounting onto healthy
        groups."""
        while g.queue:
            req = g.queue.popleft()
            if not req.future.done():  # else: abandoned while queued
                return req
        for other in sorted(
            (o for o in self.groups if o is not g and o.queue),
            key=lambda o: -len(o.queue),
        ):
            for req in list(other.queue):
                if req.future.done():
                    other.queue.remove(req)
                    continue
                if not req.out:
                    other.queue.remove(req)
                    return req
        return None

    async def _drain_admissions(self, g: _Group) -> bool:
        """Admit queued requests into group g's free rows (each
        admission is one masked-prefill chain). Shared by both drivers
        so their admission semantics can never diverge. Returns False
        when an admission chain failed — the failure, with the in-flight
        request, has already been routed through the group-scoped
        ladder."""
        while True:
            row = g.free_row()
            if row is None:
                return True
            req = self._claim_admission(g)
            if req is None:
                return True
            try:
                await self._admit(g, row, req)
            except Exception as e:  # noqa: BLE001 — group-scoped ladder
                await self._on_group_failure(g, e, req)
                return False

    async def _group_loop(self, g: _Group) -> None:
        """The free-running driver of ONE microbatch group: admit queued
        requests into free rows (each admission is one masked-prefill
        chain) and chain decode steps back-to-back. No barrier against
        the other groups — the moment this group's chain leaves stage 0,
        another group's chain can enter it."""
        while not self._closed:
            if not g.queue and not g.active():
                g.wake.clear()
                try:
                    await self.clock.wait_for(g.wake.wait(), 30.0)
                except asyncio.TimeoutError:
                    # a generate() can land during wait_for's cancellation
                    # window (an await point) — park only when still idle
                    if g.queue or g.active():
                        continue
                    break  # idle: park; the next assignment restarts us
                continue
            try:
                if not await self._drain_admissions(g):
                    continue  # admission failure already rode the ladder
                if g.active():
                    await self._step_group(g)
                    g.failovers = 0  # a whole step landed: chain healthy
            except Exception as e:  # noqa: BLE001 — group-scoped ladder
                await self._on_group_failure(g, e, None)

    async def _lockstep_loop(self) -> None:
        """The pre-interleave barrier scheduler, kept selectable
        (``interleave=False``) as the A/B baseline the bench rung
        measures bubble fraction against: admission prefills park every
        group's decode, and all busy groups advance behind one per-step
        gather barrier — a straggler group stalls the rest for exactly
        the bubble time the free-running scheduler drains."""
        while not self._closed:
            if not self._any_pending and not self._any_active:
                self._wake.clear()
                try:
                    await self.clock.wait_for(self._wake.wait(), 30.0)
                except asyncio.TimeoutError:
                    if self._any_pending or self._any_active:
                        continue
                    break
                continue
            for g in list(self.groups):  # snapshot: admit() appends mid-drain
                await self._drain_admissions(g)
            busy = [g for g in self.groups if g.active()]
            if not busy:
                continue
            results = await asyncio.gather(
                *(self._step_group(g) for g in busy), return_exceptions=True
            )
            for g, r in zip(busy, results):
                if isinstance(r, BaseException):
                    await self._on_group_failure(g, r, None)
                else:
                    g.failovers = 0

    # ------------------------------------------------------------ failover

    async def _evacuate(self, g: _Group) -> list[_SessionReq]:
        """Pull group g's in-flight rows, release its stage caches, and
        rotate its rid (the next admission starts from fresh caches).
        Returns the pulled rows — callers requeue or fail them."""
        rows: list[_SessionReq] = []
        for i, req in enumerate(g.rows):
            if req is not None:
                g.rows[i] = None
                rows.append(req)
        old_rid = g.rid
        fresh = new_id("ppsess")
        if len(self.groups) == 1:
            # legacy contract: a single-group session's id IS its cache
            # identity, and callers observe it rotate on failover
            self.sid = fresh
            g.rid = fresh
        else:
            # multi-group: rotate only THIS group's rid — the session id
            # keeps naming the session, and sibling groups' rids (still
            # derived from it) stay live
            g.rid = f"{fresh}:m{g.idx}"
        await self._release_rid(old_rid)
        return rows

    async def _on_group_failure(self, g: _Group, e: Exception,
                                admitting: "_SessionReq | None") -> None:
        """A chain of group g failed. Group-scoped ladder:
        only THIS group's rows ride it — healthy groups' chains keep
        running through it. Rungs:

        1. epoch adoption: a concurrent recover() bumped the stage epoch
           WITHOUT re-placing any stage — surviving stages kept this
           group's caches, so adopt the epoch and retry in place (the
           error was bookkeeping, not a fault; no failover charged).
        2. resume in place: an ALIVE chain (typed error/timeout, epoch
           unchanged) keeps every stage's K/V — retry the step on the
           live caches, one try per failure burst.
        3. group failover: release + rotate THIS group's rid, recover()
           the chain (single-flight across groups via observed_epoch),
           requeue this group's rows for re-prefill (prompt + accepted).
           Only when recover() actually RE-PLACED a stage are the other
           groups evacuated too — the replaced process took every
           group's caches with it.
        4. typed failure of this group's rows; other groups untouched.
        """
        if (
            not self._closed
            and self.coordinator is not None
            and isinstance(e, StageError)
            and not isinstance(e, StageDead)
            and self.coordinator.epoch != self.epoch
            and list(self.coordinator.stage_peers) == list(self.stage_peers)
        ):
            self.epoch = self.coordinator.epoch
            self.relay = (self.coordinator.relay_ok
                          and len(self.stage_peers) > 1)
            if admitting is not None:
                g.queue.appendleft(admitting)
            logger.info(
                "group %d adopting rebuilt chain epoch %d (same stages — "
                "caches intact, no re-prefill)", g.idx, self.epoch,
            )
            return
        if (
            not self._closed
            and isinstance(e, StageError)
            and not isinstance(e, StageDead)
            and g.failovers == 0
            and self.max_failovers > 0
            and (self.coordinator is None
                 or self.coordinator.epoch == self.epoch)
        ):
            # one in-place try per failure burst (failovers resets on a
            # whole successful step); a repeat escalates to re-prefill
            g.failovers += 1
            await self.clock.sleep(self.failover_backoff_s)
            # re-check AFTER the sleep: a concurrent failover may have
            # rebuilt the chain meanwhile, invalidating this group's
            # stage caches on any replaced peer — fall through to the
            # requeue path then, bounded by the incremented count
            if (self.coordinator is None
                    or self.coordinator.epoch == self.epoch):
                if admitting is not None:
                    # the popped request never finished admission: its
                    # masked prefill re-runs against the same rid
                    # (idempotent row writes), resumed rows are untouched
                    g.queue.appendleft(admitting)
                self.stats["resumes_in_place"] = (
                    self.stats.get("resumes_in_place", 0) + 1
                )
                _C_RESUMES_IN_PLACE.inc()
                logger.warning(
                    "group %d step failed (%s: %s); resuming in place on "
                    "live stage caches", g.idx, type(e).__name__, e,
                )
                return
            logger.warning(
                "group %d step failed (%s: %s); chain rebuilt during "
                "backoff — requeueing rows instead of resuming in place",
                g.idx, type(e).__name__, e,
            )
        # the popped-but-not-yet-admitted request is in neither the queue
        # nor a row — collect it with the rest so it can't hang
        inflight: list[_SessionReq] = (
            [admitting] if admitting is not None else []
        )
        inflight.extend(await self._evacuate(g))
        if (not self._closed and self.coordinator is not None
                and isinstance(e, StageError)
                and g.failovers < self.max_failovers):
            g.failovers += 1
            _C_SESSION_FAILOVERS.inc()
            try:
                await self.clock.sleep(min(
                    self.failover_backoff_s * 2 ** (g.failovers - 1), 5.0
                ))
                # observed_epoch: if another group/generation already
                # rebuilt the chain, this returns [] and we just adopt
                replaced = await self.coordinator.recover(
                    timeout=self.failover_load_timeout,
                    observed_epoch=self.epoch,
                )
            except Exception as rec_err:  # noqa: BLE001 — typed fail below
                logger.warning("group %d failover failed: %s", g.idx, rec_err)
                if isinstance(rec_err, StageError):
                    e = rec_err
            else:
                topology_changed = (
                    list(self.coordinator.stage_peers)
                    != list(self.stage_peers)
                )
                self.stage_peers = list(self.coordinator.stage_peers)
                self.relay = (self.coordinator.relay_ok
                              and len(self.stage_peers) > 1)
                self.epoch = self.coordinator.epoch
                if replaced or topology_changed:
                    # a RE-PLACED stage lost every group's caches with
                    # its process: evacuate the healthy groups too (their
                    # rows requeue into their own groups and re-prefill)
                    for other in list(self.groups):  # snapshot: evacuation awaits per group
                        if other is g:
                            continue
                        other_rows = await self._evacuate(other)
                        live = [r for r in other_rows
                                if not r.future.done()]
                        other.queue.extendleft(reversed(live))
                        other.wake.set()
                live = [r for r in inflight if not r.future.done()]
                g.queue.extendleft(reversed(live))
                g.wake.set()
                self._wake.set()
                logger.info(
                    "group %d failover %d/%d: requeued %d rows (epoch "
                    "%d%s)", g.idx, g.failovers, self.max_failovers,
                    len(live), self.epoch,
                    ", all groups evacuated"
                    if replaced or topology_changed else "",
                )
                return
        logger.warning(
            "group %d step failed (%s: %s); failing %d in-flight rows",
            g.idx, type(e).__name__, e, len(inflight),
        )
        err = e if isinstance(e, StageError) else RuntimeError(
            f"pipeline session step failed: {e}"
        )
        for req in inflight:
            if not req.future.done():
                req.future.set_exception(err)
