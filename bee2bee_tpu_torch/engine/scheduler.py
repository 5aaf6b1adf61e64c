"""Continuous-batching scheduler: shared paged-pool decode with rolling
admission.

The port of ``bee2bee_tpu/engine/scheduler.py``'s main loop:

- **One shared paged KV pool** plus per-row state (current token, write
  offset) kept as host numpy mirrors. All rows decode together; per-row
  block tables (engine/paged.py) map positions onto pool blocks, which
  are allocated lazily and freed at retirement.
- **Batch bucketing**: ``bsz`` tracks the active row count in power-of-
  two buckets; active rows stay compacted in [0, active) by host table
  moves. With ``batch_sticky`` (the default) the bucket only grows while
  work flows; an empty batch drops to 1 when the next admission comes
  more than ``_sticky_idle_s`` after the last dispatch. Without it the
  bucket walks the quarter-occupancy halving ladder.
- **Rolling admission**: a queued request prefills straight into the pool
  through its row's block table (whole-prompt bucket or fixed chunks);
  its first token is sampled at once, and a burst of admissions is read
  back in ONE host read. Admission only runs on a settled batch: the
  readback ring is drained first.
- **The decode root**: one decode step for all rows (forward, sampling,
  penalty counts) works in place on static device buffers (``cur``,
  offsets, block tables, the sampling knobs, the counts, the chunk's
  token buffer), so on the card it is captured once per key as a CUDA
  graph and a chunk of ``decode_chunk`` steps is that many replays and no
  other launch. The key is the JAX ``_decode_key`` (batch bucket, table
  width, min_p / adapters / counts flags) plus the all-greedy flag. There
  is one root: penalty counts always ride it (the JAX engine's fused
  root), so ``fused_root`` selects nothing here. On the CPU the same step
  runs eagerly.
- **The overlapped readback ring**: a window of up to
  ``max_inflight_chunks`` chunks is dispatched without a host sync; its
  tokens go from the chunk's token buffer to the ring slot's pinned host
  buffer behind an event. Up to ``readback_depth`` windows are in flight
  (``decode_overlap``); the fetch of the oldest (the event's wait) is the
  loop's one host sync, and the next window is dispatched before the
  fetched tokens are processed. Look-ahead windows chain on the device's
  own ``cur`` and offsets; the host writes its mirrors into them only when
  the ring is empty. Blocks of a row that retires while windows are in
  flight are freed when the ring drains. EOS / stop / budget retire a row
  when its window is processed.
- **Per-row sampling and penalties**: the knobs ride as [B] tensors;
  penalty counts [B, 2, V] (prompt, generated) live on the card and are
  bumped by every sampled token.
- **Prompt prefix cache** (``prefix_cache_entries > 0``): a prefilled
  prompt's blocks are pinned under its token ids (engine/paged.py
  ``PagedPrefixCache``). A later prompt that extends a cached one maps
  the entry's full blocks into its own table (refcounts, no copy), copies
  the one partial block it would write into (copy-on-write: pages, and
  on an int8 pool their scales), and prefills only the rest, with a
  write floor at the match so no shared block is ever written. Pins are
  evicted LRU by capacity and, under pool pressure, by the allocation
  funnel before it gives up.
- **Economics** (engine/introspect.py): prefill chunks and decode
  windows book their FLOPs and scheduled positions, accepted tokens book
  as useful, the dispatch cadence feeds the pool forecast, every decode
  graph capture books a compile of the ``decode`` root, and the HBM
  ledger's headroom gates sticky growth.
- **Tenant fairness**: the submit queue is a WDRR queue keyed by
  ``Request.tenant`` (router/fairness.py), weighted from the
  ``BEE2BEE_TENANTS`` config or ``set_tenant_weights``; a request costs
  its token budget, charged when it is popped and refunded when it never
  runs or is requeued. With no tenants configured the order is FIFO.

Threading model: one daemon scheduler thread owns all device state;
``submit`` only appends to a queue under a condition variable, and
callers read per-request event queues.

Not ported yet: speculative decoding, adapters, migration checkpoints and
prefill graphs.
"""

from __future__ import annotations

import functools
import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..metrics import get_registry
from ..ops import flash, ragged
from ..router.fairness import WdrrQueue
from ..router.tenants import load_tenant_config
from ..unported import unported
from .introspect import (
    _C_HOST_SYNCS,
    _C_SYNC_STALLS,
    _G_OVERLAP,
    declared_batch_sizes,
    declared_table_width,
    device_gate,
    graph_capture_lock,
)
from .paged import (
    BlockAllocator,
    PagedPrefixCache,
    ceil_div,
    pow2_at_least,
    prefill_chunk_positions,
)
from .sampling import sample_batched

logger = logging.getLogger("bee2bee_tpu_torch.scheduler")

_REG = get_registry()
_H_QUEUE_WAIT = _REG.histogram(
    "engine.queue_wait_ms", "submit-to-admission wait per request (ms)"
)
_H_PREFILL = _REG.histogram(
    "engine.prefill_ms",
    "admission prefill through first-token readback per request (ms)",
)
_H_STEP = _REG.histogram(
    "engine.step_ms", "one decode window / spec verify step wall time (ms)"
)
_G_BATCH_FILL = _REG.gauge(
    "engine.batch_fill", "active rows / current batch bucket (0..1)"
)
_G_ACTIVE_ROWS = _REG.gauge("engine.active_rows", "rows decoding this step")

@dataclass
class _Timing:
    t_submit: float = 0.0
    t_admit: float = 0.0  # popped off the queue (queue_wait endpoint)
    t_first: float = 0.0  # first token available (ttft reference point)
    t_done: float = 0.0


class Request:
    """One in-flight generation. Consumers read .events until a done
    event; the scheduler thread is the only producer."""

    def __init__(
        self,
        ids: list[int],
        max_new_tokens: int,
        temperature: float,
        top_k: int,
        top_p: float,
        stop: set[int],
        eos: int | None,
        tokenizer,
        stream: bool = False,
        repetition_penalty: float = 1.0,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
        min_p: float = 0.0,
        tenant: str = "default",
    ):
        self.stream = stream
        self.tenant = str(tenant or "default")
        # set by an abandoning consumer (generate_stream closed early); the
        # scheduler thread reads it at window boundaries and retires the row
        self.cancelled = False
        self.ids = ids
        self.max_new_tokens = max_new_tokens
        self.temperature = float(temperature if temperature is not None else 0.0)
        self.top_k = int(top_k or 0)
        self.top_p = float(top_p if top_p is not None else 1.0)
        self.min_p = float(min_p or 0.0)
        self.stop = stop
        self.eos = eos
        self.repetition_penalty = float(repetition_penalty or 1.0)
        self.presence_penalty = float(presence_penalty or 0.0)
        self.frequency_penalty = float(frequency_penalty or 0.0)
        self.tokenizer = tokenizer
        self.events: queue.Queue = queue.Queue()
        self.out_ids: list[int] = []
        self.finish: str | None = None
        self.timing = _Timing(t_submit=time.perf_counter())
        self.prompt_tokens = len(ids)
        self.bucket = 0
        self.chunks_decoded = 0
        self._flushed_text = ""

    def accept(self, tok: int) -> bool:
        """Feed one sampled token; returns False when the request is done
        (budget reached / stop token) — the token is NOT kept then."""
        if self.finish is not None:
            return False
        if len(self.out_ids) >= self.max_new_tokens:
            self.finish = "length"
            return False
        if tok in self.stop:
            self.finish = "eos" if tok == self.eos else "stop"
            return False
        self.out_ids.append(tok)
        if len(self.out_ids) >= self.max_new_tokens:
            self.finish = "length"
        return True

    def text_delta(self, final: bool = False) -> str:
        """Cumulative decode -> UTF-8-safe incremental text (holds back a
        trailing replacement char until the multi-byte token completes)."""
        full = self.tokenizer.decode(self.out_ids)
        if not final:
            full = full.rstrip("�")
        delta = full[len(self._flushed_text):]
        self._flushed_text = full
        return delta

    @property
    def done(self) -> bool:
        return self.finish is not None

    @property
    def penalized(self) -> bool:
        return (
            self.repetition_penalty != 1.0
            or self.presence_penalty != 0.0
            or self.frequency_penalty != 0.0
        )


@dataclass
class SchedulerStats:
    admitted: int = 0
    retired: int = 0
    chunks: int = 0  # decode chunks run
    windows: int = 0  # decode windows run (= host reads of decode tokens)
    peak_active: int = 0
    prefix_hits: int = 0
    prefix_tokens_saved: int = 0
    paged_blocks_in_use: int = 0
    paged_blocks_hwm: int = 0
    paged_blocks_copied: int = 0  # CoW copies (<= 1 per prefix hit)
    paged_blocks_read_last_step: int = 0
    paged_live_blocks: int = 0
    paged_alloc_waits: int = 0  # admissions deferred on an exhausted pool
    counts_windows: int = 0  # windows that carried the penalty counts
    width_grow_denials: int = 0  # bucket grows refused by the growth gate
    # decode graphs (the card only): captures, replays (one per decode
    # step), seconds spent in warm-up and capture (the warm-up's share
    # apart), the forwards those ran eagerly, and each key's (captures,
    # seconds)
    graph_captures: int = 0
    graph_replays: int = 0
    graph_capture_s: float = 0.0
    graph_warmup_s: float = 0.0
    graph_setup_forwards: int = 0
    graph_keys: dict = field(default_factory=dict)
    # the JAX engine's speculative-decoding and migration counts, so the
    # two packages' stats carry the same keys; they stay 0 until those
    # paths are ported (ROADMAP.md queue A items 7 and 9)
    spec_steps: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_tiers: dict = field(default_factory=dict)
    migrated_out: int = 0
    migrated_in: int = 0
    import_reprefills: int = 0
    prefill_handoffs: int = 0
    history: deque = field(default_factory=lambda: deque(maxlen=64))

    @property
    def spec_acceptance(self) -> float:
        return self.spec_accepted / self.spec_drafted if self.spec_drafted else 0.0


def tenant_queue(source: str | None = None) -> WdrrQueue:
    """The scheduler's submit queue: per-tenant weighted-deficit fairness,
    FIFO within a tenant and WDRR across tenants, weighted from the tenant
    config (``source``, else ``BEE2BEE_TENANTS``). With no tenants
    configured every request shares the default queue and the order stays
    pure FIFO."""
    return WdrrQueue(
        weights={name: spec.weight for name, spec in load_tenant_config(source).items()}
    )


def _cost(req: Request) -> float:
    """A request's WDRR cost: its token budget (fairness in tokens)."""
    return max(1.0, float(req.max_new_tokens))


class _PoolExhausted(RuntimeError):
    """The paged pool has no free blocks (after reclaiming prefix pins):
    admission backpressure, not a crash — callers requeue or fail the one
    request."""


def copy_block(pool: dict, src: int, dst: int) -> None:
    """The CoW block copy, in place: block ``src`` to ``dst`` in dim 2 of
    every pool tensor (pages ``k``/``v`` [L, Hkv, NB, BS, hd] and, on an
    int8 pool, ``k_scale``/``v_scale`` [L, Hkv, NB]): one device copy per
    tensor, on the current stream, no host sync."""
    for t in pool.values():
        t.select(2, dst).copy_(t.select(2, src))


def launch_counters(engine) -> list[tuple[object, str]]:
    """(holder, attribute) of every host-side count a decode step moves:
    each attention op's launch counters and the engine's forward count. A
    captured graph's replay calls no wrapper, so it adds back what its
    capture counted (``_DecodeGraph``)."""
    return ([(ragged.ragged_paged_attention, n) for n in ragged.LAUNCH_COUNTERS]
            + [(flash.flash_attention, n) for n in flash.LAUNCH_COUNTERS]
            + [(engine, "forward_calls")])


class _DecodeGraph:
    """One captured decode step and the counts its capture moved, as
    (holder, attribute, delta): each replay adds the deltas, so the
    launch and forward identities hold for replays as for eager calls."""

    def __init__(self, graph, deltas: list[tuple[object, str, int]]):
        self.graph = graph
        self.deltas = deltas

    def replay(self):
        self.graph.replay()
        for holder, name, delta in self.deltas:
            setattr(holder, name, getattr(holder, name) + delta)


@dataclass
class _DecodeViews:
    """The static buffers one decode key reads and writes, viewed at its
    batch bucket (and table width): fixed addresses, so a graph captured
    over them stays valid as their contents change."""

    cur: torch.Tensor  # [bsz] int64: each row's last token
    off: torch.Tensor  # [bsz] int32: each row's write position
    tables: torch.Tensor  # [bsz, tw] int32, contiguous
    rows: torch.Tensor  # [bsz] int64: arange
    temperature: torch.Tensor  # [bsz] f32
    top_k: torch.Tensor  # [bsz] int32
    top_p: torch.Tensor  # [bsz] f32
    min_p: torch.Tensor | None  # [bsz] f32, None = the min-p-free path
    repetition: torch.Tensor  # [bsz] f32
    presence: torch.Tensor  # [bsz] f32
    frequency: torch.Tensor  # [bsz] f32
    counts: torch.Tensor | None  # [bsz, 2, V] int32, None = no penalties
    toks: torch.Tensor  # [bsz, decode_chunk] int64: the chunk's tokens
    step: torch.Tensor  # [1] int64: the chunk's step index
    any_sampled: bool


# the float knobs' rows in the static [6, max_batch] buffer, with the
# value a free row carries
_KNOBS_F = (("temperature", 0.0), ("top_p", 1.0), ("min_p", 0.0),
            ("repetition", 1.0), ("presence", 0.0), ("frequency", 0.0))


class _RingSlot:
    """One readback-ring slot's host memory (pinned on the card): staging
    for the host-to-device copies of the window dispatched in it, the
    window's tokens [max_inflight_chunks, max_batch, decode_chunk], and
    the event recorded after their device-to-host copy. A slot is reused
    only after its window's fetch waited on that event, so no pending
    copy still reads or writes it."""

    def __init__(self, max_batch: int, blocks_per_row: int, chunks: int, K: int,
                 pinned: bool):
        def buf(shape, dtype):
            return torch.zeros(shape, dtype=dtype, pin_memory=pinned)

        self.cur = buf((max_batch,), torch.int64)
        self.off = buf((max_batch,), torch.int32)
        self.tables = buf((max_batch * blocks_per_row,), torch.int32)
        self.knobs_f = buf((len(_KNOBS_F), max_batch), torch.float32)
        self.top_k = buf((max_batch,), torch.int32)
        self.toks = buf((chunks, max_batch, K), torch.int64)
        self.event = torch.cuda.Event() if pinned else None


class BatchScheduler:
    """Owns the shared pool + row table; see the module docstring."""

    def __init__(self, engine, max_batch: int):
        self.engine = engine
        self.max_batch = max_batch
        self.stats = SchedulerStats()
        self._queue = tenant_queue()
        self._cond = threading.Condition()
        self._shutdown = False

        e = engine
        cfg = e.engine_cfg
        self._device = e.device
        self._on_card = self._device.type == "cuda"
        self._block_size = cfg.kv_block_size
        self._vocab = e.model_cfg.vocab_size
        self._tables = np.zeros((max_batch, e.blocks_per_row), np.int32)
        # the hot-loop mechanisms, resolved once from EngineConfig (its
        # __post_init__ folded the env knobs in)
        self._overlap = bool(cfg.decode_overlap)
        self._depth = max(1, int(cfg.readback_depth))
        self._sticky = bool(cfg.batch_sticky)
        # sticky-width idle release: an all-idle batch holds its bucket
        # this long after the last dispatch (an attribute so tests can
        # collapse the window)
        self._sticky_idle_s = 5.0
        self._last_dispatch_t = 0.0
        # economics (engine/introspect.py): the decode root's declared
        # capture space is the batch ladder x the pow2 table widths (any
        # flags); the CoW copy is an eager op, a root with no compiles
        ic = e.introspect
        self._meter = ic.meter
        bs_ok = declared_batch_sizes(max_batch)
        bpr = e.blocks_per_row
        ic.sentinel.register(
            "decode",
            allowed=lambda key: key[0] in bs_ok and declared_table_width(key[1], bpr),
        )
        ic.sentinel.register("cow_copy")
        ic.ledger.register("kv_pool", lambda: self._cache)
        self._init_device_state()

        self._thread = threading.Thread(
            target=self._loop, name="bee2bee-torch-batch-scheduler", daemon=True
        )
        self._thread.start()

    def _init_device_state(self):
        """An empty bucket-1 batch over a fresh pool and allocator, the
        decode root's static buffers, the readback ring's slots and no
        captured graph. The constructor's state, and the recovery after a
        failure (a graph holds the addresses of the buffers it was
        captured over, so every graph goes with them)."""
        e = self.engine
        dev = self._device
        mb = self.max_batch
        K = e.engine_cfg.decode_chunk
        self._bsz = 1
        self._alloc = BlockAllocator(e.pool_blocks)
        # the prefix pins live in the allocator: a rebuilt pool starts an
        # empty cache
        entries = e.engine_cfg.prefix_cache_entries
        self._prefix_cache = (PagedPrefixCache(entries, self._alloc)
                              if entries > 0 else None)
        self._tables[:] = 0
        self._row_blocks: list[list[int]] = [[] for _ in range(mb)]
        self._cache = e.new_pool()
        self.stats.paged_blocks_in_use = 0
        self._cur = np.zeros((1,), np.int64)
        self._offsets = np.zeros((1,), np.int32)
        self._rows: list[Request | None] = [None]
        self._row_params_dirty = True
        self._knob_flags: dict = {}
        # the decode root's static device buffers, allocated once at the
        # largest bucket: a key views their leading rows. Penalty counts
        # [max_batch, 2, V] (prompt, generated): rows of plain requests may
        # hold stale counts, which rep=1/pres=0/freq=0 never read, and
        # every penalized admission overwrites its row
        self._d_cur = torch.zeros((mb,), dtype=torch.int64, device=dev)
        self._d_off = torch.zeros((mb,), dtype=torch.int32, device=dev)
        self._d_tables = torch.zeros((mb * e.blocks_per_row,), dtype=torch.int32,
                                     device=dev)
        self._d_rows = torch.arange(mb, device=dev)
        self._d_knobs_f = torch.zeros((len(_KNOBS_F), mb), dtype=torch.float32,
                                      device=dev)
        self._d_top_k = torch.zeros((mb,), dtype=torch.int32, device=dev)
        self._counts = torch.zeros((mb, 2, self._vocab), dtype=torch.int32,
                                   device=dev)
        self._d_toks = torch.zeros((mb, K), dtype=torch.int64, device=dev)
        self._d_step = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._graphs: dict[tuple, _DecodeGraph] = {}
        if self._on_card:
            # every decode graph shares one memory pool: nothing read after
            # a replay lives in it (the static buffers above do not)
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(dev)
        # readback ring: dispatched-but-unread windows, each with its slot
        # and its own (row, request) map (retirement nulls _rows[b]
        # between dispatch and fetch)
        self._slots = deque(
            _RingSlot(mb, e.blocks_per_row, e.engine_cfg.max_inflight_chunks, K,
                      self._on_card)
            for _ in range(self._depth)
        )
        self._inflight: deque = deque()
        # blocks of rows that retired while windows were in flight: those
        # windows still write into them, so the deref waits for the ring
        # to drain (an early reuse would let an in-flight write corrupt
        # another row's fresh block)
        self._deferred_blocks: list[int] = []
        _G_OVERLAP.set(0)

    # ------------------------------------------------------------ public

    def set_tenant_weights(self, weights: dict) -> None:
        """Adopt the owning node's resolved tenant weights, so a registry
        replaced at runtime cannot drift from the env-seeded defaults."""
        with self._cond:
            self._queue.set_weights(weights)

    def submit(self, req: Request) -> Request:
        with self._cond:
            if self._shutdown:
                raise RuntimeError("scheduler is shut down")
            self._queue.append(req, tenant=req.tenant, cost=_cost(req))
            self._cond.notify()
        return req

    def shutdown(self):
        with self._cond:
            self._shutdown = True
            self._cond.notify()
        self._thread.join(timeout=30)

    @property
    def active(self) -> int:
        return sum(r is not None for r in self._rows)

    def live_requests(self) -> list[Request]:
        """Admitted + queued requests (the node's drain enumerates these)."""
        with self._cond:
            queued = list(self._queue)
        return [r for r in self._rows if r is not None] + queued

    def checkpoint(self, req: Request, timeout: float = 30.0) -> dict | None:
        """Snapshot a live request with its KV blocks for migration (the JAX
        scheduler's ``checkpoint``)."""
        raise unported("KV migration export (BatchScheduler.checkpoint)", 9)

    # ------------------------------------------------------------ loop

    def _loop(self):
        while True:
            with self._cond:
                while not self._queue and self.active == 0 and not self._shutdown:
                    self._cond.wait()
                if self._shutdown:
                    self._fail_all("engine shut down")
                    return
            # a device profile starts and stops between passes
            with device_gate.device_pass():
                if not self._pass():
                    return

    def _pass(self) -> bool:
        """One pass over the device: drain before admission, admit, step.
        A failure fails the batch and rebuilds the device state; False when
        even that failed and the loop must end."""
        try:
            if self._inflight and self._queue:
                # admission needs settled row state: drain the
                # readback ring before touching it
                if self._drain_inflight():
                    self._compact_and_shrink()
            self._admit()
            if self.active or self._inflight:
                self._step()
        except Exception as e:  # noqa: BLE001 — the thread must survive:
            # a dead scheduler thread would hang every blocked caller
            logger.exception("scheduler step failed; failing active requests")
            try:
                with self._cond:
                    self._fail_all(f"scheduler error: {e!r}")
                self._init_device_state()
            except Exception:
                logger.exception("scheduler recovery failed; shutting down")
                with self._cond:
                    self._shutdown = True
                    self._fail_all("scheduler dead: device unrecoverable")
                return False
        return True

    def _fail_all(self, reason: str):
        """Error-terminate every queued AND admitted request (callers are
        blocked on their event queues and must always get a done event).
        Caller holds self._cond."""
        # abandon the readback ring: its windows may be poisoned, and with
        # every row released below nobody reads them
        self._inflight.clear()
        _G_OVERLAP.set(0)
        if self._deferred_blocks:
            self._alloc.deref(self._deferred_blocks)
            self._deferred_blocks = []
        for req in list(self._queue) + [r for r in self._rows if r is not None]:
            req.finish = "error"
            req.events.put({"done": True, "result": None, "error": reason})
        self._queue.clear()
        for b, r in enumerate(self._rows):
            if r is not None:
                self._release_row(b)
        self._rows = [None] * self._bsz

    # ------------------------------------------------------------ paged state

    def _release_row(self, b: int):
        """Drop row b's block references and null its table row, so the
        dead row's decode writes land in the null block. While windows are
        in flight they still write into the row's blocks: the deref waits
        for the ring to drain (_release_deferred)."""
        if self._row_blocks[b]:
            if self._inflight:
                self._deferred_blocks.extend(self._row_blocks[b])
            else:
                self._alloc.deref(self._row_blocks[b])
            self._row_blocks[b] = []
        self._tables[b, :] = 0
        self.stats.paged_blocks_in_use = self._alloc.used_count

    def _alloc_blocks(self, n: int) -> list[int]:
        """THE allocation funnel (admission prefill, decode growth, CoW copy
        targets): n fresh blocks, reclaiming LRU prefix pins under
        pressure; raises _PoolExhausted when even that cannot cover them.
        Pressure eviction runs with an empty readback ring only: admission
        waits for one, and a look-ahead window dispatches only when the
        free list covers it (_overlap_ready). Besides, a block whose only
        reference is a pin is in no row's table.
        On an int8 pool it zeroes the fresh blocks' scales: the
        quantize-on-write running max would otherwise inherit the previous
        tenant's amax and serve the new row at an inflated quantization
        step (a CoW copy then overwrites its target's with the donor's,
        queued after the reset on the same stream)."""
        fresh = self._alloc.alloc(n)
        if fresh is None and self._prefix_cache is not None:
            if self._prefix_cache.evict_for_pressure(n):
                fresh = self._alloc.alloc(n)
        if fresh is None:
            raise _PoolExhausted(
                f"paged KV pool exhausted: need {n} blocks, "
                f"{self._alloc.free_count} free of {self._alloc.num_blocks}"
            )
        if self.engine.kv_quantized and fresh:
            idx = torch.tensor(fresh, dtype=torch.long)
            if self._on_card:
                # pinned + non_blocking: the copy queues, the host runs on
                idx = idx.pin_memory().to(self._device, non_blocking=True)
            self._cache["k_scale"].index_fill_(2, idx, 0.0)
            self._cache["v_scale"].index_fill_(2, idx, 0.0)
        self.stats.paged_blocks_in_use = self._alloc.used_count
        self.stats.paged_blocks_hwm = self._alloc.hwm
        return fresh

    def _ensure_blocks(self, b: int, upto: int):
        """Grow row b's block table to cover positions [0, upto)."""
        need = ceil_div(upto, self._block_size)
        have = len(self._row_blocks[b])
        if need <= have:
            return
        if need > self.engine.blocks_per_row:
            raise ValueError(f"row {b} needs {need} blocks for position {upto}")
        fresh = self._alloc_blocks(need - have)
        self._row_blocks[b].extend(fresh)
        self._tables[b, have:need] = fresh

    def _table_width(self, nblocks: int) -> int:
        """Pow2-bucketed table width, never past the physical table."""
        return min(pow2_at_least(nblocks), self.engine.blocks_per_row)

    # ------------------------------------------------------- batch resizing

    # minimum HBM ledger headroom fraction required to grow the batch
    # bucket (sticky widths make growth near-permanent)
    _GROW_HEADROOM_MIN = 0.02

    def _growth_headroom(self) -> bool:
        """May the batch bucket grow? Gated on the HBM ledger's headroom
        fraction (engine/introspect.py). An unknown limit (the CPU without
        BEE2BEE_HBM_BYTES) always allows: the gate stops growth into a
        KNOWN ceiling, never guesses one."""
        try:
            frac = self.engine.introspect.ledger.snapshot().get("headroom_frac")
        except Exception:  # noqa: BLE001 — telemetry never blocks admission
            return True
        return frac is None or frac > self._GROW_HEADROOM_MIN

    def _resize(self, new_bsz: int):
        """Move to a new batch bucket: only the host mirrors resize. The
        pool is batch-independent and the device buffers are allocated at
        max_batch, so the active rows [0, active) keep their addresses.
        Called with an empty readback ring only."""
        old = self._bsz
        if new_bsz == old:
            return
        keep = min(old, new_bsz)
        cur = np.zeros((new_bsz,), np.int64)
        offs = np.zeros((new_bsz,), np.int32)
        cur[:keep] = self._cur[:keep]
        offs[:keep] = self._offsets[:keep]
        self._cur, self._offsets = cur, offs
        self._rows = self._rows[:keep] + [None] * (new_bsz - keep)
        self._bsz = new_bsz
        self._row_params_dirty = True

    def _compact_and_shrink(self):
        """Close retirement holes by moving the highest active row down,
        then (sticky) release the bucket of an empty batch after an idle
        window, or (not sticky) drop to a smaller bucket when occupancy
        allows. Called with an empty readback ring only: in-flight windows
        carry row indices."""
        while True:
            hole = next((i for i, r in enumerate(self._rows) if r is None), None)
            last = next(
                (i for i in range(self._bsz - 1, -1, -1) if self._rows[i] is not None),
                None,
            )
            if hole is None or last is None or last < hole:
                break
            self._tables[hole] = self._tables[last]
            self._tables[last] = 0
            self._row_blocks[hole] = self._row_blocks[last]
            self._row_blocks[last] = []
            self._counts[hole] = self._counts[last]
            self._cur[hole] = self._cur[last]
            self._offsets[hole] = self._offsets[last]
            self._rows[hole] = self._rows[last]
            self._rows[last] = None
            self._row_params_dirty = True
        A = self.active
        if self._sticky:
            # grow-only while work flows: every bucket is a decode graph
            # key, and the ladder's shrink-then-regrow churn would capture
            # them again and again. An all-idle batch releases its bucket
            # only after the hysteresis window; the loop sleeps while idle,
            # so the release happens at the next admission (_admit)
            if (A == 0 and self._bsz > 1
                    and time.perf_counter() - self._last_dispatch_t
                    > self._sticky_idle_s):
                self._resize(1)
            return
        if A == 0 and self._bsz > 1:
            self._resize(1)
        elif self._bsz > 1 and A * 2 <= self._bsz // 2:
            # quarter-occupancy hysteresis: halve without thrashing
            self._resize(max(1, self._bsz // 2))

    # ------------------------------------------------------------ admission

    def _paged_prefill(self, req: Request, b: int, bucket: int, start: int,
                       cached, seq: list | None = None):
        """Admit one request onto the paged pool: wire row b's block table
        (sharing a matched prefix's full blocks, copying at most its final
        partial block), chunk-prefill the rest straight into the pool, and
        pin the prompt's blocks in the prefix cache. Returns last_logits
        [1, V]. On _PoolExhausted every reference this call took is
        released and the table row is nulled, so the caller can requeue
        the request cleanly; the raise happens BEFORE any device work (the
        block sufficiency is prechecked), so a requeue never redoes CoW
        copies or prefill chunks, nor counts prefix stats twice.

        ``seq`` overrides the token sequence prefilled (default: the
        prompt); its positions then book as scheduled work with no useful
        tokens (a re-prefill)."""
        e = self.engine
        BS = self._block_size
        recompute = seq is not None
        if seq is None:
            seq = req.ids
        n = len(seq)
        if cached is None:
            start = 0
        row: list[int] = []
        self._row_blocks[b] = row
        self._tables[b, :] = 0
        temp_ref: list[int] = []
        try:
            full = start // BS
            if cached is not None:
                shared = list(cached[:full])
                # take our refs FIRST: the eviction below may reclaim
                # prefix entries, the donor's among them, and must not free
                # blocks this row is about to depend on
                self._alloc.ref(shared)
                row.extend(shared)
                self._tables[b, :full] = shared
                if start % BS:
                    self._alloc.ref([int(cached[full])])
                    temp_ref.append(int(cached[full]))
            # blocks freed behind the (empty) ring count as free
            self._release_deferred()
            # sufficiency precheck before ANY device work: the write ceil
            # drops every scatter at/past n, so prefill claims exactly the
            # blocks covering the prompt, ceil(n / BS), whatever the
            # bucket (fresh blocks = that less the shared full ones; the
            # CoW target is the full-th block and is counted)
            fresh_needed = ceil_div(n, BS) - full
            if fresh_needed > self._alloc.free_count and not (
                self._prefix_cache is not None
                and self._prefix_cache.evict_for_pressure(fresh_needed)
            ):
                raise _PoolExhausted(
                    f"paged KV pool exhausted: admission needs {fresh_needed} "
                    f"blocks, {self._alloc.free_count} free of "
                    f"{self._alloc.num_blocks}"
                )
            if cached is not None:
                if start % BS:
                    src = temp_ref[0]
                    fresh = self._alloc_blocks(1)
                    # the ONE CoW copy: the borrower writes into this block
                    # from position `start`, so it gets its own. Queued on
                    # the stream after _alloc_blocks' scale reset of the
                    # target, so the target ends with the donor's scales
                    copy_block(self._cache, src, fresh[0])
                    self.stats.paged_blocks_copied += 1
                    row.append(fresh[0])
                    self._tables[b, full] = fresh[0]
                    self._alloc.deref(temp_ref)
                    temp_ref.clear()
                self.stats.prefix_hits += 1
                self.stats.prefix_tokens_saved += start
            last_logits = None
            # the chunk walk from `start`. Its capacity re-anchor can
            # re-feed tokens below `start`: the write floor sends those
            # writes to the null block, so the shared blocks stay read-only
            # (attention still reads the donor's values there)
            for pos in prefill_chunk_positions(n, start, bucket, e.max_seq_len):
                self._ensure_blocks(b, min(pos + bucket, n))
                chunk = seq[pos:pos + bucket]
                tokens = np.zeros((1, bucket), np.int64)
                tokens[0, :len(chunk)] = chunk
                tw = self._table_width(len(row))
                last_logits = e._prefill(
                    torch.from_numpy(tokens).to(self._device),
                    self._cache,
                    torch.tensor([len(chunk)], device=self._device),
                    pos,
                    torch.from_numpy(self._tables[b:b + 1, :tw].copy()).to(self._device),
                    write_floor=start,
                    write_ceil=n,
                )
                # economics: the bucket's padded width is what the card
                # ran; only the real prompt tokens were useful
                self._meter.record_dispatch(bucket, pos + bucket / 2.0, scheduled=bucket)
                if not recompute:
                    self._meter.note_useful(len(chunk))
            # pinning is free (refcounts): the entry claims the blocks
            # covering exactly the prefilled positions. (The JAX engine
            # never pins an adapter row's blocks; the port serves no
            # adapters yet, ROADMAP.md queue A item 8.)
            if self._prefix_cache is not None and not self._prefix_cache.has(seq):
                self._prefix_cache.put(seq, row[:ceil_div(n, BS)])
                # a capacity eviction inside put() may have freed blocks
                self.stats.paged_blocks_in_use = self._alloc.used_count
            return last_logits
        except _PoolExhausted:
            if temp_ref:
                self._alloc.deref(temp_ref)
            self._release_row(b)
            raise

    def _admit(self):
        """Prefill queued requests into free rows, growing the batch bucket
        up to max_batch. The first tokens of the whole burst come back in
        ONE host read. Admits only into a settled batch: with windows in
        flight the request waits for the loop's drain."""
        e = self.engine
        placed: list[tuple] = []  # (req, row, firsts index)
        firsts: list[torch.Tensor] = []
        if self.active == 0 and not self._inflight:
            # the first admission after an idle spell: a sticky bucket held
            # past the idle window is released before the rows are placed
            # (the JAX loop checks only after a window, when the batch is
            # never idle long enough, and keeps the bucket)
            self._compact_and_shrink()
        while True:
            with self._cond:
                if (not self._queue or self.active >= self.max_batch
                        or self._inflight):
                    break
                req = self._queue.popleft()
            if req.cancelled:
                req.finish = "cancelled"
                req.timing.t_first = req.timing.t_done = time.perf_counter()
                req.events.put({"done": True, "result": e._build_result(req)})
                # the pop charged this tenant's deficit for tokens that
                # will never decode: refund them
                with self._cond:
                    self._queue.refund(req.tenant, _cost(req))
                continue
            req.timing.t_admit = time.perf_counter()
            if self.active == self._bsz:
                if not self._growth_headroom():
                    # a sticky bucket never shrinks back while work flows:
                    # requeue at the front (refunding the pop's cost) and
                    # retry into a retirement hole at the current width
                    with self._cond:
                        self._queue.appendleft(req, tenant=req.tenant, cost=_cost(req))
                    self.stats.width_grow_denials += 1
                    break
                self._resize(min(self._bsz * 2, self.max_batch))
            b = next(i for i, r in enumerate(self._rows) if r is None)
            # longest cached prompt prefix: admit from there and prefill
            # only the rest (chat transcripts grow by appending)
            start, cached = (self._prefix_cache.match(req.ids)
                             if self._prefix_cache is not None else (0, None))
            C = e.engine_cfg.prefill_chunk
            remaining = len(req.ids) - (start if cached is not None else 0)
            bucket = C if C is not None and remaining > C else e._bucket_for(remaining)
            req.bucket = bucket
            try:
                last_logits = self._paged_prefill(req, b, bucket, start, cached)
                dev = self._device
                kw = {}
                if req.penalized:
                    # prompt occurrences host-side, shipped as the row's
                    # fresh counts; channel 1 (generated) starts at zero
                    prompt_counts = np.bincount(
                        np.asarray(req.ids, np.int64), minlength=self._vocab
                    )[:self._vocab]
                    row_counts = torch.zeros((2, self._vocab), dtype=torch.int32)
                    row_counts[0] = torch.from_numpy(prompt_counts)
                    self._counts[b] = row_counts.to(dev)
                    kw = dict(
                        counts=self._counts[b:b + 1],
                        repetition=torch.tensor([req.repetition_penalty], device=dev),
                        presence=torch.tensor([req.presence_penalty], device=dev),
                        frequency=torch.tensor([req.frequency_penalty], device=dev),
                    )
                first = sample_batched(
                    last_logits, e.generator,
                    torch.tensor([req.temperature], device=dev),
                    torch.tensor([req.top_k], device=dev),
                    torch.tensor([req.top_p], device=dev),
                    torch.tensor([req.min_p], device=dev) if req.min_p > 0 else None,
                    any_sampled=req.temperature > 0,
                    **kw,
                )
            except _PoolExhausted as err:
                if self.active > 0 or placed:
                    # backpressure: blocks free as rows retire — requeue
                    # at the front (refunding the cost charged at the
                    # pop) and admit again after the next window
                    with self._cond:
                        self._queue.appendleft(req, tenant=req.tenant, cost=_cost(req))
                    self.stats.paged_alloc_waits += 1
                    break
                req.finish = "error"
                req.events.put({
                    "done": True, "result": None,
                    "error": f"admission failed: {err} "
                             "(kv_pool_blocks too small for this request)",
                })
                continue
            except Exception as err:
                # the popped request is in neither _queue nor _rows: fail
                # it here, then let _loop's handler recover
                req.finish = "error"
                req.events.put(
                    {"done": True, "result": None, "error": f"admission failed: {err!r}"}
                )
                raise
            self._rows[b] = req
            self._offsets[b] = len(req.ids)
            placed.append((req, b, len(firsts)))
            firsts.append(first)

        if not placed:
            return
        toks = torch.cat(firsts).cpu().numpy()  # the burst's one host read
        now = time.perf_counter()
        for req, b, i in placed:
            tok = int(toks[i])
            req.timing.t_first = now
            t = req.timing
            _H_QUEUE_WAIT.observe((t.t_admit - t.t_submit) * 1000.0)
            _H_PREFILL.observe((now - t.t_admit) * 1000.0)
            self.stats.admitted += 1
            accepted = req.accept(tok)
            if accepted:
                # the admission-sampled first token is useful, and its slot
                # is scheduled too (its FLOPs were booked with the prefill)
                self._meter.record_dispatch(0.0, 0.0, scheduled=1)
                self._meter.note_useful(1)
            if accepted and req.stream:
                req.events.put(
                    {"token": tok, "tokens": [tok], "text": req.text_delta(final=req.done)}
                )
            if req.done:  # instant stop / zero budget: free the row again
                self._rows[b] = None
                self._release_row(b)
                self._retire(req)
                continue
            if req.penalized:
                # the first token counts toward later penalties too
                self._counts[b, 1, tok] += 1
            self._cur[b] = tok
            self._row_params_dirty = True
            self.stats.peak_active = max(self.stats.peak_active, self.active)
        self._compact_and_shrink()

    # ------------------------------------------------------------ decode

    def _stage_knobs(self, slot: _RingSlot) -> dict:
        """The host flags of the rows' sampling knobs (any row sampled,
        any min-p, any penalty). When rows changed, their knob values go
        through the slot's staging into the static device buffers first:
        a copy queued behind the windows in flight, so only later windows
        read them."""
        if self._row_params_dirty:
            live = [r for r in self._rows if r is not None]
            self._knob_flags = {
                "any_sampled": any(r.temperature > 0 for r in live),
                "min_p": any(r.min_p > 0 for r in live),
                "penalized": any(r.penalized for r in live),
            }
            knobs_f, top_k = slot.knobs_f.numpy(), slot.top_k.numpy()
            knobs_f[:] = np.asarray([n for _, n in _KNOBS_F], np.float32)[:, None]
            top_k[:] = 0
            for b, r in enumerate(self._rows):
                if r is not None:
                    knobs_f[:, b] = (r.temperature, r.top_p, r.min_p,
                                     r.repetition_penalty, r.presence_penalty,
                                     r.frequency_penalty)
                    top_k[b] = r.top_k
            self._d_knobs_f.copy_(slot.knobs_f, non_blocking=self._on_card)
            self._d_top_k.copy_(slot.top_k, non_blocking=self._on_card)
            self._row_params_dirty = False
        return self._knob_flags

    def _decode_key(self, tw: int, flags: dict) -> tuple:
        """The decode root's key: the JAX ``_decode_key`` fields (batch
        bucket, table width, min_p flag, adapters flag, counts flag), then
        the all-greedy short-cut's flag."""
        return (self._bsz, tw, flags["min_p"], False, flags["penalized"],
                flags["any_sampled"])

    def _views(self, key: tuple) -> _DecodeViews:
        """The static buffers viewed at ``key``'s bucket and width."""
        bsz, tw, min_p, _, counts, any_sampled = key
        f = {name: self._d_knobs_f[i, :bsz] for i, (name, _) in enumerate(_KNOBS_F)}
        return _DecodeViews(
            cur=self._d_cur[:bsz], off=self._d_off[:bsz],
            # a [:bsz, :tw] slice of a 2-D buffer would not be contiguous,
            # and the kernel takes contiguous tables only
            tables=self._d_tables[:bsz * tw].view(bsz, tw),
            rows=self._d_rows[:bsz],
            temperature=f["temperature"], top_k=self._d_top_k[:bsz],
            top_p=f["top_p"], min_p=f["min_p"] if min_p else None,
            repetition=f["repetition"], presence=f["presence"],
            frequency=f["frequency"],
            counts=self._counts[:bsz] if counts else None,
            toks=self._d_toks[:bsz], step=self._d_step,
            any_sampled=any_sampled,
        )

    def _decode_step(self, v: _DecodeViews):
        """One decode step for all rows, in place on ``v``'s buffers:
        forward, sample, bump the penalty counts, write the token into
        ``cur`` and into the chunk's token buffer at the step index,
        advance the offsets and the index (mod decode_chunk). What a decode
        graph captures: no host sync, no host copy."""
        e = self.engine
        logits, _ = e.forward(v.cur[:, None], self._cache, v.off, v.tables)
        pen = {}
        if v.counts is not None:
            pen = dict(counts=v.counts, repetition=v.repetition,
                       presence=v.presence, frequency=v.frequency)
        nxt = sample_batched(
            logits[:, -1], e.generator, v.temperature, v.top_k, v.top_p,
            v.min_p, any_sampled=v.any_sampled, **pen,
        )
        if v.counts is not None:
            v.counts[v.rows, 1, nxt] += 1
        v.cur.copy_(nxt)
        v.off.add_(1)
        v.toks.index_copy_(1, v.step, nxt[:, None])
        v.step.add_(1).remainder_(v.toks.shape[1])

    def _capture(self, key: tuple) -> _DecodeGraph:
        """Capture ``key``'s decode step as a CUDA graph. A warm-up step
        runs first on the capture stream (lazy initialisations, the
        kernels' one-time attribute calls, the stream's cuBLAS workspace)
        over scratch state: all-zero tables (every write lands in the null
        block, garbage by design; an int8 pool's live scales only grow, so
        a live page must not be written), scratch cur, offsets, counts and
        tokens. The capture reads and writes the live static buffers but
        runs nothing. The counts both move are put back; the capture's are
        the graph's deltas. A failure raises: there is no eager decode on
        the card."""
        # a device profile and a capture never overlap (the capture waits,
        # outside its pass: the profile's stop waits for the pass to end)
        if not graph_capture_lock.acquire(blocking=False):
            with device_gate.outside_pass():
                graph_capture_lock.acquire()
        try:
            dg, seconds = self._capture_locked(key)
        finally:
            graph_capture_lock.release()
        self.engine.introspect.sentinel.note_compile("decode", key, seconds)
        return dg

    def _capture_locked(self, key: tuple) -> tuple[_DecodeGraph, float]:
        e = self.engine
        t0 = time.perf_counter()
        v = self._views(key)
        bsz, tw = v.tables.shape
        zeros = functools.partial(torch.zeros, device=self._device)
        scratch = replace(
            v, cur=zeros(bsz, dtype=torch.int64), off=zeros(bsz, dtype=torch.int32),
            tables=zeros((bsz, tw), dtype=torch.int32),
            counts=None if v.counts is None else torch.zeros_like(v.counts),
            toks=torch.zeros_like(v.toks), step=torch.zeros_like(v.step),
        )
        counters = launch_counters(e)
        base = [getattr(h, n) for h, n in counters]
        main = torch.cuda.current_stream(self._device)
        stream = self._capture_stream
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            self._decode_step(scratch)
        main.wait_stream(stream)
        warm_s = time.perf_counter() - t0
        warmed = [getattr(h, n) for h, n in counters]
        graph = torch.cuda.CUDAGraph()
        if v.any_sampled:
            # each replay then draws at the generator's current offset and
            # advances it: fresh noise per replay
            graph.register_generator_state(e.generator)
        # capture_begin/end rather than the torch.cuda.graph context, which
        # also synchronises the device and empties the device and pinned
        # host caches: work the next prefill would pay for again. Only this
        # thread's unsafe calls break the capture (thread_local)
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=self._graph_pool, capture_error_mode="thread_local")
            try:
                self._decode_step(v)
            finally:
                graph.capture_end()
        captured = [getattr(h, n) for h, n in counters]
        deltas = [(h, n, c - w) for (h, n), c, w in zip(counters, captured, warmed)
                  if c != w]
        for (h, n), value in zip(counters, base):
            setattr(h, n, value)
        dg = self._graphs[key] = _DecodeGraph(graph, deltas)
        seconds = time.perf_counter() - t0
        st = self.stats
        st.graph_captures += 1
        st.graph_capture_s += seconds
        st.graph_warmup_s += warm_s
        st.graph_setup_forwards += captured[-1] - base[-1]
        captures, total = st.graph_keys.get(key, (0, 0.0))
        st.graph_keys[key] = (captures + 1, total + seconds)
        logger.info("captured decode graph %s in %.3f s", key, seconds)
        return dg, seconds

    def _decode_chunk(self, key: tuple):
        """One chunk: decode_chunk steps for all rows on the static buffers;
        the tokens end in ``self._d_toks[:bsz]``. On the card every step is
        a replay of the key's graph (captured on its first use); on the
        CPU the step runs eagerly."""
        K = self.engine.engine_cfg.decode_chunk
        if not self._on_card:
            v = self._views(key)
            for _ in range(K):
                self._decode_step(v)
            return
        graph = self._graphs.get(key) or self._capture(key)
        for _ in range(K):
            graph.replay()
        self.stats.graph_replays += K

    def _window_size(self, pending: int = 0) -> int:
        """Chunks to dispatch before the next host sync: 1 while a request
        streams (tokens flush at chunk cadence); else the tightest active
        row budget, less ``pending`` tokens already in flight, capped at
        max_inflight_chunks (and at 2 while requests queue)."""
        e = self.engine
        K = e.engine_cfg.decode_chunk
        if any(r is not None and r.stream for r in self._rows):
            return 1
        min_left = min(
            r.max_new_tokens - len(r.out_ids) for r in self._rows if r is not None
        ) - pending
        w = -(-min_left // K)
        if self._queue:
            w = min(w, 2)
        return max(1, min(w, e.engine_cfg.max_inflight_chunks))

    def _prepare_window_tables(self, extra: int) -> int | None:
        """Grow every active row's block table to cover the window's
        writes (positions < offset + extra); a row the pool cannot cover
        fails alone. Returns the window's pow2 table width, or None when
        no active row survives."""
        for b, req in enumerate(self._rows):
            if req is None:
                continue
            try:
                self._ensure_blocks(b, int(self._offsets[b]) + extra)
            except _PoolExhausted as err:
                self._rows[b] = None
                self._release_row(b)
                self._row_params_dirty = True
                self._retire_error(req, str(err))
        live = [
            len(self._row_blocks[b]) for b, r in enumerate(self._rows) if r is not None
        ]
        if not live:
            return None
        tw = self._table_width(max(live))
        self.stats.paged_live_blocks = sum(live)
        self.stats.paged_blocks_read_last_step = self._bsz * tw
        self.stats.paged_blocks_in_use = self._alloc.used_count
        return tw

    def _step(self):
        """One hot-loop turn: keep the readback ring full, fetch the OLDEST
        in-flight window (the only host sync), refill the ring BEFORE
        processing its tokens, so token intake overlaps the next window's
        device time, then process. With overlap off the ring holds one
        window and this is the plain dispatch -> sync -> process loop."""
        K = self.engine.engine_cfg.decode_chunk
        depth = self._depth if self._overlap else 1
        while len(self._inflight) < depth:
            pending = sum(r["W"] for r in self._inflight) * K
            if self._inflight and not self._overlap_ready(pending):
                break
            if not self._dispatch_window(pending):
                break
        if not self._inflight:
            self._compact_and_shrink()
            return
        rec = self._inflight.popleft()
        toks_host = self._fetch_window(rec)
        if self._overlap:
            # rec's tokens are not in out_ids yet: they count as pending
            while len(self._inflight) < self._depth:
                pending = (sum(r["W"] for r in self._inflight) + rec["W"]) * K
                if not self._overlap_ready(pending):
                    break
                if not self._dispatch_window(pending):
                    break
        if not self._inflight:
            # the device goes idle while the host processes this window
            _C_SYNC_STALLS.inc()
        retired_any = self._process_window(rec, toks_host)
        self._release_deferred()
        if self.active == 0 and self._inflight:
            # every row retired mid-ring: the rest is overshoot nobody
            # reads; drain it so the batch can compact
            retired_any |= self._drain_inflight()
        if retired_any and not self._inflight:
            # compaction moves rows, and in-flight records carry row
            # indices: it waits for an empty ring
            self._compact_and_shrink()

    def _dispatch_window(self, pending: int = 0) -> bool:
        """Dispatch one W-chunk window without a host sync and push its
        record onto the ring. Host offsets advance AT DISPATCH, so every
        later consumer sees the post-in-flight positions. With the ring
        empty the host mirrors of cur and the offsets are copied into the
        static buffers; otherwise the window chains on the device's own,
        which the graph advanced. Returns False when no active row
        survives table preparation."""
        e = self.engine
        K = e.engine_cfg.decode_chunk
        W = self._window_size(pending)
        tw = self._prepare_window_tables(W * K)
        if tw is None:
            return False
        slot = self._slots.popleft()
        bsz, nb = self._bsz, self._on_card
        tables = slot.tables[:bsz * tw].view(bsz, tw)
        tables.copy_(torch.from_numpy(self._tables[:bsz, :tw]))
        self._d_tables[:bsz * tw].view(bsz, tw).copy_(tables, non_blocking=nb)
        if not self._inflight:
            slot.cur[:bsz] = torch.from_numpy(self._cur)
            slot.off[:bsz] = torch.from_numpy(self._offsets)
            self._d_cur[:bsz].copy_(slot.cur[:bsz], non_blocking=nb)
            self._d_off[:bsz].copy_(slot.off[:bsz], non_blocking=nb)
        flags = self._stage_knobs(slot)
        key = self._decode_key(tw, flags)
        a = self.active
        _G_ACTIVE_ROWS.set(a)
        _G_BATCH_FILL.set(a / bsz)
        # pool-growth forecast on the dispatch cadence, and the window's
        # economics: bsz*W*K positions run (dead rows included), active*W*K
        # token slots scheduled
        self.engine.introspect.forecast.feed(self._alloc.used_count,
                                             self._alloc.free_count)
        self._meter.record_dispatch(bsz * W * K, self._mean_active_ctx() + W * K / 2.0,
                                    scheduled=a * W * K)
        t0 = time.perf_counter()
        for c in range(W):
            self._decode_chunk(key)
            slot.toks[c, :bsz].copy_(self._d_toks[:bsz], non_blocking=nb)
        if slot.event is not None:
            slot.event.record()
        self._inflight.append({
            "slot": slot, "W": W, "bsz": bsz, "t0": t0,
            "rows": [(b, r) for b, r in enumerate(self._rows) if r is not None],
        })
        self._offsets = self._offsets + np.int32(W * K)
        self.stats.chunks += W
        if flags["penalized"]:
            self.stats.counts_windows += 1
        self._last_dispatch_t = time.perf_counter()
        return True

    def _mean_active_ctx(self) -> float:
        """Mean cache depth of the active rows: the FLOPs model's attention
        input. Read before the dispatch advances the offsets."""
        depths = [int(self._offsets[b]) for b, r in enumerate(self._rows) if r is not None]
        return sum(depths) / len(depths) if depths else 0.0

    def _overlap_ready(self, pending: int) -> bool:
        """May a look-ahead window dispatch with ``pending`` tokens already
        in flight? Look-ahead never retires or fails a row and never takes
        the sync cadence from work that wants the host: queued admissions
        and streaming rows. Reads post-in-flight offsets."""
        if not self._overlap or self.active == 0:
            return False
        if self._queue:
            return False
        if any(r is not None and r.stream for r in self._rows):
            return False
        e = self.engine
        K = e.engine_cfg.decode_chunk
        min_left = min(
            r.max_new_tokens - len(r.out_ids) for r in self._rows if r is not None
        )
        # some row must still need tokens beyond those in flight, or the
        # whole window would be budget overshoot
        if min_left <= pending:
            return False
        W = self._window_size(pending)
        need = 0
        for b, r in enumerate(self._rows):
            if r is None:
                continue
            upto = int(self._offsets[b]) + W * K
            # hard capacity: the plain path may overshoot into the
            # decode_chunk margin once; stacked look-ahead may not
            if upto > e.max_seq_len:
                return False
            need += max(
                0, ceil_div(upto, self._block_size) - len(self._row_blocks[b])
            )
        # the free list must cover the window outright
        return need <= self._alloc.free_count

    def _fetch_window(self, rec) -> np.ndarray:
        """THE host sync of the decode hot loop: wait for one window's
        token copy (its slot's event), then take the tokens [bsz, W*K] out
        of the slot, which goes back to the ring."""
        _G_OVERLAP.set(len(self._inflight))
        _C_HOST_SYNCS.inc()
        self.stats.windows += 1
        slot = rec["slot"]
        if slot.event is not None:
            slot.event.synchronize()
        bsz = rec["bsz"]
        toks_host = np.concatenate(
            [slot.toks[c, :bsz].numpy() for c in range(rec["W"])], axis=1
        )
        self._slots.append(slot)
        if not self._inflight:
            # ring drained: the host mirror of each row's latest token is
            # the window's last column (mid-ring, a newer window already
            # chains on the device's own)
            self._cur = toks_host[:, -1].copy()
        _H_STEP.observe((time.perf_counter() - rec["t0"]) * 1000.0)
        return toks_host

    def _process_window(self, rec, toks_host: np.ndarray) -> bool:
        """Route one fetched window's tokens through the per-row intake.
        Rows that retired since dispatch are skipped: their tokens are
        overshoot."""
        retired_any = False
        for b, req in rec["rows"]:
            if self._rows[b] is not req or req.done:
                continue
            req.chunks_decoded += rec["W"]
            retired_any |= self._process_row_tokens(b, req, toks_host[b])
        return retired_any

    def _drain_inflight(self) -> bool:
        """Fetch and process every in-flight window. Each fetch is a stall:
        the device goes idle behind it."""
        retired_any = False
        while self._inflight:
            rec = self._inflight.popleft()
            _C_SYNC_STALLS.inc()
            toks_host = self._fetch_window(rec)
            retired_any |= self._process_window(rec, toks_host)
        self._release_deferred()
        return retired_any

    def _release_deferred(self):
        """Free the blocks of rows that retired while windows were in
        flight, once the ring is empty."""
        if self._deferred_blocks and not self._inflight:
            self._alloc.deref(self._deferred_blocks)
            self._deferred_blocks = []
            self.stats.paged_blocks_in_use = self._alloc.used_count

    def _process_row_tokens(self, b: int, req: Request, tokens) -> bool:
        """THE per-row token intake: mark cancellation, accept tokens until
        the request finishes, emit the stream event, retire a done row.
        Returns True when the row retired."""
        if req.cancelled and not req.done:
            req.finish = "cancelled"
        emitted: list[int] = []
        for t in tokens:
            if not req.accept(int(t)):
                break
            emitted.append(int(t))
            if req.done:
                break
        # goodput: only tokens accepted into an output are useful
        # (post-stop overshoot and cancelled rows stay scheduled-only)
        self._meter.note_useful(len(emitted))
        if emitted and req.stream:
            req.events.put({
                "token": emitted[-1],
                "tokens": emitted,
                "text": req.text_delta(final=req.done),
            })
        if req.done:
            self._rows[b] = None
            self._release_row(b)
            self._row_params_dirty = True
            self._retire(req)
            return True
        return False

    def _retire(self, req: Request):
        req.timing.t_done = time.perf_counter()
        self.stats.retired += 1
        self.stats.history.append(
            {"new_tokens": len(req.out_ids), "chunks": req.chunks_decoded}
        )
        req.events.put({"done": True, "result": self.engine._build_result(req)})

    def _retire_error(self, req: Request, reason: str):
        """Error-terminate an ADMITTED row with full retirement accounting."""
        req.finish = "error"
        req.timing.t_done = time.perf_counter()
        self.stats.retired += 1
        self.stats.history.append(
            {"new_tokens": len(req.out_ids), "chunks": req.chunks_decoded,
             "error": True}
        )
        req.events.put({"done": True, "result": None, "error": reason})
