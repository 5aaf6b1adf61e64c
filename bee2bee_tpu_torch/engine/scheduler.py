"""Continuous-batching scheduler: shared paged-pool decode with rolling
admission.

The port of ``bee2bee_tpu/engine/scheduler.py``'s main loop:

- **One shared paged KV pool** plus per-row state (current token, write
  offset) kept as host numpy mirrors. All rows decode together; per-row
  block tables (engine/paged.py) map positions onto pool blocks, which
  are allocated lazily and freed at retirement.
- **Adaptive batch bucketing**: ``bsz`` tracks the active row count in
  power-of-two buckets (grow on admission, shrink on retirement); active
  rows stay compacted in [0, active) by host table moves.
- **Rolling admission**: a queued request prefills straight into the pool
  through its row's block table (whole-prompt bucket or fixed chunks);
  its first token is sampled at once, and a burst of admissions is read
  back in ONE host read.
- **Decode windows**: one window is up to ``max_inflight_chunks`` chunks
  of ``decode_chunk`` steps, run as a python loop of forwards whose
  sampled tokens stay on the card; the host reads them once per window.
  EOS / stop / budget retire a row at the window's end.
- **Per-row sampling and penalties**: the knobs ride as [B] tensors;
  penalty counts [B, 2, V] (prompt, generated) live on the card and are
  bumped by every sampled token.
- **Tenant fairness**: the submit queue is a WDRR queue keyed by
  ``Request.tenant`` (router/fairness.py), weighted from the
  ``BEE2BEE_TENANTS`` config or ``set_tenant_weights``; a request costs
  its token budget, charged when it is popped and refunded when it never
  runs or is requeued. With no tenants configured the order is FIFO.

Threading model: one daemon scheduler thread owns all device state;
``submit`` only appends to a queue under a condition variable, and
callers read per-request event queues.

Not ported yet: speculative decoding, adapters, migration checkpoints,
the prefix cache and its copy-on-write sharing, sticky batch widths, the
overlapped readback ring and introspection.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..metrics import get_registry
from ..router.fairness import WdrrQueue
from ..router.tenants import load_tenant_config
from ..unported import unported
from .paged import BlockAllocator, ceil_div, pow2_at_least, prefill_chunk_positions
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
    paged_blocks_in_use: int = 0
    paged_blocks_hwm: int = 0
    paged_blocks_read_last_step: int = 0
    paged_live_blocks: int = 0
    paged_alloc_waits: int = 0  # admissions deferred on an exhausted pool
    counts_windows: int = 0  # windows that carried the penalty counts
    history: deque = field(default_factory=lambda: deque(maxlen=64))


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
    """The paged pool has no free blocks: admission backpressure, not a
    crash — callers requeue or fail the one request."""


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
        self._device = e.device
        self._bsz = 1
        self._block_size = e.engine_cfg.kv_block_size
        self._alloc = BlockAllocator(e.pool_blocks)
        self._tables = np.zeros((max_batch, e.blocks_per_row), np.int32)
        self._row_blocks: list[list[int]] = [[] for _ in range(max_batch)]
        self._cache = e.new_pool()
        self._cur = np.zeros((self._bsz,), np.int64)
        self._offsets = np.zeros((self._bsz,), np.int32)
        self._rows: list[Request | None] = [None] * self._bsz
        self._row_params_dirty = True
        self._knobs: dict | None = None
        # penalty occurrence counts [bsz, 2, V] int32 on the device,
        # allocated on the first penalized admission. Rows of plain
        # requests may hold stale counts; rep=1/pres=0/freq=0 never read
        # them, and every admission overwrites its row.
        self._counts: torch.Tensor | None = None
        self._vocab = e.model_cfg.vocab_size

        self._thread = threading.Thread(
            target=self._loop, name="bee2bee-torch-batch-scheduler", daemon=True
        )
        self._thread.start()

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
            try:
                self._admit()
                if self.active:
                    self._step()
            except Exception as e:  # noqa: BLE001 — the thread must survive:
                # a dead scheduler thread would hang every blocked caller
                logger.exception("scheduler step failed; failing active requests")
                try:
                    with self._cond:
                        self._fail_all(f"scheduler error: {e!r}")
                    self._reset_device_state()
                except Exception:
                    logger.exception("scheduler recovery failed; shutting down")
                    with self._cond:
                        self._shutdown = True
                        self._fail_all("scheduler dead: device unrecoverable")
                    return

    def _fail_all(self, reason: str):
        """Error-terminate every queued AND admitted request (callers are
        blocked on their event queues and must always get a done event).
        Caller holds self._cond."""
        for req in list(self._queue) + [r for r in self._rows if r is not None]:
            req.finish = "error"
            req.events.put({"done": True, "result": None, "error": reason})
        self._queue.clear()
        for b, r in enumerate(self._rows):
            if r is not None:
                self._release_row(b)
        self._rows = [None] * self._bsz

    def _reset_device_state(self):
        """Recover to an empty bucket-1 batch after a failure: the pool
        (with an int8 pool's zeroed scales) and the allocator are
        rebuilt."""
        e = self.engine
        self._bsz = 1
        self._alloc = BlockAllocator(e.pool_blocks)
        self._tables[:] = 0
        self._row_blocks = [[] for _ in range(self.max_batch)]
        self._cache = e.new_pool()
        self.stats.paged_blocks_in_use = 0
        self._cur = np.zeros((1,), np.int64)
        self._offsets = np.zeros((1,), np.int32)
        self._rows = [None]
        self._counts = None
        self._row_params_dirty = True

    # ------------------------------------------------------------ paged state

    def _release_row(self, b: int):
        """Drop row b's block references and null its table row, so the
        dead row's decode writes land in the null block."""
        if self._row_blocks[b]:
            self._alloc.deref(self._row_blocks[b])
            self._row_blocks[b] = []
        self._tables[b, :] = 0
        self.stats.paged_blocks_in_use = self._alloc.used_count

    def _alloc_blocks(self, n: int) -> list[int]:
        """THE allocation funnel. On an int8 pool it zeroes the fresh
        blocks' scales: the quantize-on-write running max would otherwise
        inherit the previous tenant's amax and serve the new row at an
        inflated quantization step."""
        fresh = self._alloc.alloc(n)
        if fresh is None:
            raise _PoolExhausted(
                f"paged KV pool exhausted: need {n} blocks, "
                f"{self._alloc.free_count} free of {self._alloc.num_blocks}"
            )
        if self.engine.kv_quantized and fresh:
            idx = torch.tensor(fresh, dtype=torch.long)
            if self._device.type == "cuda":
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

    def _resize(self, new_bsz: int):
        """Move to a new batch bucket: only the host mirrors and the
        counts resize; the pool is batch-independent."""
        old = self._bsz
        if new_bsz == old:
            return
        keep = min(old, new_bsz)
        if self._counts is not None:
            counts = torch.zeros(
                (new_bsz, 2, self._vocab), dtype=torch.int32, device=self._device
            )
            counts[:keep] = self._counts[:keep]
            self._counts = counts
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
        then drop to a smaller bucket when occupancy allows."""
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
            if self._counts is not None:
                self._counts[hole] = self._counts[last]
            self._cur[hole] = self._cur[last]
            self._offsets[hole] = self._offsets[last]
            self._rows[hole] = self._rows[last]
            self._rows[last] = None
            self._row_params_dirty = True
        A = self.active
        if A == 0 and self._bsz > 1:
            self._resize(1)
        elif self._bsz > 1 and A * 2 <= self._bsz // 2:
            # quarter-occupancy hysteresis: halve without thrashing
            self._resize(max(1, self._bsz // 2))

    # ------------------------------------------------------------ admission

    def _paged_prefill(self, req: Request, b: int, bucket: int):
        """Prefill req's prompt straight into the pool through row b's
        block table, chunk by chunk; returns last_logits [1, V]. The
        block-sufficiency check runs BEFORE any device work: on
        _PoolExhausted the row holds nothing and the caller can requeue."""
        e = self.engine
        BS = self._block_size
        seq = req.ids
        n = len(seq)
        self._row_blocks[b] = []
        self._tables[b, :] = 0
        try:
            # the write ceil drops every scatter at/past n, so prefill
            # claims exactly ceil(n / BS) blocks whatever the bucket
            need = ceil_div(n, BS)
            if need > self._alloc.free_count:
                raise _PoolExhausted(
                    f"paged KV pool exhausted: admission needs {need} blocks, "
                    f"{self._alloc.free_count} free of {self._alloc.num_blocks}"
                )
            last_logits = None
            for pos in prefill_chunk_positions(n, 0, bucket, e.max_seq_len):
                self._ensure_blocks(b, min(pos + bucket, n))
                chunk = seq[pos:pos + bucket]
                tokens = np.zeros((1, bucket), np.int64)
                tokens[0, :len(chunk)] = chunk
                tw = self._table_width(len(self._row_blocks[b]))
                last_logits = e._prefill(
                    torch.from_numpy(tokens).to(self._device),
                    self._cache,
                    torch.tensor([len(chunk)], device=self._device),
                    pos,
                    torch.from_numpy(self._tables[b:b + 1, :tw].copy()).to(self._device),
                    write_ceil=n,
                )
            return last_logits
        except _PoolExhausted:
            self._release_row(b)
            raise

    def _admit(self):
        """Prefill queued requests into free rows, growing the batch bucket
        up to max_batch. The first tokens of the whole burst come back in
        ONE host read."""
        e = self.engine
        placed: list[tuple] = []  # (req, row, firsts index)
        firsts: list[torch.Tensor] = []
        while True:
            with self._cond:
                if not self._queue or self.active >= self.max_batch:
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
                self._resize(min(self._bsz * 2, self.max_batch))
            b = next(i for i, r in enumerate(self._rows) if r is None)
            n = len(req.ids)
            C = e.engine_cfg.prefill_chunk
            bucket = C if C is not None and n > C else e._bucket_for(n)
            req.bucket = bucket
            try:
                last_logits = self._paged_prefill(req, b, bucket)
                dev = self._device
                kw = {}
                if req.penalized:
                    # prompt occurrences host-side, shipped as the row's
                    # fresh counts; channel 1 (generated) starts at zero
                    if self._counts is None:
                        self._counts = torch.zeros(
                            (self._bsz, 2, self._vocab), dtype=torch.int32,
                            device=dev,
                        )
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
            self._offsets[b] = n
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

    def _row_sampling_arrays(self) -> dict:
        """The rows' sampling knobs as [bsz] device tensors, rebuilt when
        rows change, plus the host-side all-greedy flag."""
        if self._row_params_dirty or self._knobs is None:
            rows = self._rows
            dev = self._device

            def col(fn, dtype):
                return torch.tensor([fn(r) for r in rows], dtype=dtype, device=dev)

            live = [r for r in rows if r is not None]
            self._knobs = {
                "temperature": col(lambda r: r.temperature if r else 0.0,
                                   torch.float32),
                "top_k": col(lambda r: r.top_k if r else 0, torch.int32),
                "top_p": col(lambda r: r.top_p if r else 1.0, torch.float32),
                # None selects the min-p-free path when no row asks for it
                "min_p": (col(lambda r: r.min_p if r else 0.0, torch.float32)
                          if any(r.min_p > 0 for r in live) else None),
                "any_sampled": any(r.temperature > 0 for r in live),
                "penalized": any(r.penalized for r in live),
                "repetition": col(lambda r: r.repetition_penalty if r else 1.0,
                                  torch.float32),
                "presence": col(lambda r: r.presence_penalty if r else 0.0,
                                torch.float32),
                "frequency": col(lambda r: r.frequency_penalty if r else 0.0,
                                 torch.float32),
            }
            self._row_params_dirty = False
        return self._knobs

    def _window_size(self) -> int:
        """Chunks to run before the next host read: 1 while a request
        streams; else the tightest active row budget, capped at
        max_inflight_chunks (and at 2 while requests queue)."""
        e = self.engine
        K = e.engine_cfg.decode_chunk
        if any(r is not None and r.stream for r in self._rows):
            return 1
        min_left = min(
            r.max_new_tokens - len(r.out_ids) for r in self._rows if r is not None
        )
        w = -(-min_left // K)
        if self._queue:
            w = min(w, 2)
        return max(1, min(w, e.engine_cfg.max_inflight_chunks))

    def _prepare_window_tables(self, extra: int):
        """Grow every active row's block table to cover the window's
        writes (positions < offset + extra); a row the pool cannot cover
        fails alone. Returns the [bsz, tw] device tables, or None when no
        active row survives."""
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
        return torch.from_numpy(self._tables[:self._bsz, :tw].copy()).to(self._device)

    def _decode_chunk(self, cur, offsets, tables, knobs, counts):
        """One chunk: decode_chunk steps for ALL rows, the sampled tokens
        staying on the device. Returns (cur, offsets, counts, toks [B, K])."""
        e = self.engine
        B = cur.shape[0]
        rows = torch.arange(B, device=cur.device)
        toks = []
        for _ in range(e.engine_cfg.decode_chunk):
            logits, _ = e.forward(cur[:, None], self._cache, offsets, tables)
            pen = {}
            if counts is not None:
                pen = dict(counts=counts, repetition=knobs["repetition"],
                           presence=knobs["presence"], frequency=knobs["frequency"])
            cur = sample_batched(
                logits[:, -1], e.generator, knobs["temperature"],
                knobs["top_k"], knobs["top_p"], knobs["min_p"],
                any_sampled=knobs["any_sampled"], **pen,
            )
            if counts is not None:
                counts[rows, 1, cur] += 1
            offsets = offsets + 1
            toks.append(cur)
        return cur, offsets, counts, torch.stack(toks, dim=1)

    def _step(self):
        """One decode window: W chunks on the device, ONE host read of
        their tokens, then per-row intake (stop, stream, retire)."""
        e = self.engine
        K = e.engine_cfg.decode_chunk
        W = self._window_size()
        tables = self._prepare_window_tables(W * K)
        if tables is None:
            self._compact_and_shrink()
            return
        knobs = self._row_sampling_arrays()
        counts = self._counts if knobs["penalized"] else None
        a = self.active
        _G_ACTIVE_ROWS.set(a)
        _G_BATCH_FILL.set(a / self._bsz)
        rows = [(b, r) for b, r in enumerate(self._rows) if r is not None]
        t0 = time.perf_counter()
        cur = torch.from_numpy(self._cur).to(self._device)
        offsets = torch.from_numpy(self._offsets).to(self._device)
        parts = []
        for _ in range(W):
            cur, offsets, counts, toks = self._decode_chunk(
                cur, offsets, tables, knobs, counts
            )
            parts.append(toks)
        toks_host = torch.cat(parts, dim=1).cpu().numpy()  # the window's read
        _H_STEP.observe((time.perf_counter() - t0) * 1000.0)
        self._cur = toks_host[:, -1].astype(np.int64).copy()
        self._offsets = self._offsets + np.int32(W * K)
        self.stats.chunks += W
        self.stats.windows += 1
        if counts is not None:
            self.stats.counts_windows += 1
        retired_any = False
        for b, req in rows:
            req.chunks_decoded += W
            retired_any |= self._process_row_tokens(b, req, toks_host[b])
        if retired_any:
            self._compact_and_shrink()

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
