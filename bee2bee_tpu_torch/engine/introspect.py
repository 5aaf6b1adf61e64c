"""Engine economics plane: capture sentinel, HBM ledger, MFU/goodput
meters, pool forecast and on-demand device profiling.

The PyTorch port of ``bee2bee_tpu/engine/introspect.py``, under the JAX
module's metric names, label sets and never-throw contract:

- **RetraceSentinel**: a registry of the engine's roots. On the card
  what the port compiles while it serves is a CUDA graph capture of a
  root's step (engine/graphs.py), so a "compile" here is a graph
  capture: ``engine.compiles{root}`` counts the captures of ``decode``,
  ``prefill``, ``first_token``, ``spec_verify`` (engine/scheduler.py)
  and the drafter's ``draft`` and ``draft_prime`` (engine/drafter.py),
  ``engine.compile_seconds{root}`` their seconds. The eager root
  (``cow_copy``) is registered with zero compiles. The nvcc build of the
  attention kernels at first use (ops/_build.py) books its seconds to
  ``root="other"``. The **warm-up contract** is the JAX one: a root
  declares its legitimate key space (for the decode root the pow2 batch
  ladder, the pow2 table widths up to ``blocks_per_row``, and any flags;
  for the prefill root the bucket widths by the table widths); the first capture of
  a declared key fires nothing, a capture of an undeclared key fires the
  typed ``engine:retrace_storm`` incident at once, and repeated captures
  of one seen key fire it once they storm (``storm_repeats`` within
  ``storm_window_s``).
- **HbmLedger**: the device memory by component, from the engine's own
  tensors (weights: dense tensors and, for int8 weights, the packed int8
  bytes and their f32 scales; the KV pool with its int8 scales; the
  drafter; the adapter pool's stacked factors and scales), each storage
  counted once (tied embeddings are one storage), and for int8 weights
  the dequantize route's peak scratch in the engine's dtype
  (``int8_dequant_scratch``, a byte count: the allocator's cache keeps it
  once a wide prefill chunk ran; f32 engines and the CPU only, a bf16
  engine on the card runs a kernel at every width). The device total comes
  from ``torch.cuda.mem_get_info`` (total - free, device-wide): the
  caching allocator and the graphs' private pool hold memory that
  ``memory_allocated()`` does not show. The ledger never synchronises the
  device. ``engine.hbm_bytes{component}``, ``engine.hbm_headroom_frac``,
  and a ``workspace_other`` residual when the device total is known.
- **PoolForecast**: the paged pool's growth rate projected into the
  ``engine.pool_exhaust_eta_s`` gauge the admission shed reads.
- **GoodputMeter**: the analytic FLOPs model over the scheduler's
  dispatches (the same for int8 weights, which do the same operations)
  gives ``engine.mfu`` (model FLOP/s over the card's peak) and
  ``engine.goodput_tokens_per_s``; scheduled token positions are told
  apart from useful tokens (padded prefill tails and post-stop window
  overshoot count against goodput).
- **DeviceProfiler**: a duration-bounded ``torch.profiler`` capture (the
  device's activity on a card, the CPU's without one) behind ``POST
  /debug/profile`` (api.py): the chrome trace, written and zipped by a
  forked child, under ``$BEE2BEE_INCIDENT_DIR/profiles``, listed and
  fetched like incidents; a concurrent capture is refused typed. It never
  overlaps a CUDA graph capture: both take ``graph_capture_lock``. The
  profiler starts and stops only between device passes (``device_gate``:
  the schedulers' passes, every captured root's run, a draft server's
  draft).
- The decode hot loop's readback metrics (``engine.host_syncs``,
  ``engine.host_sync_stalls``, ``engine.overlap_inflight``), which the
  scheduler moves.

Left out: the JAX ``bench_snapshot`` (it feeds the JAX bench.py; the port
has no bench yet). The module imports torch only inside the functions
that touch the device or the profiler.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import weakref
import zipfile
from collections import deque
from contextlib import contextmanager
from pathlib import Path
from typing import Callable

from ..health import get_recorder, register_digest_provider
from ..metrics import get_registry
from ..utils import new_id

logger = logging.getLogger("bee2bee_tpu_torch.introspect")

_REG = get_registry()
# per-root compile accounting; the `root` label set is closed: exactly
# the roots the engine and scheduler register, plus "other"
_C_COMPILES = _REG.counter(
    "engine.compiles", "jit traces per registered engine root"
)
_C_COMPILE_SECONDS = _REG.counter(
    "engine.compile_seconds", "XLA compile wall-time per registered root"
)
_C_RETRACE_STORMS = _REG.counter(
    "engine.retrace_storms",
    "steady-state retraces detected per root (undeclared shapes / "
    "repeat-key compile storms)",
)
_G_MFU = _REG.gauge(
    "engine.mfu",
    "model FLOP/s over platform peak FLOP/s, trailing window (0..1)",
)
_G_GOODPUT = _REG.gauge(
    "engine.goodput_tokens_per_s",
    "USEFUL tokens per second over the trailing window (rejected drafts, "
    "re-prefills and overshoot excluded)",
)
_G_SCHEDULED_TPS = _REG.gauge(
    "engine.scheduled_tokens_per_s",
    "token positions dispatched per second over the trailing window",
)
_G_GOODPUT_FRAC = _REG.gauge(
    "engine.goodput_fraction",
    "useful / scheduled tokens over the trailing window (0..1)",
)
_G_SPEC_ACCEPT = _REG.gauge(
    "engine.spec_acceptance",
    "cumulative accepted/drafted speculative tokens per drafter tier "
    "(tier label; absent until that tier has drafted)",
)
_G_HBM_BYTES = _REG.gauge(
    "engine.hbm_bytes", "live device memory by component (bytes)"
)
_G_HBM_HEADROOM = _REG.gauge(
    "engine.hbm_headroom_frac",
    "fraction of device memory still free (1 - in_use/limit)",
)
_G_POOL_ETA = _REG.gauge(
    "engine.pool_exhaust_eta_s",
    "projected seconds until the paged KV pool runs dry at the current "
    "growth rate (absent when the pool is not growing)",
)
_C_HOST_SYNCS = _REG.counter(
    "engine.host_syncs",
    "device->host token fetches in the decode hot loop (one per readback "
    "window — the only blocking point the overlap design permits)",
)
_C_SYNC_STALLS = _REG.counter(
    "engine.host_sync_stalls",
    "host syncs that blocked with NO other decode window in flight — the "
    "device sat idle while the host processed tokens (0 when overlap "
    "keeps the ring full)",
)
_G_OVERLAP = _REG.gauge(
    "engine.overlap_inflight",
    "decode windows still in flight on-device at readback time (0 = "
    "serialized loop, >=1 = async dispatch overlap is working)",
)

# compile seconds spent outside any registered root (the kernels' nvcc
# builds) book to this root
_OTHER_ROOT = "other"

# held by a CUDA graph capture (engine/scheduler.py) and by a device
# profile for each of its windows: a profiler never starts, runs or
# stops while a graph is being captured (a capture waits for the window)
graph_capture_lock = threading.Lock()


class DeviceGate:
    """The schedulers' passes over the device against the profiler's start
    and stop. Passes run together (one per engine); a transition waits for
    the passes in progress to end, holds new ones back and runs alone.
    torch.profiler's stop (``_disable_profiler``: CUPTI off) deadlocked
    against a CUDA graph replay that a scheduler thread launched at the
    same moment (H100, torch 2.11): both threads waited for good."""

    def __init__(self):
        self._cond = threading.Condition()
        self._passes = 0
        self._closed = False
        self._local = threading.local()

    def _enter(self) -> None:
        with self._cond:
            while self._closed:
                self._cond.wait()
            self._passes += 1
        self._local.inside = True

    def inside(self) -> bool:
        """Is this thread in a device pass?"""
        return getattr(self._local, "inside", False)

    def _leave(self) -> None:
        self._local.inside = False
        with self._cond:
            self._passes -= 1
            self._cond.notify_all()

    @contextmanager
    def device_pass(self):
        """One pass over the device: a scheduler pass (admission,
        dispatch and readback), a captured root's run, a draft server's
        draft. Reentrant: inside a pass it is the pass it is in."""
        if self.inside():
            yield
            return
        self._enter()
        try:
            yield
        finally:
            self._leave()

    @contextmanager
    def outside_pass(self):
        """Steps this thread out of its pass, if it is in one, while it
        waits and launches nothing: for what a transition's caller holds
        (graph_capture_lock), or for the device (a decode window's
        readback), so a transition need not wait for that wait."""
        inside = self.inside()
        if inside:
            self._leave()
        try:
            yield
        finally:
            if inside:
                self._enter()

    def let_transition_in(self) -> None:
        """Between two launches of a pass: if a transition waits, step out
        of the pass until it has run (a chunk's replays take milliseconds
        each to launch while a profile records: a pass launching one
        would hold a window open for the whole chunk)."""
        if self._closed and self.inside():
            with self.outside_pass():
                pass

    @contextmanager
    def transition(self):
        """Runs alone: no pass is in progress until it ends."""
        with self._cond:
            while self._closed:
                self._cond.wait()
            self._closed = True
            while self._passes:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._closed = False
                self._cond.notify_all()


device_gate = DeviceGate()


def book_build_seconds(seconds: float) -> None:
    """Book a kernel build's wall time (ops/_build.py) to root "other"."""
    _C_COMPILE_SECONDS.inc(float(seconds), root=_OTHER_ROOT)


# ---------------------------------------------------------------- FLOPs model

# published dense bf16 peaks (NVIDIA data sheets, no sparsity) by a
# fragment of torch.cuda.get_device_name(); the first match wins
_GPU_PEAKS = (
    ("H100 PCIe", 756e12),
    ("H100", 989e12),  # SXM
    ("A100", 312e12),
)


def peak_flops_per_device(platform: str, device_kind: str = "") -> float:
    """Peak dense FLOP/s of one device, the MFU denominator.

    ``BEE2BEE_PEAK_FLOPS`` (per device) overrides everything. On ``"gpu"``
    the card's published dense bf16 peak by its name, else the JAX
    package's nominal 1e14; the CPU value is a NOMINAL placeholder so the
    gauge exists on dev boxes (CPU "MFU" is never a hardware claim)."""
    env = os.environ.get("BEE2BEE_PEAK_FLOPS")
    if env:
        try:
            v = float(env)
            if v > 0:
                return v
        except ValueError:
            logger.warning("BEE2BEE_PEAK_FLOPS=%r is not a number", env)
    if platform == "gpu":
        for pat, peak in _GPU_PEAKS:
            if pat.lower() in (device_kind or "").lower():
                return peak
        return 1e14  # nominal; set BEE2BEE_PEAK_FLOPS for real numbers
    return 1e11  # nominal CPU placeholder (proxy MFU only)


class FlopsModel:
    """Analytic forward-FLOPs model for one ModelConfig:
    ``flops(positions, ctx)`` = positions x (2 x matmul_params + 4 x L x H
    x hd x ctx): every (active) weight multiplied and added once per
    position, plus QK^T and AV against ``ctx`` cached positions across all
    query heads."""

    def __init__(self, model_cfg):
        from ..models.core import matmul_params_per_token

        self.matmul_flops_per_pos = 2.0 * matmul_params_per_token(model_cfg)
        self.attn_flops_per_pos_per_ctx = (
            4.0 * model_cfg.n_layers * model_cfg.n_heads * model_cfg.head_dim
        )

    def flops(self, positions: float, ctx: float) -> float:
        return positions * (
            self.matmul_flops_per_pos
            + self.attn_flops_per_pos_per_ctx * max(ctx, 0.0)
        )


# ------------------------------------------------------------ capture sentinel


class _Root:
    __slots__ = ("name", "allowed", "seen", "traces", "repeat_ts", "storms",
                 "last_storm_ts")

    def __init__(self, name: str, allowed: Callable | None):
        self.name = name
        self.allowed = allowed
        self.seen: set = set()
        self.traces = 0
        # PER-KEY repeat timestamps: only the SAME key storming is the
        # per-step-recapture signal (bounded: keys are a subset of seen)
        self.repeat_ts: dict = {}
        self.storms = 0
        self.last_storm_ts = 0.0


class RetraceSentinel:
    """Watches the engine's roots for steady-state recompiles, here CUDA
    graph captures (see the module docstring). One sentinel per engine;
    the metrics are process-global (label ``root``)."""

    def __init__(self, node: str | None = None, storm_window_s: float = 60.0,
                 storm_repeats: int = 3, recorder=None):
        self.node = node
        self.storm_window_s = float(storm_window_s)
        self.storm_repeats = int(storm_repeats)
        self._recorder = recorder
        self._lock = threading.Lock()
        self._roots: dict[str, _Root] = {}

    def register(self, name: str, allowed: Callable | None = None) -> None:
        """Declare root ``name`` with zero compiles. ``allowed(key)``
        declares its legitimate key space; None accepts any first-seen
        key."""
        with self._lock:
            if name not in self._roots:
                self._roots[name] = _Root(name, allowed)
        _C_COMPILES.inc(0, root=name)
        _C_COMPILE_SECONDS.inc(0, root=name)

    def note_compile(self, name: str, key, seconds: float = 0.0) -> None:
        """Book one compile (a graph capture) of root ``name`` at shape
        ``key`` (None = unkeyed: counted, not classified) and classify it.
        Never throws."""
        try:
            with self._lock:
                root = self._roots.get(name)
                if root is None:
                    root = self._roots[name] = _Root(name, None)
                root.traces += 1
            _C_COMPILES.inc(root=name)
            _C_COMPILE_SECONDS.inc(float(seconds), root=name)
            self._classify(root, key)
        except Exception:  # noqa: BLE001 — telemetry never throws
            pass

    def _classify(self, root: _Root, key) -> None:
        now = time.time()
        with self._lock:
            if key is None:
                return  # un-keyed: counted, not classified
            if key not in root.seen:
                root.seen.add(key)
                if root.allowed is None or root.allowed(key):
                    return  # declared growth / warm-up: fire nothing
                storm_detail = (
                    f"root {root.name!r} compiled an UNDECLARED shape key "
                    f"{key!r} in steady state"
                )
            else:
                # a repeat of a seen key storms only when THIS key storms
                ts = root.repeat_ts.setdefault(key, deque(maxlen=32))
                ts.append(now)
                recent = [t for t in ts if now - t <= self.storm_window_s]
                if len(recent) < self.storm_repeats:
                    return
                ts.clear()
                storm_detail = (
                    f"root {root.name!r} recompiled an already-seen shape "
                    f"key {key!r} {len(recent)}x within "
                    f"{self.storm_window_s:.0f}s"
                )
            root.storms += 1
            root.last_storm_ts = now
        _C_RETRACE_STORMS.inc(root=root.name)
        try:
            rec = self._recorder or get_recorder()
            rec.incident(
                "engine:retrace_storm", detail=storm_detail, node=self.node,
                extra={"root": root.name, "key": repr(key),
                       "traces": root.traces, "storms": root.storms},
            )
        except Exception:  # noqa: BLE001 — telemetry never throws
            pass
        logger.warning("retrace storm: %s", storm_detail)

    def snapshot(self) -> dict:
        """{root: {traces, storms}} for this sentinel's roots."""
        with self._lock:
            return {name: {"traces": r.traces, "storms": r.storms}
                    for name, r in self._roots.items()}

    def storming(self, within_s: float | None = None) -> bool:
        horizon = within_s if within_s is not None else self.storm_window_s
        now = time.time()
        with self._lock:
            return any(r.last_storm_ts and now - r.last_storm_ts <= horizon
                       for r in self._roots.values())


def declared_batch_sizes(max_batch: int) -> frozenset:
    """The batch buckets the scheduler can reach: the closure of {1,
    max_batch} under its resize ops (grow min(2b, max_batch), shrink
    max(1, b // 2)), so a non-pow2 max_batch's shrink ladder (6 -> 3 -> 1)
    is declared warm-up, not a false storm."""
    sizes: set[int] = set()
    frontier = {1, max_batch}
    while frontier:
        b = frontier.pop()
        if b in sizes:
            continue
        sizes.add(b)
        frontier.add(min(2 * b, max_batch))
        frontier.add(max(1, b // 2))
    return frozenset(sizes)


def declared_table_width(w: int, blocks_per_row: int) -> bool:
    """A block-table width the scheduler emits: a power of two up to
    ``blocks_per_row``, or ``blocks_per_row`` itself (the cap)."""
    return w == blocks_per_row or (w & (w - 1) == 0 and 0 < w <= blocks_per_row)


# ---------------------------------------------------------------- HBM ledger


def tensor_tree_bytes(tree, seen: set | None = None) -> int:
    """Device bytes of a tree (dict / list / tuple) of tensors: each
    storage counted once, whole (a view counts its base's storage, two
    names of one storage count it once). ``seen`` carries the storages
    already counted across calls."""
    seen = set() if seen is None else seen
    total = 0
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif node is not None:
            try:
                storage = node.untyped_storage()
                key = (storage.device.type, storage.device.index, storage.data_ptr())
            except Exception:  # noqa: BLE001 — not a tensor: nothing to count
                continue
            if key not in seen:
                seen.add(key)
                total += storage.nbytes()
    return total


class HbmLedger:
    """Device memory by component, from registered tensor sources.

    A component registers a zero-arg callable returning its live tensor
    tree (or None once torn down), or the int bytes it reserves outside
    any tensor it keeps; ``snapshot()`` counts the trees, reads
    the device's used and total memory where there is a device (see the
    module docstring), refreshes the ``engine.hbm_*`` gauges and returns
    the breakdown that rides engine.info and the telemetry digest.
    ``mem_info`` returns (free, total) bytes; the default reads
    ``torch.cuda.mem_get_info`` for a CUDA ``device`` and nothing
    otherwise, where a ``BEE2BEE_HBM_BYTES`` budget stands in for the
    limit."""

    def __init__(self, device=None, mem_info: Callable | None = None):
        self._lock = threading.Lock()
        self._sources: dict[str, Callable] = {}
        if mem_info is None and device is not None and getattr(device, "type", "") == "cuda":
            def mem_info(device=device):
                import torch

                return torch.cuda.mem_get_info(device)
        self._mem_info = mem_info

    def register(self, component: str, source: Callable) -> None:
        with self._lock:
            self._sources[component] = source

    def unregister(self, component: str) -> None:
        with self._lock:
            self._sources.pop(component, None)
        _G_HBM_BYTES.clear(component=component)

    def close(self) -> None:
        """Drop every source closure: they close over the pool and the
        params, which a closed engine must not keep reachable."""
        with self._lock:
            self._sources.clear()

    def _device_stats(self) -> tuple[int | None, int | None]:
        """(bytes_in_use, bytes_limit) of the device, or (None, budget)
        without one (``BEE2BEE_HBM_BYTES``, else None)."""
        if self._mem_info is not None:
            free, total = self._mem_info()
            return int(total) - int(free), int(total)
        env = os.environ.get("BEE2BEE_HBM_BYTES")
        if env:
            try:
                return None, int(float(env))
            except ValueError:
                pass
        return None, None

    def snapshot(self) -> dict:
        """Never-throw: a ledger read must not take down a scrape."""
        try:
            return self._snapshot()
        except Exception:  # noqa: BLE001
            logger.exception("hbm ledger snapshot failed")
            return {"components": {}, "accounted_bytes": 0}

    def _snapshot(self) -> dict:
        with self._lock:
            sources = dict(self._sources)
        components: dict[str, int] = {}
        for name, src in sources.items():
            try:
                tree = src()
            except Exception:  # noqa: BLE001 — a torn-down engine reads 0
                tree = None
            if isinstance(tree, int):  # bytes a component reserves, no tensor
                components[name] = tree
            else:
                components[name] = tensor_tree_bytes(tree) if tree is not None else 0
        accounted = sum(components.values())
        in_use, limit = self._device_stats()
        out: dict = {"components": components, "accounted_bytes": accounted}
        for name, b in components.items():
            _G_HBM_BYTES.set(b, component=name)
        if in_use is not None:
            out["bytes_in_use"] = in_use
            # the allocator's cache, the graphs' pool, the CUDA context,
            # workspaces: whatever the sources do not name
            workspace = max(0, in_use - accounted)
            out["components"]["workspace_other"] = workspace
            _G_HBM_BYTES.set(workspace, component="workspace_other")
        else:
            _G_HBM_BYTES.clear(component="workspace_other")
        if limit:
            used = in_use if in_use is not None else accounted
            headroom = max(0.0, min(1.0, 1.0 - used / limit))
            out["bytes_limit"] = limit
            out["headroom_frac"] = round(headroom, 4)
            _G_HBM_HEADROOM.set(headroom)
        else:
            _G_HBM_HEADROOM.clear()
        return out


class PoolForecast:
    """Linear growth forecast for the paged block pool: the scheduler
    feeds ``(used, free)`` on its dispatch path (one deque append,
    self-throttled to one gauge refresh per second); ``eta_s()`` projects
    free blocks over the growth rate of the trailing window."""

    def __init__(self, window_s: float = 30.0):
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._samples: deque = deque(maxlen=256)  # (t, used, free)
        self._last_refresh = 0.0

    def feed(self, used: int, free: int, now: float | None = None) -> None:
        try:
            now = time.time() if now is None else now
            with self._lock:
                self._samples.append((now, int(used), int(free)))
                throttled = now - self._last_refresh < 1.0
                if not throttled:
                    self._last_refresh = now
            if not throttled:
                self.refresh(now)
        except Exception:  # noqa: BLE001 — telemetry never throws
            pass

    def eta_s(self, now: float | None = None) -> float | None:
        """Projected seconds to exhaustion, or None (shrinking pool / not
        enough signal: >= 2 samples spanning >= 2 s, so one admission
        burst cannot fabricate a trend)."""
        now = time.time() if now is None else now
        with self._lock:
            samples = [s for s in self._samples if now - s[0] <= self.window_s]
        if len(samples) < 2:
            return None
        t0, used0, _ = samples[0]
        t1, used1, free1 = samples[-1]
        dt = t1 - t0
        if dt < 2.0 or used1 <= used0:
            return None
        rate = (used1 - used0) / dt  # blocks/s, > 0
        return free1 / rate if free1 > 0 else 0.0

    def refresh(self, now: float | None = None) -> float | None:
        eta = self.eta_s(now)
        if eta is None:
            _G_POOL_ETA.clear()
        else:
            _G_POOL_ETA.set(eta)
        return eta


# -------------------------------------------------------------- goodput meter


class GoodputMeter:
    """Scheduled-vs-useful token accounting and the MFU meter.

    ``record_dispatch(positions, ctx, scheduled)`` books compute at
    dispatch (positions = batch rows x token width actually run, dead rows
    included); ``note_useful`` books tokens that made it into an output.
    Cumulative counters snapshot into a bounded deque at most every
    250 ms; ``refresh()`` derives trailing-window rates into the gauges."""

    SNAPSHOT_EVERY_S = 0.25

    def __init__(self, flops_model: FlopsModel | None, peak_flops: float,
                 window_s: float = 60.0):
        self.flops_model = flops_model
        self.peak_flops = max(float(peak_flops), 1.0)
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self.scheduled_total = 0
        self.useful_total = 0
        self.flops_total = 0.0
        self._snaps: deque = deque(maxlen=512)  # (t, sched, useful, flops)
        # zero baseline: without it the first dispatch burst would vanish
        # from the window's denominator
        self._snaps.append((time.time(), 0, 0, 0.0))
        self._last_snap = 0.0
        # tier -> [drafted, accepted], cumulative (the tier set is closed)
        self._spec_tiers: dict[str, list] = {}

    def record_dispatch(self, positions: float, ctx: float, scheduled: int) -> None:
        try:
            flops = (self.flops_model.flops(positions, ctx)
                     if self.flops_model is not None else 0.0)
            with self._lock:
                self.scheduled_total += int(scheduled)
                self.flops_total += flops
            self._maybe_snap()
        except Exception:  # noqa: BLE001 — telemetry never throws
            pass

    def note_useful(self, n: int) -> None:
        try:
            if n <= 0:
                return
            with self._lock:
                self.useful_total += int(n)
            self._maybe_snap()
        except Exception:  # noqa: BLE001 — telemetry never throws
            pass

    def note_spec(self, tier: str, drafted: int, accepted: int) -> None:
        """Book one row's verify outcome against its drafter tier: the
        per-tier acceptance view beside the scheduled/useful split (which
        already counts the [B, K+1] width and only the survivors)."""
        try:
            if drafted <= 0:
                return
            with self._lock:
                t = self._spec_tiers.setdefault(tier, [0, 0])
                t[0] += int(drafted)
                t[1] += int(accepted)
        except Exception:  # noqa: BLE001 — telemetry never throws
            pass

    def _maybe_snap(self, force: bool = False) -> None:
        now = time.time()
        with self._lock:
            if not force and now - self._last_snap < self.SNAPSHOT_EVERY_S:
                return
            self._last_snap = now
            self._snaps.append(
                (now, self.scheduled_total, self.useful_total, self.flops_total)
            )

    def refresh(self) -> dict:
        """Trailing-window rates -> gauges; returns the snapshot dict.
        With no dispatch inside the window the rate gauges CLEAR (an idle
        engine reports nothing, never its last busy reading)."""
        rate_gauges = (_G_MFU, _G_GOODPUT, _G_SCHEDULED_TPS, _G_GOODPUT_FRAC)
        try:
            self._maybe_snap(force=True)
            now = time.time()
            with self._lock:
                snaps = list(self._snaps)
            # the newest snapshot at or before the window start anchors
            # the delta
            start = now - self.window_s
            ref = snaps[0]
            for s in snaps:
                if s[0] <= start:
                    ref = s
                else:
                    break
            out: dict = {
                "scheduled_tokens_total": self.scheduled_total,
                "useful_tokens_total": self.useful_total,
                "model_flops_total": self.flops_total,
            }
            with self._lock:
                spec_tiers = {k: tuple(v) for k, v in self._spec_tiers.items()}
            if spec_tiers:
                out["spec_tiers"] = {
                    k: {"drafted": d, "accepted": a,
                        "acceptance": round(a / d, 4) if d else 0.0}
                    for k, (d, a) in spec_tiers.items()
                }
                for k, (d, a) in spec_tiers.items():
                    if d:
                        _G_SPEC_ACCEPT.set(a / d, tier=k)
            t0, s0, u0, f0 = ref
            t1, s1, u1, f1 = snaps[-1]
            if t1 - t0 <= 0 or (s1, u1, f1) == (s0, u0, f0):
                for g in rate_gauges:
                    g.clear()
                return out
            dt = t1 - t0
            sched_rate = (s1 - s0) / dt
            useful_rate = (u1 - u0) / dt
            mfu = (f1 - f0) / dt / self.peak_flops
            out.update(
                scheduled_tokens_per_s=round(sched_rate, 3),
                goodput_tokens_per_s=round(useful_rate, 3),
                goodput_fraction=(round(useful_rate / sched_rate, 4)
                                  if sched_rate > 0 else 0.0),
                mfu=round(mfu, 6),
                window_s=round(dt, 3),
            )
            _G_SCHEDULED_TPS.set(sched_rate)
            _G_GOODPUT.set(useful_rate)
            _G_MFU.set(mfu)
            if sched_rate > 0:
                _G_GOODPUT_FRAC.set(useful_rate / sched_rate)
            return out
        except Exception:  # noqa: BLE001 — telemetry never throws
            logger.exception("goodput refresh failed")
            return {}


# ------------------------------------------------------------ device profiler


class ProfileInProgress(RuntimeError):
    """A capture is already running (the profiler is a process singleton).
    Typed so the API answers 409 profile_in_progress instead of a 500."""


class DeviceProfiler:
    """Duration-bounded on-demand ``torch.profiler`` capture.

    One capture at a time per process. With a card it records the CPU
    ops and the device's activity (CUPTI: the kernels whatever thread
    launched them, graph replays included), without stacks, shapes,
    memory or CUPTI's external correlation (each kernel linked to the CPU
    op that launched it, which makes each stop about a fifth longer; the
    trace names every kernel without it); without a card, the CPU's. It
    records ``duration_s`` and zips the chrome trace into
    ``prof-<id>.zip`` under ``<incident_dir>/profiles``, listed and
    fetched like incident bundles. The capture runs on the CALLER's
    thread (api.py offloads it); each window holds ``graph_capture_lock``
    while the profiler runs, so no CUDA graph capture overlaps it, and
    starts and stops inside ``device_gate.transition()``, between the
    device passes, so serving pauses for the start (seconds at a
    process's first) and the stop.

    The stop holds the GIL while torch turns the window's device events
    into its result, 10-50 us an event on an H100 (a second of B=1
    llama-3-8b decode is some 1.8 * 10^5 kernel events of graph
    replays), which serving waits out whole. So a capture samples: it
    records windows of ``WINDOW_S`` with ``SPACING_S`` unrecorded between
    them, where serving runs at its own pace, until the windows have
    recorded ``duration_s``. A window starts and stops between device
    passes (a scheduler waiting for a readback is outside its pass, and
    one replaying a chunk lets a transition in between two replays) and
    stops by the C++ disable alone, without syncing the device, so it
    holds the device's work while it was open, not the queue behind it:
    each stop walks about ``WINDOW_S`` of events, and a stream's chunk
    meets at most one stop. The trace joins the windows. A forked child
    (a copy of this process that touches no device) writes and zips the
    trace while this thread waits without the GIL and without
    ``graph_capture_lock``, so serving and its captures run on beside
    the export; where ``os.fork`` is missing this process writes it.
    ``profile_probe.py`` measures these choices against the ones they
    replaced (PERF.md §6). ``last_timings`` holds the last capture's
    start seconds (summed), its longest stop (what serving waits out),
    the stops summed, the export seconds, the windows and each window's
    stop and recorded seconds."""

    MAX_DURATION_S = 60.0
    # the seconds of one profiler window, and unrecorded between two
    WINDOW_S = 0.05
    SPACING_S = 0.25
    # a forked export still running after this long is killed
    EXPORT_TIMEOUT_S = 300.0

    def __init__(self, profile_dir: str | Path | None = None):
        self._dir = Path(profile_dir) if profile_dir else None
        self._lock = threading.Lock()
        self._active: dict | None = None
        self.last_timings: dict | None = None

    @property
    def profile_dir(self) -> Path:
        if self._dir is None:
            self._dir = get_recorder().incident_dir / "profiles"
        return self._dir

    @property
    def active(self) -> dict | None:
        with self._lock:
            return dict(self._active) if self._active else None

    def capture(self, duration_s: float = 2.0, workload: Callable | None = None) -> dict:
        """Blocking capture: run the profiler in windows of ``WINDOW_S``
        (start, run ``workload()`` or sleep, stop), ``SPACING_S`` apart,
        until they have recorded ``duration_s``, then write one chrome
        trace of every window and zip it. Returns the artifact header.
        Raises ProfileInProgress when a capture is already running."""
        duration_s = max(0.05, min(float(duration_s), self.MAX_DURATION_S))
        prof_id = new_id("prof")
        with self._lock:
            if self._active is not None:
                raise ProfileInProgress(f"capture {self._active['id']} already running")
            self._active = {"id": prof_id, "started": time.time(),
                            "duration_s": duration_s}
        raw_dir = self.profile_dir / prof_id
        try:
            raw_dir.mkdir(parents=True, exist_ok=True)
            # windows until they have recorded ``duration_s`` (the capture
            # starts once the profiler runs: its first start in a process
            # takes seconds)
            profs, starts, stops = [], [], []
            captured_s = 0.0
            while not profs or captured_s < duration_s - 1e-3:
                if profs:
                    time.sleep(self.SPACING_S)
                profs.append(self._window(workload, starts, stops,
                                          duration_s - captured_s))
                captured_s += profs[-1].recorded_s
            t0 = profs[0].t0
            t_export = time.perf_counter()
            zip_path = self.profile_dir / f"{prof_id}.zip"
            n_files = self._export(profs, raw_dir, zip_path)
            export_s = time.perf_counter() - t_export
            self.last_timings = {"start_s": sum(starts), "stop_s": max(stops),
                                 "stops_s": sum(stops), "export_s": export_s,
                                 "windows": len(profs),
                                 "window_stops_s": [round(x, 3) for x in stops],
                                 "window_recorded_s": [round(p.recorded_s, 3)
                                                       for p in profs]}
            self._rmtree(raw_dir)
            return {
                "id": prof_id,
                "ts": t0,
                "duration_s": round(captured_s, 3),
                "files": n_files,
                "bytes": zip_path.stat().st_size,
            }
        finally:
            with self._lock:
                self._active = None

    def _window(self, workload, starts: list, stops: list, budget_s: float):
        """One profiler window, holding ``graph_capture_lock``: start and
        stop inside gate transitions, ``workload()`` (or a sleep) between
        them for ``WINDOW_S``, at most ``budget_s``. The profiler gets
        ``t0``, its window's start, and ``recorded_s``, the seconds from
        then to its stop."""
        prof = self._profiler()
        with graph_capture_lock:
            with device_gate.transition():
                t = time.perf_counter()
                prof.start()
                starts.append(time.perf_counter() - t)
            try:
                prof.t0 = time.time()
                stop_at = prof.t0 + min(self.WINDOW_S, budget_s)
                if workload is not None:
                    while time.time() < stop_at:
                        workload()
                else:
                    time.sleep(max(0.0, stop_at - time.time()))
            finally:
                with device_gate.transition():
                    prof.recorded_s = time.time() - prof.t0
                    t = time.perf_counter()
                    self._stop(prof)
                    stops.append(time.perf_counter() - t)
        return prof

    @staticmethod
    def _profiler():
        """One window's ``torch.profiler.profile``, not yet started."""
        import torch

        act = torch.profiler.ProfilerActivity
        activities = [act.CPU, act.CUDA] if torch.cuda.is_available() else [act.CPU]
        return torch.profiler.profile(
            activities=activities, record_shapes=False, profile_memory=False,
            with_stack=False,
            experimental_config=torch._C._profiler._ExperimentalConfig(
                disable_external_correlation=True))

    @staticmethod
    def _stop(prof) -> None:
        """Stop a window's profiler by the C++ call alone (what
        ``prof.stop()`` runs after syncing the device): the profiler
        disabled, its results kept for the trace's export. Kernels still
        queued or running are left out (CUPTI delivers completed records
        only), so the window holds what ran while it was open. torch's
        Python-side bookkeeping after it, which a chrome trace does not
        need, is skipped: it runs under the GIL, where on a serving node
        every other thread slows it."""
        from torch.autograd import _disable_profiler

        prof.profiler.kineto_results = _disable_profiler()

    @staticmethod
    def _write_trace(profs: list, raw_dir: Path) -> None:
        """One chrome trace, ``trace.json``, of every window: the first
        window's document with the others' events appended (their times
        moved onto the first's base where the bases differ)."""
        if len(profs) == 1:
            profs[0].export_chrome_trace(str(raw_dir / "trace.json"))
            return
        merged, base = None, None
        for i, prof in enumerate(profs):
            part = raw_dir / f"window-{i}.json"
            prof.export_chrome_trace(str(part))
            doc = json.loads(part.read_text())
            part.unlink()
            if merged is None:
                merged, base = doc, doc.get("baseTimeNanoseconds")
                continue
            own = doc.get("baseTimeNanoseconds")
            shift = (own - base) / 1000.0 if base is not None and own is not None else 0.0
            for ev in doc.get("traceEvents", []):
                if shift and isinstance(ev.get("ts"), (int, float)):
                    ev["ts"] += shift
                merged["traceEvents"].append(ev)
        (raw_dir / "trace.json").write_text(json.dumps(merged))

    def _export(self, profs: list, raw_dir: Path, zip_path: Path) -> int:
        """Write the chrome trace into ``raw_dir`` and zip it; returns the
        files zipped. A child process (a copy of this one, which touches
        no device) writes and zips while this thread polls for it with
        the GIL released; the child never returns into this code."""
        if not hasattr(os, "fork"):
            self._write_trace(profs, raw_dir)
            return self._zip_dir(raw_dir, zip_path)
        pid = os.fork()
        if pid == 0:  # the child: write, zip, leave without cleanup
            code = 1
            try:
                self._write_trace(profs, raw_dir)
                self._zip_dir(raw_dir, zip_path)
                code = 0
            finally:
                os._exit(code)
        deadline = time.monotonic() + self.EXPORT_TIMEOUT_S
        while True:
            done, status = os.waitpid(pid, os.WNOHANG)
            if done:
                break
            if time.monotonic() > deadline:
                os.kill(pid, 9)
                os.waitpid(pid, 0)
                raise RuntimeError(f"profile export still running after "
                                   f"{self.EXPORT_TIMEOUT_S:.0f} s: killed")
            time.sleep(0.01)
        if os.waitstatus_to_exitcode(status) != 0:
            raise RuntimeError(f"profile export failed (child status {status})")
        with zipfile.ZipFile(zip_path) as zf:
            return len(zf.namelist())

    @staticmethod
    def _zip_dir(src: Path, dst: Path) -> int:
        n = 0
        with zipfile.ZipFile(dst, "w", zipfile.ZIP_DEFLATED) as zf:
            for p in sorted(src.rglob("*")):
                if p.is_file():
                    zf.write(p, p.relative_to(src))
                    n += 1
        return n

    @staticmethod
    def _rmtree(d: Path) -> None:
        import shutil

        try:
            shutil.rmtree(d)
        except OSError:
            pass

    def list_profiles(self) -> list[dict]:
        """Newest-first artifact index (id, ts, bytes): the GET
        /debug/profile listing."""
        try:
            d = self.profile_dir
            if not d.is_dir():
                return []
            out = []
            for p in sorted(d.glob("prof-*.zip"), key=lambda p: p.stat().st_mtime,
                            reverse=True):
                st = p.stat()
                out.append({"id": p.stem, "ts": st.st_mtime, "bytes": st.st_size})
            return out
        except Exception:  # noqa: BLE001
            logger.exception("profile listing failed")
            return []

    def profile_path(self, prof_id: str) -> Path | None:
        """Artifact path by id (exact stem match, never a path join: the
        id is URL input); None when unknown."""
        try:
            d = self.profile_dir
            if not d.is_dir():
                return None
            for p in d.glob("prof-*.zip"):
                if p.stem == prof_id:
                    return p
            return None
        except Exception:  # noqa: BLE001
            logger.exception("profile lookup failed")
            return None


_PROFILER = DeviceProfiler()


def get_profiler() -> DeviceProfiler:
    """The process-global profiler (the profiler is a process singleton,
    so the serializing lock must be too)."""
    return _PROFILER


# --------------------------------------------------- per-engine aggregation

# live engines' introspection, keyed by id, folded into one `introspect`
# digest entry. WEAK values: an engine dropped without close() must not
# stay pinned here (its ledger sources hold the params)
_INSTANCES_LOCK = threading.Lock()
_INSTANCES: "weakref.WeakValueDictionary[int, EngineIntrospection]" = (
    weakref.WeakValueDictionary()
)
_PROVIDER_WIRED = False


def _digest_provider() -> dict | None:
    """health.build_digest's live-path hook: refresh the gauges and return
    the digest block (compiles per root, MFU/goodput, HBM headroom) for
    every live engine, merged. None when no engine runs in this process."""
    with _INSTANCES_LOCK:
        instances = list(_INSTANCES.values())
    if not instances:
        return None
    merged: dict = {"compiles": {}, "storms": 0}
    mfu = goodput = None
    hbm = None
    for ins in instances:
        snap = ins.refresh()
        for root, entry in (snap.get("compiles") or {}).items():
            slot = merged["compiles"].setdefault(root, {"traces": 0, "storms": 0})
            slot["traces"] += entry.get("traces", 0)
            slot["storms"] += entry.get("storms", 0)
            merged["storms"] += entry.get("storms", 0)
        meter = snap.get("goodput") or {}
        if meter.get("mfu") is not None:
            mfu = (mfu or 0.0) + meter["mfu"]
        if meter.get("goodput_tokens_per_s") is not None:
            goodput = (goodput or 0.0) + meter["goodput_tokens_per_s"]
        if snap.get("hbm"):
            hbm = snap["hbm"]  # one device per process in practice
    if mfu is not None:
        merged["mfu"] = round(mfu, 6)
    if goodput is not None:
        merged["goodput_tokens_per_s"] = round(goodput, 3)
    if hbm is not None:
        merged["hbm"] = {k: hbm[k] for k in ("accounted_bytes", "bytes_in_use",
                                              "bytes_limit", "headroom_frac")
                         if k in hbm}
    merged["storming"] = any(ins.sentinel.storming() for ins in instances)
    return merged


def _wire_provider() -> None:
    global _PROVIDER_WIRED
    if not _PROVIDER_WIRED:
        _PROVIDER_WIRED = True
        register_digest_provider("introspect", _digest_provider)


class EngineIntrospection:
    """One engine's economics instruments, built by InferenceEngine before
    its first forward: the sentinel its roots register with, the HBM
    ledger its tensor owners register with, the goodput meter and the pool
    forecast the scheduler feeds. ``refresh()`` is the scrape and digest
    entry point; ``close()`` unhooks the engine from the digest."""

    def __init__(self, model_cfg, device=None, peak_flops: float | None = None):
        platform, kind = "cpu", ""
        if device is not None and getattr(device, "type", "") == "cuda":
            import torch

            platform, kind = "gpu", torch.cuda.get_device_name(device)
        if peak_flops is None:
            peak_flops = peak_flops_per_device(platform, kind)
        self.platform = platform
        self.sentinel = RetraceSentinel()
        self.ledger = HbmLedger(device)
        self.meter = GoodputMeter(FlopsModel(model_cfg), peak_flops)
        self.forecast = PoolForecast()
        with _INSTANCES_LOCK:
            _INSTANCES[id(self)] = self
        _wire_provider()

    def close(self) -> None:
        with _INSTANCES_LOCK:
            _INSTANCES.pop(id(self), None)
        self.ledger.close()
        # drop the economics gauges outright: with no live engine they
        # would serve this engine's last busy reading forever (a surviving
        # sibling's series come back at its next refresh)
        try:
            for g in (_G_MFU, _G_GOODPUT, _G_SCHEDULED_TPS, _G_GOODPUT_FRAC,
                      _G_POOL_ETA, _G_HBM_HEADROOM, _G_OVERLAP):
                g.clear()
            for labels, _v in _G_HBM_BYTES.series():
                _G_HBM_BYTES.clear(**dict(labels))
        except Exception:  # noqa: BLE001 — telemetry never throws
            pass

    def refresh(self) -> dict:
        """Refresh every gauge this plane owns; return the snapshot that
        rides engine.info and the digest."""
        out = {
            "compiles": self.sentinel.snapshot(),
            "goodput": self.meter.refresh(),
            "hbm": self.ledger.snapshot(),
            "platform": self.platform,
            "peak_flops": self.meter.peak_flops,
        }
        # the forecast's own value, not the shared process gauge
        eta = self.forecast.refresh()
        if eta is not None:
            out["pool_exhaust_eta_s"] = round(eta, 3)
        return out
