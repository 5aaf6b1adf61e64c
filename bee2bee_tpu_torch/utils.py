"""Infra utilities: home dir, atomic JSON persistence, ids, hashing, metrics.

Capability parity with reference utils (bee2bee/utils.py:11-135)
with one deliberate divergence: `get_system_metrics` never fabricates numbers.
The reference simulates throughput as `cpu_percent * 0.85` and invents a
trust_score (utils.py:129-132); here throughput is a real measured
tokens/sec figure reported by the serving engine (see MetricsAggregator),
and accelerator telemetry comes from `jax.local_devices()` memory stats
instead of nvidia-smi.

PyTorch port: a copy of ``bee2bee_tpu/utils.py`` with the import root
rewritten to ``bee2bee_tpu_torch``; comments that cited the JAX package's
change history or the reference checkout's path are trimmed.
``get_accelerator_info`` reads the CUDA cards through torch.cuda, not
jax.local_devices.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import json
import logging
import os
import socket
import tempfile
import threading
import time
import uuid
from pathlib import Path
from typing import Any


def bee2bee_home() -> Path:
    """Per-user state directory (env `BEE2BEE_TPU_HOME` overrides).

    Mirrors reference `bee2bee_home` (utils.py:11-18).
    """
    root = os.environ.get("BEE2BEE_TPU_HOME")
    home = Path(root) if root else Path.home() / ".bee2bee_tpu"
    home.mkdir(parents=True, exist_ok=True)
    return home


def data_file(name: str) -> Path:
    return bee2bee_home() / name


def save_json(path: Path | str, obj: Any) -> None:
    """Atomic JSON write: tmp file + os.replace (reference utils.py:37-40)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_json_source(source: str | None, env_var: str,
                     opener: str = "{") -> Any:
    """THE inline-JSON-or-file-path config convention (BEE2BEE_SLO_CONFIG,
    BEE2BEE_TENANTS, BEE2BEE_ADMISSION, BEE2BEE_ROUTER share it): `source`
    wins, else the env var; a value starting with `opener` parses inline,
    anything else is a path read and parsed. Returns None when no source
    is configured at all; parse/read errors raise — these configs fail
    the node at construction, never route on garbage."""
    raw = source if source is not None else os.environ.get(env_var)
    if not raw:
        return None
    text = raw.strip()
    if not text.startswith(opener):
        text = Path(text).read_text()
    return json.loads(text)


def load_json(path: Path | str, default: Any = None) -> Any:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return default


def new_id(prefix: str = "id") -> str:
    """Unique id `prefix-<12 hex>` (reference utils.py:43-44)."""
    return f"{prefix}-{uuid.uuid4().hex[:12]}"


def sha256_hex(data: bytes | str) -> str:
    if isinstance(data, str):
        data = data.encode("utf-8")
    return hashlib.sha256(data).hexdigest()


def get_lan_ip(default: str | None = "127.0.0.1") -> str | None:
    """Best-effort LAN IP via the UDP-connect trick (reference utils.py:68-80).
    Returns `default` (pass None to detect failure) when no route exists."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.settimeout(0.5)
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return default


def now_ms() -> int:
    return int(time.time() * 1000)


class MetricsAggregator:
    """Rolling real-throughput accounting for a serving node.

    Replaces the reference's simulated telemetry (utils.py:129-132) with
    measured values: every completed generation reports (new_tokens,
    latency_s) and the aggregator exposes tokens/sec over a sliding window.
    Thread-safe: services may complete requests from executor threads.
    """

    def __init__(self, window_s: float = 60.0):
        self.window_s = window_s
        self._events: list[tuple[float, int, float]] = []  # (t, tokens, latency_s)
        self._lock = threading.Lock()
        self._total_tokens = 0
        self._total_requests = 0

    def record(self, new_tokens: int, latency_s: float) -> None:
        with self._lock:
            self._events.append((time.time(), int(new_tokens), float(latency_s)))
            self._total_tokens += int(new_tokens)
            self._total_requests += 1
            self._prune()

    def _prune(self) -> None:
        cutoff = time.time() - self.window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.pop(0)

    def snapshot(self) -> dict:
        import time as _time

        with self._lock:
            self._prune()
            toks = sum(e[1] for e in self._events)
            lats = [e[2] for e in self._events if e[2] > 0]
            # divide by actual elapsed span (capped at the window), not the
            # full window — else a fresh node underreports for window_s secs
            if self._events:
                span = max(_time.time() - self._events[0][0], self._events[0][2], 1e-3)
                span = min(span, self.window_s)
            else:
                span = 1.0
            return {
                "tokens_per_sec": round(toks / span, 3),
                "window_tokens": toks,
                "p50_latency_s": round(_percentile(lats, 0.5), 4) if lats else None,
                "total_tokens": self._total_tokens,
                "total_requests": self._total_requests,
            }


def _percentile(values: list[float], q: float) -> float:
    xs = sorted(values)
    if not xs:
        return 0.0
    idx = min(int(q * len(xs)), len(xs) - 1)
    return xs[idx]


def get_accelerator_info() -> dict:
    """Describe the local CUDA cards via torch.cuda (replaces nvidia-smi
    polling, reference utils.py:102-118). Without a card — or on any
    failure — returns a CPU-only record."""
    try:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device")
        n = torch.cuda.device_count()
        kinds: dict[str, int] = {}
        for i in range(n):
            kind = torch.cuda.get_device_name(i)
            kinds[kind] = kinds.get(kind, 0) + 1
        mem = None
        try:
            free, total = torch.cuda.mem_get_info(0)
            mem = {"bytes_in_use": total - free, "bytes_limit": total}
        except Exception:
            pass
        return {
            "platform": "gpu",
            "device_count": n,
            "device_kinds": kinds,
            "memory": mem,
        }
    except Exception:
        return {"platform": "cpu", "device_count": 0, "device_kinds": {}, "memory": None}


def get_system_metrics(throughput: MetricsAggregator | None = None) -> dict:
    """System + accelerator metrics. Schema keeps the reference's keys
    (utils.py:128-133) for registry/UI compatibility, but every value is
    measured: cpu/ram via psutil, gpu via torch.cuda memory info, throughput from
    the engine's MetricsAggregator (0.0 if none supplied — never simulated).
    """
    cpu = ram = 0.0
    try:
        import psutil

        cpu = psutil.cpu_percent(interval=None)
        ram = psutil.virtual_memory().percent
    except Exception:
        pass
    accel = get_accelerator_info()
    gpu_pct = 0.0
    if accel["memory"] and accel["memory"].get("bytes_limit"):
        gpu_pct = round(
            100.0 * (accel["memory"].get("bytes_in_use") or 0) / accel["memory"]["bytes_limit"],
            2,
        )
    tp = throughput.snapshot() if throughput else None
    return {
        "cpu": cpu,
        "ram": ram,
        "gpu": gpu_pct,
        "throughput": (tp or {}).get("tokens_per_sec", 0.0),
        "p50_latency_s": (tp or {}).get("p50_latency_s"),
        "accelerator": accel,
        "timestamp": now_ms(),
    }


async def pump_queue_until(task, q, emit):
    """Forward queued items through `emit` (awaited per item) until `task`
    completes, then drain anything queued after completion. Returns the
    task's result (re-raising its exception).

    The cancellation-sensitive streaming pump shared by the mesh node's
    GEN_CHUNK forwarding and the web gateway's HTTP chunk relay: cancelling
    a waiting `q.get()` is safe because put_nowait appends to the queue's
    internal deque, so items survive for the post-completion drain.

    When `emit` raises (consumer hung up mid-stream), the producer task is
    cancelled and its outcome consumed — the generation must not keep
    running to its token budget for nobody, and its eventual exception
    must not surface as "Task exception was never retrieved". (Work a
    producer already handed to an executor thread finishes in that thread;
    cancellation stops everything scheduled after it.)
    """
    getter = None
    try:
        while True:
            getter = asyncio.create_task(q.get())
            done, _ = await asyncio.wait(
                {getter, task}, return_when=asyncio.FIRST_COMPLETED
            )
            if getter in done:
                await emit(getter.result())
                continue
            getter.cancel()
            break
        result = await task
        while not q.empty():
            await emit(q.get_nowait())
        return result
    except BaseException:
        # also reached when the pump itself is cancelled (client hung up):
        # neither the producer nor a pending q.get() may be left dangling
        if getter is not None and not getter.done():
            getter.cancel()
        task.cancel()
        with contextlib.suppress(BaseException):
            await task
        raise


_task_logger = logging.getLogger("bee2bee_tpu_torch.tasks")


def log_task_exception(task: asyncio.Task) -> None:
    """Done-callback that surfaces a background task's exception instead of
    letting it vanish into "Task exception was never retrieved" at GC time.
    Retrieving the exception here also marks it retrieved, so the asyncio
    destructor warning never fires."""
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        _task_logger.error(
            "background task %r crashed: %r",
            task.get_name(),
            exc,
            exc_info=exc,
        )


class TaskTracker:
    """Tracked background-task spawning: the `node._spawn` pattern as a
    reusable helper, and the blessed route past meshlint ML-R002.

    A raw ``asyncio.create_task`` whose handle is dropped has two failure
    modes: its exception is silently swallowed, and asyncio holds only a
    weak reference so GC can cancel it mid-flight. The tracker keeps a
    strong reference until the task finishes, logs any exception via
    `log_task_exception`, and cancels everything still running on
    `cancel_all()` (stop/teardown). Policy (docs/ANALYSIS.md): a raw
    create_task is fine only when the handle is awaited on every path in
    the same function (e.g. `pump_queue_until`); every background task
    goes through a tracker.
    """

    def __init__(self, name: str = "tasks"):
        self.name = name
        self._tasks: set[asyncio.Task] = set()

    def spawn(self, coro, name: str | None = None) -> asyncio.Task:
        task = asyncio.get_running_loop().create_task(coro, name=name)
        self._tasks.add(task)
        task.add_done_callback(self._reap)
        return task

    def _reap(self, task: asyncio.Task) -> None:
        self._tasks.discard(task)
        log_task_exception(task)

    def __len__(self) -> int:
        return len(self._tasks)

    def __iter__(self):
        return iter(list(self._tasks))

    async def cancel_all(self) -> None:
        tasks = [t for t in self._tasks if not t.done()]
        for t in tasks:
            t.cancel()
        for t in tasks:
            with contextlib.suppress(BaseException):
                await t
