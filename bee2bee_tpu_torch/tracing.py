"""Tracing and observability: request spans + cross-node trace propagation
+ on-demand device profiles.

The reference has NO tracing (SURVEY §5) — the closest artifacts are
per-request latency_ms (reference services.py:97-105) and ping RTTs
(reference p2p_runtime.py:544-557). This module is the required upgrade:

- `Tracer`: a lock-guarded ring buffer of completed `Span`s with nested
  span support (contextvar parent), percentile aggregation per span name,
  and zero dependencies. One process-global instance via `get_tracer()`.
- `Span` context manager works in sync and async code and never throws:
  tracing must not take down the serving path.
- **Trace context propagation**: every span carries a `trace_id` (opened
  fresh at the first span of a request, inherited inside it).
  `inject_trace(frame)` stamps the current (trace_id, span_id) onto a wire
  frame as the optional `trace_ctx` key; the receiving hop calls
  `extract_trace(data)` + `use_trace_ctx(ctx)` so its spans parent under
  the ORIGINATING request across nodes. `/trace?trace_id=` on any node
  returns its local fragment; `stitch_trace()` merges fragments from
  several nodes into one cross-node timeline.
- `device_profile()`: wraps `jax.profiler.trace` so one call captures an
  XLA device trace viewable in TensorBoard/Perfetto.

Spans are cheap (monotonic clock + dict append) and bounded (ring
buffer), so they stay on in production; mesh nodes surface them at the
gateway's `/trace` route. Span NAMES are literal dotted constants —
meshlint ML-T001 rejects dynamically-built names (request-varying names
would defeat the per-name aggregation and explode cardinality).

PyTorch port: a copy of ``bee2bee_tpu/tracing.py`` with the import root
rewritten to ``bee2bee_tpu_torch``. ``device_profile`` and ``annotate`` wrap
torch.profiler, not jax.profiler.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Iterator

from .protocol import TRACE_CTX
from .utils import new_id

_current_span: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "bee2bee_current_span", default=None
)
_current_trace: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "bee2bee_current_trace", default=None
)


@dataclass
class Span:
    name: str
    span_id: str = field(default_factory=lambda: new_id("span"))
    parent_id: str | None = None
    trace_id: str | None = None
    start_ms: float = 0.0
    duration_ms: float = -1.0  # -1 while open
    attrs: dict[str, Any] = field(default_factory=dict)
    error: str | None = None

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "trace_id": self.trace_id,
            "start_ms": round(self.start_ms, 3),
            "duration_ms": round(self.duration_ms, 3),
            "attrs": self.attrs,
            "error": self.error,
        }


@dataclass(frozen=True)
class TraceContext:
    """The wire-portable half of a span: enough for a remote hop to parent
    its own spans under the originating request."""

    trace_id: str
    span_id: str

    def to_wire(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_wire(cls, obj: Any) -> "TraceContext | None":
        if (
            isinstance(obj, dict)
            and isinstance(obj.get("trace_id"), str)
            and isinstance(obj.get("span_id"), str)
        ):
            return cls(obj["trace_id"], obj["span_id"])
        return None


def current_trace_ctx() -> TraceContext | None:
    """The (trace_id, span_id) pair of the innermost open span, or None
    outside any span."""
    tid, sid = _current_trace.get(), _current_span.get()
    if tid is None or sid is None:
        return None
    return TraceContext(tid, sid)


def inject_trace(fields: dict) -> dict:
    """Stamp the current trace context onto a wire frame/fields dict as
    the optional `trace_ctx` key (declared in analysis/schema.py; the
    reference mesh ignores unknown keys, so frames stay wire-compatible).
    No-op outside a span — never throws."""
    try:
        ctx = current_trace_ctx()
        if ctx is not None:
            fields[TRACE_CTX] = ctx.to_wire()
    except Exception:  # noqa: BLE001 — telemetry never breaks the wire path
        pass
    return fields


def extract_trace(data: dict) -> TraceContext | None:
    """Read a `trace_ctx` key off a received frame; None when absent or
    malformed (old peers / non-instrumented senders) — never throws."""
    try:
        return TraceContext.from_wire(data.get(TRACE_CTX))
    except Exception:  # noqa: BLE001 — a bad frame must not kill a handler
        return None


@contextmanager
def use_trace_ctx(ctx: TraceContext | None):
    """Run a block under a remote trace context: spans opened inside carry
    ctx.trace_id and parent under ctx.span_id. ctx=None is a no-op, so
    handlers can call this unconditionally."""
    if ctx is None:
        yield
        return
    t_trace = _current_trace.set(ctx.trace_id)
    t_span = _current_span.set(ctx.span_id)
    try:
        yield
    finally:
        _current_span.reset(t_span)
        _current_trace.reset(t_trace)


class Tracer:
    """Bounded in-memory span collector; thread-safe; never raises."""

    def __init__(self, capacity: int = 2048):
        self._spans: deque[Span] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._epoch = time.time() * 1000.0 - time.monotonic() * 1000.0
        self.counters: dict[str, int] = {}
        # completion listeners (health.FlightRecorder): called with each
        # closed Span outside the lock; listener errors are swallowed —
        # an observability consumer must never fail the traced code path
        self._listeners: list = []

    def add_listener(self, fn) -> None:
        """Subscribe to span completions (idempotent per function)."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    @contextmanager
    def span(self, name: str, **attrs) -> Iterator[Span]:
        trace_id = _current_trace.get()
        trace_token = None
        if trace_id is None:  # first span of a request: open a new trace
            trace_id = new_id("trace")
            trace_token = _current_trace.set(trace_id)
        s = Span(
            name=name,
            parent_id=_current_span.get(),
            trace_id=trace_id,
            start_ms=self._epoch + time.monotonic() * 1000.0,
            attrs=dict(attrs),
        )
        token = _current_span.set(s.span_id)
        t0 = time.monotonic()
        try:
            yield s
        except BaseException as exc:
            s.error = f"{type(exc).__name__}: {exc}"
            raise
        finally:
            s.duration_ms = (time.monotonic() - t0) * 1000.0
            _current_span.reset(token)
            if trace_token is not None:
                _current_trace.reset(trace_token)
            with self._lock:
                self._spans.append(s)
                listeners = list(self._listeners)
            for fn in listeners:
                try:
                    fn(s)
                except Exception:  # noqa: BLE001 — tracing never throws
                    pass

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def recent(self, limit: int = 100, name: str | None = None) -> list[dict]:
        with self._lock:
            spans = list(self._spans)
        if name is not None:
            spans = [s for s in spans if s.name == name]
        return [s.to_dict() for s in spans[-limit:]]

    def for_trace(self, trace_id: str, limit: int = 1000) -> list[dict]:
        """This process's local fragment of one trace, oldest first —
        what `/trace?trace_id=` serves; stitch fragments from several
        nodes with `stitch_trace`."""
        with self._lock:
            spans = [s for s in self._spans if s.trace_id == trace_id]
        return [s.to_dict() for s in spans[-limit:]]

    def stats(self) -> dict[str, dict]:
        """Per-span-name aggregates: count, p50/p95/max duration, errors."""
        with self._lock:
            spans = list(self._spans)
            counters = dict(self.counters)
        by_name: dict[str, list[Span]] = {}
        for s in spans:
            by_name.setdefault(s.name, []).append(s)
        out: dict[str, dict] = {}
        for name, group in by_name.items():
            durs = sorted(s.duration_ms for s in group)
            out[name] = {
                "count": len(durs),
                "errors": sum(1 for s in group if s.error),
                "p50_ms": round(_pct(durs, 0.50), 3),
                "p95_ms": round(_pct(durs, 0.95), 3),
                "max_ms": round(durs[-1], 3),
            }
        if counters:
            out["_counters"] = counters
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.counters.clear()


def stitch_trace(
    fragments: list[dict], expected_nodes: list[str] | None = None
) -> dict:
    """Merge per-node trace fragments into one cross-node timeline.

    `fragments` is a list of ``{"node": <peer_id>, "spans": [span dicts]}``
    (each the payload of one node's ``/trace?trace_id=`` response). Spans
    are annotated with their node, de-duplicated by span_id (fragments may
    overlap when nodes share a process, e.g. loopback tests) and ordered
    by start_ms — parent links then read as one tree across nodes.

    Degrades gracefully instead of failing the whole stitch: a fragment
    marked ``{"unreachable": True}`` (the peer never answered) or
    ``{"partial": True}`` (it answered without a usable span list), and
    any ``expected_nodes`` entry that contributed no fragment, land in
    ``missing_peers`` and flip ``incomplete`` — the merged PARTIAL
    timeline is still returned."""
    seen: dict[str, dict] = {}
    responded: set = set()
    missing: set = set()
    for frag in fragments or []:
        node = frag.get("node")
        if frag.get("unreachable") or frag.get("partial"):
            if node:
                missing.add(node)
            continue
        if node:
            responded.add(node)
        for s in frag.get("spans") or []:
            sid = s.get("span_id")
            if sid is None or sid in seen:
                continue
            seen[sid] = {**s, "node": node}
    for node in expected_nodes or []:
        if node not in responded:
            missing.add(node)
    missing -= responded  # a duplicate fragment pair: any answer counts
    spans = sorted(seen.values(), key=lambda s: s.get("start_ms") or 0.0)
    trace_ids = {s.get("trace_id") for s in spans if s.get("trace_id")}
    return {
        "trace_id": next(iter(trace_ids)) if len(trace_ids) == 1 else None,
        "nodes": sorted({s["node"] for s in spans if s.get("node")}),
        "spans": spans,
        "incomplete": bool(missing),
        "missing_peers": sorted(missing),
    }


def _pct(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    return _GLOBAL


@contextmanager
def device_profile(log_dir: str = "/tmp/bee2bee_trace"):
    """Capture a host + CUDA device trace (Chrome ``trace.json`` readable,
    in ``log_dir``).

    The answer to "how do I see where the time goes": wraps
    torch.profiler.profile around any block — kernel launches, copies and
    the host ops around them all appear in the timeline.
    """
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with get_tracer().span("device_profile", log_dir=log_dir):
            yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str, **attrs):
    """torch.profiler.record_function + host span in one: shows up both in
    the device timeline and in /trace output."""
    from torch.profiler import record_function

    @contextmanager
    def _cm():
        with record_function(name):
            with get_tracer().span(name, **attrs):
                yield

    return _cm()
