"""Admission control: bounded queueing, per-tenant budgets, typed shedding.

The front door's backpressure layer, sitting at both ingress surfaces
(api.py HTTP handlers and meshnet/node._serve_gen_request p2p serving).
Every local generation acquires a slot first; when the node is saturated,
requests wait in a **weighted deficit-round-robin** queue keyed by tenant
(router/fairness.py), so one tenant's burst cannot starve another past
its weight. Rejections are TYPED — the caller always learns which
contract it hit and when to come back:

- ``429`` + ``rate_limited``      — the tenant's token budget is spent
  (token bucket; ``Retry-After`` = time until the bucket covers the ask);
- ``429`` + ``tenant_queue_full`` — the tenant already has its fair share
  of waiters queued (per-tenant bound — a fairness rejection, not a node
  overload);
- ``503`` + ``queue_full``        — the node-wide waiter bound is hit;
- ``503`` + ``queue_timeout``     — a waiter aged out before a slot freed
  (the no-request-hangs contract);
- ``503`` + ``pool_exhausted``    — the paged KV pool is nearly dry while
  every slot is busy (admission would only park the request on scheduler
  backpressure);
- ``503`` + ``slo_shed``          — this node's SLO fast window is burning
  (health.SloTracker): shed BEFORE the node melts, while peers with
  budget left absorb the traffic (the router stops picking a burning
  node, so shedding and routing converge).

Everything runs on the node's event loop: no locks, no threads. Config
via ``BEE2BEE_ADMISSION`` (inline JSON or a path), validated loudly.

PyTorch port: a copy of ``bee2bee_tpu/router/admission.py`` with the import root rewritten to
``bee2bee_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import math
from dataclasses import dataclass, fields

from ..clock import Clock, get_clock, resolve_clock
from ..metrics import get_registry
from ..utils import load_json_source
from .fairness import WdrrQueue

# admission observability (bee2bee_admission_* after prefixing): outcome/
# kind are closed sets; tenant is bounded by configuration (TenantRegistry
# clamps wire claims to configured names + "default")
_C_REQUESTS = get_registry().counter(
    "admission.requests", "admission outcomes by kind"
)
_C_SHED = get_registry().counter(
    "admission.shed", "requests shed with a typed 429/503 by kind"
)
_C_TENANT_TOKENS = get_registry().counter(
    "admission.tenant_tokens", "completed generation tokens by tenant"
)
_G_INFLIGHT = get_registry().gauge(
    "admission.inflight", "generations holding an admission slot"
)
_G_QUEUED = get_registry().gauge(
    "admission.queued", "requests waiting for an admission slot"
)

KIND_RATE = "rate_limited"
KIND_TENANT_QUEUE = "tenant_queue_full"
KIND_QUEUE = "queue_full"
KIND_TIMEOUT = "queue_timeout"
KIND_POOL = "pool_exhausted"
KIND_SLO = "slo_shed"
KIND_DRAINING = "draining"

# 429: the CALLER's contract (its budget, its share of the queue);
# 503: the NODE's state (overload, pool, SLO, drain) — retry elsewhere/later
_STATUS = {
    KIND_RATE: 429,
    KIND_TENANT_QUEUE: 429,
    KIND_QUEUE: 503,
    KIND_TIMEOUT: 503,
    KIND_POOL: 503,
    KIND_SLO: 503,
    KIND_DRAINING: 503,
}


class AdmissionReject(RuntimeError):
    """Typed admission rejection; carries everything a 429/503 response
    (or a GEN_ERROR frame) needs: kind, HTTP status, Retry-After."""

    def __init__(self, kind: str, retry_after_s: float, detail: str = ""):
        super().__init__(detail or f"admission rejected: {kind}")
        self.kind = kind
        self.status = _STATUS.get(kind, 503)
        self.retry_after_s = round(max(float(retry_after_s), 0.0), 3)
        self.detail = detail or f"admission rejected: {kind}"


@dataclass(frozen=True)
class AdmissionConfig:
    max_concurrent: int = 32      # in-flight generations (slots)
    max_queue: int = 128          # node-wide waiter bound
    tenant_queue: int = 64        # per-tenant waiter bound
    queue_timeout_s: float = 60.0  # max wait for a slot (no request hangs)
    shed_burn_rate: float = 6.0   # SLO fast-window burn that starts shedding
    pool_free_frac_min: float = 0.02  # paged free fraction under which we shed
    pool_eta_shed_s: float = 5.0  # shed when the pool-growth forecast
    # (engine.pool_exhaust_eta_s) projects exhaustion inside this horizon
    # while all slots are busy; 0 disables the forecast shed
    retry_after_s: float = 1.0    # base Retry-After hint for queue rejections
    shed_retry_after_s: float = 5.0  # Retry-After for node-state (503) sheds
    quantum: float = 256.0        # WDRR quantum (tokens)


def parse_admission_config(obj) -> AdmissionConfig:
    if not isinstance(obj, dict):
        raise ValueError(
            f"admission config must be a JSON object, got {type(obj).__name__}"
        )
    known = {f.name for f in fields(AdmissionConfig)}
    unknown = set(obj) - known
    if unknown:
        raise ValueError(f"admission config: unknown keys {sorted(unknown)}")
    kwargs = {}
    for k, v in obj.items():
        kwargs[k] = (
            int(v) if k in ("max_concurrent", "max_queue", "tenant_queue")
            else float(v)
        )
        if kwargs[k] <= 0 and k in ("max_concurrent", "quantum"):
            raise ValueError(f"admission config: {k} must be > 0")
        if kwargs[k] < 0:
            raise ValueError(f"admission config: {k} must be >= 0")
    return AdmissionConfig(**kwargs)


def load_admission_config(source: str | None = None) -> AdmissionConfig:
    """Config from `source`, ``BEE2BEE_ADMISSION`` (inline JSON or a
    path), or the defaults; malformed config fails node construction."""
    data = load_json_source(source, "BEE2BEE_ADMISSION")
    return parse_admission_config(data) if data is not None else AdmissionConfig()


def paged_pool_free_fraction() -> float | None:
    """Free fraction of the paged KV pool from the local registry gauges,
    or None when no paged engine runs in this process."""
    reg = get_registry()
    total = reg.get("engine.paged_blocks_total")
    free = reg.get("engine.paged_blocks_free")
    try:
        if total is None or free is None or not total.series():
            return None
        t = total.value()
        if t <= 0:
            return None
        return max(0.0, min(free.value() / t, 1.0))
    except Exception:  # noqa: BLE001 — a telemetry read must not shed traffic
        return None


def pool_exhaust_eta() -> float | None:
    """Projected seconds to paged-pool exhaustion from the forecast gauge
    (engine/introspect.py PoolForecast), or None when the pool is not
    growing / no paged engine runs here. Registry-read like
    paged_pool_free_fraction, so the front door needs no engine import."""
    reg = get_registry()
    g = reg.get("engine.pool_exhaust_eta_s")
    try:
        if g is None or not g.series():
            return None
        return float(g.value())
    except Exception:  # noqa: BLE001 — a telemetry read must not shed traffic
        return None


class _TokenBucket:
    """Sustained-rate token budget with burst capacity."""

    def __init__(self, rate_per_s: float, burst: float, now=None):
        self.rate = float(rate_per_s)
        self.burst = max(float(burst), 1.0)
        self._now = now if now is not None else (lambda: get_clock().monotonic())
        self._tokens = self.burst
        self._t = now()

    def _refill(self) -> None:
        t = self._now()
        self._tokens = min(self.burst, self._tokens + (t - self._t) * self.rate)
        self._t = t

    def take(self, n: float) -> bool:
        # an ask larger than the burst clamps to it: the request charges
        # (and, on rejection, waits for) the WHOLE burst — heavy but
        # SATISFIABLE. Without the clamp a default-sized ask against a
        # small burst is permanently unsatisfiable yet rejected with a
        # finite Retry-After, and well-behaved clients retry forever.
        n = min(float(n), self.burst)
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def refund(self, n: float) -> None:
        """Return tokens charged for work that never ran (queue timeout,
        cancelled waiter): overload must not convert into a spurious
        rate-limit lockout once the node recovers. The same burst clamp
        as take(), so a refund restores exactly what was charged."""
        self._refill()
        self._tokens = min(
            self.burst, self._tokens + min(max(float(n), 0.0), self.burst)
        )

    def eta_s(self, n: float) -> float:
        """Seconds until the bucket could cover n tokens."""
        self._refill()
        if self._tokens >= n:
            return 0.0
        if self.rate <= 0:
            return math.inf
        return (min(n, self.burst) - self._tokens) / self.rate


class _Waiter:
    __slots__ = ("fut", "tenant", "cost", "abandoned")

    def __init__(self, fut: asyncio.Future, tenant: str, cost: float = 1.0):
        self.fut = fut
        self.tenant = tenant
        self.cost = cost
        # set by the abandoning acquire (timeout / caller cancellation),
        # which ALSO removes the waiter from the queue-bound counters —
        # _dispatch must then skip it without double-decrementing
        self.abandoned = False


class AdmissionTicket:
    """One admitted generation's slot; release exactly once (idempotent).
    Usable as an async context manager."""

    def __init__(self, ctrl: "AdmissionController", tenant: str):
        self._ctrl = ctrl
        self.tenant = tenant
        self._released = False

    def note_tokens(self, n: int) -> None:
        """Completed-token accounting (the fairness bench's measurement)."""
        self._ctrl.note_tokens(self.tenant, n)

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._ctrl._release()

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        self.release()


class AdmissionController:
    """Slot-bounded admission with WDRR tenant queues and typed rejects.

    ``slo_burn`` / ``pool_free_fraction`` are injected callables so the
    controller stays testable without a node (and so a node wires its OWN
    SloTracker, not process-global state)."""

    def __init__(
        self,
        config: AdmissionConfig | None = None,
        weights: dict[str, float] | None = None,
        budgets: dict[str, tuple[float, float]] | None = None,
        slo_burn=None,
        pool_free_fraction=None,
        pool_eta=None,  # callable -> float | None: projected seconds to
        # paged-pool exhaustion (engine/introspect.py PoolForecast) —
        # sheds pool_exhausted BEFORE the free-fraction floor trips
        draining=None,  # callable -> bool: node drain state (migrate.py);
        # True rejects every new acquisition 503 `draining` + Retry-After
        now=None,
        clock: Clock | None = None,  # time seam (clock.py): queue
        # timeouts + token buckets follow the node's injected clock; an
        # explicit `now` callable still wins for bucket tests
    ):
        self.config = config or AdmissionConfig()
        self._clock = resolve_clock(clock)
        if now is None:
            now = self._clock.monotonic
        self._buckets = {
            t: _TokenBucket(rate, burst, now)
            for t, (rate, burst) in (budgets or {}).items()
        }
        self._slo_burn = slo_burn
        self._pool_free = pool_free_fraction
        self._pool_eta = pool_eta
        self._draining = draining
        self._free = int(self.config.max_concurrent)
        self._waiters = WdrrQueue(weights or {}, quantum=self.config.quantum)
        self._queued_total = 0
        self._queued_by_tenant: dict[str, int] = {}
        self.tenant_tokens: dict[str, float] = {}  # bench/debug view

    # ------------------------------------------------------------- metrics

    def note_tokens(self, tenant: str, n) -> None:
        try:
            n = float(n)
        except (TypeError, ValueError):
            return
        if n > 0:
            self.tenant_tokens[tenant] = self.tenant_tokens.get(tenant, 0.0) + n
            _C_TENANT_TOKENS.inc(n, tenant=tenant)

    def _reject(self, kind: str, retry_after_s: float, detail: str = ""):
        _C_REQUESTS.inc(outcome="rejected", kind=kind)
        _C_SHED.inc(kind=kind)
        raise AdmissionReject(kind, retry_after_s, detail)

    # ------------------------------------------------------------- acquire

    @property
    def inflight(self) -> int:
        return int(self.config.max_concurrent) - self._free

    @property
    def queued(self) -> int:
        return self._queued_total

    def _check_shed(self, migration: bool = False) -> None:
        cfg = self.config
        if self._draining is not None and self._draining():
            # draining precedes every other check: the node is leaving —
            # in-flight generations migrate out, new work goes elsewhere
            # (and it must not ACCEPT migrations while exporting its own)
            self._reject(
                KIND_DRAINING, cfg.shed_retry_after_s,
                "node is draining; retry against another peer",
            )
        if not migration and self._slo_burn is not None:
            # migration imports skip ONLY this clause: evacuated state
            # must land somewhere, the exporter's router already
            # deprioritizes burning peers, and the pool/queue bounds
            # below still protect the target
            burn = self._slo_burn()
            if burn is not None and burn >= cfg.shed_burn_rate:
                self._reject(
                    KIND_SLO, cfg.shed_retry_after_s,
                    f"SLO fast window burning at {burn:.1f}x budget "
                    f"(shed threshold {cfg.shed_burn_rate:g}x)",
                )
        if self._pool_free is not None and self._free <= 0:
            # pool pressure only sheds when every slot is busy too: a dry
            # pool with idle slots means retirements are freeing blocks
            frac = self._pool_free()
            if frac is not None and frac < cfg.pool_free_frac_min:
                self._reject(
                    KIND_POOL, cfg.shed_retry_after_s,
                    f"paged KV pool {frac * 100:.1f}% free "
                    f"(< {cfg.pool_free_frac_min * 100:.1f}%) with all "
                    "slots busy",
                )
        if (self._pool_eta is not None and self._free <= 0
                and cfg.pool_eta_shed_s > 0):
            # growth FORECAST (engine/introspect.py): the pool may still
            # be above the free floor, but at the current allocation rate
            # it runs dry inside the horizon — shed now, while the
            # Retry-After still means something (all-slots-busy guarded
            # like the floor check: with idle slots, retirements free
            # blocks faster than the trend says)
            eta = self._pool_eta()
            if eta is not None and eta < cfg.pool_eta_shed_s:
                self._reject(
                    KIND_POOL, cfg.shed_retry_after_s,
                    f"paged KV pool projected dry in {eta:.1f}s "
                    f"(< {cfg.pool_eta_shed_s:g}s horizon) with all "
                    "slots busy",
                )

    def _charge_budget(self, tenant: str, cost_tokens: float) -> None:
        bucket = self._buckets.get(tenant)
        if bucket is not None and not bucket.take(cost_tokens):
            eta = bucket.eta_s(cost_tokens)
            self._reject(
                KIND_RATE,
                self.config.retry_after_s if math.isinf(eta) else eta,
                f"tenant {tenant!r} token budget exhausted "
                f"({cost_tokens:g} tokens asked)",
            )

    def _unqueue(self, tenant: str) -> None:
        """Remove one waiter from the queue-bound counters."""
        self._queued_total = max(0, self._queued_total - 1)
        left = self._queued_by_tenant.get(tenant, 1) - 1
        if left <= 0:
            self._queued_by_tenant.pop(tenant, None)
        else:
            self._queued_by_tenant[tenant] = left
        _G_QUEUED.set(self._queued_total)

    def _refund_budget(self, tenant: str, cost: float) -> None:
        bucket = self._buckets.get(tenant)
        if bucket is not None:
            bucket.refund(cost)

    async def acquire(self, tenant: str = "default",
                      cost_tokens: float = 1.0,
                      migration: bool = False) -> AdmissionTicket:
        """Admit one generation (await a slot if saturated) or raise a
        typed AdmissionReject. ``cost_tokens`` is the request's token ask
        (max_new_tokens) — the unit budgets and WDRR fairness run in.
        ``migration`` marks a KV import (meshnet/migrate.py): it is not
        new demand but state being EVACUATED, so the SLO shed does not
        apply — draining, queue and pool bounds still do."""
        tenant = str(tenant or "default")
        cost = max(float(cost_tokens), 1.0)
        self._check_shed(migration=migration)
        if self._free > 0 and self._queued_total == 0:
            self._charge_budget(tenant, cost)
            self._free -= 1
            _C_REQUESTS.inc(outcome="admitted", kind="ok")
            _G_INFLIGHT.set(self.inflight)
            return AdmissionTicket(self, tenant)
        # saturated: queue under WDRR, bounded per tenant and node-wide.
        # Capacity rejections come BEFORE the budget charge — a request
        # the queue bounds turn away must not spend its tenant's tokens.
        cfg = self.config
        if self._queued_by_tenant.get(tenant, 0) >= cfg.tenant_queue:
            self._reject(
                KIND_TENANT_QUEUE, cfg.retry_after_s,
                f"tenant {tenant!r} already has {cfg.tenant_queue} "
                "requests waiting",
            )
        if self._queued_total >= cfg.max_queue:
            self._reject(
                KIND_QUEUE, cfg.retry_after_s,
                f"admission queue full ({cfg.max_queue} waiting)",
            )
        self._charge_budget(tenant, cost)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        w = _Waiter(fut, tenant, cost)
        self._waiters.append(w, tenant=tenant, cost=cost)
        self._queued_total += 1
        self._queued_by_tenant[tenant] = self._queued_by_tenant.get(tenant, 0) + 1
        _G_QUEUED.set(self._queued_total)
        try:
            await self._clock.wait_for(fut, cfg.queue_timeout_s)
        except asyncio.TimeoutError:
            # the abandoning side owns the bookkeeping: counts come off
            # NOW (a stalled node must not reject new arrivals against a
            # queue of dead waiters) and the charged budget is refunded
            # (the work never ran). _dispatch skips the cancelled record
            # when it eventually pops it.
            w.abandoned = True
            self._unqueue(tenant)
            self._refund_budget(tenant, cost)
            self._reject(
                KIND_TIMEOUT, cfg.retry_after_s,
                f"no execution slot freed within {cfg.queue_timeout_s:g}s",
            )
        except asyncio.CancelledError:
            w.abandoned = True
            if fut.done() and not fut.cancelled():
                # granted between the caller's cancellation and this frame
                # resuming: _dispatch already uncounted it and took the
                # slot — hand the slot straight back, and refund the
                # budget like every other work-never-ran path (cancel
                # storms must not convert into a rate-limit lockout)
                self._refund_budget(tenant, cost)
                self._release()
            else:
                self._unqueue(tenant)
                self._refund_budget(tenant, cost)
            raise
        _C_REQUESTS.inc(outcome="admitted", kind="ok")
        return AdmissionTicket(self, tenant)

    # ------------------------------------------------------------- release

    def _release(self) -> None:
        self._free += 1
        self._dispatch()
        _G_INFLIGHT.set(self.inflight)

    def _dispatch(self) -> None:
        """Hand freed slots to waiters in WDRR order, skipping abandoned
        (timed-out / cancelled) records — their counters were already
        removed by the abandoning acquire."""
        while self._free > 0 and self._waiters:
            w = self._waiters.popleft()
            if w.fut.cancelled() or w.abandoned:
                # popping charged the tenant's WDRR deficit for work that
                # never ran — give it back, or timeouts concentrated on
                # one tenant would push its share below its weight
                self._waiters.refund(w.tenant, w.cost)
                continue
            self._unqueue(w.tenant)
            self._free -= 1
            w.fut.set_result(None)
        _G_INFLIGHT.set(self.inflight)
