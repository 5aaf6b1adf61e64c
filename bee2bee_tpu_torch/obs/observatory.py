"""The node-facing observatory: collectors + sampling loop + trend digest.

One `Observatory` per node ties the pieces together: a curated set of
**collectors** (callables returning the current value of one series, or
None for "subsystem not running") feeds a `TsRing` on a fixed cadence
driven by the node's injected clock, a `TrendWatchdog` examines every
sample, and the resulting trend digest rides the TELEMETRY gossip so
the router's degrading penalty and the fleet controller's pool forecast
can act on *slopes*, not just instants.

Collectors are injectable (`set_collector`) — the simnet regression
test scripts a deterministic acceptance collapse as a pure function of
virtual time; production nodes use the registry-backed defaults below.

PyTorch port: a copy of ``bee2bee_tpu/obs/observatory.py`` with the import root rewritten to
``bee2bee_tpu_torch``.
"""

from __future__ import annotations

import statistics
from typing import Callable, Mapping

from ..clock import Clock, resolve_clock
from ..metrics import Counter, Gauge, Histogram, MetricsRegistry, get_registry
from .tsring import OBS_CADENCE_S, OBS_CAPACITY, SERIES_NAMES, TsRing
from .watchdog import TREND_DIGEST_VERSION, TrendPolicy, TrendWatchdog

Collector = Callable[[], "float | None"]

_REG = get_registry()
_C_SAMPLES = _REG.counter(
    "obs.samples", "observatory ring samples taken"
)
_C_ANOMALIES = _REG.counter(
    "obs.anomalies", "trend-watchdog anomalies fired (by series)"
)
_G_RING_POINTS = _REG.gauge(
    "obs.ring_points", "samples currently retained in the observatory ring"
)


def _gauge_mean(reg: MetricsRegistry, name: str) -> float | None:
    m = reg.get(name)
    if not isinstance(m, Gauge):
        return None
    series = m.series()
    if not series:
        return None
    return statistics.fmean(v for _, v in series)


def _gauge_max(reg: MetricsRegistry, name: str) -> float | None:
    m = reg.get(name)
    if not isinstance(m, Gauge):
        return None
    series = m.series()
    if not series:
        return None
    return max(v for _, v in series)


def _hist_p95(reg: MetricsRegistry, name: str) -> float | None:
    m = reg.get(name)
    if not isinstance(m, Histogram):
        return None
    count, _ = m.totals()
    if count == 0:
        return None
    return m.percentile(0.95)


def _pool_free_frac(reg: MetricsRegistry) -> float | None:
    total = reg.get("engine.paged_blocks_total")
    free = reg.get("engine.paged_blocks_free")
    if not isinstance(total, Gauge) or not isinstance(free, Gauge):
        return None
    if not total.series():
        return None
    t = total.value()
    if t <= 0:
        return None
    return min(max(free.value() / t, 0.0), 1.0)


class _CounterRate:
    """Per-interval rate of a cumulative counter (None until the second
    sample, and across a registry reset's backwards jump)."""

    def __init__(self, reg: MetricsRegistry, name: str, clock: Clock):
        self._reg, self._name, self._clock = reg, name, clock
        self._last: tuple[float, float] | None = None

    def __call__(self) -> float | None:
        m = self._reg.get(self._name)
        if not isinstance(m, Counter):
            return None
        now, cur = self._clock.time(), m.total()
        last, self._last = self._last, (now, cur)
        if last is None:
            return None
        dt, dv = now - last[0], cur - last[1]
        if dt <= 0 or dv < 0:
            return None
        return dv / dt


class _AcceptanceRate:
    """Per-interval spec acceptance: accepted-delta / drafted-delta —
    the *current* acceptance, unlike the digest's cumulative ratio whose
    inertia hides a mid-run collapse (exactly what the watchdog hunts)."""

    def __init__(self, reg: MetricsRegistry):
        self._reg = reg
        self._last: tuple[float, float] | None = None

    def __call__(self) -> float | None:
        acc = self._reg.get("engine.spec_accepted")
        dra = self._reg.get("engine.spec_drafted")
        if not isinstance(acc, Counter) or not isinstance(dra, Counter):
            return None
        cur = (acc.total(), dra.total())
        last, self._last = self._last, cur
        if last is None:
            return None
        d_acc, d_dra = cur[0] - last[0], cur[1] - last[1]
        if d_dra <= 0 or d_acc < 0:
            return None
        return min(d_acc / d_dra, 1.0)


def default_collectors(
    node=None,
    registry: MetricsRegistry | None = None,
    clock: Clock | None = None,
) -> dict[str, Collector]:
    """Registry-backed collectors for the curated series set. Node-local
    signals (SLO burn, peer RTT) degrade to None without a node."""
    reg = registry or get_registry()
    ck = resolve_clock(clock)

    def slo_burn() -> float | None:
        if node is not None:
            try:
                return float(node.slo.max_fast_burn())
            except Exception:  # noqa: BLE001 — telemetry never throws
                return None
        return _gauge_max(reg, "slo.burn_rate")

    def peer_rtt() -> float | None:
        if node is None:
            return None
        rtts = [
            info.get("rtt_ms")
            for info in list(node.peers.values())
            if info.get("rtt_ms") is not None
        ]
        return statistics.fmean(rtts) if rtts else None

    return {
        "decode_tok_s": _CounterRate(reg, "engine.tokens_generated", ck),
        "goodput_tok_s": lambda: _gauge_mean(reg, "engine.goodput_tokens_per_s"),
        "mfu": lambda: _gauge_mean(reg, "engine.mfu"),
        "spec_acceptance": _AcceptanceRate(reg),
        "queue_wait_p95_ms": lambda: _hist_p95(reg, "engine.queue_wait_ms"),
        "pool_free_frac": lambda: _pool_free_frac(reg),
        "pipeline_bubble": lambda: _gauge_mean(reg, "pipeline.bubble_fraction"),
        "slo_burn_fast": slo_burn,
        "peer_rtt_ms": peer_rtt,
    }


class Observatory:
    """TsRing + watchdog + collectors behind one sampling loop."""

    def __init__(
        self,
        node=None,
        clock: Clock | None = None,
        cadence_s: float = OBS_CADENCE_S,
        capacity: int = OBS_CAPACITY,
        collectors: Mapping[str, Collector] | None = None,
        policies: Mapping[str, TrendPolicy] | None = None,
        recorder=None,
        registry: MetricsRegistry | None = None,
    ):
        self.node = node
        self.clock = resolve_clock(
            clock if clock is not None else getattr(node, "clock", None)
        )
        self.cadence_s = float(cadence_s)
        self.ring = TsRing(
            SERIES_NAMES, cadence_s=self.cadence_s, capacity=capacity,
            clock=self.clock,
        )
        self.watchdog = TrendWatchdog(
            self.ring,
            policies=policies,
            recorder=recorder,
            node_id=getattr(node, "peer_id", None),
            clock=self.clock,
        )
        self.collectors: dict[str, Collector] = dict(
            collectors
            if collectors is not None
            else default_collectors(node, registry=registry, clock=self.clock)
        )

    def set_collector(self, name: str, fn: Collector) -> None:
        self.collectors[name] = fn

    # ----------------------------------------------------------- sampling

    def sample_once(self) -> dict[str, float | None]:
        """Collect every series (per-collector never-throw), append one
        ring snapshot, run the watchdog. Returns the collected values."""
        values: dict[str, float | None] = {}
        for name, fn in self.collectors.items():
            try:
                values[name] = fn()
            except Exception:  # noqa: BLE001 — telemetry never throws
                values[name] = None
        self.ring.append(values)
        _C_SAMPLES.inc()
        _G_RING_POINTS.set(float(len(self.ring)))
        for anom in self.watchdog.observe():
            _C_ANOMALIES.inc(series=anom["series"])
        return values

    async def run(self, stopped: Callable[[], bool]) -> None:
        """The sampling loop (spawned by P2PNode.start): one snapshot per
        cadence on the injected clock until ``stopped()``. Never-throw —
        a broken collector must not kill the node's task group."""
        while not stopped():
            await self.clock.sleep(self.cadence_s)
            if stopped():
                return
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 — telemetry never throws
                pass

    # ------------------------------------------------------------ queries

    def history(
        self,
        names=None,
        window_s: float | None = None,
        raw: bool = False,
    ) -> dict:
        """Per-series curves for /metrics/history: delta-encoded by
        default, ``raw=True`` for plain ``[[ts, v], ...]`` points."""
        if raw:
            return {
                name: [[t, v] for t, v in pts]
                for name, pts in self.ring.window(names, window_s).items()
            }
        return self.ring.encode(names, window_s)

    def trend_digest(self) -> dict | None:
        """The compact trend block riding the TELEMETRY digest, or None
        before the watchdog has two samples of anything (the
        absent-subsystem contract: no history, no key)."""
        series = self.watchdog.snapshot()
        if not series:
            return None
        return {
            "v": TREND_DIGEST_VERSION,
            "cadence_s": self.cadence_s,
            "series": series,
        }
