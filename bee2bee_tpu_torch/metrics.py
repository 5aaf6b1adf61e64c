"""Zero-dependency serving metrics: Counter / Gauge / Histogram + exposition.

The PyTorch port's own copy of the JAX package's registry
(``bee2bee_tpu/metrics.py``): the same classes, the same Prometheus text
exposition and the same dotted metric names, so a dashboard reads a CUDA
node exactly like a TPU node. The port imports nothing of the JAX
package, so it keeps this copy.

- ``Counter`` / ``Gauge`` / ``Histogram`` with optional labels; histograms
  use FIXED log-spaced buckets (no per-value allocation, bounded memory,
  mergeable across scrapes) and can estimate percentiles from the bucket
  counts.
- ``MetricsRegistry.render()`` emits Prometheus text exposition
  (``bee2bee_<name> …``); ``snapshot()`` is the JSON twin.
- One process-global registry via ``get_registry()``; creation is
  idempotent so modules can hold module-level handles.

Never-throw guarantee: the record paths (``inc``/``set``/``observe``)
swallow bad values — telemetry must not take down the serving path.
Metric NAMES are dotted literals ("engine.ttft_ms"), which keeps
label/series cardinality bounded.
"""

from __future__ import annotations

import math
import threading

# fixed log-spaced latency buckets (milliseconds): 1 ms .. ~65 s, factor 2.
# 17 buckets + the implicit +Inf — wide enough for queue-wait through
# whole-generation latencies, coarse enough to stay cheap per observe.
DEFAULT_BUCKETS_MS = tuple(float(2 ** i) for i in range(17))


def log_buckets(lo: float, hi: float, factor: float = 2.0) -> tuple:
    """Log-spaced bucket upper bounds covering [lo, hi]."""
    out = [float(lo)]
    while out[-1] < hi:
        out.append(out[-1] * factor)
    return tuple(out)


def _labels_key(labels: dict) -> tuple:
    # fast paths for the hot-path shapes (`inc()`, `inc(op=...)`): the
    # per-frame mesh counters pay this on every send/receive, and the
    # generator + sorted() pipeline below is several times the cost of
    # the whole inc() otherwise
    if not labels:
        return ()
    if len(labels) == 1:
        ((k, v),) = labels.items()
        return ((k if type(k) is str else str(k), v if type(v) is str else str(v)),)
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(key: tuple, extra: tuple = ()) -> str:
    pairs = list(extra) + list(key)
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Shared base: per-metric lock + labeled series table."""

    kind = "untyped"

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
        self._series: dict[tuple, object] = {}

    @property
    def prom_name(self) -> str:
        return "bee2bee_" + self.name.replace(".", "_").replace("-", "_")


class Counter(_Metric):
    kind = "counter"

    def inc(self, n: float = 1.0, **labels) -> None:
        try:
            n = float(n)
            if not math.isfinite(n):
                return
            key = _labels_key(labels)
            with self._lock:
                self._series[key] = float(self._series.get(key, 0.0)) + n
        except Exception:  # noqa: BLE001 — telemetry never throws
            pass

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_labels_key(labels), 0.0))

    def bind(self, **labels):
        """Pre-resolve one labeled series; returns `inc(n=1.0)` for it.
        The per-frame mesh counters call inc() for every frame on the
        wire with the same label values — binding once hoists the
        label-key construction out of the hot path (the moral equivalent
        of prometheus clients' `counter.labels(...).inc()`)."""
        key = _labels_key(labels)

        def _inc(n: float = 1.0) -> None:
            try:
                with self._lock:
                    self._series[key] = float(self._series.get(key, 0.0)) + n
            except Exception:  # noqa: BLE001 — telemetry never throws
                pass

        return _inc

    def total(self) -> float:
        """Sum across every labeled series (the digest-friendly scalar)."""
        with self._lock:
            return float(sum(self._series.values()))

    def series(self) -> list[tuple[tuple, float]]:
        """[(labels_key, value)] — labels_key is the sorted (k, v) tuple."""
        with self._lock:
            return sorted(self._series.items())

    def render(self) -> list[str]:
        # prometheus convention: counters expose as <name>_total
        base = self.prom_name + "_total"
        with self._lock:
            items = sorted(self._series.items())
        lines = [f"# HELP {base} {self.help}" if self.help else f"# HELP {base} {self.name}",
                 f"# TYPE {base} counter"]
        if not items:
            items = [((), 0.0)]
        lines += [f"{base}{_fmt_labels(k)} {_fmt_value(v)}" for k, v in items]
        return lines

    def snapshot(self) -> dict:
        with self._lock:
            items = sorted(self._series.items())
        return {
            "type": "counter",
            "series": [{"labels": dict(k), "value": v} for k, v in items],
        }


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        try:
            v = float(v)
            if not math.isfinite(v):
                return
            with self._lock:
                self._series[_labels_key(labels)] = v
        except Exception:  # noqa: BLE001 — telemetry never throws
            pass

    def add(self, n: float = 1.0, **labels) -> None:
        try:
            n = float(n)
            if not math.isfinite(n):
                return
            key = _labels_key(labels)
            with self._lock:
                self._series[key] = float(self._series.get(key, 0.0)) + n
        except Exception:  # noqa: BLE001 — telemetry never throws
            pass

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_labels_key(labels), 0.0))

    def series(self) -> list[tuple[tuple, float]]:
        """[(labels_key, value)] — labels_key is the sorted (k, v) tuple."""
        with self._lock:
            return sorted(self._series.items())

    def clear(self, **labels) -> None:
        """Drop a series so the exposition omits it: a gauge whose source
        has no current reading (e.g. an empty rolling-latency window) must
        disappear rather than serve its last stale value forever."""
        try:
            with self._lock:
                self._series.pop(_labels_key(labels), None)
        except Exception:  # noqa: BLE001 — telemetry never throws
            pass

    def render(self) -> list[str]:
        base = self.prom_name
        with self._lock:
            items = sorted(self._series.items())
        lines = [f"# HELP {base} {self.help}" if self.help else f"# HELP {base} {self.name}",
                 f"# TYPE {base} gauge"]
        # no synthetic 0 sample when nothing was ever set / all cleared:
        # unlike counters (0 is meaningful), a fabricated gauge reading
        # would be indistinguishable from a real measurement of 0
        lines += [f"{base}{_fmt_labels(k)} {_fmt_value(v)}" for k, v in items]
        return lines

    def snapshot(self) -> dict:
        with self._lock:
            items = sorted(self._series.items())
        return {
            "type": "gauge",
            "series": [{"labels": dict(k), "value": v} for k, v in items],
        }


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # + the +Inf bucket
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_: str = "", buckets: tuple | None = None):
        super().__init__(name, help_)
        bs = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS_MS)))
        if not bs:
            bs = DEFAULT_BUCKETS_MS
        self.buckets = bs

    def observe(self, v: float, **labels) -> None:
        try:
            v = float(v)
            if not math.isfinite(v):
                return
            key = _labels_key(labels)
            with self._lock:
                s = self._series.get(key)
                if s is None:
                    s = self._series[key] = _HistSeries(len(self.buckets))
                i = 0
                while i < len(self.buckets) and v > self.buckets[i]:
                    i += 1
                s.counts[i] += 1
                s.sum += v
                s.count += 1
        except Exception:  # noqa: BLE001 — telemetry never throws
            pass

    def percentile(self, q: float, **labels) -> float:
        """Bucket-resolution percentile estimate: the upper bound of the
        bucket where the cumulative count crosses q (the +Inf bucket
        reports the top finite bound — an estimate, clearly biased up to
        one bucket width, which log spacing keeps proportional)."""
        with self._lock:
            s = self._series.get(_labels_key(labels))
            if s is None or s.count == 0:
                return 0.0
            target = q * s.count
            cum = 0
            for i, c in enumerate(s.counts):
                cum += c
                if cum >= target:
                    return self.buckets[i] if i < len(self.buckets) else self.buckets[-1]
            return self.buckets[-1]

    def series_count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(_labels_key(labels))
            return s.count if s else 0

    def totals(self, **labels) -> tuple[int, float]:
        """(observation count, value sum) for one series."""
        with self._lock:
            s = self._series.get(_labels_key(labels))
            return (s.count, s.sum) if s else (0, 0.0)

    def count_le(self, v: float, **labels) -> int:
        """Observations that landed in buckets whose upper bound is <= v
        (bucket resolution: an off-bound v rounds DOWN to the nearest
        bound, so the answer never overcounts — what SLO good-event
        counting needs from a bucketed histogram)."""
        with self._lock:
            s = self._series.get(_labels_key(labels))
            if s is None:
                return 0
            cum = 0
            for i, b in enumerate(self.buckets):
                if b > v:
                    break
                cum += s.counts[i]
            else:
                if v == math.inf:
                    cum += s.counts[-1]
            return cum

    def render(self) -> list[str]:
        base = self.prom_name
        with self._lock:
            items = sorted(
                (k, list(s.counts), s.sum, s.count)
                for k, s in self._series.items()
            )
        lines = [f"# HELP {base} {self.help}" if self.help else f"# HELP {base} {self.name}",
                 f"# TYPE {base} histogram"]
        for key, counts, total, count in items:
            cum = 0
            for i, b in enumerate(list(self.buckets) + [math.inf]):
                cum += counts[i]
                lines.append(
                    f"{base}_bucket"
                    f"{_fmt_labels(key, (('le', _fmt_value(b)),))} {cum}"
                )
            lines.append(f"{base}_sum{_fmt_labels(key)} {_fmt_value(round(total, 6))}")
            lines.append(f"{base}_count{_fmt_labels(key)} {count}")
        return lines

    def snapshot(self, percentiles: tuple = (0.5, 0.95, 0.99)) -> dict:
        with self._lock:
            keys = list(self._series)
        series = []
        for key in keys:
            with self._lock:
                s = self._series.get(key)
                if s is None:
                    continue
                count, total = s.count, s.sum
            entry = {"labels": dict(key), "count": count, "sum": round(total, 6)}
            for q in percentiles:
                entry[f"p{int(q * 100)}"] = self.percentile(q, **dict(key))
            series.append(entry)
        return {"type": "histogram", "buckets": list(self.buckets), "series": series}


class MetricsRegistry:
    """Thread-safe named-metric table; creation is idempotent so modules
    hold module-level handles (`_H = get_registry().histogram("x.y")`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_make(self, cls, name: str, help_: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help_, **kw)
            elif not isinstance(m, cls):
                # a kind collision is a CODE bug, not a runtime hazard —
                # raise at registration so tests catch it immediately
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_make(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_make(Gauge, name, help_)

    def histogram(
        self, name: str, help_: str = "", buckets: tuple | None = None
    ) -> Histogram:
        return self._get_or_make(Histogram, name, help_, buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        """Registered metric by name WITHOUT creating it — readers (the
        health digest, SLO evaluation) must not materialize series for
        subsystems this process never imported."""
        with self._lock:
            return self._metrics.get(name)

    def render(self) -> str:
        """Prometheus text exposition (format 0.0.4) of every metric."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self, percentiles: tuple = (0.5, 0.95, 0.99)) -> dict:
        """JSON view: {dotted_name: {type, series, ...}}."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        out: dict[str, dict] = {}
        for m in metrics:
            if isinstance(m, Histogram):
                out[m.name] = m.snapshot(percentiles)
            else:
                out[m.name] = m.snapshot()
        return out

    def reset_all(self) -> None:
        """Zero every registered metric IN PLACE. Modules bind metric
        handles at import time (`_C = get_registry().counter(...)`), so
        swapping the registry object would leave those handles writing
        into the old one — the only way to get a clean slate (simnet
        needs one between same-seed replays so telemetry digests match
        bit-for-bit) is to clear the series tables the handles share."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            with m._lock:
                m._series.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
