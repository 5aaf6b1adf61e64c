"""Retained time-series: the fleet observatory's storage primitive.

Every observability surface before this PR was point-in-time — /metrics
is cumulative, the health digest is the latest snapshot. The TsRing is
the missing primitive: a fixed-cadence, bounded ring of samples over a
curated series set, so degradation is a queryable *curve* (and a
detectable slope — obs/watchdog.py) rather than a scrape-time instant.

Contracts:

- **Clock seam**: the ring stamps samples from an injected `Clock`
  (clock.py), never wall time, so a simnet run in virtual time replays
  the retained history bit-identically across same-seed runs.
- **Bounded**: `capacity` samples, oldest evicted. At the default 5 s
  cadence, 720 samples retain one hour.
- **Delta encoding**: the wire/query form (`encode`) quantizes values to
  per-series fixed-point integers and ships first-value + deltas, so a
  1 h window stays a few KB of JSON. Quantization is integer-exact:
  `delta_decode(delta_encode(pts))` reproduces `round(v, precision)`
  with no float accumulation drift.
- **Absent-subsystem contract**: a collector returning None (no engine,
  no peers) stores a gap; gaps are skipped in points/encodes, matching
  the digest's "absent means not running, not zero" rule.

PyTorch port: a copy of ``bee2bee_tpu/obs/tsring.py`` with the import root rewritten to
``bee2bee_tpu_torch``; comments that cited the JAX package's change history or the
reference checkout's path are trimmed.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Iterable, Mapping

from ..clock import Clock, resolve_clock

# production sampling defaults: one sample per OBS_CADENCE_S, one hour
# retained. Overridable per-node via BEE2BEE_OBS_CADENCE_S (node.py).
OBS_CADENCE_S = 5.0
OBS_CAPACITY = 720


@dataclass(frozen=True)
class SeriesSpec:
    """One curated series: identity plus the rules every consumer needs.

    - ``agg``: how /mesh/history merges peers into a fleet curve —
      throughput series sum, level/fraction series average.
    - ``direction``: which way is degradation ("up_bad": rising queue
      wait is bad; "down_bad": falling acceptance is bad). The watchdog
      only alarms in the bad direction.
    - ``precision``: decimal places kept by the delta encoding.
    - ``scale_floor``: denominator floor when normalizing slopes to
      "fraction of the level per minute" — keeps a near-zero baseline
      from reading as an infinite relative slope.
    """

    name: str
    unit: str
    agg: str  # "sum" | "mean"
    direction: str  # "up_bad" | "down_bad"
    precision: int
    scale_floor: float


# The curated series set. Names are the wire vocabulary:
# /metrics/history keys, trend-digest keys, and `trend:<series>`
# incident kinds all use them verbatim, so they are append-only.
SERIES: tuple[SeriesSpec, ...] = (
    SeriesSpec("decode_tok_s", "tok/s", "sum", "down_bad", 2, 1.0),
    SeriesSpec("goodput_tok_s", "tok/s", "sum", "down_bad", 2, 1.0),
    SeriesSpec("mfu", "fraction", "mean", "down_bad", 4, 0.01),
    SeriesSpec("spec_acceptance", "fraction", "mean", "down_bad", 4, 0.05),
    SeriesSpec("queue_wait_p95_ms", "ms", "mean", "up_bad", 2, 1.0),
    SeriesSpec("pool_free_frac", "fraction", "mean", "down_bad", 4, 0.05),
    SeriesSpec("pipeline_bubble", "fraction", "mean", "up_bad", 4, 0.05),
    SeriesSpec("slo_burn_fast", "ratio", "mean", "up_bad", 3, 0.1),
    SeriesSpec("peer_rtt_ms", "ms", "mean", "up_bad", 2, 1.0),
)
SERIES_BY_NAME: dict[str, SeriesSpec] = {s.name: s for s in SERIES}
SERIES_NAMES: tuple[str, ...] = tuple(s.name for s in SERIES)

# shared slope-normalization floor for series NOT in the catalog (unit
# digests over ad-hoc series); catalog series carry their own.
DEFAULT_SCALE_FLOOR = 1.0


def _precision(name: str) -> int:
    spec = SERIES_BY_NAME.get(name)
    return spec.precision if spec is not None else 4


def delta_encode(points: list[tuple[float, float]], precision: int = 4) -> dict:
    """Quantize ``[(ts, value), ...]`` to fixed-point and delta-encode.

    Timestamps quantize to milliseconds, values to ``precision`` decimal
    places; both ship as first-value + integer deltas so a steady series
    costs ~2 digits per sample instead of a float per sample."""
    if not points:
        return {"n": 0, "p": precision}
    vq = 10 ** precision
    ts_q = [int(round(t * 1000.0)) for t, _ in points]
    vs_q = [int(round(v * vq)) for _, v in points]
    return {
        "n": len(points),
        "p": precision,
        "t0": ts_q[0],
        "td": [b - a for a, b in zip(ts_q, ts_q[1:])],
        "v0": vs_q[0],
        "vd": [b - a for a, b in zip(vs_q, vs_q[1:])],
    }


def delta_decode(enc: Mapping) -> list[tuple[float, float]]:
    """Inverse of `delta_encode`: integer-exact up to the quantization."""
    n = int(enc.get("n") or 0)
    if n == 0:
        return []
    vq = 10 ** int(enc.get("p") or 0)
    t = int(enc["t0"])
    v = int(enc["v0"])
    out = [(t / 1000.0, v / vq)]
    for dt, dv in zip(enc.get("td") or [], enc.get("vd") or []):
        t += int(dt)
        v += int(dv)
        out.append((t / 1000.0, v / vq))
    return out


class TsRing:
    """Fixed-cadence bounded ring of snapshots over a fixed series set.

    Columnar: one shared timestamp ring plus one value ring per series
    (None marks a gap). Thread-safe — sampled on the node's loop but
    read from API handlers and the bench harness's timing threads."""

    def __init__(
        self,
        series: Iterable[str] = SERIES_NAMES,
        cadence_s: float = OBS_CADENCE_S,
        capacity: int = OBS_CAPACITY,
        clock: Clock | None = None,
    ):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.cadence_s = float(cadence_s)
        self.capacity = int(capacity)
        self._clock = resolve_clock(clock)
        self._lock = threading.Lock()
        self._ts: deque[float] = deque(maxlen=self.capacity)
        self._cols: dict[str, deque] = {
            str(name): deque(maxlen=self.capacity) for name in series
        }
        if not self._cols:
            raise ValueError("TsRing needs at least one series")

    @property
    def series(self) -> tuple[str, ...]:
        return tuple(self._cols)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ts)

    def append(self, values: Mapping[str, float | None], ts: float | None = None) -> float:
        """Record one snapshot (missing/unknown series store a gap).
        Returns the stamp used — the injected clock's now by default."""
        stamp = self._clock.time() if ts is None else float(ts)
        with self._lock:
            self._ts.append(stamp)
            for name, col in self._cols.items():
                v = values.get(name)
                col.append(float(v) if v is not None else None)
        return stamp

    def points(
        self, name: str, window_s: float | None = None
    ) -> list[tuple[float, float]]:
        """``[(ts, value), ...]`` for one series, gaps skipped, optionally
        restricted to the trailing ``window_s`` of retained time."""
        col = self._cols.get(name)
        if col is None:
            return []
        with self._lock:
            ts = list(self._ts)
            vs = list(col)
        if window_s is not None and ts:
            cutoff = ts[-1] - float(window_s)
            out = [(t, v) for t, v in zip(ts, vs) if v is not None and t >= cutoff]
        else:
            out = [(t, v) for t, v in zip(ts, vs) if v is not None]
        return out

    def window(
        self,
        names: Iterable[str] | None = None,
        window_s: float | None = None,
    ) -> dict[str, list[tuple[float, float]]]:
        return {
            name: self.points(name, window_s)
            for name in (names if names is not None else self._cols)
            if name in self._cols
        }

    def encode(
        self,
        names: Iterable[str] | None = None,
        window_s: float | None = None,
    ) -> dict[str, dict]:
        """The compact query/wire form: per-series delta encodings."""
        return {
            name: delta_encode(pts, _precision(name))
            for name, pts in self.window(names, window_s).items()
        }
