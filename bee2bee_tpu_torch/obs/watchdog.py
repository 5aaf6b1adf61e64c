"""Trend watchdog: EWMA baseline + change-point detection over a TsRing.

Dependency-free detection of the two degradation shapes that matter
operationally, per curated series (obs/tsring.py):

- **slope**: the trailing window's least-squares slope, normalized to
  "fraction of the level per minute", exceeds the series threshold in
  its bad direction — a sinking peer caught while it is still sinking;
- **level_shift**: the trailing window's mean has departed the EWMA
  baseline by both a sigma multiple AND a relative fraction — a step
  change (acceptance collapse, queue cliff) too abrupt to read as slope.

The EWMA baseline/variance is **lagged**: it absorbs only samples old
enough to have left the detection window, so the anomaly being detected
cannot contaminate the baseline it is judged against.

A confirmed anomaly emits a typed ``trend:<series>`` incident into the
FlightRecorder (health.py) with the offending window attached, under a
per-series cooldown on the injected clock — deterministic in simnet
virtual time, which is what makes the seeded-collapse regression test
(tests/test_obs.py) able to pin the firing tick across same-seed runs.

PyTorch port: a copy of ``bee2bee_tpu/obs/watchdog.py`` with the import root rewritten to
``bee2bee_tpu_torch``.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, replace
from typing import Mapping

from ..clock import Clock, resolve_clock
from .tsring import DEFAULT_SCALE_FLOOR, SERIES_BY_NAME, TsRing

TREND_DIGEST_VERSION = 1


@dataclass(frozen=True)
class TrendPolicy:
    """Per-series detection thresholds (all per-series overridable).

    - ``slope_per_min``: relative slope (fraction of the level per
      minute) in the bad direction that counts as degradation.
    - ``level_sigma`` / ``level_frac``: a level shift must clear BOTH a
      baseline-sigma multiple and a relative fraction of the level —
      the sigma gate alone would alarm on any quiet series' first
      wiggle, the fraction gate alone on any noisy series forever.
    - ``window``: trailing samples examined for slope/window-mean.
    - ``min_baseline``: baseline samples absorbed before detection arms.
    - ``cooldown_s``: per-series incident spacing (on the clock seam;
      the recorder's own per-kind cooldown still applies underneath).
    """

    slope_per_min: float = 0.05
    level_sigma: float = 4.0
    level_frac: float = 0.25
    window: int = 12
    min_baseline: int = 6
    cooldown_s: float = 60.0
    ewma_alpha: float = 0.1


# series-tuned overrides on top of the dataclass defaults: acceptance
# and pool-occupancy move slowly by construction (cumulative-ish
# denominators), so their slope gates are tighter; RTT is jittery, so
# its level gate is looser.
DEFAULT_POLICIES: dict[str, TrendPolicy] = {
    "spec_acceptance": TrendPolicy(slope_per_min=0.03, level_frac=0.15),
    "pool_free_frac": TrendPolicy(slope_per_min=0.03),
    "peer_rtt_ms": TrendPolicy(level_sigma=6.0, level_frac=0.5),
}


class _SeriesState:
    __slots__ = ("ewma", "ewvar", "warm", "pending", "last_fire", "anom")

    def __init__(self, window: int):
        self.ewma: float | None = None
        self.ewvar = 0.0
        self.warm = 0
        # samples younger than the detection window, oldest first; they
        # graduate into the EWMA baseline as newer samples arrive
        self.pending: deque[tuple[float, float]] = deque(maxlen=window + 1)
        self.last_fire: float | None = None
        self.anom: dict | None = None


def _slope_per_s(points: list[tuple[float, float]]) -> float:
    """Ordinary least-squares slope of value over time (per second)."""
    n = len(points)
    if n < 2:
        return 0.0
    mt = sum(t for t, _ in points) / n
    mv = sum(v for _, v in points) / n
    num = sum((t - mt) * (v - mv) for t, v in points)
    den = sum((t - mt) ** 2 for t, _ in points)
    return num / den if den > 0 else 0.0


class TrendWatchdog:
    """Observe a TsRing after each sample; fire typed trend incidents.

    ``recorder=None`` resolves the process-global FlightRecorder at fire
    time (the singleton contract health.py documents); tests inject
    their own. ``node_id`` stamps incidents with the owning peer."""

    def __init__(
        self,
        ring: TsRing,
        policies: Mapping[str, TrendPolicy] | None = None,
        recorder=None,
        node_id: str | None = None,
        clock: Clock | None = None,
    ):
        self.ring = ring
        self.recorder = recorder
        self.node_id = node_id
        self._clock = resolve_clock(clock)
        base = dict(DEFAULT_POLICIES)
        if policies:
            base.update(policies)
        self.policies: dict[str, TrendPolicy] = {
            name: base.get(name, TrendPolicy()) for name in ring.series
        }
        self._state: dict[str, _SeriesState] = {
            name: _SeriesState(self.policies[name].window)
            for name in ring.series
        }

    def set_policy(self, name: str, **overrides) -> None:
        self.policies[name] = replace(self.policies[name], **overrides)

    # ------------------------------------------------------------ detection

    def observe(self) -> list[dict]:
        """Examine the ring's latest sample; returns the anomalies fired
        THIS call (already recorded as incidents). Call after append."""
        fired: list[dict] = []
        for name in self.ring.series:
            pts = self.ring.points(name)
            if not pts:
                continue
            st = self._state[name]
            pol = self.policies[name]
            last = pts[-1]
            if st.pending and st.pending[-1][0] >= last[0]:
                continue  # no new sample for this series (gap tick)
            st.pending.append(last)
            # graduate samples that aged out of the detection window
            while len(st.pending) > pol.window:
                _, old = st.pending.popleft()
                self._absorb(st, old, pol.ewma_alpha)
            anom = self._detect(name, st, pol)
            st.anom = anom
            if anom is not None and self._cooldown_ok(st, pol):
                st.last_fire = self._clock.time()
                self._fire(name, anom)
                fired.append(anom)
        return fired

    @staticmethod
    def _absorb(st: _SeriesState, v: float, alpha: float) -> None:
        if st.ewma is None:
            st.ewma, st.ewvar = v, 0.0
        else:
            d = v - st.ewma
            st.ewma += alpha * d
            st.ewvar = (1 - alpha) * (st.ewvar + alpha * d * d)
        st.warm += 1

    def _detect(self, name: str, st: _SeriesState, pol: TrendPolicy) -> dict | None:
        if st.ewma is None or st.warm < pol.min_baseline:
            return None
        if len(st.pending) < max(3, pol.window // 2):
            return None
        spec = SERIES_BY_NAME.get(name)
        up_bad = spec is None or spec.direction == "up_bad"
        floor = spec.scale_floor if spec is not None else DEFAULT_SCALE_FLOOR
        window = list(st.pending)
        mean = sum(v for _, v in window) / len(window)
        scale = max(abs(st.ewma), floor)
        sigma = math.sqrt(max(st.ewvar, 0.0))
        dev = mean - st.ewma
        bad_dev = dev if up_bad else -dev
        rel_slope = _slope_per_s(window) * 60.0 / scale
        bad_slope = rel_slope if up_bad else -rel_slope
        kind = None
        if bad_dev > pol.level_sigma * sigma and bad_dev >= pol.level_frac * scale:
            kind = "level_shift"
        elif bad_slope > pol.slope_per_min:
            kind = "slope"
        if kind is None:
            return None
        return {
            "series": name,
            "kind": kind,
            "baseline": round(st.ewma, 6),
            "baseline_sigma": round(sigma, 6),
            "window_mean": round(mean, 6),
            "slope_per_min": round(rel_slope, 6),
            "window": [[round(t, 3), round(v, 6)] for t, v in window],
        }

    def _cooldown_ok(self, st: _SeriesState, pol: TrendPolicy) -> bool:
        if st.last_fire is None:
            return True
        return self._clock.time() - st.last_fire >= pol.cooldown_s

    def _fire(self, name: str, anom: dict) -> None:
        rec = self.recorder
        if rec is None:
            from ..health import get_recorder  # late: singleton at fire time

            rec = get_recorder()
        try:
            rec.incident(
                "trend:" + name,
                detail=(
                    f"{anom['kind']}: window mean {anom['window_mean']} vs "
                    f"baseline {anom['baseline']} "
                    f"(slope {anom['slope_per_min']}/min)"
                ),
                node=self.node_id,
                extra=anom,
            )
        except Exception:  # noqa: BLE001 — telemetry never throws
            pass

    # ------------------------------------------------------------- digest

    def snapshot(self) -> dict[str, dict]:
        """The trend digest's ``series`` block: per-series window mean,
        relative slope (fraction of the level per minute, normalized by
        ``max(|window mean|, scale_floor)`` so receivers can recover an
        absolute slope), and the current anomaly flag."""
        out: dict[str, dict] = {}
        for name in self.ring.series:
            st = self._state[name]
            window = list(st.pending)
            if len(window) < 2:
                continue
            spec = SERIES_BY_NAME.get(name)
            floor = spec.scale_floor if spec is not None else DEFAULT_SCALE_FLOOR
            mean = sum(v for _, v in window) / len(window)
            rel = _slope_per_s(window) * 60.0 / max(abs(mean), floor)
            entry = {
                "mean": round(mean, 4),
                "slope": round(rel, 4),
                "n": len(window),
            }
            if st.anom is not None:
                entry["anom"] = 1
                entry["anom_kind"] = st.anom["kind"]
            out[name] = entry
        return out
