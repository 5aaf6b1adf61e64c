"""Mesh health plane: telemetry digests, SLO burn-rate tracking, and an
incident flight recorder.

The metrics layer gave every node rich *local* instruments (metrics.py histograms,
tracing.py spans). This module turns them into the *operational* layer the
ROADMAP's front-door items consume:

- ``build_digest()`` folds the local metrics registry into a compact,
  wire-portable summary (histogram count/sum/percentiles, pool occupancy,
  batch fill, spec acceptance, per-stage task counters). Nodes gossip it
  on the ping cadence as a ``TELEMETRY`` frame (meshnet/node.py) and store
  peers' digests in a ``HealthStore`` with staleness stamps, so *every*
  node can serve the merged fleet view at ``GET /mesh/health``.
- ``SloTracker`` evaluates a declarative SLO config (``ttft_p95 < 2s``
  style latency objectives and error-rate objectives) against the local
  histograms with **multi-window burn rates** (fast + slow window, Google
  SRE style): burn rate = (bad fraction over the window) / error budget.
  Exposed as ``bee2bee_slo_*`` gauges and ``GET /slo`` — the signal the
  future SLO-aware router and admission controller route on.
- ``FlightRecorder`` keeps a bounded ring of recent span completions,
  frame-op events and metric deltas; typed failures (StageDead /
  StageTimeout, paged-pool exhaustion, gen_error, SLO burn trips) snapshot
  the ring plus the stitched trace of the offending request into an
  on-disk **incident bundle**, listable via ``GET /debug/incidents``.

Everything here honors the telemetry never-throw contract (metrics.py,
tracing.py): recording, gossiping and snapshotting must not take down the
serving path. Disk writes are best-effort; a full disk costs incident
bundles, never generations.

PyTorch port: a copy of ``bee2bee_tpu/health.py`` with the import root rewritten to
``bee2bee_tpu_torch``; comments that cited the JAX package's change history or the
reference checkout's path are trimmed.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

from .clock import Clock, get_clock, resolve_clock
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, get_registry
from .tracing import current_trace_ctx, get_tracer, stitch_trace
from .utils import bee2bee_home, load_json_source, new_id

logger = logging.getLogger("bee2bee_tpu_torch.health")

DIGEST_VERSION = 1

# the metric allowlist a digest summarizes. A digest is a WIRE payload
# repeated every ping interval to every peer: it must stay compact and
# schema-stable, so the contents are enumerated here instead of shipping
# the whole registry snapshot (which grows with every instrumented
# subsystem and with label cardinality).
DIGEST_HISTOGRAMS = (
    "engine.queue_wait_ms",
    "engine.ttft_ms",
    "engine.inter_token_ms",
    "engine.e2e_latency_ms",
    "service.execute_ms",
    # worker-side stage compute (engine/stage_runner.py, measured inside
    # the concurrency gate): its p50 feeds the coordinator's microbatch
    # auto-depth heuristic (resolve_microbatches)
    "pipeline.stage_task_ms",
)
DIGEST_GAUGES = (
    "engine.batch_fill",
    "engine.active_rows",
    "engine.paged_blocks_in_use",
    "engine.paged_blocks_free",
    "engine.paged_blocks_total",
)
DIGEST_COUNTERS = (
    "engine.tokens_generated",
    "engine.spec_drafted",
    "engine.spec_accepted",
    "gen.requests",
    "gen.errors",
    "mesh.relay_hops",
    "pipeline.recoveries",
    "pipeline.session_failovers",
)
# labeled counter whose per-label breakdown rides the digest (the MPMD
# bubble-fraction analysis needs per-stage task counts, not one total)
DIGEST_STAGE_TASKS = "pipeline.stage_tasks"

# ------------------------------------------------- pipeline bubble fraction
#
# The MPMD serving analogue of arxiv 2412.14374's bubble
# analysis. A stage worker's stage.task spans (meshnet/pipeline.py) record
# exactly when its compute was busy; everything else inside the
# observation window is bubble — the stage sat idle while its neighbors
# computed. Derived, never sampled: the gauges below are recomputed from
# the local tracer ring at digest-build/scrape time, and the same interval
# math serves stitched cross-node traces (bench + /trace consumers).

BUBBLE_WINDOW_S = 30.0

# stage.task spans that count as BUSY serving compute. part_load
# (checkpoint read + XLA compile) and part_release also run inside
# stage.task spans; counting a failover reload as "busy" would report
# ~zero bubble during exactly the incident when the pipeline is
# maximally stalled. Literal protocol task-kind values (health cannot
# import meshnet.pipeline — it imports health for the recorder).
_BUBBLE_TASK_KINDS = ("part_forward", "part_forward_relay", "decode_run")

_G_BUBBLE = get_registry().gauge(
    "pipeline.bubble_fraction",
    "fraction of the observation window this node's pipeline stages sat "
    "idle (1 - busy; from stage.task spans)",
)
_G_STAGE_BUSY = get_registry().gauge(
    "pipeline.stage_busy_fraction",
    "per-stage busy fraction over the observation window",
)


def _merge_busy_ms(intervals: list[tuple[float, float]]) -> float:
    """Total covered milliseconds of possibly-overlapping [a, b) spans —
    concurrent forwards on one stage must not double-count busy time."""
    busy = 0.0
    cur_a = cur_b = None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    return busy


def bubble_from_spans(
    spans: list[dict],
    window_start_ms: float | None = None,
    window_end_ms: float | None = None,
) -> dict | None:
    """Bubble fraction from ``stage.task`` span dicts (local tracer
    output OR a stitched cross-node timeline — spans may carry a ``node``
    key). Spans are clipped to the window (default: the spans' own
    extent); per-stage busy intervals merge before summing, so concurrent
    chains never count a stage >100% busy. Returns None when no completed
    stage.task span lands in the window.

    ``bubble_fraction`` is 1 - mean per-stage busy fraction: 0.0 means
    every stage computed wall-to-wall, 0.5 means the average stage sat
    idle half the window — the number the interleaved scheduler exists
    to drive toward zero."""
    stage_spans = []
    for s in spans or []:
        if s.get("name") != "stage.task":
            continue
        kind = (s.get("attrs") or {}).get("kind")
        if kind is not None and kind not in _BUBBLE_TASK_KINDS:
            continue  # loads/releases are stall time, not serving compute
        d = s.get("duration_ms")
        a = s.get("start_ms")
        if d is None or a is None or d < 0:
            continue  # open/malformed spans carry no busy interval
        stage_spans.append(s)
    if not stage_spans:
        return None
    if window_start_ms is None:
        window_start_ms = min(s["start_ms"] for s in stage_spans)
    if window_end_ms is None:
        window_end_ms = max(s["start_ms"] + s["duration_ms"]
                            for s in stage_spans)
    window_ms = window_end_ms - window_start_ms
    if window_ms <= 0:
        return None
    per: dict[str, list[tuple[float, float]]] = {}
    tasks: dict[str, int] = {}
    for s in stage_spans:
        a = max(s["start_ms"], window_start_ms)
        b = min(s["start_ms"] + s["duration_ms"], window_end_ms)
        if b <= a:
            continue
        stage = (s.get("attrs") or {}).get("stage")
        node = s.get("node")
        key = (f"{node}/" if node else "") + (
            str(stage) if stage is not None else "?"
        )
        per.setdefault(key, []).append((a, b))
        tasks[key] = tasks.get(key, 0) + 1
    if not per:
        return None
    stages = {
        key: {
            "busy_fraction": round(
                min(_merge_busy_ms(iv) / window_ms, 1.0), 4
            ),
            "tasks": tasks[key],
        }
        for key, iv in per.items()
    }
    mean_busy = sum(v["busy_fraction"] for v in stages.values()) / len(stages)
    return {
        "window_s": round(window_ms / 1000.0, 3),
        "bubble_fraction": round(max(0.0, 1.0 - mean_busy), 4),
        "stages": stages,
    }


def local_stage_idleness(
    window_s: float = BUBBLE_WINDOW_S, tracer=None
) -> dict | None:
    """This node's bubble fraction over the trailing ``window_s``,
    refreshed into the ``pipeline.bubble_fraction`` /
    ``pipeline.stage_busy_fraction{stage=}`` gauges. With no stage.task
    span in the window the gauges CLEAR (the empty-gauge contract: a
    stage that stopped serving drops out instead of freezing its last
    reading) and None is returned."""
    try:
        tr = tracer or get_tracer()
        now_ms = get_clock().time() * 1000.0
        info = bubble_from_spans(
            tr.recent(limit=2048, name="stage.task"),
            now_ms - window_s * 1000.0, now_ms,
        )
        if info is None:
            _G_BUBBLE.clear()
            for labels, _v in _G_STAGE_BUSY.series():
                _G_STAGE_BUSY.clear(**dict(labels))
            return None
        _G_BUBBLE.set(info["bubble_fraction"])
        fresh = set()
        for key, entry in info["stages"].items():
            _G_STAGE_BUSY.set(entry["busy_fraction"], stage=key)
            fresh.add((("stage", key),))
        for labels, _v in _G_STAGE_BUSY.series():
            if tuple(labels) not in fresh:
                _G_STAGE_BUSY.clear(**dict(labels))
        return info
    except Exception:  # noqa: BLE001 — telemetry never breaks the caller
        return None


# live-digest providers: subsystems that derive their digest entry at
# build time (refreshing their gauges as a side effect) register here —
# e.g. the engine economics plane (engine/introspect.py) contributes the
# `introspect` block. A dict, not a list: re-registration replaces, so
# module reloads/tests can't stack duplicates.
_DIGEST_PROVIDERS: dict[str, Callable[[], dict | None]] = {}


def register_digest_provider(key: str, fn: Callable[[], dict | None]) -> None:
    """Register a live-digest provider: ``fn()`` returns the payload for
    digest[key] (None = omit — the absent-subsystem contract)."""
    _DIGEST_PROVIDERS[key] = fn


def run_digest_providers() -> dict[str, dict]:
    """Every provider's current payload (never-throw per provider). Also
    the scrape-time gauge-refresh hook: api.py calls this at /metrics so
    provider-owned gauges (MFU, HBM ledger, pool forecast) are current."""
    out: dict[str, dict] = {}
    for key, fn in list(_DIGEST_PROVIDERS.items()):
        try:
            payload = fn()
        except Exception:  # noqa: BLE001 — telemetry never throws
            logger.exception("digest provider %r failed", key)
            continue
        if payload is not None:
            out[key] = payload
    return out


def build_digest(registry: MetricsRegistry | None = None) -> dict:
    """Fold the metrics registry into a compact wire-portable summary.

    Missing metrics (e.g. a client-only node that never imported the
    engine) are simply absent from the digest — receivers treat absent
    keys as "this node doesn't run that subsystem", not as zero.

    On the live path (no explicit registry) the digest also carries
    ``pipeline_bubble`` — this node's stage-idleness breakdown derived
    from its tracer's stage.task spans — so ``/mesh/health`` shows
    fleet-wide pipeline bubbles without another scrape. Unit digests
    built from throwaway registries stay pure registry summaries."""
    live = registry is None
    reg = registry or get_registry()
    digest: dict[str, Any] = {"v": DIGEST_VERSION, "ts": get_clock().time()}
    if live:
        bubble = local_stage_idleness()
        if bubble is not None:
            digest["pipeline_bubble"] = bubble
        # provider-derived entries (engine economics plane etc.): each
        # refreshes its own gauges and returns its digest block
        digest.update(run_digest_providers())
    hists: dict[str, dict] = {}
    for name in DIGEST_HISTOGRAMS:
        m = reg.get(name)
        if not isinstance(m, Histogram):
            continue
        count, total = m.totals()
        if count == 0:
            continue
        hists[name] = {
            "count": count,
            "sum": round(total, 3),
            "p50": m.percentile(0.5),
            "p95": m.percentile(0.95),
            "p99": m.percentile(0.99),
        }
    if hists:
        digest["hist"] = hists
    gauges: dict[str, float] = {}
    for name in DIGEST_GAUGES:
        m = reg.get(name)
        if isinstance(m, Gauge) and m.series():
            gauges[name] = m.value()
    if gauges:
        digest["gauge"] = gauges
    counters: dict[str, float] = {}
    for name in DIGEST_COUNTERS:
        m = reg.get(name)
        if isinstance(m, Counter):
            counters[name] = m.total()
    if counters:
        digest["counter"] = counters
    stage = reg.get(DIGEST_STAGE_TASKS)
    if isinstance(stage, Counter):
        by_kind = {
            ",".join(v for _, v in labels) or "_": value
            for labels, value in stage.series()
        }
        if by_kind:
            digest["stage_tasks"] = by_kind
    drafted = counters.get("engine.spec_drafted") or 0.0
    if drafted:
        digest["spec_acceptance"] = round(
            (counters.get("engine.spec_accepted") or 0.0) / drafted, 4
        )
    return digest


# --------------------------------------------------------------- health store


class HealthStore:
    """Per-peer telemetry digests with staleness stamps.

    A digest older than ``ttl_s`` is STALE: it stays readable (``all()``)
    for debugging but is excluded from ``fresh()`` — and therefore from
    ``/mesh/health`` aggregates and the peer-labeled exposition, matching
    the registry's empty-gauge contract (a reading that stopped arriving
    must drop out, not serve forever as if current)."""

    def __init__(self, ttl_s: float = 45.0, clock: Clock | None = None):
        self.ttl_s = ttl_s
        self._clock = resolve_clock(clock)
        self._lock = threading.Lock()
        self._digests: dict[str, dict] = {}  # peer_id -> digest
        self._received: dict[str, float] = {}  # peer_id -> local arrival time

    def update(self, peer_id: str, digest: dict) -> None:
        if not peer_id or not isinstance(digest, dict):
            return
        with self._lock:
            self._digests[peer_id] = digest
            self._received[peer_id] = self._clock.time()

    def drop(self, peer_id: str) -> None:
        with self._lock:
            self._digests.pop(peer_id, None)
            self._received.pop(peer_id, None)

    def age_s(self, peer_id: str) -> float | None:
        with self._lock:
            t = self._received.get(peer_id)
        return None if t is None else self._clock.time() - t

    def fresh(self) -> dict[str, dict]:
        """{peer_id: digest} for peers heard from within the TTL."""
        now = self._clock.time()
        with self._lock:
            return {
                pid: d
                for pid, d in self._digests.items()
                if now - self._received[pid] <= self.ttl_s
            }

    def all(self) -> dict[str, dict]:
        """Every stored digest annotated with age/staleness (debug view)."""
        now = self._clock.time()
        with self._lock:
            return {
                pid: {
                    **d,
                    "age_s": round(now - self._received[pid], 3),
                    "stale": now - self._received[pid] > self.ttl_s,
                }
                for pid, d in self._digests.items()
            }

    def stale_peers(self) -> list[str]:
        now = self._clock.time()
        with self._lock:
            return sorted(
                pid
                for pid in self._digests
                if now - self._received[pid] > self.ttl_s
            )


def digest_slo_burn(digest: dict | None) -> tuple[float, bool]:
    """(max fast-window burn rate, is_burning) from a digest's SLO brief.
    ``is_burning`` uses the same rule the router's exclusion does: any
    objective reporting burning/tripped status."""
    if not isinstance(digest, dict):
        return 0.0, False
    brief = digest.get("slo")
    if not isinstance(brief, dict):
        return 0.0, False
    burn = 0.0
    burning = False
    for e in brief.values():
        if not isinstance(e, dict):
            continue
        try:
            burn = max(burn, float(e.get("burn_fast") or 0.0))
        except (TypeError, ValueError):
            pass
        if e.get("status") in ("burning", "tripped"):
            burning = True
    return burn, burning


def controller_aggregates(
    digests: dict[str, dict], serving: set | None = None
) -> dict:
    """Controller-grade fleet aggregates (fleet/controller.py's input,
    also served under ``/mesh/health``'s ``aggregate.fleet``).

    Callers pass FRESH digests only (``HealthStore.fresh()`` + the local
    live digest) — a stale digest must drop out of these numbers before
    it can trigger a scale action, and freshness is the store's job, not
    re-derived here.

    Bucketing rules, which ARE the capacity semantics:

    - ``draining`` peers are leaving: excluded from the eligible count
      and from every headroom signal (their emptying batch would read as
      fake headroom exactly while the fleet is losing a replica);
    - ``standby`` / ``warming`` peers receive no routed traffic yet, so
      their (idle) signals say nothing about serving capacity — counted
      in their own buckets only;
    - with ``serving`` given, a peer must be in it to count as eligible
      (a client-only node gossips a digest too, but it is not a
      replica).

    Headroom/burn signals over the ELIGIBLE set only: ``burning`` /
    ``burn_fast_max`` from the SLO briefs, ``fill_mean`` (absent
    batch-fill gauges count as 0 — no engine, no pressure),
    ``queue_p95_max``, ``pool_free_min``, ``active_rows_total``.

    ``pool_eta_s`` is the pool-occupancy trend FORECAST: the
    soonest projected paged-pool exhaustion across eligible peers, read
    from their gossiped trend digests (obs/). A trend slope is relative
    — fraction of the level per minute, normalized by
    ``max(mean, scale_floor)`` (tsring.SeriesSpec; pool_free_frac's
    floor is 0.05, kept in lockstep by tests/test_obs.py) — so with the
    current level ``m`` and relative slope ``s < 0`` the absolute drain
    rate is ``s * max(m, 0.05)`` per minute and exhaustion lands in
    ``m / (-s * max(m, 0.05))`` minutes. None when no eligible peer
    reports a falling pool trend."""
    eligible: dict[str, dict] = {}
    draining: list[str] = []
    standby: list[str] = []
    warming: list[str] = []
    other: list[str] = []
    for pid, d in digests.items():
        if not isinstance(d, dict):
            continue
        if d.get("draining"):
            draining.append(pid)
            continue
        state = d.get("fleet_state")
        if state == "standby":
            standby.append(pid)
            continue
        if state == "warming":
            warming.append(pid)
            continue
        if serving is not None and pid not in serving:
            other.append(pid)
            continue
        eligible[pid] = d
    burning_ids: list[str] = []
    burn_max = 0.0
    fills: list[float] = []
    q95s: list[float] = []
    pool_fracs: list[float] = []
    pool_etas: list[tuple[float, str]] = []
    rows = 0.0
    for pid, d in eligible.items():
        burn, is_burning = digest_slo_burn(d)
        burn_max = max(burn_max, burn)
        if is_burning:
            burning_ids.append(pid)
        gauge = d.get("gauge") or {}
        fills.append(
            min(max(float(gauge.get("engine.batch_fill") or 0.0), 0.0), 1.0)
        )
        qw = (d.get("hist") or {}).get("engine.queue_wait_ms") or {}
        q95s.append(float(qw.get("p95") or 0.0))
        total = float(gauge.get("engine.paged_blocks_total") or 0.0)
        if total > 0:
            free = float(gauge.get("engine.paged_blocks_free") or 0.0)
            pool_fracs.append(min(max(free / total, 0.0), 1.0))
        rows += float(gauge.get("engine.active_rows") or 0.0)
        pf = ((d.get("trend") or {}).get("series") or {}).get(
            "pool_free_frac"
        ) or {}
        try:
            mean = float(pf["mean"])
            slope = float(pf["slope"])
        except (KeyError, TypeError, ValueError):
            mean = slope = 0.0
        if slope < -1e-4 and mean > 0:
            drain_per_min = -slope * max(mean, 0.05)  # tsring scale_floor
            pool_etas.append((round(60.0 * mean / drain_per_min, 1), pid))
    n = len(eligible)
    pool_eta = min(pool_etas) if pool_etas else None
    return {
        "nodes": len(digests),
        "eligible": n,
        "eligible_ids": sorted(eligible),
        "draining": sorted(draining),
        "standby": sorted(standby),
        "warming": sorted(warming),
        "other": sorted(other),
        "burning": len(burning_ids),
        "burning_ids": sorted(burning_ids),
        "burning_frac": round(len(burning_ids) / n, 4) if n else 0.0,
        "burn_fast_max": round(burn_max, 4),
        "fill_mean": round(sum(fills) / n, 4) if n else 0.0,
        "queue_p95_max": round(max(q95s), 3) if q95s else 0.0,
        "pool_free_min": round(min(pool_fracs), 4) if pool_fracs else None,
        "pool_eta_s": pool_eta[0] if pool_eta else None,
        "pool_eta_peer": pool_eta[1] if pool_eta else None,
        "active_rows_total": rows,
    }


def fleet_view(local_peer_id: str, local_digest: dict, store: HealthStore,
               serving: set | None = None) -> dict:
    """The merged ``/mesh/health`` payload: the local node's digest plus
    every FRESH peer digest, with fleet-level aggregates. Stale peers are
    listed by id but contribute nothing to the aggregates. ``serving``
    (the controller's replica universe — api.py passes
    ``node.fleet.serving_peers()``) scopes the ``fleet`` aggregate block
    to actual replicas, so the endpoint shows the exact numbers a scale
    decision reads; without it every gossiping node counts as eligible."""
    peers: dict[str, dict] = {local_peer_id: {**local_digest, "age_s": 0.0}}
    for pid, digest in store.fresh().items():
        age = store.age_s(pid)
        peers[pid] = {**digest, "age_s": round(age, 3) if age is not None else None}
    agg: dict[str, float] = {"nodes": len(peers)}
    p95s, queue_p95s, tokens, blocks, rows = [], [], 0.0, 0.0, 0.0
    bubbles = []
    goodputs, mfus, headrooms, storming = [], [], [], []
    for pid, d in peers.items():
        hist = d.get("hist") or {}
        ttft = hist.get("engine.ttft_ms")
        if ttft:
            p95s.append(float(ttft.get("p95") or 0.0))
        qw = hist.get("engine.queue_wait_ms")
        if qw:
            queue_p95s.append(float(qw.get("p95") or 0.0))
        counter = d.get("counter") or {}
        tokens += float(counter.get("engine.tokens_generated") or 0.0)
        gauge = d.get("gauge") or {}
        blocks += float(gauge.get("engine.paged_blocks_in_use") or 0.0)
        rows += float(gauge.get("engine.active_rows") or 0.0)
        bubble = (d.get("pipeline_bubble") or {}).get("bubble_fraction")
        if bubble is not None:
            bubbles.append(float(bubble))
        # engine economics (digest `introspect` block): fleet goodput is
        # the SUM across engine peers; MFU averages over reporters; HBM
        # headroom keeps the worst peer — the one a router/controller
        # must notice — and retrace-storming peers are listed by id
        intro = d.get("introspect") or {}
        if intro.get("goodput_tokens_per_s") is not None:
            goodputs.append(float(intro["goodput_tokens_per_s"]))
        if intro.get("mfu") is not None:
            mfus.append(float(intro["mfu"]))
        hr = (intro.get("hbm") or {}).get("headroom_frac")
        if hr is not None:
            headrooms.append((float(hr), pid))
        if intro.get("storming"):
            storming.append(pid)
    if p95s:
        agg["ttft_p95_ms_max"] = max(p95s)
    if queue_p95s:
        agg["queue_wait_p95_ms_max"] = max(queue_p95s)
    if bubbles:
        # fleet-wide stage idleness: the mean of the stage-hosting peers'
        # bubble fractions (nodes with no stage traffic report nothing)
        agg["bubble_fraction_mean"] = round(sum(bubbles) / len(bubbles), 4)
    if goodputs:
        agg["goodput_tokens_per_s_total"] = round(sum(goodputs), 3)
    if mfus:
        agg["mfu_mean"] = round(sum(mfus) / len(mfus), 6)
    if headrooms:
        worst = min(headrooms)
        agg["hbm_headroom_frac_min"] = worst[0]
        agg["hbm_headroom_min_peer"] = worst[1]
    if storming:
        agg["retrace_storming_peers"] = sorted(storming)
    agg["tokens_generated_total"] = tokens
    agg["paged_blocks_in_use_total"] = blocks
    agg["active_rows_total"] = rows
    # the controller-grade breakdown (fleet/controller.py consumes the
    # same function over the same fresh digests): /mesh/health shows the
    # exact numbers a scale decision would read
    agg["fleet"] = controller_aggregates(peers, serving=serving)
    return {
        "node": local_peer_id,
        "ttl_s": store.ttl_s,
        "peers": peers,
        "stale_peers": store.stale_peers(),
        "aggregate": agg,
    }


def render_fleet_prom(view: dict) -> str:
    """Prometheus text exposition of a fleet view, one series per FRESH
    peer under a ``peer`` label. Built from a throwaway registry each
    scrape, so a peer absent from the view simply has no series — the
    drop-out contract for stale peers comes for free."""
    reg = MetricsRegistry()
    up = reg.gauge("mesh.peer_up", "1 for every fresh peer digest in the view")
    age = reg.gauge("mesh.peer_digest_age_s", "digest age at scrape")
    ttft = reg.gauge("mesh.peer_ttft_p95_ms", "peer-reported TTFT p95")
    qwait = reg.gauge("mesh.peer_queue_wait_p95_ms", "peer-reported queue-wait p95")
    e2e = reg.gauge("mesh.peer_e2e_p95_ms", "peer-reported e2e latency p95")
    fill = reg.gauge("mesh.peer_batch_fill", "peer-reported batch fill")
    rows = reg.gauge("mesh.peer_active_rows", "peer-reported active rows")
    used = reg.gauge("mesh.peer_paged_blocks_in_use", "peer-reported pool blocks used")
    free = reg.gauge("mesh.peer_paged_blocks_free", "peer-reported pool blocks free")
    toks = reg.gauge("mesh.peer_tokens_generated", "peer-reported tokens generated")
    errs = reg.gauge("mesh.peer_gen_errors", "peer-reported failed generations")
    acc = reg.gauge("mesh.peer_spec_acceptance", "peer-reported spec acceptance")
    bub = reg.gauge(
        "mesh.peer_bubble_fraction", "peer-reported pipeline bubble fraction"
    )
    # engine economics: the digest `introspect` block's
    # fleet-visible numbers under the same peer-labeled drop-out contract
    mfu = reg.gauge("mesh.peer_mfu", "peer-reported engine MFU")
    gput = reg.gauge(
        "mesh.peer_goodput_tokens_per_s", "peer-reported useful tokens/s"
    )
    hbm = reg.gauge(
        "mesh.peer_hbm_headroom_frac", "peer-reported device memory headroom"
    )
    storm = reg.gauge(
        "mesh.peer_retrace_storming",
        "1 while the peer reports a recent retrace storm",
    )
    for pid, d in (view.get("peers") or {}).items():
        up.set(1, peer=pid)
        if d.get("age_s") is not None:
            age.set(d["age_s"], peer=pid)
        hist = d.get("hist") or {}
        if "engine.ttft_ms" in hist:
            ttft.set(hist["engine.ttft_ms"].get("p95") or 0.0, peer=pid)
        if "engine.queue_wait_ms" in hist:
            qwait.set(hist["engine.queue_wait_ms"].get("p95") or 0.0, peer=pid)
        if "engine.e2e_latency_ms" in hist:
            e2e.set(hist["engine.e2e_latency_ms"].get("p95") or 0.0, peer=pid)
        gauge = d.get("gauge") or {}
        if "engine.batch_fill" in gauge:
            fill.set(gauge["engine.batch_fill"], peer=pid)
        if "engine.active_rows" in gauge:
            rows.set(gauge["engine.active_rows"], peer=pid)
        if "engine.paged_blocks_in_use" in gauge:
            used.set(gauge["engine.paged_blocks_in_use"], peer=pid)
        if "engine.paged_blocks_free" in gauge:
            free.set(gauge["engine.paged_blocks_free"], peer=pid)
        counter = d.get("counter") or {}
        if "engine.tokens_generated" in counter:
            toks.set(counter["engine.tokens_generated"], peer=pid)
        if "gen.errors" in counter:
            errs.set(counter["gen.errors"], peer=pid)
        if d.get("spec_acceptance") is not None:
            acc.set(d["spec_acceptance"], peer=pid)
        bubble = d.get("pipeline_bubble") or {}
        if bubble.get("bubble_fraction") is not None:
            bub.set(bubble["bubble_fraction"], peer=pid)
        intro = d.get("introspect") or {}
        if intro.get("mfu") is not None:
            mfu.set(intro["mfu"], peer=pid)
        if intro.get("goodput_tokens_per_s") is not None:
            gput.set(intro["goodput_tokens_per_s"], peer=pid)
        headroom = (intro.get("hbm") or {}).get("headroom_frac")
        if headroom is not None:
            hbm.set(headroom, peer=pid)
        if intro.get("storming"):
            storm.set(1, peer=pid)
    return reg.render()


# ------------------------------------------------------------- SLO tracking


@dataclass(frozen=True)
class SloObjective:
    """One declarative objective.

    kind="latency": good events are observations of histogram ``metric``
    at or under ``threshold_ms`` (the threshold should sit on a bucket
    bound — the default buckets are powers of two ms — since bucketed
    counts can only split at bounds; an off-bound threshold is rounded
    DOWN to the nearest bound, the conservative direction).

    kind="error_rate": good events are ``total_metric`` counts minus
    ``errors_metric`` counts (both counters).

    ``target`` is the availability goal, e.g. 0.95 ⇒ a 5% error budget.
    """

    name: str
    kind: str  # "latency" | "error_rate"
    target: float
    metric: str = ""  # latency: histogram name
    threshold_ms: float = 0.0  # latency only
    errors_metric: str = ""  # error_rate: counters
    total_metric: str = ""

    @property
    def budget(self) -> float:
        return max(1.0 - self.target, 1e-9)

    def describe(self) -> dict:
        out = {"name": self.name, "kind": self.kind, "target": self.target}
        if self.kind == "latency":
            out["metric"] = self.metric
            out["threshold_ms"] = self.threshold_ms
        else:
            out["errors_metric"] = self.errors_metric
            out["total_metric"] = self.total_metric
        return out


DEFAULT_SLO_CONFIG: tuple[dict, ...] = (
    {"name": "ttft_p95", "kind": "latency", "metric": "engine.ttft_ms",
     "threshold_ms": 2048.0, "target": 0.95},
    {"name": "queue_wait_p99", "kind": "latency",
     "metric": "engine.queue_wait_ms", "threshold_ms": 4096.0, "target": 0.99},
    {"name": "gen_error_rate", "kind": "error_rate",
     "errors_metric": "gen.errors", "total_metric": "gen.requests",
     "target": 0.99},
)


def parse_slo_config(entries) -> list[SloObjective]:
    """Validate a list of objective dicts; raises ValueError on junk (a
    mis-typed SLO config must fail loudly at boot, not route on garbage)."""
    out: list[SloObjective] = []
    seen_names: set[str] = set()
    for e in entries:
        if not isinstance(e, dict) or not e.get("name"):
            raise ValueError(f"SLO entry needs a name: {e!r}")
        name = str(e["name"])
        # SloTracker keys its snapshot deques by name: two objectives
        # sharing one would interleave unrelated cumulative counts and
        # burn-rate on garbage
        if name in seen_names:
            raise ValueError(f"duplicate SLO objective name {name!r}")
        seen_names.add(name)
        kind = e.get("kind")
        target = float(e.get("target", 0.0))
        if not 0.0 < target < 1.0:
            raise ValueError(f"SLO {e['name']!r}: target must be in (0, 1)")
        if kind == "latency":
            if not e.get("metric") or float(e.get("threshold_ms", 0)) <= 0:
                raise ValueError(
                    f"SLO {e['name']!r}: latency kind needs metric + threshold_ms"
                )
            out.append(SloObjective(
                name=str(e["name"]), kind="latency", target=target,
                metric=str(e["metric"]), threshold_ms=float(e["threshold_ms"]),
            ))
        elif kind == "error_rate":
            if not e.get("errors_metric") or not e.get("total_metric"):
                raise ValueError(
                    f"SLO {e['name']!r}: error_rate kind needs "
                    "errors_metric + total_metric"
                )
            out.append(SloObjective(
                name=str(e["name"]), kind="error_rate", target=target,
                errors_metric=str(e["errors_metric"]),
                total_metric=str(e["total_metric"]),
            ))
        else:
            raise ValueError(f"SLO {e['name']!r}: unknown kind {kind!r}")
    return out


def load_slo_config(source: str | None = None) -> list[SloObjective]:
    """SLO objectives from `source`, the ``BEE2BEE_SLO_CONFIG`` env var
    (inline JSON array, or a path to a JSON file), or the defaults."""
    data = load_json_source(source, "BEE2BEE_SLO_CONFIG", opener="[")
    if data is None:
        return parse_slo_config(DEFAULT_SLO_CONFIG)
    return parse_slo_config(data)


# burn-rate gauges (bee2bee_slo_* after prefixing): labeled by objective
# name — bounded by the configured objective list, not by request traffic
_G_SLO_BURN = get_registry().gauge(
    "slo.burn_rate", "error-budget burn rate by objective and window"
)
_G_SLO_STATUS = get_registry().gauge(
    "slo.status", "objective status: 0 ok, 1 burning, 2 tripped"
)
_G_SLO_BAD_FRACTION = get_registry().gauge(
    "slo.bad_fraction", "bad-event fraction over the fast window"
)

STATUS_OK = "ok"
STATUS_BURNING = "burning"
STATUS_TRIPPED = "tripped"
_STATUS_CODE = {STATUS_OK: 0, STATUS_BURNING: 1, STATUS_TRIPPED: 2}


class SloTracker:
    """Continuous multi-window burn-rate evaluation of SLO objectives
    against the (cumulative) local metrics registry.

    Each ``evaluate()`` snapshots every objective's cumulative (bad,
    total) event counts and computes the bad fraction over a FAST and a
    SLOW trailing window from snapshot deltas; burn rate is that fraction
    divided by the error budget (burn 1.0 = exactly spending the budget;
    the classic page condition is burn high in BOTH windows — fast for
    responsiveness, slow to ignore blips). A trip calls ``on_trip``
    (the flight recorder) at most once per ``trip_cooldown_s``."""

    def __init__(
        self,
        objectives: list[SloObjective] | None = None,
        registry: MetricsRegistry | None = None,
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        trip_burn_rate: float = 6.0,
        on_trip: Callable[[SloObjective, dict], None] | None = None,
        trip_cooldown_s: float = 300.0,
        clock: Clock | None = None,
    ):
        self.objectives = (
            list(objectives) if objectives is not None
            else parse_slo_config(DEFAULT_SLO_CONFIG)
        )
        self._reg = registry or get_registry()
        self._clock = resolve_clock(clock)
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.trip_burn_rate = trip_burn_rate
        self.on_trip = on_trip
        self.trip_cooldown_s = trip_cooldown_s
        self._lock = threading.Lock()
        self._snaps: dict[str, deque] = {
            o.name: deque() for o in self.objectives
        }
        self._last_trip: dict[str, float] = {}
        self._last_eval: list[dict] = []

    # ---- cumulative event counts

    def _counts(self, o: SloObjective) -> tuple[float, float]:
        """Cumulative (bad, total) event counts for an objective."""
        if o.kind == "latency":
            m = self._reg.get(o.metric)
            if not isinstance(m, Histogram):
                return 0.0, 0.0
            count, _ = m.totals()
            good = m.count_le(o.threshold_ms)
            # totals() and count_le() take the histogram lock separately:
            # an observe landing between them can make good > count for
            # one reading. bad is cumulative and monotone — clamp rather
            # than report a negative burn for a tick.
            return float(max(0, count - good)), float(count)
        errors = self._reg.get(o.errors_metric)
        total = self._reg.get(o.total_metric)
        bad = errors.total() if isinstance(errors, Counter) else 0.0
        tot = total.total() if isinstance(total, Counter) else 0.0
        return float(bad), float(tot)

    @staticmethod
    def _window_delta(snaps: deque, now: float, window_s: float) -> tuple[float, float]:
        """(bad, total) delta over the trailing window: latest snapshot
        minus the newest snapshot at/before the window start (or the
        oldest available — a partial window early in the process's life
        still reports, it just covers less time)."""
        if len(snaps) < 2:
            return 0.0, 0.0
        t_now, bad_now, tot_now = snaps[-1]
        start = now - window_s
        ref = snaps[0]
        for s in snaps:
            if s[0] <= start:
                ref = s
            else:
                break
        return bad_now - ref[1], tot_now - ref[2]

    def evaluate(self, now: float | None = None) -> list[dict]:
        """Snapshot + compute every objective; refresh the slo.* gauges;
        fire on_trip for fresh trips. Never throws (telemetry contract)."""
        try:
            return self._evaluate(now)
        except Exception:  # noqa: BLE001 — the health plane must not crash serving
            logger.exception("SLO evaluation failed")
            return self._last_eval

    def _evaluate(self, now: float | None) -> list[dict]:
        now = self._clock.time() if now is None else now
        out: list[dict] = []
        with self._lock:
            for o in self.objectives:
                bad, tot = self._counts(o)
                snaps = self._snaps[o.name]
                snaps.append((now, bad, tot))
                horizon = now - self.slow_window_s
                # keep ONE snapshot at/before the horizon as the slow
                # window's reference point
                while len(snaps) > 2 and snaps[1][0] <= horizon:
                    snaps.popleft()
                entry = {**o.describe()}
                burns = {}
                for label, win in (("fast", self.fast_window_s),
                                   ("slow", self.slow_window_s)):
                    dbad, dtot = self._window_delta(snaps, now, win)
                    frac = dbad / dtot if dtot > 0 else 0.0
                    burns[label] = {
                        "bad": dbad, "total": dtot,
                        "bad_fraction": round(frac, 6),
                        "burn_rate": round(frac / o.budget, 4),
                    }
                burn_fast = burns["fast"]["burn_rate"]
                burn_slow = burns["slow"]["burn_rate"]
                if (burn_fast >= self.trip_burn_rate
                        and burn_slow >= self.trip_burn_rate):
                    status = STATUS_TRIPPED
                elif burn_fast >= 1.0:
                    status = STATUS_BURNING
                else:
                    status = STATUS_OK
                entry.update(
                    windows=burns, status=status,
                    burn_rate_fast=burn_fast, burn_rate_slow=burn_slow,
                )
                _G_SLO_BURN.set(burn_fast, objective=o.name, window="fast")
                _G_SLO_BURN.set(burn_slow, objective=o.name, window="slow")
                _G_SLO_STATUS.set(_STATUS_CODE[status], objective=o.name)
                _G_SLO_BAD_FRACTION.set(
                    burns["fast"]["bad_fraction"], objective=o.name
                )
                if status == STATUS_TRIPPED:
                    last = self._last_trip.get(o.name, -math.inf)
                    if now - last >= self.trip_cooldown_s:
                        self._last_trip[o.name] = now
                        entry["tripped_at"] = now
                        if self.on_trip is not None:
                            try:
                                self.on_trip(o, dict(entry))
                            except Exception:  # noqa: BLE001
                                logger.exception("SLO on_trip hook failed")
                out.append(entry)
            self._last_eval = out
        return out

    def status(self) -> list[dict]:
        """A fresh evaluation (what ``GET /slo`` serves)."""
        return self.evaluate()

    def max_fast_burn(self) -> float:
        """Highest fast-window burn rate across objectives from the LAST
        evaluation (the monitor loop refreshes it on the ping cadence) —
        the shed signal the admission controller (router/admission.py)
        gates on. 0.0 before any evaluation: a node must not shed on no
        evidence."""
        return max(
            (float(e.get("burn_rate_fast") or 0.0) for e in self._last_eval),
            default=0.0,
        )

    def brief(self) -> dict:
        """Compact per-objective summary for the gossip digest."""
        out = {}
        for entry in self._last_eval:
            out[entry["name"]] = {
                "status": entry["status"],
                "burn_fast": entry["burn_rate_fast"],
                "burn_slow": entry["burn_rate_slow"],
            }
        return out


# --------------------------------------------------------- flight recorder


@dataclass
class _RingEvent:
    ts: float
    kind: str
    fields: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"ts": round(self.ts, 3), "kind": self.kind, **self.fields}


class FlightRecorder:
    """Bounded ring of recent telemetry events + on-disk incident bundles.

    ``record()`` is the cheap path (deque append under a lock, never
    throws) fed by span completions (tracing listener), notable frame ops
    (meshnet/node.py) and per-tick metric deltas (monitor loop).

    ``incident()`` is the expensive path, taken only on typed failures:
    it snapshots the ring, the metrics digest, and the stitched trace of
    the offending request into one JSON bundle under ``incident_dir``.
    The snapshot itself is in-memory and cheap; the DISK half (mkdir,
    write, prune) runs on a short-lived writer thread so callers on the
    asyncio event loop (gen_error serve path, pipeline failover, SLO
    trips from the monitor loop) never block mesh traffic on a slow
    filesystem — ``flush()`` joins outstanding writes (tests, shutdown).
    Per-kind cooldown bounds disk churn under a failure storm; bundles
    beyond ``max_incidents`` are pruned oldest-first."""

    def __init__(
        self,
        capacity: int = 512,
        incident_dir: str | Path | None = None,
        max_incidents: int = 32,
        cooldown_s: float = 30.0,
    ):
        self._events: deque[_RingEvent] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._incident_dir = Path(incident_dir) if incident_dir else None
        self.max_incidents = max_incidents
        self.cooldown_s = cooldown_s
        self._last_incident: dict[str, float] = {}  # kind -> ts
        self._disk_lock = threading.Lock()  # serializes write + prune
        self._writers: list[threading.Thread] = []
        # header index cache for list_incidents: path -> (stat sig, header)
        self._index_cache: dict[str, tuple[tuple, dict]] = {}

    # ---- configuration

    @property
    def incident_dir(self) -> Path:
        """Resolved lazily: env ``BEE2BEE_INCIDENT_DIR``, else
        ``<bee2bee home>/incidents`` (home itself is env-overridable)."""
        if self._incident_dir is None:
            env = os.environ.get("BEE2BEE_INCIDENT_DIR")
            self._incident_dir = (
                Path(env) if env else bee2bee_home() / "incidents"
            )
        return self._incident_dir

    @incident_dir.setter
    def incident_dir(self, value: str | Path | None) -> None:
        self._incident_dir = Path(value) if value else None

    # ---- ring

    def record(self, kind: str, **fields) -> None:
        """Append one ring event; never throws."""
        try:
            with self._lock:
                # the recorder is process-global and may outlive any one
                # clock installation — resolve at call time, not __init__
                self._events.append(
                    _RingEvent(get_clock().time(), str(kind), fields)
                )
        except Exception:  # noqa: BLE001 — telemetry never throws
            pass

    def events(self, limit: int = 200) -> list[dict]:
        with self._lock:
            evs = list(self._events)
        return [e.to_dict() for e in evs[-limit:]]

    def clear(self) -> None:
        """Tests: reset ring + cooldowns (disk bundles stay)."""
        with self._lock:
            self._events.clear()
            self._last_incident.clear()

    # ---- incidents

    def incident(
        self,
        kind: str,
        detail: str = "",
        trace_id: str | None = None,
        node: str | None = None,
        extra: dict | None = None,
    ) -> str | None:
        """Snapshot an incident bundle. Returns the incident id, or None
        when suppressed by the per-kind cooldown (or when the snapshot
        itself fails). The bundle is captured in-memory HERE — ring, trace
        and digest reflect this instant — but the disk write happens on a
        writer thread (``flush()`` waits for it): callers sit on the
        asyncio event loop and must not block on a slow filesystem. A
        failed write costs the bundle, never serving — best-effort by
        contract."""
        try:
            now = get_clock().time()
            with self._lock:
                last = self._last_incident.get(kind, -math.inf)
                if now - last < self.cooldown_s:
                    return None
                self._last_incident[kind] = now
            if trace_id is None:
                ctx = current_trace_ctx()
                trace_id = ctx.trace_id if ctx else None
            inc_id = new_id("inc")
            bundle: dict[str, Any] = {
                "id": inc_id,
                "ts": now,
                "kind": kind,
                "detail": detail,
                "node": node,
                "trace_id": trace_id,
                "events": self.events(limit=self._events.maxlen or 512),
                "metrics": build_digest(),
            }
            if extra:
                bundle["extra"] = extra
            if trace_id:
                # the stitched trace of the offending request: in a
                # one-node-per-process deployment this is the local
                # fragment (peers' fragments stitch on read via /trace);
                # in loopback meshes the shared tracer holds every hop
                bundle["trace"] = stitch_trace([
                    {"node": node, "spans": get_tracer().for_trace(trace_id)}
                ])
            self.record("incident", id=inc_id, incident_kind=kind, detail=detail)
            payload = json.dumps(bundle, default=str)
            t = threading.Thread(
                target=self._write_bundle, args=(inc_id, kind, detail, payload),
                name=f"incident-write-{inc_id}", daemon=True,
            )
            with self._lock:
                self._writers = [w for w in self._writers if w.is_alive()]
                self._writers.append(t)
            t.start()
            return inc_id
        except Exception:  # noqa: BLE001 — telemetry never throws
            logger.exception("incident snapshot failed")
            return None

    def flush(self, timeout_s: float = 5.0) -> None:
        """Join outstanding bundle writes (tests, orderly shutdown)."""
        # writer threads live in REAL time: joining them against a virtual
        # deadline would mis-compute the remaining wait under a sim clock
        deadline = time.time() + timeout_s  # meshlint: ignore[ML-C001] -- real thread-join deadline
        with self._lock:
            writers = list(self._writers)
        for w in writers:
            w.join(max(0.0, deadline - time.time()))  # meshlint: ignore[ML-C001] -- real thread-join deadline

    def _write_bundle(self, inc_id: str, kind: str, detail: str, payload: str) -> None:
        try:
            with self._disk_lock:
                d = self.incident_dir
                d.mkdir(parents=True, exist_ok=True)
                path = d / f"{inc_id}.json"
                path.write_text(payload)
                self._prune(d)
            logger.warning("incident %s (%s): %s -> %s", inc_id, kind, detail, path)
        except Exception:  # noqa: BLE001 — a full disk must not take down serving
            logger.exception("incident write failed (%s)", inc_id)

    def _prune(self, d: Path) -> None:
        bundles = sorted(d.glob("inc-*.json"), key=lambda p: p.stat().st_mtime)
        for p in bundles[: max(0, len(bundles) - self.max_incidents)]:
            try:
                p.unlink()
            except OSError:
                pass

    def list_incidents(self) -> list[dict]:
        """Newest-first header index of on-disk bundles (id, ts, kind,
        detail, node, trace_id) — the ``GET /debug/incidents`` listing.
        Headers are cached per (path, stat signature): polling the debug
        surface re-parses only bundles that actually changed, not every
        multi-hundred-KB ring+trace payload on each request."""
        try:
            d = self.incident_dir
            if not d.is_dir():
                return []
            out = []
            seen_paths: set[str] = set()
            for p in sorted(d.glob("inc-*.json"),
                            key=lambda p: p.stat().st_mtime, reverse=True):
                key = str(p)
                seen_paths.add(key)
                try:
                    st = p.stat()
                    sig = (st.st_mtime_ns, st.st_size)
                    cached = self._index_cache.get(key)
                    if cached and cached[0] == sig:
                        out.append(dict(cached[1]))
                        continue
                    b = json.loads(p.read_text())
                except (OSError, ValueError):
                    continue
                header = {
                    k: b.get(k)
                    for k in ("id", "ts", "kind", "detail", "node", "trace_id")
                }
                self._index_cache[key] = (sig, header)
                out.append(dict(header))
            for key in list(self._index_cache):
                if key not in seen_paths:  # pruned/removed bundles
                    self._index_cache.pop(key, None)
            return out
        except Exception:  # noqa: BLE001
            logger.exception("incident listing failed")
            return []

    def load_incident(self, incident_id: str) -> dict | None:
        """Full bundle by id; None when unknown. The id is user input off
        a URL — resolve by exact-match listing, never by path join."""
        try:
            d = self.incident_dir
            if not d.is_dir():
                return None
            for p in d.glob("inc-*.json"):
                if p.stem == incident_id:
                    return json.loads(p.read_text())
            return None
        except Exception:  # noqa: BLE001
            logger.exception("incident load failed")
            return None


_RECORDER = FlightRecorder()
_LISTENER_WIRED = False


def _span_listener(span) -> None:
    """Tracing listener: every completed span becomes a compact ring
    event — the 'what just happened' half of an incident bundle."""
    _RECORDER.record(
        "span",
        name=span.name,
        duration_ms=round(span.duration_ms, 3),
        trace_id=span.trace_id,
        error=span.error,
    )


def get_recorder() -> FlightRecorder:
    """The process-global flight recorder (wired to the global tracer on
    first use, so span completions start landing in the ring)."""
    global _LISTENER_WIRED
    if not _LISTENER_WIRED:
        _LISTENER_WIRED = True
        get_tracer().add_listener(_span_listener)
    return _RECORDER
