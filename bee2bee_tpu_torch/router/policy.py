"""SLO-aware routing policy: score providers on live telemetry digests.

Replaces ``pick_provider``'s static "cheapest, then lowest-latency" sort
(the reference's rule, PAPER.md L3) with a scorer over the signals the
health plane already gossips fleet-wide (health.py digests on the ping
cadence):

- queue-wait p95 (``hist["engine.queue_wait_ms"]``) — requests already
  waiting there will wait in front of ours;
- batch-fill (``gauge["engine.batch_fill"]``) — headroom in the decode
  batch;
- paged-pool pressure (``engine.paged_blocks_free / _total``) — a nearly
  dry pool means admission backpressure is imminent;
- SLO burn state (the digest's ``slo`` brief) — a peer burning its error
  budget is EXCLUDED outright (sending it more traffic melts it faster),
  unless every candidate is excluded (degraded service beats none);
- RTT to the peer (the hello/ping bookkeeping) and price as weak signals;
- prompt-prefix locality (router/prefixmap.py): a peer advertising the
  prompt's leading-block hashes gets a bonus per matched block, so CoW
  prefix sharing actually gets hit across the mesh.

Scores are penalties — lower wins. Every signal is normalized to [0, 1]
via soft knees (``x / (x + ref)``) so one hot metric can't saturate the
sum. A peer with NO fresh digest scores the explicit **unknown tier**
(neutral 0.5 on the load signals) instead of the old ``_latency or 1e9``
sort key that permanently deprioritized never-pinged peers; when no
candidate has a fresh digest at all, the caller falls back to the legacy
static sort (meshnet/node.pick_provider keeps it).

Weights are env-tunable (``BEE2BEE_ROUTER``, inline JSON or a path) and
validated loudly, same contract as the SLO config.

PyTorch port: a copy of ``bee2bee_tpu/router/policy.py`` with the import root rewritten to
``bee2bee_tpu_torch``; comments that cited the JAX package's change history or the
reference checkout's path are trimmed.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

from ..health import digest_slo_burn
from ..metrics import get_registry
from ..utils import load_json_source
from .prefixmap import match_depth, prompt_prefix_hashes

# routing decision counters: mode is a closed set, so cardinality is fixed
_C_DECISIONS = get_registry().counter(
    "router.decisions", "provider picks by mode (scored / static fallback)"
)
_C_PREFIX_PREFERRED = get_registry().counter(
    "router.prefix_preferred",
    "scored picks whose winner matched the prompt's prefix blocks",
)
_C_SLO_EXCLUDED = get_registry().counter(
    "router.slo_excluded", "candidates excluded for burning their SLO budget"
)
_C_DRAIN_EXCLUDED = get_registry().counter(
    "router.drain_excluded", "candidates excluded for draining"
)
_C_WARMUP_EXCLUDED = get_registry().counter(
    "router.warmup_excluded",
    "candidates excluded as standby/warming fleet replicas",
)
_C_ADAPTER_PREFERRED = get_registry().counter(
    "router.adapter_preferred",
    "scored picks whose winner already held the requested adapter",
)

MODE_SCORED = "scored"
MODE_STATIC = "static_fallback"


@dataclass(frozen=True)
class RouterWeights:
    """Penalty weights + normalization knees; lower total score wins."""

    queue: float = 0.30        # queue-wait p95 penalty weight
    fill: float = 0.25         # batch-fill penalty weight
    pool: float = 0.20         # paged-pool pressure penalty weight
    rtt: float = 0.10          # network distance penalty weight
    price: float = 0.05        # price tie-break weight
    prefix_bonus: float = 0.08  # score credit per matched prefix block
    prefix_max_blocks: int = 2  # cap on credited blocks ("within tolerance":
    # a prefix match may beat at most ~prefix_bonus*max/fill of batch-fill
    # difference, never a peer that is outright loaded)
    adapter_bonus: float = 0.12  # score credit for a peer whose digest
    # advertises the requested LoRA adapter resident (adapters/): routing
    # there skips a whole DHT piece fetch + pool churn. Like the prefix
    # bonus it is affinity-within-tolerance — burning/draining peers are
    # excluded BEFORE scoring, and the bonus stays below fill+pool
    # weights so residency never beats an outright-loaded node
    queue_ref_ms: float = 500.0  # soft knee: p95 at the knee scores 0.5
    rtt_ref_ms: float = 100.0
    unknown: float = 0.5       # the explicit unknown tier for digest-less peers
    # engine economics (digest `introspect` block, engine/introspect.py):
    # a memory-squeezed peer — HBM headroom under the floor — ramps a
    # penalty 0→1 as headroom falls to zero (peers without a ledger
    # reading pay nothing: absent subsystem, not unknown pressure), and
    # a peer reporting a recent retrace storm pays a flat penalty (its
    # next requests eat compile wall-time, the exact latency a router
    # exists to route around) — penalties, not exclusions: a degraded
    # engine still beats a burning or draining one
    hbm: float = 0.15
    hbm_headroom_floor: float = 0.10
    storm: float = 0.10
    # trend watchdog (obs/): a DEGRADING peer — queue-wait
    # sloping up or goodput sloping down in its gossiped trend digest —
    # pays a penalty that ramps with the relative slope and saturates
    # when the peer's own watchdog flags either series anomalous. A
    # penalty, not an exclusion: the point is to demote a sinking peer
    # BEFORE its SLO trips, and a mildly-degrading engine still beats a
    # burning or draining one. degrading_slope_ref is the relative slope
    # (fraction of the level per minute) that counts as fully degrading.
    degrading: float = 0.15
    degrading_slope_ref: float = 0.10


def parse_router_weights(obj) -> RouterWeights:
    if not isinstance(obj, dict):
        raise ValueError(f"router config must be a JSON object, got {type(obj).__name__}")
    known = {f.name for f in fields(RouterWeights)}
    unknown = set(obj) - known
    if unknown:
        raise ValueError(f"router config: unknown keys {sorted(unknown)}")
    kwargs = {}
    for k, v in obj.items():
        kwargs[k] = int(v) if k == "prefix_max_blocks" else float(v)
        if kwargs[k] < 0:
            raise ValueError(f"router config: {k} must be >= 0")
    return RouterWeights(**kwargs)


def load_router_weights(source: str | None = None) -> RouterWeights:
    """Weights from `source`, ``BEE2BEE_ROUTER`` (inline JSON or a path),
    or the defaults; malformed config raises at node construction."""
    data = load_json_source(source, "BEE2BEE_ROUTER")
    return parse_router_weights(data) if data is not None else RouterWeights()


def _soft(value: float, ref: float) -> float:
    """x/(x+ref): 0 at 0, 0.5 at the knee, asymptotically 1."""
    v = max(float(value), 0.0)
    return v / (v + ref) if ref > 0 else 1.0


def _slo_burning(digest: dict | None) -> bool:
    """True when the peer's own SLO brief reports any objective burning or
    tripped — the shed-before-melt contract seen from the outside. ONE
    rule shared with the fleet controller's aggregates
    (health.digest_slo_burn): the controller must scale on exactly the
    definition of "burning" the router excludes on."""
    return digest_slo_burn(digest)[1]


class RouterPolicy:
    """Scores ``list_providers()`` candidates against HealthStore digests;
    ``pick`` returns the winner or None."""

    def __init__(self, weights: RouterWeights | None = None):
        self.weights = weights or load_router_weights()

    # ------------------------------------------------------------- scoring

    def score(self, cand: dict, digest: dict | None, rtt_ms: float | None,
              max_price: float, prompt_hashes: list[str],
              adapter: str | None = None) -> tuple[float, dict]:
        """(penalty score, breakdown) for one candidate. ``digest`` is the
        peer's fresh telemetry digest (the node's own live digest for the
        local candidate); None selects the unknown tier. ``adapter``
        credits peers whose digest advertises that LoRA adapter resident."""
        w = self.weights
        adapter_resident = bool(
            adapter
            and digest is not None
            and any(
                adapter in names
                for names in (digest.get("adapters") or {}).values()
                if isinstance(names, (list, tuple))
            )
        )
        hbm = 0.0
        storming = False
        degrading = 0.0
        if digest is None:
            queue = fill = pool = w.unknown
            matched = 0
        else:
            hist = digest.get("hist") or {}
            qw = hist.get("engine.queue_wait_ms") or {}
            queue = _soft(qw.get("p95") or 0.0, w.queue_ref_ms)
            gauge = digest.get("gauge") or {}
            # absent batch-fill/pool gauges mean the subsystem isn't
            # running (health.build_digest contract) — no pressure, not
            # unknown pressure
            fill = min(max(float(gauge.get("engine.batch_fill") or 0.0), 0.0), 1.0)
            total = float(gauge.get("engine.paged_blocks_total") or 0.0)
            if total > 0:
                free = float(gauge.get("engine.paged_blocks_free") or 0.0)
                pool = 1.0 - min(max(free / total, 0.0), 1.0)
            else:
                pool = 0.0
            matched = min(
                match_depth(prompt_hashes, digest.get("prefix_hashes")),
                w.prefix_max_blocks,
            )
            intro = digest.get("introspect") or {}
            headroom = (intro.get("hbm") or {}).get("headroom_frac")
            if headroom is not None and w.hbm_headroom_floor > 0:
                hbm = min(
                    max(
                        (w.hbm_headroom_floor - float(headroom))
                        / w.hbm_headroom_floor,
                        0.0,
                    ),
                    1.0,
                )
            storming = bool(intro.get("storming"))
            # trend digest (obs/): relative slopes, fraction of the
            # level per minute. Rising queue wait and falling goodput
            # are the two "sinking peer" signatures; either series
            # flagged anomalous by the peer's own watchdog saturates
            # the penalty. Absent trend block = absent subsystem = no
            # penalty (same contract as every other digest signal).
            tser = (digest.get("trend") or {}).get("series") or {}
            q_trend = tser.get("queue_wait_p95_ms") or {}
            g_trend = tser.get("goodput_tok_s") or {}
            try:
                bad_slope = max(float(q_trend.get("slope") or 0.0), 0.0) + \
                    max(-float(g_trend.get("slope") or 0.0), 0.0)
            except (TypeError, ValueError):
                bad_slope = 0.0
            if w.degrading_slope_ref > 0:
                degrading = min(bad_slope / w.degrading_slope_ref, 1.0)
            if q_trend.get("anom") or g_trend.get("anom"):
                degrading = 1.0
        rtt = 0.0 if cand.get("local") else (
            _soft(rtt_ms, w.rtt_ref_ms) if rtt_ms is not None else w.unknown
        )
        price = float(cand.get("price_per_token") or 0.0)
        pnorm = price / max_price if max_price > 0 else 0.0
        score = (
            w.queue * queue + w.fill * fill + w.pool * pool
            + w.rtt * rtt + w.price * pnorm
            + w.hbm * hbm + (w.storm if storming else 0.0)
            + w.degrading * degrading
            - w.prefix_bonus * matched
            - (w.adapter_bonus if adapter_resident else 0.0)
        )
        return score, {
            "queue": round(queue, 4), "fill": round(fill, 4),
            "pool": round(pool, 4), "rtt": round(rtt, 4),
            "price": round(pnorm, 4), "prefix_blocks": matched,
            "adapter_resident": adapter_resident,
            "hbm": round(hbm, 4), "storming": storming,
            "degrading": round(degrading, 4),
            "unknown": digest is None, "score": round(score, 4),
        }

    # --------------------------------------------------------------- pick

    def pick(
        self,
        candidates: list[dict],
        fresh_digests: dict[str, dict],
        local_digest: dict | None = None,
        prompt: str | None = None,
        adapter: str | None = None,
    ) -> tuple[dict | None, dict]:
        """Pick from candidates using fresh digests; returns
        ``(winner | None, decision)``. The caller handles the no-fresh-
        digest case (static fallback) — this method assumes scoring is
        worthwhile, i.e. at least one candidate has a digest."""
        ph = prompt_prefix_hashes(prompt)
        max_price = max(
            (float(c.get("price_per_token") or 0.0) for c in candidates),
            default=0.0,
        )
        scored: list[tuple[float, int, dict, dict]] = []
        excluded = 0
        for i, cand in enumerate(candidates):
            digest = (
                local_digest if cand.get("local")
                else fresh_digests.get(cand.get("provider_id"))
            )
            if digest is not None and digest.get("draining"):
                # a draining peer is LEAVING: its admission 503s every
                # new request anyway — unlike the SLO exclusion below,
                # there is no all-burning waiver back in (routing to it
                # just converts one hop into a guaranteed typed shed)
                _C_DRAIN_EXCLUDED.inc()
                continue
            if digest is not None and digest.get("fleet_state") in (
                "standby", "warming"
            ):
                # an elastic-fleet standby/warming replica (fleet/) has
                # NOT passed its warm-up probe: it must never receive
                # routed traffic — no waiver, same as draining (the
                # controller's probe is the only thing allowed to hit it)
                _C_WARMUP_EXCLUDED.inc()
                continue
            if _slo_burning(digest):
                excluded += 1
                _C_SLO_EXCLUDED.inc()
                continue
            s, breakdown = self.score(
                cand, digest, cand.get("_latency"), max_price, ph,
                adapter=adapter,
            )
            # deterministic tie-break: local first, then provider id
            scored.append((s, i, cand, breakdown))
        if not scored and excluded:
            # every candidate is burning: serve SOMEWHERE — degraded
            # routing beats a routable-provider deadlock (draining peers
            # stay out even here: they reject typed regardless)
            for i, cand in enumerate(candidates):
                digest = (
                    local_digest if cand.get("local")
                    else fresh_digests.get(cand.get("provider_id"))
                )
                if digest is not None and (
                    digest.get("draining")
                    or digest.get("fleet_state") in ("standby", "warming")
                ):
                    continue
                s, breakdown = self.score(
                    cand, digest, cand.get("_latency"), max_price, ph,
                    adapter=adapter,
                )
                breakdown["slo_override"] = True
                scored.append((s, i, cand, breakdown))
        if not scored:
            return None, {"mode": MODE_SCORED, "candidates": 0}
        scored.sort(key=lambda t: (
            t[0], not t[2].get("local"), str(t[2].get("provider_id"))
        ))
        best_score, _, winner, breakdown = scored[0]
        _C_DECISIONS.inc(mode=MODE_SCORED)
        if breakdown.get("prefix_blocks"):
            _C_PREFIX_PREFERRED.inc()
        if breakdown.get("adapter_resident"):
            _C_ADAPTER_PREFERRED.inc()
        return winner, {
            "mode": MODE_SCORED,
            "candidates": len(candidates),
            "slo_excluded": excluded,
            "winner": winner.get("provider_id"),
            "breakdown": breakdown,
        }


def static_sort(candidates: list[dict]) -> dict | None:
    """The legacy sort (reference p2p_runtime.py:744-746): cheapest, then
    lowest-latency, local as zero latency. Kept as the explicit fallback
    for when no telemetry digest is fresh — with its known stale-latency
    wart (``or 1e9`` deprioritizes never-pinged peers) contained to the
    no-telemetry regime where nothing better is knowable."""
    if not candidates:
        return None
    _C_DECISIONS.inc(mode=MODE_STATIC)
    return sorted(
        candidates,
        key=lambda p: (
            p.get("price_per_token") or 0.0,
            0.0 if p.get("local") else (p.get("_latency") or 1e9),
        ),
    )[0]
