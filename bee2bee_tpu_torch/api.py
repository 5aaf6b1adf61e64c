"""HTTP gateway: per-node REST API over the mesh runtime.

Same surface as the reference's FastAPI app (api.py:113-267): `GET /` status,
`GET /peers`, `GET /providers`, `POST /connect`, `POST /chat` + `/generate`
(alias) with local-first fuzzy model match, streaming via chunked responses,
and P2P fallback; `X-API-KEY` auth — but DENIED BY DEFAULT when no key is
configured locally-only (the reference leaves the API wide open with no key,
api.py:24-26; here an unset key only allows loopback callers). Built on
aiohttp (fastapi/uvicorn are not in this image).

PyTorch port: a copy of ``bee2bee_tpu/api.py`` with the import root rewritten
to ``bee2bee_tpu_torch``; comments that cited the JAX package's change history
or the reference checkout's path are trimmed. ``/debug/profile`` answers a
typed 501 naming its ROADMAP.md item, and the ``/metrics/history`` platform
stamp reads torch, not jax.
"""

from __future__ import annotations

import asyncio
import contextlib
import hmac
import json
import logging
import os
from typing import Any

from aiohttp import web

import math

from . import __version__
from . import health
from .adapters import (
    AdapterPoolBusy,
    UnknownAdapter,
    clamp_adapter_name,
    split_model_adapter,
)
from .health import fleet_view, render_fleet_prom
from .meshnet.node import P2PNode
from .metrics import PROMETHEUS_CONTENT_TYPE, get_registry
from .obs import SERIES_BY_NAME, SERIES_NAMES
from .protocol import copy_sampling
from .router import DEFAULT_TENANT, AdmissionReject
from .tracing import get_tracer, stitch_trace

logger = logging.getLogger("bee2bee_tpu_torch.api")

# node-level gauges refreshed at scrape time. Names match the pre-registry
# /metrics exposition exactly (dashboards already scrape them); gauges, not
# counters, because the Prometheus counter convention appends _total and
# would rename the series.
_REG = get_registry()
_G_TOKENS_PER_SEC = _REG.gauge(
    "tokens_per_sec", "measured serving throughput (rolling)"
)
_G_TOTAL_TOKENS = _REG.gauge("total_tokens", "tokens served since boot")
_G_TOTAL_REQUESTS = _REG.gauge("total_requests", "requests served since boot")
_G_PEERS = _REG.gauge("peers", "connected mesh peers")
_G_PROVIDERS = _REG.gauge("providers", "remote services known")
_G_LOCAL_SERVICES = _REG.gauge("local_services", "services hosted locally")
_G_PIECES = _REG.gauge("pieces", "weight pieces stored")
_G_CPU = _REG.gauge("cpu_percent", "host CPU utilization")
_G_ACCEL_MEM = _REG.gauge(
    "accelerator_mem_percent", "accelerator memory utilization"
)
_G_P50_LATENCY = _REG.gauge(
    "p50_latency_seconds", "rolling p50 request latency"
)


def _cors_headers(api_key: str | None) -> dict[str, str]:
    """CORS policy. The reference always sends `*` (api.py:92-98) — but
    combined with our loopback-only keyless auth that would let any page in
    the operator's browser drive the node. So: browsers are only allowed
    when an origin list is configured explicitly, or when requests must
    carry an API key anyway (which a drive-by page doesn't have)."""
    origin = os.environ.get("BEE2BEE_CORS_ORIGINS") or ("*" if api_key else None)
    if not origin:
        return {}
    return {
        "Access-Control-Allow-Origin": origin,
        "Access-Control-Allow-Methods": "GET, POST, OPTIONS",
        "Access-Control-Allow-Headers": "Content-Type, X-API-KEY, Authorization",
    }


def _int_param(body: dict, keys: tuple[str, ...], default: int) -> int:
    """First present-and-not-None key wins; an explicit 0 stays 0."""
    for k in keys:
        v = body.get(k)
        if v is not None:
            return int(v)
    return default


def _presented_key(request: web.Request) -> str:
    """The credential the caller sent: X-API-KEY, or the Bearer token
    (standard OpenAI SDKs send the key that way on /v1)."""
    key = request.headers.get("X-API-KEY", "")
    if key:
        return key
    auth = request.headers.get("Authorization", "")
    if auth.startswith("Bearer "):
        return auth[len("Bearer "):]
    return ""


def _auth_ok(request: web.Request, api_key: str | None, tenants=None) -> bool:
    # constant-time comparisons: == leaks matching-prefix length via
    # timing on the SDK-facing /v1 surface. Compare utf-8 bytes —
    # compare_digest raises TypeError on non-ASCII str input, which
    # would turn a bad header into a 500 instead of a 401
    enc = lambda s: s.encode("utf-8", "surrogateescape")
    presented = _presented_key(request)
    if api_key and hmac.compare_digest(enc(presented), enc(api_key)):
        return True
    # per-tenant API keys (router/tenants.py) authenticate too — tenant
    # identity FLOWS from the key, so a tenant key must open the door it
    # is billed through (resolve_key is constant-time per key)
    if tenants is not None and tenants.resolve_key(presented) is not None:
        return True
    if api_key:
        return False
    # no node key configured: loopback only (safer than the reference's
    # open default, per SURVEY §7 "what NOT to carry over")
    peer = request.remote or ""
    return peer in ("127.0.0.1", "::1", "localhost", "")


def _tenant_of(request: web.Request, tenants) -> str:
    """Tenant billed for this request: the one owning the presented API
    key, else the default tenant (weight 1, no budget)."""
    if tenants is None:
        return DEFAULT_TENANT
    return tenants.resolve_key(_presented_key(request)) or DEFAULT_TENANT


def _admission_response(rej: AdmissionReject, cors, v1: bool = False):
    """Typed 429/503 response: Retry-After header + error_kind /
    retry_after_s body — the contract docs/SERVING.md documents and
    client.MeshOverloaded parses."""
    if v1:
        body = {"error": {
            "message": rej.detail, "type": "overloaded_error",
            "error_kind": rej.kind, "retry_after_s": rej.retry_after_s,
        }}
    else:
        body = {"detail": rej.detail, "error_kind": rej.kind,
                "retry_after_s": rej.retry_after_s}
    return web.json_response(
        body,
        status=rej.status,
        headers={**dict(cors), "Retry-After": str(max(1, math.ceil(rej.retry_after_s)))},
    )


# local service resolution lives on the node (_local_service_for) so the
# HTTP gateway and the P2P gen_request path share one matching rule


def build_app(node: P2PNode, api_key: str | None = None) -> web.Application:
    app = web.Application(client_max_size=32 * 1024 * 1024)
    app["node"] = node
    cors = _cors_headers(api_key)

    @web.middleware
    async def middleware(request: web.Request, handler):
        if request.method == "OPTIONS":
            return web.Response(headers=cors)
        if not _auth_ok(request, api_key, node.tenants):
            return web.json_response(
                {"detail": "invalid or missing X-API-KEY"}, status=401, headers=cors
            )
        try:
            resp = await handler(request)
        except web.HTTPException:
            raise
        except ConnectionResetError:
            raise  # client went away mid-stream; nothing to respond to
        except AdmissionReject as rej:
            # a typed shed from ANY depth — this node's admission or a
            # remote hop's rejection surfaced by request_generation —
            # keeps its 429/503 + Retry-After contract instead of
            # collapsing into the generic 500 below
            return _admission_response(
                rej, cors, v1=request.path.startswith("/v1")
            )
        except UnknownAdapter as e:
            # the eviction-races-admission window (the pre-admission
            # ensure_adapter check covers the common path): still a typed
            # 404, never a 500
            if request.path.startswith("/v1"):
                body = {"error": {"message": str(e),
                                  "type": "invalid_request_error",
                                  "error_kind": "unknown_adapter"}}
            else:
                body = {"detail": str(e), "error_kind": "unknown_adapter"}
            return web.json_response(body, status=404, headers=cors)
        except AdapterPoolBusy as e:
            # a VALID adapter hitting a slot-saturated pool is
            # backpressure, not absence: the pool_exhausted 503 +
            # Retry-After shed (clients retry; a 404 they would not)
            return _admission_response(
                AdmissionReject(
                    "pool_exhausted",
                    node.admission.config.shed_retry_after_s,
                    f"adapter pool busy: {e}",
                ),
                cors, v1=request.path.startswith("/v1"),
            )
        except Exception as e:
            if request.transport is None:
                raise  # response already started and connection is gone
            logger.exception("handler error")
            return web.json_response({"detail": str(e)}, status=500, headers=cors)
        for k, v in cors.items():
            resp.headers.setdefault(k, v)
        return resp

    app.middlewares.append(middleware)

    async def home(request):
        st = node.status()
        st.update({"status": "ok", "version": __version__})
        return web.json_response(st)

    async def peers(request):
        out = []
        for pid, info in node.peers.items():
            out.append(
                {
                    "peer_id": pid,
                    "addr": info.get("addr"),
                    "region": info.get("region"),
                    "health": info.get("health"),
                    "rtt_ms": info.get("rtt_ms"),
                    "metrics": info.get("metrics"),
                    "api_port": info.get("api_port"),
                }
            )
        return web.json_response({"peers": out})

    async def providers(request):
        return web.json_response({"providers": node.list_providers(request.query.get("model"))})

    async def connect(request):
        body = await _json_body(request)
        target = body.get("addr") or body.get("link")
        if not target:
            return web.json_response({"detail": "addr or link required"}, status=400)
        ok = await node.connect_bootstrap(target)
        return web.json_response({"connected": ok})

    async def _admit_and_serve_local(request, svc, params, stream, sse=None):
        """THE admission contract on the HTTP surface, shared by /chat and
        /v1: acquire a slot (WDRR-queued by tenant when saturated) →
        stream or execute → bill the tenant's completed tokens → release.
        Raises AdmissionReject for the middleware's typed 429/503 +
        Retry-After response; returns the StreamResponse (streaming) or
        the service result dict."""
        ticket = await node.admission.acquire(
            params["tenant"], cost_tokens=params["max_new_tokens"]
        )
        try:
            if stream:
                return await _stream_service(
                    request, node, svc, params, cors, sse=sse, ticket=ticket
                )
            # node._execute_local = executor dispatch + gen.local span
            # with contextvar parenting (engine spans nest under it)
            result = await node._execute_local(
                svc, params, stream=False, on_chunk=None
            )
            ticket.note_tokens(result.get("tokens") or 0)
            return result
        finally:
            ticket.release()

    async def chat(request):
        body = await _json_body(request)
        prompt = body.get("prompt") or _prompt_from_messages(body.get("messages"))
        if not prompt:
            return web.json_response({"detail": "prompt or messages required"}, status=400)
        model = body.get("model")
        with get_tracer().span(
            "api.chat", model=model, stream=bool(body.get("stream"))
        ):
            return await _chat_inner(request, body, prompt, model)

    def _resolve_model(model, tenant):
        """(svc, base model, adapter, affinity) for one request. The
        "<base>:<adapter>" grammar applies ONLY where a colon can mean
        an adapter — the base resolves to an adapter-pooled engine
        service: a backend whose OWN ids contain colons (ollama
        "llama3:8b") advertised verbatim keeps serving them whole.
        Within the grammar, the explicit model form wins, else the
        tenant's configured default adapter (router/tenants.py) — the
        one-base-many-tenants mapping every surface shares. A malformed
        adapter half raises UnknownAdapter (the middleware's typed 404)
        — never a silent fall-through to the plain base. `adapter` is
        what this node COMMITS to (params + ensure_adapter); `affinity`
        only scores the provider pick when nothing local resolves and
        the serving node must re-derive from the forwarded model id."""
        base_model, raw = split_model_adapter(model)
        if raw is None:
            svc = node.local_service_for(base_model)
            adapter = node.tenants.default_adapter(tenant)
            if adapter and svc is not None and not P2PNode.adapter_capable(svc):
                adapter = None  # a default can't apply to this backend
            return svc, base_model, adapter, adapter
        svc = node.local_service_for(base_model)
        if svc is not None and P2PNode.adapter_capable(svc):
            adapter = clamp_adapter_name(raw)
            if adapter is None:
                raise UnknownAdapter(
                    f"malformed adapter name in model {model!r}"
                )
            return svc, base_model, adapter, adapter
        verbatim = node.service_advertising(model)
        if verbatim is not None:
            # the colon belongs to the backend's own tag grammar
            return verbatim, model, None, None
        if svc is not None:
            # the base resolves locally but cannot serve adapters: the
            # typed 404 (a pool-less engine must never silently serve
            # the plain base under an adapter-qualified id)
            raise UnknownAdapter(
                f"service for {base_model!r} cannot serve adapter "
                f"models ({model!r})"
            )
        # nothing local either way: forward the ORIGINAL id whole; the
        # split half only biases the provider pick toward residents
        return None, model, None, clamp_adapter_name(raw)

    async def _chat_inner(request, body, prompt, model):
        params = {
            "prompt": prompt,
            "max_new_tokens": _int_param(body, ("max_new_tokens", "max_tokens"), 2048),
            "temperature": float(body.get("temperature", 0.7)),
        }
        # the full sampling surface rides through to the service layer —
        # silently dropping a requested penalty would be wrong output, not
        # a degraded default
        copy_sampling(body, params)
        stream = bool(body.get("stream"))
        tenant = _tenant_of(request, node.tenants)
        params["tenant"] = tenant
        svc, base_model, adapter, affinity = _resolve_model(model, tenant)
        if adapter:
            params["adapter"] = adapter

        if svc is not None:
            if adapter and not await node.ensure_adapter(svc, adapter):
                # typed 404: the adapter neither is resident nor could be
                # paged in from the mesh — a wrong name must not serve
                # the plain base model silently
                return web.json_response(
                    {"detail": f"unknown adapter {adapter!r} for model "
                               f"{base_model!r}",
                     "error_kind": "unknown_adapter"}, status=404
                )
            out = await _admit_and_serve_local(request, svc, params, stream)
            if isinstance(out, web.StreamResponse):
                return out
            return web.json_response(out)

        # P2P fallback (reference api.py:247-264): prefix-aware scored pick
        provider = node.pick_provider(
            model, prompt=prompt, adapter=adapter or affinity
        )
        if provider is None or provider["local"]:
            return web.json_response(
                {"detail": f"no provider for model {model!r}"}, status=404
            )
        if stream:
            return await _stream_p2p(
                request, node, provider, params, model, cors, tenant=tenant
            )
        result = await node.request_generation(
            provider["provider_id"],
            prompt,
            model=model,
            max_new_tokens=params["max_new_tokens"],
            temperature=params["temperature"],
            extra=_sampling_extra(params),
            tenant=tenant,
        )
        return web.json_response(result)

    async def trace(request):
        """Observability surface the reference lacks (SURVEY §5).

        - default: per-span percentiles + recent spans.
        - ``?trace_id=``: this node's local FRAGMENT of one trace —
          {"node", "trace_id", "spans"} (spans share the id across every
          hop the request touched, thanks to wire trace propagation).
        - ``?trace_id=&stitch=1``: additionally query every peer that
          advertises an api port for ITS fragment and merge them into one
          cross-node timeline (tracing.stitch_trace). Best-effort: peers
          that are unreachable or require a key we don't hold are skipped.
        """
        tracer = get_tracer()
        trace_id = request.query.get("trace_id")
        if trace_id:
            frag = {
                "node": node.peer_id,
                "trace_id": trace_id,
                "spans": tracer.for_trace(trace_id),
            }
            if not request.query.get("stitch"):
                return web.json_response(frag)
            import aiohttp

            async def fetch_fragment(s, pid, host, port):
                """A peer that can't answer (or answers garbage) becomes a
                typed PARTIAL fragment, so stitch_trace reports it under
                missing_peers instead of silently shrinking the timeline."""
                try:
                    async with s.get(
                        f"http://{host}:{port}/trace",
                        params={"trace_id": trace_id},
                        timeout=aiohttp.ClientTimeout(total=3),
                    ) as r:
                        if r.status == 200:
                            got = await r.json()
                            if isinstance(got, dict) and isinstance(
                                got.get("spans"), list
                            ):
                                return got
                            return {"node": pid, "partial": True}
                except Exception:  # noqa: BLE001 — stitch what answers
                    pass
                return {"node": pid, "unreachable": True}

            # concurrent fan-out: N unreachable peers cost ONE 3s timeout,
            # not 3s each — a stitch over a big mesh must stay interactive.
            # A peer with no advertised API endpoint can't be asked at all:
            # it lands in missing_peers too, so the stitch never reports
            # complete while silently lacking that node's spans.
            tasks, no_endpoint = [], []
            for pid, info in list(node.peers.items()):
                if info.get("api_host") and info.get("api_port"):
                    tasks.append(
                        (pid, info.get("api_host"), info.get("api_port"))
                    )
                else:
                    no_endpoint.append({"node": pid, "unreachable": True})
            async with aiohttp.ClientSession() as s:
                got = await asyncio.gather(*(
                    fetch_fragment(s, pid, host, port)
                    for pid, host, port in tasks
                ))
            return web.json_response(
                stitch_trace([frag] + list(got) + no_endpoint)
            )
        try:
            limit = min(1000, max(1, int(request.query.get("limit", 50))))
        except ValueError:
            return web.json_response({"detail": "limit must be an int"}, status=400)
        return web.json_response(
            {
                "stats": tracer.stats(),
                "recent": tracer.recent(limit, name=request.query.get("name")),
            }
        )

    def _refresh_node_gauges():
        from . import utils

        snap = node.throughput.snapshot()
        # None: one snapshot is enough — only cpu/gpu are read from sysm
        sysm = utils.get_system_metrics(None)
        _G_TOKENS_PER_SEC.set(snap.get("tokens_per_sec", 0.0))
        _G_TOTAL_TOKENS.set(snap.get("total_tokens", 0))
        _G_TOTAL_REQUESTS.set(snap.get("total_requests", 0))
        _G_PEERS.set(len(node.peers))
        _G_PROVIDERS.set(sum(len(v) for v in node.providers.values()))
        _G_LOCAL_SERVICES.set(len(node.local_services))
        _G_PIECES.set(len(node.piece_store))
        _G_CPU.set(sysm.get("cpu", 0.0))
        _G_ACCEL_MEM.set(sysm.get("gpu", 0.0))
        p50 = snap.get("p50_latency_s")
        if p50 is not None:
            _G_P50_LATENCY.set(p50)
        else:
            # the rolling window is empty: drop the series rather than
            # serve the last measured p50 as if it were current (the
            # pre-registry exposition omitted the line in this case too)
            _G_P50_LATENCY.clear()
        # pipeline stage idleness: bee2bee_pipeline_bubble_
        # fraction is DERIVED from the tracer's stage.task spans, so a
        # scrape recomputes it over the trailing window (and clears it
        # when this node served no stage traffic — never-throw inside)
        health.local_stage_idleness()
        # engine economics: MFU/goodput/HBM-ledger gauges are
        # provider-derived the same way — refresh them at scrape time
        health.run_digest_providers()

    async def metrics(request):
        """The node's metrics registry (metrics.py): Prometheus text
        exposition by default — node gauges plus every registered serving
        series (TTFT/inter-token/queue-wait histograms, block-pool
        occupancy, mesh frame counters, ...). Content-negotiated:
        ``?format=json`` or ``Accept: application/json`` returns the JSON
        snapshot (bucket counts + estimated percentiles) instead."""
        _refresh_node_gauges()
        reg = get_registry()
        fmt = request.query.get("format")
        accept = request.headers.get("Accept", "")
        if fmt == "json" or (fmt is None and "application/json" in accept):
            return web.json_response(
                {"node": node.peer_id, "metrics": reg.snapshot()}
            )
        return web.Response(
            body=reg.render().encode("utf-8"),
            headers={"Content-Type": PROMETHEUS_CONTENT_TYPE},
        )

    # ---- health plane (health.py): the fleet view, SLO status, and the
    # incident flight recorder — the surface the SLO-aware front door
    # (ROADMAP item 3) scrapes/routes on.

    async def mesh_health(request):
        """Merged fleet view: this node's live digest + every FRESH peer
        digest from telemetry gossip, with fleet aggregates. JSON default;
        ``?format=prom`` (or ``Accept: text/plain``) renders Prometheus
        text with one series per fresh peer under a ``peer`` label —
        stale peers' series drop out rather than serving forever."""
        view = fleet_view(
            node.peer_id, node.telemetry_digest(), node.health,
            # scope the fleet aggregate block to the controller's actual
            # replica universe — the endpoint must show the same numbers
            # a scale decision reads, not count every gossiping node
            serving=node.fleet.serving_peers(),
        )
        fmt = request.query.get("format")
        accept = request.headers.get("Accept", "")
        if fmt == "prom" or (fmt is None and "text/plain" in accept):
            return web.Response(
                body=render_fleet_prom(view).encode("utf-8"),
                headers={"Content-Type": PROMETHEUS_CONTENT_TYPE},
            )
        return web.json_response(view)

    def _platform_stamp() -> str:
        """Best-effort accelerator platform for /metrics/history, so
        benchdiff --live can apply the cross-platform refusal. Reads
        torch only if something else already imported it — a control-plane
        node must not pay a torch import for a telemetry stamp."""
        import sys as _sys

        torch = _sys.modules.get("torch")
        if torch is not None:
            try:
                return "gpu" if torch.cuda.is_available() else "cpu"
            except Exception:  # noqa: BLE001 — stamp is best-effort
                pass
        return "unknown"

    def _parse_history_query(request):
        """(names, window_s) shared by /metrics/history + /mesh/history;
        raises web.HTTPBadRequest with a typed body on garbage."""
        names_q = (request.query.get("series") or "").strip()
        names = None
        if names_q:
            names = [n.strip() for n in names_q.split(",") if n.strip()]
            unknown = sorted(n for n in names if n not in SERIES_BY_NAME)
            if unknown:
                raise web.HTTPBadRequest(
                    text=json.dumps({
                        "detail": f"unknown series: {unknown}",
                        "known": list(SERIES_NAMES),
                    }),
                    content_type="application/json",
                )
        try:
            window_s = float(request.query.get("window", 3600.0))
        except ValueError:
            raise web.HTTPBadRequest(
                text=json.dumps({"detail": "window must be a number"}),
                content_type="application/json",
            )
        return names, window_s

    async def metrics_history(request):
        """The observatory's retained time-series (obs/tsring.py):
        ``?series=a,b`` restricts to named series (400 on unknown names),
        ``?window=`` trims to the trailing seconds (default 3600), and
        the payload is delta-encoded by default — ``?format=raw`` returns
        plain ``[[ts, value], ...]`` points instead. The ``platform``
        stamp lets scripts/benchdiff.py --live refuse cross-platform
        comparisons, same rule as recorded artifacts."""
        names, window_s = _parse_history_query(request)
        raw = request.query.get("format") == "raw"
        return web.json_response({
            "node": node.peer_id,
            "cadence_s": node.obs.cadence_s,
            "window_s": window_s,
            "retained": len(node.obs.ring),
            "platform": _platform_stamp(),
            "encoding": "raw" if raw else "delta",
            "series": node.obs.history(names, window_s, raw=raw),
        })

    async def mesh_history(request):
        """Fleet-level curves: this node's retained history merged with
        every connected peer's (fetched from their /metrics/history —
        same best-effort fan-out as /trace?stitch=1: unreachable peers
        and peers with no advertised API endpoint are typed, never
        silently dropped). The ``fleet`` block buckets all reporters
        onto the sampling-cadence grid and aggregates each series by its
        catalog rule — throughput sums, levels average."""
        names, window_s = _parse_history_query(request)
        peers_out: dict[str, dict] = {
            node.peer_id: {"series": node.obs.history(names, window_s, raw=True)}
        }
        import aiohttp

        async def fetch_history(s, pid, host, port):
            try:
                params = {"window": str(window_s), "format": "raw"}
                if names:
                    params["series"] = ",".join(names)
                async with s.get(
                    f"http://{host}:{port}/metrics/history",
                    params=params,
                    timeout=aiohttp.ClientTimeout(total=3),
                ) as r:
                    if r.status == 200:
                        got = await r.json()
                        if isinstance(got, dict) and isinstance(
                            got.get("series"), dict
                        ):
                            return pid, {"series": got["series"]}
            except Exception:  # noqa: BLE001 — merge what answers
                pass
            return pid, {"unreachable": True}

        tasks = []
        for pid, info in list(node.peers.items()):
            if info.get("api_host") and info.get("api_port"):
                tasks.append((pid, info["api_host"], info["api_port"]))
            else:
                peers_out[pid] = {"no_endpoint": True}
        if tasks:
            async with aiohttp.ClientSession() as s:
                got = await asyncio.gather(*(
                    fetch_history(s, pid, host, port)
                    for pid, host, port in tasks
                ))
            peers_out.update({pid: entry for pid, entry in got})
        cadence = node.obs.cadence_s
        fleet: dict[str, list] = {}
        for name in (names or SERIES_NAMES):
            spec = SERIES_BY_NAME[name]
            buckets: dict[int, list[float]] = {}
            for entry in peers_out.values():
                for point in (entry.get("series") or {}).get(name) or []:
                    try:
                        t, v = float(point[0]), float(point[1])
                    except (TypeError, ValueError, IndexError):
                        continue
                    buckets.setdefault(int(t // cadence), []).append(v)
            if not buckets:
                continue
            fleet[name] = [
                [
                    round(b * cadence, 3),
                    round(
                        sum(vs) if spec.agg == "sum" else sum(vs) / len(vs), 6
                    ),
                ]
                for b, vs in sorted(buckets.items())
            ]
        return web.json_response({
            "node": node.peer_id,
            "cadence_s": cadence,
            "window_s": window_s,
            "agg": {n: SERIES_BY_NAME[n].agg for n in (names or SERIES_NAMES)},
            "peers": peers_out,
            "fleet": fleet,
        })

    async def slo(request):
        """Per-objective SLO status: a FRESH burn-rate evaluation (also
        refreshes the bee2bee_slo_* gauges served by /metrics)."""
        return web.json_response(
            {
                "node": node.peer_id,
                "windows": {
                    "fast_s": node.slo.fast_window_s,
                    "slow_s": node.slo.slow_window_s,
                },
                "trip_burn_rate": node.slo.trip_burn_rate,
                "objectives": node.slo.status(),
            }
        )

    async def admin_drain(request):
        """Graceful drain (docs/ROBUSTNESS.md "Live migration & drain"):
        flips the node to draining — new requests 503 typed ``draining``
        with Retry-After, the drain state rides the telemetry digest so
        peers stop routing here — and migrates every in-flight generation
        to scored-healthy peers (KV export; re-prefill fallback). Body:
        ``{"stop": true}`` additionally exits the node with a clean
        GOODBYE once the last bridged stream finishes; ``{"wait": false}``
        returns immediately with ``pending`` instead of blocking until
        the bridged generations complete (long generations can hold the
        default waiting response open for minutes — poll GET /admin/drain
        for progress then).

        ADMIN surface: the first destructive action the API exposes.
        Tenant API keys (which open the serving routes) do NOT open it —
        only the node key, or loopback when no key is configured
        (_auth_ok with tenants=None is exactly that rule)."""
        if not _auth_ok(request, api_key, None):
            return web.json_response(
                {"detail": "drain requires the node API key"},
                status=403, headers=cors,
            )
        body = {}
        if request.can_read_body:
            with_suppress = False
            try:
                body = await request.json()
            except (json.JSONDecodeError, UnicodeDecodeError):
                with_suppress = True
            if with_suppress or not isinstance(body, dict):
                return web.json_response(
                    {"detail": "invalid JSON body"}, status=400
                )
        summary = await node.begin_drain(
            stop=bool(body.get("stop")),
            wait=bool(body.get("wait", True)),
        )
        return web.json_response(summary)

    async def admin_drain_status(request):
        return web.json_response({
            "draining": node.draining,
            "migration": dict(node.migration.stats),
        })

    async def fleet_status(request):
        """Elastic fleet control surface (fleet/controller.py): lease
        view, leader role, latest controller aggregates, the bounded
        decision journal (noops included — the operator sees WHY nothing
        happened), in-flight action and config."""
        return web.json_response(node.fleet.status())

    async def fleet_override(request):
        """Manual override (docs/ROBUSTNESS.md "Elastic fleet control"):
        body ``{"action": "scale_out"|"scale_in"|"pause"|"resume",
        "target": <peer_id, optional>}``. Scale actions bypass the
        hysteresis but NOT the probe gate or the one-in-flight rule, and
        only the lease holder runs them (409 points at the leader).
        ADMIN surface, same rule as /admin/drain: tenant keys do not
        open it."""
        if not _auth_ok(request, api_key, None):
            return web.json_response(
                {"detail": "fleet override requires the node API key"},
                status=403, headers=cors,
            )
        body = await _json_body(request)
        action = body.get("action")
        if not action:
            return web.json_response({"detail": "action required"}, status=400)
        out = await node.fleet.override(
            str(action), target=body.get("target")
        )
        if out.get("ok"):
            return web.json_response(out)
        status = 409 if out.get("error") in (
            "not_leader", "action_in_flight"
        ) else 400
        return web.json_response(out, status=status)

    async def debug_incidents(request):
        """Flight-recorder surface: ``?id=<incident id>`` fetches one full
        on-disk bundle; otherwise the newest-first bundle index plus the
        live ring tail (the events an incident WOULD snapshot right now)."""
        inc_id = request.query.get("id")
        if inc_id:
            # bundle reads hit disk — off the event loop, same reasoning
            # as the recorder's threaded write path
            bundle = await asyncio.to_thread(node.recorder.load_incident, inc_id)
            if bundle is None:
                return web.json_response(
                    {"detail": f"unknown incident {inc_id!r}"}, status=404
                )
            return web.json_response(bundle)
        try:
            limit = min(500, max(1, int(request.query.get("ring", 50))))
        except ValueError:
            return web.json_response({"detail": "ring must be an int"}, status=400)
        return web.json_response(
            {
                "node": node.peer_id,
                "incidents": await asyncio.to_thread(node.recorder.list_incidents),
                "ring": node.recorder.events(limit=limit),
            }
        )

    async def debug_profile(request):
        """On-demand device profiling (docs/OBSERVABILITY.md "Engine
        economics"). The capture behind it (engine/introspect.py) is not
        ported: the route answers a typed 501 in the gateway's error shape,
        naming the ROADMAP item that ports it.

        ADMIN surface, same rule as /admin/drain: a device profile leaks
        whole-node execution detail, so tenant keys do not open it."""
        from .unported import unported

        if not _auth_ok(request, api_key, None):
            return web.json_response(
                {"detail": "device profiling requires the node API key"},
                status=403, headers=cors,
            )
        err = unported("device profiling (/debug/profile, engine/introspect.py)", 6)
        return web.json_response(
            {"detail": str(err), "error_kind": "not_implemented"}, status=501,
        )

    # ---- OpenAI-compatible surface (/v1): standard SDKs and tools can
    # point at a mesh node unchanged (base_url="http://node:4002/v1").
    # Completions/chat map onto the same local-first + P2P-fallback path
    # as /chat; streaming uses SSE with OpenAI chunk objects.

    async def v1_models(request):
        names = set()
        # list_providers(None) already includes every LOCAL service's
        # metadata alongside mesh providers — one matching rule, one loop
        for prov in node.list_providers(None):
            names.update(prov.get("models") or [])
        return web.json_response({
            "object": "list",
            "data": [
                {"id": n, "object": "model", "owned_by": "bee2bee-tpu"}
                for n in sorted(names)
            ],
        })

    def _openai_params(body, prompt):
        params = {
            "prompt": prompt,
            "max_new_tokens": _int_param(body, ("max_tokens", "max_new_tokens"), 256),
            "temperature": float(body.get("temperature", 1.0)),
        }
        copy_sampling(body, params)
        return params

    def _openai_response(result, model, chat: bool):
        text = result.get("text", "")
        completion_tokens = int(result.get("tokens", 0))
        prompt_tokens = int(result.get("prompt_tokens", 0))
        choice = {
            "index": 0,
            "finish_reason": result.get("finish_reason", "stop"),
        }
        if chat:
            choice["message"] = {"role": "assistant", "content": text}
        else:
            choice["text"] = text
        return {
            "id": f"cmpl-{os.urandom(8).hex()}",
            "object": "chat.completion" if chat else "text_completion",
            "model": model or "",
            "choices": [choice],
            "usage": {
                "prompt_tokens": prompt_tokens,
                "completion_tokens": completion_tokens,
                "total_tokens": prompt_tokens + completion_tokens,
            },
        }

    async def _v1_generate(request, body, prompt, chat: bool):
        model = body.get("model")
        params = _openai_params(body, prompt)
        sse = ("chat" if chat else "text", model or "")
        tenant = _tenant_of(request, node.tenants)
        params["tenant"] = tenant
        # model="<base>:<adapter>" (multi-adapter serving, adapters/):
        # standard OpenAI SDKs select a tenant adapter purely through the
        # model id; a tenant's configured default applies otherwise
        svc, base_model, adapter, affinity = _resolve_model(model, tenant)
        if adapter:
            params["adapter"] = adapter
        if svc is not None:
            if adapter and not await node.ensure_adapter(svc, adapter):
                return web.json_response(
                    {"error": {
                        "message": f"model {model!r} not found "
                                   f"(unknown adapter {adapter!r})",
                        "type": "invalid_request_error",
                        "error_kind": "unknown_adapter",
                    }}, status=404)
            result = await _admit_and_serve_local(
                request, svc, params, bool(body.get("stream")), sse=sse
            )
            if isinstance(result, web.StreamResponse):
                return result
        else:
            provider = node.pick_provider(
                model, prompt=prompt, adapter=adapter or affinity
            )
            if provider is None or provider["local"]:
                return web.json_response(
                    {"error": {"message": f"model {model!r} not found",
                               "type": "invalid_request_error"}}, status=404)
            if bool(body.get("stream")):
                return await _stream_p2p(
                    request, node, provider, params, model, cors, sse=sse,
                    tenant=tenant,
                )
            result = await node.request_generation(
                provider["provider_id"], prompt, model=model,
                max_new_tokens=params["max_new_tokens"],
                temperature=params["temperature"],
                extra=_sampling_extra(params),
                tenant=tenant,
            )
        return web.json_response(_openai_response(result, model, chat))

    async def v1_completions(request):
        body = await _json_body(request)
        prompt = body.get("prompt")
        if isinstance(prompt, list):  # OpenAI allows a list of prompts
            if len(prompt) != 1:
                return web.json_response(
                    {"error": {"message": "only a single prompt is supported",
                               "type": "invalid_request_error"}}, status=400)
            prompt = prompt[0]
        if not prompt:
            return web.json_response(
                {"error": {"message": "prompt required",
                           "type": "invalid_request_error"}}, status=400)
        with get_tracer().span("api.v1.completions", model=body.get("model")):
            return await _v1_generate(request, body, prompt, chat=False)

    async def v1_chat_completions(request):
        body = await _json_body(request)
        prompt = _prompt_from_messages(body.get("messages"))
        if not prompt:
            return web.json_response(
                {"error": {"message": "messages required",
                           "type": "invalid_request_error"}}, status=400)
        # no assistant cue here: services that parse transcripts append it
        # themselves (TPUService._gen_args) — adding one would double it
        with get_tracer().span("api.v1.chat", model=body.get("model")):
            return await _v1_generate(request, body, prompt, chat=True)

    app.router.add_get("/", home)
    app.router.add_get("/peers", peers)
    app.router.add_get("/providers", providers)
    app.router.add_get("/trace", trace)
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/metrics/history", metrics_history)
    app.router.add_get("/mesh/health", mesh_health)
    app.router.add_get("/mesh/history", mesh_history)
    app.router.add_get("/slo", slo)
    app.router.add_get("/debug/incidents", debug_incidents)
    app.router.add_get("/debug/profile", debug_profile)
    app.router.add_post("/debug/profile", debug_profile)
    app.router.add_post("/admin/drain", admin_drain)
    app.router.add_get("/admin/drain", admin_drain_status)
    app.router.add_get("/fleet", fleet_status)
    app.router.add_post("/fleet/override", fleet_override)
    app.router.add_post("/connect", connect)
    app.router.add_post("/chat", chat)
    app.router.add_post("/generate", chat)  # alias (reference api.py:190-191)
    app.router.add_get("/v1/models", v1_models)
    app.router.add_post("/v1/completions", v1_completions)
    app.router.add_post("/v1/chat/completions", v1_chat_completions)
    app.router.add_route("OPTIONS", "/{tail:.*}", lambda r: web.Response(headers=cors))
    return app


def _sampling_extra(params: dict) -> dict:
    extra = copy_sampling(params, {})
    if params.get("adapter"):
        # the adapter selection must survive the P2P hop like any
        # sampling knob — the serving node resolves it against its pool
        extra["adapter"] = params["adapter"]
    return extra


async def _json_body(request: web.Request) -> dict[str, Any]:
    try:
        return await request.json()
    except (json.JSONDecodeError, UnicodeDecodeError):
        raise web.HTTPBadRequest(reason="invalid JSON body")


def _prompt_from_messages(messages) -> str | None:
    """OpenAI-style messages → user:/assistant: transcript (the format the
    reference UI sends, App.jsx:994-998). Content may be the standard
    content-parts array — the text parts are joined (feeding the model a
    list repr would be silent garbage)."""
    if not messages:
        return None

    def text_of(content) -> str:
        if isinstance(content, list):
            return "".join(
                p.get("text", "") for p in content
                if isinstance(p, dict) and p.get("type") in (None, "text")
            )
        return "" if content is None else str(content)

    return "\n".join(
        f"{m.get('role', 'user')}: {text_of(m.get('content'))}" for m in messages
    )


def _make_frame(sse):
    """Line framer for the two stream transports: identity (ndjson) or an
    OpenAI SSE encoder when sse=("chat"|"text", model). Service error
    lines become an SSE error event + [DONE] — a swallowed error would be
    indistinguishable from a short completion."""
    if sse is None:
        return lambda line: line.encode("utf-8")
    kind, model = sse
    sse_id = f"cmpl-{os.urandom(8).hex()}"
    obj_name = "chat.completion.chunk" if kind == "chat" else "text_completion"

    def frame(line: str) -> bytes:
        try:
            obj = json.loads(line)
        except ValueError:
            obj = None
        if not isinstance(obj, dict):
            # a custom service streaming plain-text (or scalar-JSON) lines
            # must not lose output on /v1 — forward the raw line as a
            # delta chunk
            obj = {"text": line}
        if obj.get("status") == "error" or obj.get("error"):
            err = {"error": {"message": obj.get("message") or obj.get("error")
                             or "generation failed", "type": "server_error"}}
            return (f"data: {json.dumps(err)}\n\ndata: [DONE]\n\n").encode()
        if obj.get("done"):
            fin = {"index": 0, "finish_reason": obj.get("finish_reason", "stop")}
            fin["delta" if kind == "chat" else "text"] = {} if kind == "chat" else ""
            payload = {"id": sse_id, "model": model, "object": obj_name,
                       "choices": [fin]}
            return (f"data: {json.dumps(payload)}\n\ndata: [DONE]\n\n").encode()
        text = obj.get("text")
        if not text:
            return b""
        ch = {"index": 0, "finish_reason": None}
        if kind == "chat":
            ch["delta"] = {"content": text}
        else:
            ch["text"] = text
        payload = {"id": sse_id, "model": model, "object": obj_name,
                   "choices": [ch]}
        return f"data: {json.dumps(payload)}\n\n".encode()

    return frame


async def _stream_service(
    request, node: P2PNode, svc, params, cors=(), sse=None, ticket=None
) -> web.StreamResponse:
    """Streaming from a local service: JSON-lines by default, or OpenAI
    SSE chunks when sse=("chat"|"text", model) (the /v1 surface)."""
    import asyncio
    import contextvars
    import threading

    ctype = "text/event-stream" if sse else "application/x-ndjson"
    frame = _make_frame(sse)

    resp = web.StreamResponse(
        headers={"Content-Type": ctype, **dict(cors)}
    )
    await resp.prepare(request)
    loop = asyncio.get_running_loop()
    q: asyncio.Queue = asyncio.Queue()
    DONE = object()
    cancelled = threading.Event()

    def pump():
        try:
            for line in svc.execute_stream(params):
                if cancelled.is_set():
                    break  # client went away: stop pulling from the engine
                loop.call_soon_threadsafe(q.put_nowait, line)
        finally:
            loop.call_soon_threadsafe(q.put_nowait, DONE)

    # span + copy_context mirror node._execute_local (the service lines pass
    # through verbatim here, so we can't reuse it directly)
    import time as _time

    with get_tracer().span("gen.local", service=svc.name, stream=True) as span:
        ctx = contextvars.copy_context()
        task = loop.run_in_executor(None, ctx.run, pump)
        chunks = 0
        text_chars = 0
        t0 = _time.time()
        try:
            while True:
                item = await q.get()
                if item is DONE:
                    break
                chunks += 1
                try:  # count streamed text for the node's measured throughput
                    obj = json.loads(item)
                    text_chars += len(obj.get("text") or "")
                    # the span must tell the request's story, not just its
                    # setup: real token count + timing ride the done line,
                    # service failures ride error lines
                    if obj.get("done"):
                        if obj.get("tokens") is not None:
                            span.attrs["tokens"] = int(obj["tokens"])
                            if ticket is not None:
                                # per-tenant completed-token accounting
                                # must not exclude streaming traffic
                                ticket.note_tokens(int(obj["tokens"]))
                        if obj.get("timing") is not None:
                            span.attrs["timing"] = obj["timing"]
                    if obj.get("status") == "error":
                        span.error = str(obj.get("message") or "stream error")
                except (ValueError, AttributeError, TypeError):
                    # metrics must never kill a stream: non-object lines or
                    # non-string "text" from custom services pass through
                    pass
                await resp.write(frame(item))
            await resp.write_eof()
        except (ConnectionResetError, asyncio.CancelledError):
            logger.info("stream client disconnected; aborting generation pump")
            raise
        finally:
            span.attrs["chunks"] = chunks
            cancelled.set()
            await task
            # node-level measured throughput must not miss the streaming
            # path (chars/4 = the reference's own token estimate)
            node.throughput.record(max(0, text_chars // 4), _time.time() - t0)
    return resp


async def _stream_p2p(
    request, node: P2PNode, provider, params, model, cors=(), sse=None,
    tenant=None,
) -> web.StreamResponse:
    import asyncio

    frame = _make_frame(sse)
    q: asyncio.Queue = asyncio.Queue()

    def on_chunk(text):
        q.put_nowait(json.dumps({"text": text}) + "\n")

    gen_task = asyncio.create_task(
        node.request_generation(
            provider["provider_id"],
            params["prompt"],
            model=model,
            max_new_tokens=params["max_new_tokens"],
            temperature=params["temperature"],
            stream=True,
            on_chunk=on_chunk,
            extra=_sampling_extra(params),
            tenant=tenant,
        )
    )
    resp = None
    getter = asyncio.create_task(q.get())
    try:
        while True:
            done, _ = await asyncio.wait({getter, gen_task}, return_when=asyncio.FIRST_COMPLETED)
            if resp is None:
                # the FIRST event decides the response: a failure arriving
                # before any chunk (typed remote shed, dead provider) must
                # surface as a real HTTP status — the middleware turns an
                # AdmissionReject into 429/503 + Retry-After — not as a 200
                # whose body smuggles an error line no backoff logic reads
                if getter not in done and gen_task.exception() is not None:
                    raise gen_task.exception()
                resp = web.StreamResponse(
                    headers={
                        "Content-Type": (
                            "text/event-stream" if sse else "application/x-ndjson"
                        ),
                        **dict(cors),
                    }
                )
                await resp.prepare(request)
            if getter in done:
                await resp.write(frame(getter.result()))
                getter = asyncio.create_task(q.get())
                continue
            # cancel BEFORE draining: a live q.get() would steal a chunk
            # from the post-completion drain below
            getter.cancel()
            try:
                await gen_task
                while not q.empty():
                    await resp.write(frame(q.get_nowait()))
                await resp.write(frame(json.dumps({"done": True}) + "\n"))
            except Exception as e:
                # mid-stream failure: the 200 is already on the wire — the
                # in-stream error line is all that's left to say
                await resp.write(
                    frame(json.dumps({"status": "error", "message": str(e)}) + "\n")
                )
            break
        await resp.write_eof()
        return resp
    finally:
        # an abandoned stream (client hung up: resp.prepare/write raises,
        # or aiohttp cancels the handler) must not leave the generation
        # decoding to its token budget for nobody, nor a q.get() task
        # dangling for the GC to cancel
        if not getter.done():
            getter.cancel()
        if not gen_task.done():
            gen_task.cancel()
            with contextlib.suppress(BaseException):
                await gen_task


async def start_api_server(node: P2PNode, host: str, port: int, api_key: str | None = None):
    """Start the gateway; returns the aiohttp AppRunner (await .cleanup())."""
    runner = web.AppRunner(build_app(node, api_key=api_key))
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    await site.start()
    logger.info("api gateway on http://%s:%s", host, port)
    return runner
