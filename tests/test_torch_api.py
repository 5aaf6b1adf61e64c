"""The port's aiohttp gateway (``bee2bee_tpu_torch/api.py``) against the JAX
package's, each over its own package's node and ``FakeService``.

- The route tables are equal.
- ``/chat``, ``/v1/completions`` and ``/v1/chat/completions`` (stream and
  not, plus the typed 4xx answers) answer with the same status codes and
  the same keys, stream line for stream line.
- The node layer registers the same metric names in both packages (each
  in a fresh process), and each gateway's ``/metrics`` carries all of its
  package's.
- ``/debug/profile`` answers with the JAX gateway's status codes and
  keys: a capture (200), the listing, the zip, an unknown id (404), a bad
  duration or body (400), a capture while one runs (409), and the admin
  gate (401 without a key, 403 for a tenant key).
"""

from __future__ import annotations

import json
import subprocess
import sys
from contextlib import asynccontextmanager
from pathlib import Path

import aiohttp
import pytest

from bee2bee_tpu import api as japi
from bee2bee_tpu.meshnet.node import P2PNode as JaxNode
from bee2bee_tpu.services.fake import FakeService as JaxFakeService
from bee2bee_tpu.transport import LoopbackTransport as JaxLoopback
from bee2bee_tpu_torch import api
from bee2bee_tpu_torch.meshnet.node import P2PNode
from bee2bee_tpu_torch.services.fake import FakeService
from bee2bee_tpu_torch.transport import LoopbackTransport

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {
    "jax": (japi, JaxNode, JaxFakeService, JaxLoopback),
    "port": (api, P2PNode, FakeService, LoopbackTransport),
}
MSGS = [{"role": "user", "content": "hi there"}]
REQUESTS = [
    ("/chat", {"prompt": "hi", "model": "demo"}),
    ("/chat", {"prompt": "hi", "model": "demo", "stream": True}),
    ("/generate", {"prompt": "hi", "model": "demo", "max_new_tokens": 4}),
    ("/chat", {"model": "demo"}),
    ("/chat", {"prompt": "hi", "model": "no-such-model"}),
    ("/v1/completions", {"prompt": "hi", "model": "demo"}),
    ("/v1/completions", {"prompt": "hi", "model": "demo", "stream": True}),
    ("/v1/chat/completions", {"messages": MSGS, "model": "demo"}),
    ("/v1/chat/completions", {"messages": MSGS, "model": "demo", "stream": True}),
    ("/v1/chat/completions", {"model": "demo"}),
]


@asynccontextmanager
async def gateway(pkg: str):
    mod, node_cls, fake_cls, transport = PACKAGES[pkg]
    node = node_cls(host="127.0.0.1", port=0, transport=transport())
    await node.start()
    node.add_service(fake_cls("demo", reply="0123456789", chunk_size=3))
    runner = await mod.start_api_server(node, "127.0.0.1", 0)
    host, port = runner.addresses[0][:2]
    try:
        async with aiohttp.ClientSession(f"http://{host}:{port}") as session:
            yield node, session
    finally:
        await runner.cleanup()
        await node.stop()


def _shape(value):
    """The keys of a JSON value, recursively (values dropped)."""
    if isinstance(value, dict):
        return {k: _shape(v) for k, v in sorted(value.items())}
    if isinstance(value, list):
        return [_shape(v) for v in value[:1]]
    return type(value).__name__ if isinstance(value, (bool, type(None))) else "v"


def _lines(body: str):
    """A response body as JSON shapes: one per line (ndjson or SSE)."""
    out = []
    for line in body.splitlines():
        line = line.removeprefix("data: ").strip()
        if not line:
            continue
        try:
            out.append(_shape(json.loads(line)))
        except json.JSONDecodeError:
            out.append(line)
    return out


async def _answers(pkg: str):
    async with gateway(pkg) as (_, session):
        got = []
        for path, body in REQUESTS:
            async with session.post(path, json=body) as r:
                got.append((path, r.status, r.content_type, _lines(await r.text())))
        return got


def test_route_tables_equal():
    def routes(mod, node_cls):
        app = mod.build_app(node_cls(host="127.0.0.1", port=0))
        return sorted((r.method, r.resource.canonical) for r in app.router.routes())

    assert routes(api, P2PNode) == routes(japi, JaxNode)


@pytest.mark.async_timeout(60)
async def test_generation_routes_answer_alike():
    ours, theirs = await _answers("port"), await _answers("jax")
    assert [a[:3] for a in ours] == [a[:3] for a in theirs]
    for a, b in zip(ours, theirs):
        assert a[3] == b[3], a[:3]
    assert {status for _, status, *_ in ours} >= {200, 400}


def _node_layer_metric_names(pkg: str) -> list[str]:
    code = (
        f"import {pkg}.api\n"
        f"from {pkg}.metrics import get_registry\n"
        "print(sorted(get_registry().snapshot()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.replace("'", '"'))


@pytest.mark.async_timeout(60)
async def test_node_layer_metric_names_equal():
    ours = _node_layer_metric_names("bee2bee_tpu_torch")
    assert ours == _node_layer_metric_names("bee2bee_tpu")
    assert {"mesh.frames_sent", "gen.requests", "admission.requests"} <= set(ours)
    for pkg in PACKAGES:
        async with gateway(pkg) as (_, session):
            async with session.post("/chat", json={"prompt": "hi", "model": "demo"}) as r:
                assert r.status == 200
            async with session.get("/metrics?format=json") as r:
                scraped = set((await r.json())["metrics"])
            async with session.get("/metrics") as r:
                text = await r.text()
        assert set(ours) <= scraped, pkg
        assert "bee2bee_gen_requests" in text


async def _profile_answers(pkg: str, profile_dir) -> list:
    """The /debug/profile walk on one package's gateway: (status, content
    type, JSON shape) of each answer, ids and times dropped."""
    import zipfile
    from io import BytesIO

    from bee2bee_tpu.engine import introspect as jintrospect
    from bee2bee_tpu.router.tenants import TenantRegistry as JaxTenants
    from bee2bee_tpu.router.tenants import parse_tenant_config as jparse
    from bee2bee_tpu_torch.engine import introspect
    from bee2bee_tpu_torch.router.tenants import TenantRegistry, parse_tenant_config

    mod, node_cls, _, transport = PACKAGES[pkg]
    intro, tenants, parse = ((jintrospect, JaxTenants, jparse) if pkg == "jax"
                             else (introspect, TenantRegistry, parse_tenant_config))
    saved = intro._PROFILER
    prof = intro._PROFILER = intro.DeviceProfiler(profile_dir)
    node = node_cls(host="127.0.0.1", port=0, transport=transport())
    node.tenants = tenants(parse({"acme": {"api_key": "tenant-key"}}))
    await node.start()
    runner = await mod.start_api_server(node, "127.0.0.1", 0, api_key="sekrit")
    host, port = runner.addresses[0][:2]
    admin, tenant = {"X-API-KEY": "sekrit"}, {"X-API-KEY": "tenant-key"}
    got = []
    try:
        async with aiohttp.ClientSession(f"http://{host}:{port}") as session:
            async def ask(method, path, headers=None, **kw):
                async with session.request(method, path, headers=headers, **kw) as r:
                    body = await r.read()
                    shape = (_shape(json.loads(body)) if r.content_type == "application/json"
                             else bool(zipfile.ZipFile(BytesIO(body)).namelist()))
                    got.append((method, path.split("?")[0], r.status, r.content_type, shape))
                    return json.loads(body) if r.content_type == "application/json" else None

            await ask("POST", "/debug/profile", json={"duration_s": 0.05})
            await ask("POST", "/debug/profile", tenant, json={"duration_s": 0.05})
            header = await ask("POST", "/debug/profile", admin, json={"duration_s": 0.05})
            await ask("GET", "/debug/profile", tenant)
            listing = await ask("GET", "/debug/profile", admin)
            assert [p["id"] for p in listing["profiles"]] == [header["id"]]
            await ask("GET", f"/debug/profile?id={header['id']}", admin)
            await ask("GET", "/debug/profile?id=prof-unknown", admin)
            await ask("POST", "/debug/profile", admin, json={"duration_s": "soon"})
            await ask("POST", "/debug/profile", admin, json=[1, 2])
            with prof._lock:  # a capture in flight
                prof._active = {"id": "prof-busy", "started": 0.0, "duration_s": 30.0}
            await ask("POST", "/debug/profile", admin, json={"duration_s": 0.05})
    finally:
        intro._PROFILER = saved
        await runner.cleanup()
        await node.stop()
    return got


@pytest.mark.async_timeout(60)
async def test_debug_profile_names_its_roadmap_item(tmp_path):
    """The profile route answers as the JAX gateway's does, status for
    status and key for key (it no longer answers 501)."""
    ours = await _profile_answers("port", tmp_path / "port")
    theirs = await _profile_answers("jax", tmp_path / "jax")
    assert ours == theirs
    assert [a[2] for a in ours] == [401, 403, 200, 403, 200, 200, 404, 400, 400, 409]
    assert ours[-1][4] == {"detail": "v", "error_kind": "v"}
