"""Tunnel helpers: expose a mesh node from behind NAT via a public tunnel.

The reference's cloud-node story is four Colab notebooks that shell out to
ngrok/bore/cloudflared and paste the public address into a join link
(notebook/ConnectIT_Cloud_Node.ipynb and the -BORE/-NGROK
variants — behavior studied). This module is the reusable core those
notebooks lacked: detect an available tunnel binary, open a TCP tunnel to
the node's WS port, parse the public address from the provider's output,
and rewrite the node's join link/announce address to the tunneled endpoint.

Design notes:
- Pure parser functions per provider (parse_bore_line / parse_ngrok_api /
  parse_cloudflared_line) so the address extraction is testable without
  the binaries or network; the process plumbing is a thin shell on top.
- The "stub" provider returns a fixed public address without spawning
  anything — tests and the notebook's dry-run path use it.
- Tunnels carry raw TCP (the mesh speaks ws:// over it). cloudflared's
  quick tunnels are HTTPS-only, so its URL maps to wss://; bore/ngrok
  map to ws://host:port.

CLI: ``--tunnel bore|ngrok|cloudflared|stub|auto`` on the serve commands
(bee2bee_tpu/__main__.py) wires this into run_p2p_node; docs recipe in
docs/CLOUD_NODE.md; notebook in notebook/cloud_node.ipynb.

PyTorch port: a copy of ``bee2bee_tpu/tunnel.py`` with the import root rewritten to
``bee2bee_tpu_torch``; comments that cited the JAX package's change history or the
reference checkout's path are trimmed.
"""

from __future__ import annotations

import json
import logging
import re
import shutil
import subprocess
import threading
import time
import urllib.request
from dataclasses import dataclass, field

logger = logging.getLogger("bee2bee_tpu_torch.tunnel")

PROVIDERS = ("bore", "ngrok", "cloudflared")
DEFAULT_BORE_SERVER = "bore.pub"
NGROK_API = "http://127.0.0.1:4040/api/tunnels"


# ------------------------------------------------------------- pure parsers


def parse_bore_line(line: str, server: str = DEFAULT_BORE_SERVER) -> str | None:
    """bore prints ``listening at bore.pub:35735`` (also via its log line
    ``remote_port=35735``). Returns ``ws://host:port`` or None."""
    m = re.search(r"listening at ([\w.\-]+):(\d+)", line)
    if m:
        return f"ws://{m.group(1)}:{m.group(2)}"
    m = re.search(r"remote_port[=:]\s*(\d+)", line)
    if m:
        return f"ws://{server}:{m.group(1)}"
    return None


def parse_cloudflared_line(line: str) -> str | None:
    """cloudflared quick tunnels print ``https://<name>.trycloudflare.com``
    (TLS-terminated → the mesh dials it as wss://)."""
    m = re.search(r"https://([\w\-]+\.trycloudflare\.com)", line)
    if m:
        return f"wss://{m.group(1)}"
    return None


def parse_ngrok_api(payload: str | dict, local_port: int) -> str | None:
    """The ngrok agent's local API lists tunnels; pick the TCP tunnel that
    fronts our port. ``tcp://0.tcp.ngrok.io:NNNN`` → ``ws://...``."""
    data = json.loads(payload) if isinstance(payload, str) else payload
    for t in data.get("tunnels", []):
        addr = t.get("config", {}).get("addr", "")
        if addr.endswith(f":{local_port}") and t.get("public_url", "").startswith("tcp://"):
            host_port = t["public_url"][len("tcp://"):]
            return f"ws://{host_port}"
    return None


# --------------------------------------------------------------- processes


@dataclass
class Tunnel:
    provider: str
    local_port: int
    ws_url: str  # public address the mesh can dial
    proc: subprocess.Popen | None = None
    _log_tail: list[str] = field(default_factory=list)

    def close(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        self.proc = None

    @property
    def host(self) -> str:
        return self.ws_url.split("://", 1)[1].rsplit(":", 1)[0]

    @property
    def port(self) -> int:
        tail = self.ws_url.split("://", 1)[1]
        if ":" in tail:
            return int(tail.rsplit(":", 1)[1])
        return 443 if self.ws_url.startswith("wss") else 80


def detect_providers() -> list[str]:
    """Tunnel binaries present on PATH, in preference order."""
    return [p for p in PROVIDERS if shutil.which(p)]


def _pump_lines(proc: subprocess.Popen, sink: list[str], parse, found: list):
    """Reader thread: collect output lines, stop parsing once found."""
    for raw in iter(proc.stdout.readline, b""):
        line = raw.decode("utf-8", "replace").rstrip()
        sink.append(line)
        if len(sink) > 50:
            del sink[:-50]
        if not found:
            url = parse(line)
            if url:
                found.append(url)


def open_tunnel(
    local_port: int,
    provider: str = "auto",
    timeout: float = 30.0,
    bore_server: str = DEFAULT_BORE_SERVER,
) -> Tunnel:
    """Spawn a tunnel for ``local_port`` and wait for its public address.

    ``stub`` never spawns anything (tests / dry runs). ``auto`` picks the
    first binary found on PATH. Raises RuntimeError when no provider is
    available or the address never appears within ``timeout``."""
    if provider == "stub":
        return Tunnel("stub", local_port, f"ws://stub.tunnel.invalid:{local_port}")
    if provider == "auto":
        avail = detect_providers()
        if not avail:
            raise RuntimeError(
                "no tunnel binary found (install one of: bore, ngrok, "
                "cloudflared) — or pass --tunnel stub for a dry run"
            )
        provider = avail[0]

    if provider == "bore":
        cmd = ["bore", "local", str(local_port), "--to", bore_server]
        parse = lambda line: parse_bore_line(line, bore_server)  # noqa: E731
    elif provider == "cloudflared":
        # quick tunnels proxy HTTP(S) origins only — which is exactly what
        # the node's WS listener is (WebSocket = HTTP upgrade); a tcp://
        # origin would need an authenticated tunnel + client-side
        # `cloudflared access` and would make the wss address undialable
        cmd = ["cloudflared", "tunnel", "--url", f"http://127.0.0.1:{local_port}"]
        parse = parse_cloudflared_line
    elif provider == "ngrok":
        cmd = ["ngrok", "tcp", str(local_port), "--log", "stdout"]
        parse = lambda line: None  # noqa: E731 — ngrok's address comes from its API
    else:
        raise ValueError(f"unknown tunnel provider {provider!r}")

    if shutil.which(cmd[0]) is None:
        raise RuntimeError(f"{cmd[0]} not found on PATH")
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True,  # our SIGINT must not kill the tunnel
    )
    tail: list[str] = []
    found: list[str] = []
    threading.Thread(
        target=_pump_lines, args=(proc, tail, parse, found), daemon=True
    ).start()

    deadline = time.time() + timeout
    while time.time() < deadline:
        if found:
            return Tunnel(provider, local_port, found[0], proc, tail)
        if provider == "ngrok":  # poll the agent's local API
            try:
                with urllib.request.urlopen(NGROK_API, timeout=2) as r:
                    url = parse_ngrok_api(r.read().decode(), local_port)
                if url:
                    return Tunnel(provider, local_port, url, proc, tail)
            except Exception:  # noqa: BLE001 — agent not up yet
                pass
        if proc.poll() is not None:
            break
        time.sleep(0.3)
    proc.terminate()
    raise RuntimeError(
        f"{provider} tunnel did not yield a public address in {timeout:.0f}s; "
        f"last output: {tail[-3:]}"
    )


async def open_tunnel_async(
    local_port: int,
    provider: str = "auto",
    timeout: float = 30.0,
    bore_server: str = DEFAULT_BORE_SERVER,
) -> Tunnel:
    """Async front for :func:`open_tunnel`, whose polling core sleeps and
    does sync HTTP (the ngrok agent probe) — that must never run on the
    node's event loop (meshlint ML-A001 bug class), so it runs in a worker
    thread. run_p2p_node boots tunnels through this."""
    import asyncio

    return await asyncio.to_thread(
        open_tunnel, local_port, provider=provider,
        timeout=timeout, bore_server=bore_server,
    )


def apply_to_node(node, tunnel: Tunnel) -> str:
    """Point the node's announce address at the tunnel and return the
    tunneled join link (what a remote peer actually dials). A wss tunnel
    (cloudflared terminates TLS) must announce wss:// — P2PNode.addr
    would otherwise advertise plaintext ws:// into a TLS endpoint."""
    node.announce_host = tunnel.host
    node.announce_port = tunnel.port
    node.announce_scheme = tunnel.ws_url.split("://", 1)[0]
    return node.join_link()
