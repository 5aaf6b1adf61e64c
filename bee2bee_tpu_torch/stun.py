"""STUN client: public endpoint discovery + NAT-type classification.

Capability parity with the reference's ``bee2bee/stun_client.py`` (RFC
5389-style binding request/response, XOR-MAPPED-ADDRESS decode, parallel
multi-server query, NAT-type detection via two-server consistency —
reference stun_client.py:10-180), rebuilt as a pure codec + thin socket
layer so every parsing path is unit-testable against a fake loopback
server instead of the real Internet (the reference's tests hit live STUN
servers with vacuous asserts, reference tests/test_nat_optional.py:1-14).

TPU-relevant because mesh peers behind NAT must learn an announceable
address before they can serve; datacenter TPU hosts usually have public
IPs, so everything here degrades to a no-op gracefully.

PyTorch port: a copy of ``bee2bee_tpu/stun.py`` with the import root rewritten to
``bee2bee_tpu_torch``.
"""

from __future__ import annotations

import os
import secrets
import socket
import struct
import time as _time
from concurrent.futures import ThreadPoolExecutor, as_completed
from dataclasses import dataclass

MAGIC_COOKIE = 0x2112A442
BINDING_REQUEST = 0x0001
BINDING_SUCCESS = 0x0101
ATTR_MAPPED_ADDRESS = 0x0001
ATTR_XOR_MAPPED_ADDRESS = 0x0020
_FAMILY_IPV4 = 0x01

# Well-known public servers; override with BEE2BEE_STUN_SERVERS="host:port,..."
DEFAULT_SERVERS: tuple[tuple[str, int], ...] = (
    ("stun.l.google.com", 19302),
    ("stun1.l.google.com", 19302),
    ("stun2.l.google.com", 19302),
    ("stun.cloudflare.com", 3478),
    ("stun.ekiga.net", 3478),
    ("stun.stunprotocol.org", 3478),
    ("stun.voipstunt.com", 3478),
)


def _servers_from_env() -> tuple[tuple[str, int], ...]:
    raw = os.environ.get("BEE2BEE_STUN_SERVERS", "")
    if not raw:
        return DEFAULT_SERVERS
    out = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.partition(":")
        out.append((host, int(port or 3478)))
    return tuple(out) or DEFAULT_SERVERS


@dataclass(frozen=True)
class StunResult:
    """Public endpoint as seen by one STUN server."""

    ip: str
    port: int
    server: str


def build_binding_request(txn_id: bytes | None = None) -> tuple[bytes, bytes]:
    """Return (packet, transaction_id) for an RFC5389 binding request."""
    txn_id = txn_id or secrets.token_bytes(12)
    if len(txn_id) != 12:
        raise ValueError("transaction id must be 12 bytes")
    header = struct.pack("!HHI", BINDING_REQUEST, 0, MAGIC_COOKIE) + txn_id
    return header, txn_id


def parse_binding_response(data: bytes, txn_id: bytes) -> tuple[str, int] | None:
    """Decode (ip, port) from a binding success response, else None.

    Prefers XOR-MAPPED-ADDRESS; falls back to plain MAPPED-ADDRESS.
    """
    if len(data) < 20:
        return None
    msg_type, msg_len, cookie = struct.unpack("!HHI", data[:8])
    if msg_type != BINDING_SUCCESS or cookie != MAGIC_COOKIE:
        return None
    if data[8:20] != txn_id:
        return None
    body = data[20 : 20 + msg_len]
    plain: tuple[str, int] | None = None
    off = 0
    while off + 4 <= len(body):
        attr_type, attr_len = struct.unpack("!HH", body[off : off + 4])
        val = body[off + 4 : off + 4 + attr_len]
        off += 4 + attr_len + ((4 - attr_len % 4) % 4)  # values pad to 32 bits
        if len(val) < 8 or val[1] != _FAMILY_IPV4:
            continue
        port = struct.unpack("!H", val[2:4])[0]
        addr = struct.unpack("!I", val[4:8])[0]
        if attr_type == ATTR_XOR_MAPPED_ADDRESS:
            port ^= MAGIC_COOKIE >> 16
            addr ^= MAGIC_COOKIE
            return socket.inet_ntoa(struct.pack("!I", addr)), port
        if attr_type == ATTR_MAPPED_ADDRESS:
            plain = socket.inet_ntoa(struct.pack("!I", addr)), port
    return plain


def build_binding_response(
    txn_id: bytes, ip: str, port: int, xor: bool = True
) -> bytes:
    """Encode a binding success response — used by tests' fake server and
    by any peer acting as a rendezvous helper."""
    addr = struct.unpack("!I", socket.inet_aton(ip))[0]
    if xor:
        attr_type = ATTR_XOR_MAPPED_ADDRESS
        port_enc = port ^ (MAGIC_COOKIE >> 16)
        addr_enc = addr ^ MAGIC_COOKIE
    else:
        attr_type = ATTR_MAPPED_ADDRESS
        port_enc, addr_enc = port, addr
    attr = struct.pack("!HHBBHI", attr_type, 8, 0, _FAMILY_IPV4, port_enc, addr_enc)
    return struct.pack("!HHI", BINDING_SUCCESS, len(attr), MAGIC_COOKIE) + txn_id + attr


class STUNClient:
    """Query STUN servers for the public (ip, port) of this host."""

    def __init__(
        self,
        servers: tuple[tuple[str, int], ...] | None = None,
        timeout: float = 2.0,
        source_port: int = 0,
    ):
        self.servers = servers if servers is not None else _servers_from_env()
        self.timeout = timeout
        self.source_port = source_port

    def query_server(
        self, host: str, port: int, sock: socket.socket | None = None
    ) -> StunResult | None:
        """One binding round-trip against a single server.

        Pass an existing bound socket to reuse one local port across
        queries — required for NAT-type comparison, where the NAT mapping
        is keyed by the source port.
        """
        packet, txn_id = build_binding_request()
        own_sock = sock is None
        if own_sock:
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            sock.bind(("0.0.0.0", self.source_port))
        try:
            sock.settimeout(self.timeout)
            sock.sendto(packet, (host, port))
            # drain until our transaction id answers (a reused socket may
            # still hold late replies from a previous query)
            deadline = _time.monotonic() + self.timeout
            while True:
                data, _ = sock.recvfrom(2048)
                decoded = parse_binding_response(data, txn_id)
                if decoded is not None:
                    return StunResult(
                        ip=decoded[0], port=decoded[1], server=f"{host}:{port}"
                    )
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return None
                sock.settimeout(remaining)
        except OSError:
            return None
        finally:
            if own_sock:
                sock.close()

    def get_public_endpoint(self, max_servers: int = 4) -> StunResult | None:
        """Query several servers in parallel; first success returns without
        waiting for the slow/unreachable ones (their threads die on their
        own socket timeouts)."""
        targets = list(self.servers[:max_servers])
        if not targets:
            return None
        pool = ThreadPoolExecutor(max_workers=len(targets))
        try:
            futures = [pool.submit(self.query_server, h, p) for h, p in targets]
            for fut in as_completed(futures):
                res = fut.result()
                if res is not None:
                    return res
            return None
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def detect_nat_type(self) -> str:
        """Classify NAT by consistency of mappings across two servers.

        Returns one of: "blocked", "open", "cone", "symmetric", "unknown".
        Both binding requests leave from ONE local socket, so the NAT holds
        a single mapping for them: same (ip, port) seen by two distinct
        servers → endpoint-independent mapping ("cone"); differing ports →
        "symmetric"; mapping equals a local interface address → "open".
        """
        results: list[StunResult] = []
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            sock.bind(("0.0.0.0", self.source_port))
            for host, port in self.servers:
                res = self.query_server(host, port, sock=sock)
                if res is not None and all(r.server != res.server for r in results):
                    results.append(res)
                if len(results) >= 2:
                    break
        except OSError:
            pass
        finally:
            sock.close()
        if not results:
            return "blocked"
        local_ips = _local_addresses()
        if results[0].ip in local_ips:
            return "open"
        if len(results) < 2:
            return "unknown"
        a, b = results[0], results[1]
        if (a.ip, a.port) == (b.ip, b.port):
            return "cone"
        return "symmetric"


def _local_addresses() -> set[str]:
    addrs = {"127.0.0.1"}
    try:
        for info in socket.getaddrinfo(socket.gethostname(), None, socket.AF_INET):
            addrs.add(info[4][0])
    except OSError:
        pass
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("8.8.8.8", 80))
        addrs.add(s.getsockname()[0])
        s.close()
    except OSError:
        pass
    return addrs
