"""NAT traversal: ordered auto-port-forwarding for mesh nodes.

Capability parity with the reference's ``bee2bee/nat.py`` — the
UPnP → NAT-PMP → PCP → STUN-detection chain (reference nat.py:50-116),
hand-rolled NAT-PMP/PCP request packets (nat.py:207-320), public-IP
discovery with a TTL cache (nat.py:411-441), gateway detection
(nat.py:454-478), mapping cleanup (nat.py:563-580) — rebuilt so that
every wire codec is a pure function (offline-testable against loopback
fakes) and the network chain is data-driven.

Datacenter TPU hosts rarely sit behind consumer NAT, so the whole module
is an optional assist: every step degrades to "no mapping, here's what
we observed" without raising.

PyTorch port: a copy of ``bee2bee_tpu/nat.py`` with the import root rewritten to
``bee2bee_tpu_torch``.
"""

from __future__ import annotations

import os
import secrets
import socket
import struct
import time
from dataclasses import dataclass, field

from .stun import STUNClient

NATPMP_PORT = 5351
PCP_PORT = 5351
NATPMP_VERSION = 0
PCP_VERSION = 2

# NAT-PMP opcodes (RFC 6886)
NATPMP_OP_PUBLIC_ADDR = 0
NATPMP_OP_MAP_UDP = 1
NATPMP_OP_MAP_TCP = 2

# PCP opcodes (RFC 6887)
PCP_OP_MAP = 1
PCP_PROTO_TCP = 6
PCP_PROTO_UDP = 17


@dataclass
class PortMapping:
    """Outcome of one forwarding attempt."""

    ok: bool
    method: str  # "upnp" | "natpmp" | "pcp" | "stun" | "none"
    internal_port: int
    external_port: int = 0
    public_ip: str | None = None
    lifetime: int = 0
    detail: str = ""
    tcp: bool = True  # protocol the mapping was created for (cleanup needs it)
    nonce: bytes | None = None  # PCP: delete must reuse the creating nonce (RFC 6887)


# ----------------------------------------------------------------- NAT-PMP


def build_natpmp_public_addr_request() -> bytes:
    return struct.pack("!BB", NATPMP_VERSION, NATPMP_OP_PUBLIC_ADDR)


def parse_natpmp_public_addr_response(data: bytes) -> str | None:
    if len(data) < 12:
        return None
    version, opcode, result = struct.unpack("!BBH", data[:4])
    if version != NATPMP_VERSION or opcode != NATPMP_OP_PUBLIC_ADDR + 128:
        return None
    if result != 0:
        return None
    return socket.inet_ntoa(data[8:12])


def build_natpmp_map_request(
    internal_port: int, external_port: int, lifetime: int = 3600, tcp: bool = True
) -> bytes:
    opcode = NATPMP_OP_MAP_TCP if tcp else NATPMP_OP_MAP_UDP
    return struct.pack(
        "!BBHHHI", NATPMP_VERSION, opcode, 0, internal_port, external_port, lifetime
    )


def parse_natpmp_map_response(data: bytes) -> tuple[int, int, int] | None:
    """Return (internal_port, external_port, lifetime) on success."""
    if len(data) < 16:
        return None
    version, opcode, result = struct.unpack("!BBH", data[:4])
    if version != NATPMP_VERSION or opcode not in (
        NATPMP_OP_MAP_UDP + 128,
        NATPMP_OP_MAP_TCP + 128,
    ):
        return None
    if result != 0:
        return None
    internal, external, lifetime = struct.unpack("!HHI", data[8:16])
    return internal, external, lifetime


# --------------------------------------------------------------------- PCP


def _ipv4_mapped(ip: str) -> bytes:
    return b"\x00" * 10 + b"\xff\xff" + socket.inet_aton(ip)


def build_pcp_map_request(
    client_ip: str,
    internal_port: int,
    external_port: int,
    lifetime: int = 3600,
    tcp: bool = True,
    nonce: bytes | None = None,
) -> tuple[bytes, bytes]:
    """PCP v2 MAP request (24-byte header + 36-byte MAP payload)."""
    nonce = nonce or secrets.token_bytes(12)
    if len(nonce) != 12:
        raise ValueError("nonce must be 12 bytes")
    header = (
        struct.pack("!BBHI", PCP_VERSION, PCP_OP_MAP, 0, lifetime)
        + _ipv4_mapped(client_ip)
    )
    payload = (
        nonce
        + struct.pack("!B3xHH", PCP_PROTO_TCP if tcp else PCP_PROTO_UDP,
                      internal_port, external_port)
        + _ipv4_mapped("0.0.0.0")  # suggested external address: any
    )
    return header + payload, nonce


def parse_pcp_map_response(data: bytes, nonce: bytes) -> tuple[int, int, str] | None:
    """Return (external_port, lifetime, external_ip) on success."""
    if len(data) < 60:
        return None
    version, op_r, _, result = struct.unpack("!BBBB", data[:4])
    if version != PCP_VERSION or op_r != (PCP_OP_MAP | 0x80) or result != 0:
        return None
    lifetime = struct.unpack("!I", data[4:8])[0]
    body = data[24:]
    if body[:12] != nonce:
        return None
    external_port = struct.unpack("!H", body[18:20])[0]
    external_ip = socket.inet_ntoa(body[20 + 12 : 20 + 16])
    return external_port, lifetime, external_ip


# -------------------------------------------------------------- discovery


def get_gateway_ip() -> str | None:
    """Default-route gateway, via /proc/net/route (Linux) or a .1 guess."""
    try:
        with open("/proc/net/route") as fh:
            for line in fh.readlines()[1:]:
                parts = line.split()
                if len(parts) >= 3 and parts[1] == "00000000":
                    return socket.inet_ntoa(struct.pack("<I", int(parts[2], 16)))
    except (OSError, ValueError):
        pass
    lan = get_lan_ip()
    if lan:
        return ".".join(lan.split(".")[:3] + ["1"])
    return None


def get_lan_ip() -> str | None:
    """None when no route exists (delegates to utils.get_lan_ip)."""
    from .utils import get_lan_ip as _lan

    return _lan(default=None)


_PUBLIC_IP_CACHE: dict[str, tuple[float, str]] = {}
PUBLIC_IP_TTL = 300.0  # reference caches for 5 minutes (nat.py:411-441)

_ECHO_SERVICES = (
    "https://api.ipify.org",
    "https://ifconfig.me/ip",
    "https://icanhazip.com",
    "https://ipinfo.io/ip",
    "https://checkip.amazonaws.com",
    "https://ipecho.net/plain",
)


def get_public_ip(timeout: float = 3.0, use_cache: bool = True) -> str | None:
    """Public IPv4 via HTTPS echo services, falling back to STUN."""
    now = time.monotonic()
    if use_cache:
        hit = _PUBLIC_IP_CACHE.get("ip")
        if hit and now - hit[0] < PUBLIC_IP_TTL:
            return hit[1]
    ip: str | None = None
    try:
        import httpx

        for url in _ECHO_SERVICES:
            try:
                resp = httpx.get(url, timeout=timeout)
                if resp.status_code == 200:
                    candidate = resp.text.strip()
                    socket.inet_aton(candidate)
                    ip = candidate
                    break
            except (httpx.HTTPError, OSError):
                continue
    except ImportError:
        pass
    if ip is None:
        res = STUNClient(timeout=timeout).get_public_endpoint()
        ip = res.ip if res else None
    if ip:
        _PUBLIC_IP_CACHE["ip"] = (now, ip)
    return ip


# ------------------------------------------------------------- forwarder


@dataclass
class PortForwarder:
    """Try each mapping method in order; remember successes for cleanup.

    Order mirrors the reference chain (nat.py:59-64): UPnP (if miniupnpc
    importable) → NAT-PMP → PCP → STUN detection (observe-only).
    """

    gateway: str | None = None
    timeout: float = 2.0
    natpmp_port: int = NATPMP_PORT
    pcp_port: int = PCP_PORT
    mappings: list[PortMapping] = field(default_factory=list)

    def __post_init__(self):
        if self.gateway is None:
            self.gateway = get_gateway_ip()

    def auto_forward(self, port: int, tcp: bool = True) -> PortMapping:
        for attempt in (self._try_upnp, self._try_natpmp, self._try_pcp):
            mapping = attempt(port, tcp)
            if mapping.ok:
                self.mappings.append(mapping)
                return mapping
        mapping = self._try_stun(port)
        if mapping.ok:
            self.mappings.append(mapping)
        return mapping

    # Each _try_* returns a failed PortMapping rather than raising.

    def _try_upnp(self, port: int, tcp: bool) -> PortMapping:
        try:
            import miniupnpc
        except ImportError:
            return PortMapping(False, "upnp", port, detail="miniupnpc not installed")
        try:
            u = miniupnpc.UPnP()
            u.discoverdelay = int(self.timeout * 1000)
            if u.discover() == 0:
                return PortMapping(False, "upnp", port, detail="no IGD found")
            u.selectigd()
            proto = "TCP" if tcp else "UDP"
            if u.addportmapping(port, proto, u.lanaddr, port, "bee2bee_tpu", ""):
                return PortMapping(
                    True, "upnp", port, external_port=port,
                    public_ip=u.externalipaddress(), lifetime=0, tcp=tcp,
                )
            return PortMapping(False, "upnp", port, detail="addportmapping refused")
        except Exception as exc:  # miniupnpc raises bare Exception
            return PortMapping(False, "upnp", port, detail=str(exc))

    def _udp_round_trip(self, packet: bytes, dest: tuple[str, int]) -> bytes | None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            sock.settimeout(self.timeout)
            sock.sendto(packet, dest)
            data, _ = sock.recvfrom(1200)
            return data
        except OSError:
            return None
        finally:
            sock.close()

    def _try_natpmp(self, port: int, tcp: bool) -> PortMapping:
        if not self.gateway:
            return PortMapping(False, "natpmp", port, detail="no gateway")
        dest = (self.gateway, self.natpmp_port)
        data = self._udp_round_trip(build_natpmp_map_request(port, port, tcp=tcp), dest)
        parsed = parse_natpmp_map_response(data) if data else None
        if parsed is None:
            return PortMapping(False, "natpmp", port, detail="no/invalid response")
        _, external, lifetime = parsed
        addr_data = self._udp_round_trip(build_natpmp_public_addr_request(), dest)
        public_ip = parse_natpmp_public_addr_response(addr_data) if addr_data else None
        return PortMapping(
            True, "natpmp", port, external_port=external,
            public_ip=public_ip, lifetime=lifetime, tcp=tcp,
        )

    def _try_pcp(self, port: int, tcp: bool) -> PortMapping:
        if not self.gateway:
            return PortMapping(False, "pcp", port, detail="no gateway")
        client_ip = get_lan_ip() or "0.0.0.0"
        packet, nonce = build_pcp_map_request(client_ip, port, port, tcp=tcp)
        data = self._udp_round_trip(packet, (self.gateway, self.pcp_port))
        parsed = parse_pcp_map_response(data, nonce) if data else None
        if parsed is None:
            return PortMapping(False, "pcp", port, detail="no/invalid response")
        external_port, lifetime, external_ip = parsed
        return PortMapping(
            True, "pcp", port, external_port=external_port,
            public_ip=external_ip, lifetime=lifetime, tcp=tcp, nonce=nonce,
        )

    def _try_stun(self, port: int) -> PortMapping:
        """Observe-only: learns the public address but maps nothing."""
        res = STUNClient(timeout=self.timeout).get_public_endpoint()
        if res is None:
            return PortMapping(False, "none", port, detail="all methods failed")
        return PortMapping(
            True, "stun", port, external_port=res.port, public_ip=res.ip,
            detail="observed via STUN; no mapping created",
        )

    def cleanup(self) -> int:
        """Remove created mappings (zero-lifetime re-request / UPnP delete)."""
        removed = 0
        for m in self.mappings:
            if not m.ok:
                continue
            try:
                if m.method == "upnp":
                    import miniupnpc

                    u = miniupnpc.UPnP()
                    u.discoverdelay = int(self.timeout * 1000)
                    if u.discover() > 0:
                        u.selectigd()
                        u.deleteportmapping(m.external_port, "TCP" if m.tcp else "UDP")
                        removed += 1
                elif m.method == "natpmp" and self.gateway:
                    self._udp_round_trip(
                        build_natpmp_map_request(
                            m.internal_port, 0, lifetime=0, tcp=m.tcp
                        ),
                        (self.gateway, self.natpmp_port),
                    )
                    removed += 1
                elif m.method == "pcp" and self.gateway:
                    packet, _ = build_pcp_map_request(
                        get_lan_ip() or "0.0.0.0", m.internal_port, 0,
                        lifetime=0, tcp=m.tcp, nonce=m.nonce,
                    )
                    self._udp_round_trip(packet, (self.gateway, self.pcp_port))
                    removed += 1
            except Exception:
                continue
        self.mappings = [m for m in self.mappings if not m.ok]
        return removed


def auto_forward_port(port: int, tcp: bool = True) -> PortMapping:
    """One-shot helper mirroring the reference's module-level wrapper
    (reference nat.py:584-609)."""
    if os.environ.get("BEE2BEE_DISABLE_NAT", "").lower() in ("1", "true", "yes"):
        return PortMapping(False, "none", port, detail="disabled by env")
    return PortForwarder().auto_forward(port, tcp=tcp)
