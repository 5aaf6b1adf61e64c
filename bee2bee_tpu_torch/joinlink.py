"""Join-link codec: deep links that encode bootstrap addresses.

Capability parity with reference p2p.py (bee2bee/p2p.py:8-52):
`coithub.org://join?...`-style links with URL-safe-base64 bootstrap addrs,
sha256 helper, chunking and bitfield helpers. Links use the
`bee2bee-tpu://join?node=...&addrs=...` schema natively; the parser ALSO
accepts a verbatim reference-generated link (`network`/`model`/`hash` plus
repeated `bootstrap=<b64>` keys, reference p2p.py:8-15) so a node can join
a swarm advertised by either implementation.

PyTorch port: a copy of ``bee2bee_tpu/joinlink.py`` with the import root rewritten to
``bee2bee_tpu_torch``; comments that cited the JAX package's change history or the
reference checkout's path are trimmed.
"""

from __future__ import annotations

import base64
from urllib.parse import parse_qs, quote, urlparse

from .utils import sha256_hex

SCHEME = "bee2bee-tpu"


def _b64e(s: str) -> str:
    return base64.urlsafe_b64encode(s.encode("utf-8")).decode("ascii").rstrip("=")


def _b64d(s: str) -> str:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad).decode("utf-8")


def generate_join_link(node_id: str, bootstrap_addrs: list[str], name: str | None = None) -> str:
    """Encode node id + bootstrap WS addrs into a deep link
    (reference p2p.py:8-15)."""
    addrs = ",".join(_b64e(a) for a in bootstrap_addrs)
    link = f"{SCHEME}://join?node={quote(node_id)}&addrs={addrs}"
    if name:
        link += f"&name={quote(name)}"
    return link


def parse_join_link(link: str) -> dict:
    """Decode a join link → {node_id, bootstrap_addrs, name, ...}
    (reference p2p.py:18-36).

    Accepts both dialects:
    - native:    bee2bee-tpu://join?node=ID&addrs=<b64>,<b64>[&name=N]
    - reference: coithub.org://join?network=NET&model=M&hash=H
                 &bootstrap=<b64>&bootstrap=<b64>   (repeated keys,
                 reference p2p.py:8-15; scheme may also be `coithub`)
    Reference-dialect links surface their extra fields as `network`,
    `model`, `hash` so callers can route/verify; `node_id` falls back to
    the network name.
    """
    parsed = urlparse(link)
    if parsed.scheme not in (SCHEME, "coithub", "coithub.org", "https", "http"):
        raise ValueError(f"unrecognized join link scheme: {parsed.scheme!r}")
    qs = parse_qs(parsed.query)  # parse_qs already percent-decodes
    out: dict = {}
    if "bootstrap" in qs:  # reference dialect: one b64 addr per repeated key
        addrs = [_b64d(b) for b in qs["bootstrap"] if b]
        out["network"] = qs.get("network", [""])[0] or None
        out["model"] = qs.get("model", [""])[0] or None
        out["hash"] = qs.get("hash", [""])[0] or None
        node = qs.get("node", [""])[0] or out["network"] or ""
    else:
        raw_addrs = qs.get("addrs", [""])[0]
        addrs = [_b64d(a) for a in raw_addrs.split(",") if a]
        node = qs.get("node", [""])[0]
    name = qs.get("name", [""])[0] or None
    if not addrs:
        raise ValueError("join link has no bootstrap addresses")
    return {"node_id": node, "bootstrap_addrs": addrs, "name": name, **out}


def chunk_bytes(data: bytes, size: int) -> list[bytes]:
    """Split bytes into fixed-size chunks (reference p2p.py:43-44)."""
    if size <= 0:
        raise ValueError("chunk size must be positive")
    return [data[i : i + size] for i in range(0, len(data), size)] or [b""]


def bitfield_from_pieces(have: set[int] | list[int], total: int) -> bytes:
    """Pack piece-possession into a bitfield (reference p2p.py:47-52)."""
    have = set(have)
    out = bytearray((total + 7) // 8)
    for i in have:
        if 0 <= i < total:
            out[i // 8] |= 1 << (7 - (i % 8))
    return bytes(out)


def pieces_from_bitfield(bitfield: bytes, total: int) -> set[int]:
    out = set()
    for i in range(total):
        if bitfield[i // 8] & (1 << (7 - (i % 8))):
            out.add(i)
    return out


sha256_hex_bytes = sha256_hex  # reference name (p2p.py:39-40)
