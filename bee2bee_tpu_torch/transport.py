"""The Transport seam: one dial/serve/send/close contract, three backends.

Historically `meshnet/node.py` imported `websockets` directly (falling
back to the `wscompat` loopback shim when the package is absent), which
welded the mesh to real sockets: no way to run 200 nodes in-process with
deterministic delivery, injected latency, loss, or partitions. This
module narrows everything the mesh uses into a `Transport` interface and
re-homes both existing paths behind it:

- `WebsocketsTransport` — the real `websockets` package (RFC 6455, TLS,
  wire compatibility with the reference's JS bridge).
- `LoopbackTransport` — the `wscompat` shim (plain asyncio streams with
  private length-prefixed framing; tests and single-host dev meshes).
- `simnet.SimTransport` — the in-process virtual network (seeded
  delivery order, per-link latency/loss, partitionable regions).

The contract is the narrow slice of the websockets API the codebase
actually exercises (wscompat's module docstring enumerates it):

- `await transport.serve(handler, host, port, max_size=...)` → server
  handle with `.sockets`, `.close()` (listener AND established
  connections), `await .wait_closed()`.
- `await transport.dial(addr, max_size=..., open_timeout=...)` →
  connection with `await .send(str|bytes)`, `await .recv()`,
  `await .close()`, async iteration ending on any close.
- `transport.exceptions.ConnectionClosed` family for except clauses.

Backends are free to expose richer objects (the real package's protocol
instances pass through untouched); the mesh only relies on the slice
above.

PyTorch port: a copy of ``bee2bee_tpu/transport.py`` with the import root
rewritten to ``bee2bee_tpu_torch``. ``WebsocketsTransport`` imports
``websockets.exceptions`` explicitly.
"""

from __future__ import annotations

from typing import Any


class Transport:
    """Transport interface. `exceptions` must expose a ConnectionClosed
    attribute usable in except clauses; `dial`/`serve` follow the
    websockets `connect`/`serve` shapes documented above."""

    #: exception namespace; backends override with their own family
    exceptions: Any = None

    #: human tag for logs / bench stamps
    name = "abstract"

    async def dial(self, addr: str, *, max_size: int | None = None,
                   open_timeout: float = 10) -> Any:
        raise NotImplementedError

    async def serve(self, handler, host: str, port: int, *,
                    max_size: int | None = None) -> Any:
        raise NotImplementedError


class WebsocketsTransport(Transport):
    """Real `websockets` package. Constructed lazily so importing this
    module never requires the dependency."""

    name = "websockets"

    def __init__(self):
        import websockets  # noqa: F401 — hard dependency of this backend
        # explicit: some websockets releases do not bind the submodule on a
        # bare `import websockets`
        import websockets.exceptions

        self._ws = websockets
        self.exceptions = websockets.exceptions

    async def dial(self, addr: str, *, max_size: int | None = None,
                   open_timeout: float = 10):
        return await self._ws.connect(
            addr, max_size=max_size, open_timeout=open_timeout
        )

    async def serve(self, handler, host: str, port: int, *,
                    max_size: int | None = None):
        return await self._ws.serve(handler, host, port, max_size=max_size)


class LoopbackTransport(Transport):
    """The wscompat shim as a Transport: plain asyncio streams, private
    framing, ws:// only. Both ends of a link must use it — exactly the
    tests / single-host-dev situation it exists for."""

    name = "loopback"

    def __init__(self):
        from . import wscompat

        self._ws = wscompat
        self.exceptions = wscompat.exceptions

    async def dial(self, addr: str, *, max_size: int | None = None,
                   open_timeout: float = 10):
        return await self._ws.connect(
            addr, max_size=max_size, open_timeout=open_timeout
        )

    async def serve(self, handler, host: str, port: int, *,
                    max_size: int | None = None):
        return await self._ws.serve(handler, host, port, max_size=max_size)


_DEFAULT: Transport | None = None


def default_transport() -> Transport:
    """The process-default transport: real websockets when the package is
    importable, else the loopback shim — the same fallback the mesh has
    always had, now expressed as backend selection. Cached: both backends
    are stateless dial/serve factories."""
    global _DEFAULT
    if _DEFAULT is None:
        try:
            _DEFAULT = WebsocketsTransport()
        except ImportError:
            _DEFAULT = LoopbackTransport()
    return _DEFAULT


def resolve_transport(transport: Transport | None) -> Transport:
    """Standard `transport=` ctor-argument resolution: explicit wins,
    None means the process default."""
    return transport if transport is not None else default_transport()
