"""Loopback WebSocket-compatible transport: the gate for a missing
`websockets` dependency.

Some minimal images (including CI containers) lack the `websockets`
package, which used to black out the ENTIRE mesh layer — node, pipeline,
failover, chaos, web tests all died at import. This module implements
the narrow slice of the websockets API the codebase uses over plain
asyncio streams, and `meshnet/node.py` / `web/bridge.py` fall back to it
when the real package is absent (same pattern as compat.py's jax shims).

Scope — read before extending:

- The wire format is a private length-prefixed framing (1-byte opcode:
  0 text / 1 binary, u64 little-endian length, payload), NOT RFC 6455.
  Both ends of a link must speak it, which is exactly the situation in
  tests and single-host dev meshes. With `websockets` installed this
  module is never imported, so real deployments keep real WebSockets
  (and wire compatibility with the reference's JS bridge).
- API covered: `serve(handler, host, port, max_size=...)` →
  `.sockets/.close()/.wait_closed()`; `connect(addr, max_size=...,
  open_timeout=...)` usable as `await` or `async with`; connection
  `.send(str|bytes)`, `.recv()`, `.close()`, async iteration;
  `ConnectionClosed` at module top level and under `.exceptions`.
- Close semantics are simplified: iteration ends (StopAsyncIteration)
  on ANY close, clean or not, and `recv()` raises ConnectionClosed.
  The mesh treats both identically (reader exit → drop peer).

PyTorch port: a copy of ``bee2bee_tpu/wscompat.py`` with the import root rewritten to
``bee2bee_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import struct
from urllib.parse import urlparse


class ConnectionClosed(Exception):
    """Connection is gone (mirrors websockets.exceptions.ConnectionClosed)."""


class ConnectionClosedOK(ConnectionClosed):
    pass


class ConnectionClosedError(ConnectionClosed):
    pass


class exceptions:  # namespace mirror: websockets.exceptions.ConnectionClosed
    ConnectionClosed = ConnectionClosed
    ConnectionClosedOK = ConnectionClosedOK
    ConnectionClosedError = ConnectionClosedError


_HDR = struct.Struct("<BQ")
_OP_TEXT, _OP_BINARY = 0, 1


class WSProto:
    """One connection end: send/recv/close + async iteration."""

    def __init__(self, reader, writer, max_size: int | None = None):
        self._reader = reader
        self._writer = writer
        self._max_size = max_size
        self.closed = False

    async def send(self, data) -> None:
        if self.closed or self._writer.is_closing():
            raise ConnectionClosedError("connection is closed")
        if isinstance(data, str):
            op, payload = _OP_TEXT, data.encode("utf-8")
        else:
            op, payload = _OP_BINARY, bytes(data)
        self._writer.write(_HDR.pack(op, len(payload)))
        self._writer.write(payload)
        try:
            await self._writer.drain()
        except (ConnectionError, OSError) as e:
            self.closed = True
            raise ConnectionClosedError(f"send failed: {e}") from e

    async def recv(self):
        try:
            op, n = _HDR.unpack(await self._reader.readexactly(_HDR.size))
            if self._max_size is not None and n > self._max_size:
                raise ConnectionClosedError(f"frame of {n} bytes exceeds max_size")
            payload = await self._reader.readexactly(n) if n else b""
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            self.closed = True
            raise ConnectionClosed("connection closed") from e
        return payload.decode("utf-8") if op == _OP_TEXT else payload

    def __aiter__(self):
        return self

    async def __anext__(self):
        try:
            return await self.recv()
        except ConnectionClosed:
            raise StopAsyncIteration from None

    async def close(self) -> None:
        self.closed = True
        try:
            self._writer.close()
            await self._writer.wait_closed()
        except Exception:  # noqa: BLE001 — closing a dead socket is fine
            pass


class Server:
    """Mirror of websockets' server handle over asyncio.start_server.
    Like the real package, close() takes down the listener AND every
    established connection (the mesh relies on that for shutdown)."""

    def __init__(self, server: asyncio.AbstractServer, conns: set):
        self._server = server
        self._conns = conns

    @property
    def sockets(self):
        return self._server.sockets

    def close(self) -> None:
        self._server.close()
        for ws in list(self._conns):
            ws.closed = True
            try:
                ws._writer.close()
            except Exception:  # noqa: BLE001 — already-dead transports
                pass

    async def wait_closed(self) -> None:
        await self._server.wait_closed()


async def serve(handler, host: str, port: int, max_size: int | None = None,
                **_kw) -> Server:
    conns: set[WSProto] = set()

    async def _cb(reader, writer):
        ws = WSProto(reader, writer, max_size)
        conns.add(ws)
        try:
            await handler(ws)
        except ConnectionClosed:
            pass
        finally:
            conns.discard(ws)
            await ws.close()

    return Server(await asyncio.start_server(_cb, host, port), conns)


class _Connect:
    """`connect(...)` result: awaitable AND an async context manager,
    like the real package's Connect object."""

    def __init__(self, addr: str, max_size: int | None = None,
                 open_timeout: float = 10, **_kw):
        self._addr = addr
        self._max_size = max_size
        self._open_timeout = open_timeout
        self._ws: WSProto | None = None

    async def _open(self) -> WSProto:
        u = urlparse(self._addr)
        if u.scheme != "ws":
            # no TLS here; callers' wss→ws fallback handles the downgrade
            raise OSError(f"wscompat supports ws:// only, got {self._addr!r}")
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(u.hostname, u.port),
            timeout=self._open_timeout,
        )
        self._ws = WSProto(reader, writer, self._max_size)
        return self._ws

    def __await__(self):
        return self._open().__await__()

    async def __aenter__(self) -> WSProto:
        return await self._open()

    async def __aexit__(self, *exc) -> None:
        if self._ws is not None:
            await self._ws.close()


def connect(addr: str, **kw) -> _Connect:
    return _Connect(addr, **kw)
