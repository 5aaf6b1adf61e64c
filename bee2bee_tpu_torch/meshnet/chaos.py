"""Deterministic fault injection for live generation migration.

The port of ``bee2bee_tpu/meshnet/chaos.py``'s migration half, product
code so that operators drive game-day drills with the primitives the
tests use (docs/ROBUSTNESS.md):

- ``hard_kill(node)``: every socket dies, no GOODBYE, nothing keeps
  responding — what a power loss or OOM kill looks like to the mesh.
- ``ChaosMigration(node, action=..., at_chunk=N)``: wraps the node's
  ``MigrationManager._send_chunk`` (source side) or its engines'
  schedulers' ``_paged_import`` (target side) to kill the link, kill the
  source, corrupt a shipped piece or exhaust the target's pool;
  ``restore()`` undoes the wraps in reverse order.

``ChaosStage`` (per-stage faults of the pipeline runner) waits for the
pipeline stages (ROADMAP.md queue A item 13), and ``ChaosController``
for the fleet controller's tests.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import struct


async def hard_kill(node) -> None:
    """Process-death semantics for an in-process node: every socket dies,
    no GOODBYE is sent, nothing of the node keeps responding."""
    node._stopped = True  # noqa: SLF001 — simulating death, not clean stop
    for info in list(node.peers.values()):
        with contextlib.suppress(Exception):
            await info["ws"].close()
    if node._server is not None:
        node._server.close()
        await node._server.wait_closed()
    for t in list(node._tasks):
        t.cancel()


def _flip_byte(frame: bytes, piece: str | None) -> bytes:
    """``frame`` (a binary tensor frame, protocol.encode_binary) with the
    first payload byte of tensor ``piece`` flipped, or its last byte."""
    at = len(frame) - 1
    if piece is not None:
        (hlen,) = struct.unpack("<I", frame[4:8])
        at = 8 + hlen
        for spec in json.loads(frame[8:8 + hlen])["tensors"]:
            if spec["name"] == piece:
                break
            at += spec["nbytes"]
        else:
            raise ValueError(f"chaos: no tensor {piece!r} in the frame")
    return frame[:at] + bytes([frame[at] ^ 0xFF]) + frame[at + 1:]


class ChaosMigration:
    """Fault injection for live generation migration (meshnet/migrate.py).
    Every faulted path must degrade down the fallback ladder (KV →
    re-prefill → typed error) with a ``migration:<reason>`` incident
    bundle, never a hung generation.

    action:
      - "kill_link":      close the source→target connection once
                          ``at_chunk`` KV_BLOCKS frames left (the source's
                          ladder re-prefills on another peer; the target
                          abandons its partial import on the drop).
      - "kill_source":    hard_kill the whole SOURCE node at that point
                          (nothing falls back; the target must still clean
                          up and nothing may hang).
      - "corrupt_piece":  flip a payload byte of chunk ``at_chunk`` so its
                          sha256 fails at the target (typed hash_mismatch →
                          re-prefill): the first byte of tensor ``piece``
                          ("k"/"v" a page, "k_scale"/"v_scale" an int8
                          pool's scale), or with no ``piece`` the frame's
                          last byte, as the JAX package's does.
      - "exhaust_target": wrap the TARGET node's engine schedulers so a KV
                          import raises pool-exhausted (typed reject →
                          re-prefill elsewhere).

    ``triggered`` is an asyncio.Event for deterministic sequencing.
    """

    ACTIONS = ("kill_link", "kill_source", "corrupt_piece", "exhaust_target")

    def __init__(self, node, action: str = "kill_link", at_chunk: int = 0,
                 piece: str | None = None):
        if action not in self.ACTIONS:
            raise ValueError(f"unknown chaos action {action!r}")
        self.node = node
        self.action = action
        self.at_chunk = int(at_chunk)
        self.piece = piece
        self.triggered = asyncio.Event()
        self._restores: list = []
        if action == "exhaust_target":
            self._wrap_imports()
        else:
            self._wrap_send()

    def _wrap_send(self) -> None:
        node, action = self.node, self.action
        mgr = node.migration
        orig = mgr._send_chunk

        async def wrapped(ws, frame: bytes, seq: int):
            if seq >= self.at_chunk and action == "kill_source":
                if not self.triggered.is_set():
                    self.triggered.set()
                    await hard_kill(node)
                raise ConnectionError("chaos: source killed mid-stream")
            if seq >= self.at_chunk and action == "kill_link":
                self.triggered.set()
                with contextlib.suppress(Exception):
                    await ws.close()
                raise ConnectionError("chaos: link dropped mid-stream")
            if seq == self.at_chunk and action == "corrupt_piece":
                self.triggered.set()
                frame = _flip_byte(frame, self.piece)
            await orig(ws, frame, seq)

        mgr._send_chunk = wrapped
        self._restores.append(lambda: setattr(mgr, "_send_chunk", orig))

    def _wrap_imports(self) -> None:
        from ..engine.scheduler import _PoolExhausted

        # the wrapper runs on the engine's scheduler thread, and
        # asyncio.Event.set is not thread-safe: the trigger hops back onto
        # the loop that owns the event
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:  # constructed outside a loop (sync test)
            loop = None

        def trigger():
            if loop is not None:
                loop.call_soon_threadsafe(self.triggered.set)
            else:
                self.triggered.set()

        for svc in self.node.local_services.values():
            eng = getattr(svc, "engine", None)
            sch = getattr(eng, "scheduler", None) if eng is not None else None
            if sch is None:
                continue

            def failing(req, b, st):
                trigger()
                raise _PoolExhausted("chaos: import pool exhausted")

            # an instance attribute shadows the method; deleting it
            # restores the class's
            sch._paged_import = failing
            self._restores.append(lambda _sch=sch: delattr(_sch, "_paged_import"))

    def restore(self) -> None:
        """Undo every wrap, the last first."""
        while self._restores:
            self._restores.pop()()
