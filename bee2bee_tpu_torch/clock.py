"""The Clock seam: every time source the coordination layer reads.

The mesh's behavior is saturated with wall-clock reads — ping cadence,
HealthStore TTLs, lease boot-grace and lapse timers, SLO burn windows,
incident cooldowns, admission queue timeouts, drain deadlines. Each bare
`time.time()` / `asyncio.sleep()` in those paths is a place the fleet
simulation (`bee2bee_tpu/simnet/`) cannot reach: a 200-node chaos run
would take real minutes per lease TTL and its traces would never be
reproducible. This module is the single seam all of them route through.

Injection contract (docs/SIMULATION.md has the long form):

- `Clock` is the interface: `time()`, `monotonic()`, `sleep()`,
  `wait_for()`. `SystemClock` is the production implementation and
  delegates straight to `time` / `asyncio`.
- Components that own a clock take a `clock=` constructor argument
  defaulting to `None` → "resolve the process-global clock". `P2PNode`
  threads its clock into everything it constructs (HealthStore,
  SloTracker, LeaseKeeper, FleetController, AdmissionController).
- Process-global singletons that outlive any one node (the flight
  recorder, module-level helpers) resolve `get_clock()` *at call time*,
  never at import/construction time, so a simulation installing a
  virtual clock with `set_clock()` takes effect everywhere at once.
- `asyncio.wait_for` is a wall-clock leak too — its timeout rides the
  real event-loop timer — so the seam includes `Clock.wait_for()`.
  `SystemClock` delegates to `asyncio.wait_for`; the generic base
  implementation races the awaitable against `self.sleep(timeout)` so a
  virtual clock's timeouts fire in virtual time.

The meshlint pass ML-C001 (analysis/clockseam.py) keeps this seam from
eroding: direct wall-clock calls inside the seamed packages are findings
unless carrying a reasoned `# meshlint: ignore[ML-C001]`.

PyTorch port: a copy of ``bee2bee_tpu/clock.py`` with the import root rewritten to
``bee2bee_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import time as _time
from typing import Any, Awaitable


class Clock:
    """Time-source interface. Subclasses must provide `time`, `monotonic`
    and `sleep`; `wait_for` has a generic implementation that only relies
    on `sleep`, so virtual clocks get virtual timeouts for free."""

    def time(self) -> float:
        raise NotImplementedError

    def monotonic(self) -> float:
        raise NotImplementedError

    async def sleep(self, delay: float) -> None:
        raise NotImplementedError

    async def wait_for(self, awaitable: Awaitable[Any], timeout: float | None) -> Any:
        """`asyncio.wait_for` semantics on this clock's timeline: returns
        the awaitable's result, or cancels it and raises
        `asyncio.TimeoutError` once `timeout` elapses *on this clock*."""
        task = asyncio.ensure_future(awaitable)
        if timeout is None:
            return await task
        timer = asyncio.ensure_future(self.sleep(timeout))
        try:
            done, _ = await asyncio.wait(
                {task, timer}, return_when=asyncio.FIRST_COMPLETED
            )
            if task in done:
                return task.result()
            task.cancel()
            # consume the cancellation so it never surfaces as "exception
            # was never retrieved" — mirrors asyncio.wait_for's own cleanup
            try:
                await task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            raise asyncio.TimeoutError
        finally:
            if not timer.done():
                timer.cancel()
                try:
                    await timer
                except asyncio.CancelledError:
                    pass


class SystemClock(Clock):
    """Production clock: real wall time, real event-loop timers."""

    def time(self) -> float:
        return _time.time()

    def monotonic(self) -> float:
        return _time.monotonic()

    async def sleep(self, delay: float) -> None:
        await asyncio.sleep(delay)

    async def wait_for(self, awaitable: Awaitable[Any], timeout: float | None) -> Any:
        return await asyncio.wait_for(awaitable, timeout)


_SYSTEM = SystemClock()
_CLOCK: Clock = _SYSTEM


def get_clock() -> Clock:
    """The process-global clock. SystemClock unless a simulation (or test)
    installed a replacement via `set_clock`."""
    return _CLOCK


def set_clock(clock: Clock | None) -> Clock:
    """Install `clock` process-wide (None restores the system clock).
    Returns the previously installed clock so callers can restore it."""
    global _CLOCK
    prev = _CLOCK
    _CLOCK = clock if clock is not None else _SYSTEM
    return prev


def resolve_clock(clock: Clock | None) -> Clock:
    """The standard `clock=` ctor-argument resolution: explicit wins,
    None means the process-global clock *as of now*."""
    return clock if clock is not None else _CLOCK
