"""Captured roots: the one capture helper every CUDA-graph root uses.

In the JAX package a serving root is a ``jax.jit`` function compiled once
per shape; in the port it is a step function over static device buffers,
captured once per key as a CUDA graph and replayed (ROADMAP.md, known
design differences: a "compile" is a capture). The scheduler's roots
(``decode``, ``prefill``, ``first_token``, ``spec_verify``) and the model
drafter's (``draft``, ``draft_prime``) all capture through ``capture``:

- a warm-up of the step over scratch state on the capture stream first
  (lazy initialisations, the kernels' one-time attribute calls, the
  stream's cuBLAS workspace); scratch state writes only where no reader
  looks (the null block, a parking row);
- the capture into the owner's shared graph pool, on the capture stream,
  with ``capture_begin``/``capture_end`` (the ``torch.cuda.graph`` context
  also synchronises the device and empties the caches);
- ``register_generator_state`` when the step draws, so each replay draws
  fresh noise;
- the host counts both moved are put back, and the capture's moves are
  the graph's deltas: each replay adds them, so the launch and forward
  identities hold for replays as for eager calls.

A root that fails to capture raises: there is no eager fallback on the
card. On the CPU the owners run the same step functions eagerly.
``capture_lock`` keeps a capture and a device profile apart.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np
import torch

from ..ops import flash, ragged
from .introspect import device_gate, graph_capture_lock


def h2d(dst: torch.Tensor, arr: np.ndarray) -> None:
    """Fill a root's static buffer from the host, queued on the current
    stream without a host sync: into a card's buffer from a pinned copy,
    which the caching host allocator keeps until the copy ran."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    if dst.is_cuda:
        src = src.pin_memory()
    dst.copy_(src, non_blocking=dst.is_cuda)


def launch_counters(engine=None) -> list[tuple[object, str]]:
    """(holder, attribute) of every host-side count a step moves: each
    attention op's launch counters and, with an engine, its forward
    count (last)."""
    out = ([(ragged.ragged_paged_attention, n) for n in ragged.LAUNCH_COUNTERS]
           + [(flash.flash_attention, n) for n in flash.LAUNCH_COUNTERS])
    if engine is not None:
        out.append((engine, "forward_calls"))
    return out


class Graph:
    """One captured step and the counts its capture moved, as (holder,
    attribute, delta): each replay adds the deltas."""

    def __init__(self, graph, deltas: list[tuple[object, str, int]]):
        self.graph = graph
        self.deltas = deltas

    def replay(self):
        self.graph.replay()
        for holder, name, delta in self.deltas:
            setattr(holder, name, getattr(holder, name) + delta)


@contextmanager
def capture_lock():
    """Hold ``graph_capture_lock`` for a capture. A device profile holds
    it for its whole window: the capture waits outside its device pass
    (the profile's stop waits for the pass to end)."""
    if not graph_capture_lock.acquire(blocking=False):
        with device_gate.outside_pass():
            graph_capture_lock.acquire()
    try:
        yield
    finally:
        graph_capture_lock.release()


def capture(step, live, scratch, *, stream, pool, counters, generator=None):
    """Warm ``step(scratch)`` up on ``stream``, then capture ``step(live)``
    into a graph from ``pool``. Returns (Graph, warm-up seconds, the
    counts warm-up and capture moved, in ``counters`` order). The capture
    reads and writes ``live``'s buffers but runs nothing."""
    base = [getattr(h, n) for h, n in counters]
    main = torch.cuda.current_stream(stream.device)
    stream.wait_stream(main)
    t0 = time.perf_counter()
    with torch.cuda.stream(stream):
        step(scratch)
    main.wait_stream(stream)
    warm_s = time.perf_counter() - t0
    warmed = [getattr(h, n) for h, n in counters]
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    # only this thread's unsafe calls break the capture (thread_local)
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            step(live)
        finally:
            graph.capture_end()
    captured = [getattr(h, n) for h, n in counters]
    deltas = [(h, n, c - w) for (h, n), c, w in zip(counters, captured, warmed)
              if c != w]
    for (h, n), value in zip(counters, base):
        setattr(h, n, value)
    return Graph(graph, deltas), warm_s, [c - b for c, b in zip(captured, base)]
