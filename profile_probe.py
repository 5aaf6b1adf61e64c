#!/usr/bin/env python3
"""What a device profile costs a serving engine, and whether it can hang
one, on one CUDA card.

Run from the root of a checkout:  python3 profile_probe.py [--captures N] [--rounds R]

- The first start. One 0.05 s capture with nothing else running: the
  first start of the profiler in a process brings up CUPTI.
- Hang. ``--rounds`` (default 4) runs of chip_smoke.py's second-node
  phase (``phase_node_prefix``: the node with ``BEE2BEE_PREFIX_CACHE=8``,
  a 1 s profile beside back-to-back streams). A round still running after
  240 s dumps every thread's stack to stderr and exits 1.
- Cost. llama-3-8b (32 layers, bf16, random init from seed 0) under the
  engine's default settings serves 32-token greedy streams of the node
  prompt back to back from one thread while ``--captures`` (default 3)
  1 s captures of the profiler behind ``POST /debug/profile``
  (``introspect.get_profiler().capture``) run one after another. Per
  capture: the profiler's start, stop and export seconds, the longest
  pause of a pure-Python thread that ticks every millisecond (a pause
  there is a pause of every thread: the GIL), and the longest gap between
  a stream's events (what serving felt). Before the first capture, the
  same two numbers with no profile.

The card's name and power limit come first. Exits non-zero without a
CUDA card.
"""

from __future__ import annotations

import argparse
import faulthandler
import os
import sys
import threading
import time
from pathlib import Path

import torch

ROUND_LIMIT_S = 240


def cost(cs, captures: int) -> None:
    from bee2bee_tpu_torch.engine import InferenceEngine
    from bee2bee_tpu_torch.engine.introspect import get_profiler

    engine = InferenceEngine("llama-3-8b")
    prompt = cs.node_prompt()
    engine.generate(prompt, max_new_tokens=32)
    stop = threading.Event()
    ticks, events = [], []

    def ticker():
        last = time.perf_counter()
        while not stop.is_set():
            time.sleep(0.001)
            now = time.perf_counter()
            ticks.append((now, now - last))
            last = now

    def streamer():
        while not stop.is_set():
            last = time.perf_counter()
            for _ in engine.generate_stream(prompt, max_new_tokens=32):
                now = time.perf_counter()
                events.append((now, now - last))
                last = now

    def longest(series, a, b):
        # a gap counts where it overlaps [a, b]
        return max([g for t, g in series if t >= a and t - g <= b] or [0.0]) * 1e3

    threads = [threading.Thread(target=f, daemon=True) for f in (ticker, streamer)]
    for t in threads:
        t.start()
    try:
        a = time.perf_counter()
        time.sleep(3.0)
        b = time.perf_counter()
        cs.log(f"profile cost: no profile: longest Python pause {longest(ticks, a, b):.1f} ms, "
               f"longest stream gap {longest(events, a, b):.1f} ms")
        profiler = get_profiler()
        for i in range(captures):
            a = time.perf_counter()
            header = profiler.capture(1.0)
            b = time.perf_counter()
            time.sleep(1.0)
            steps = {k: round(v, 3) for k, v in profiler.last_timings.items()}
            cs.log(f"profile cost: capture {i}: {b - a:.3f} s, {header['bytes']} B zipped; "
                   f"profiler start, stop, export s {steps}; longest Python pause "
                   f"{longest(ticks, a, b):.1f} ms, longest stream gap "
                   f"{longest(events, a, b):.1f} ms")
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        engine.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--captures", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_probe: no CUDA device available", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    # the nodes' state (identity, incidents, profiles) stays in the checkout
    os.environ.setdefault("BEE2BEE_TPU_HOME", str(here / "build" / "bee2bee_home"))
    import chip_smoke as cs

    card, _ = cs.phase_device_and_build()
    from bee2bee_tpu_torch.engine.introspect import get_profiler

    get_profiler().capture(0.05)
    steps = {k: round(v, 3) for k, v in get_profiler().last_timings.items()}
    cs.log(f"profile first start: a 0.05 s capture with nothing running: profiler "
           f"start, stop, export s {steps}")
    for i in range(args.rounds):
        faulthandler.dump_traceback_later(ROUND_LIMIT_S, exit=True)
        t0 = time.perf_counter()
        cs.phase_node_prefix(card)
        faulthandler.cancel_dump_traceback_later()
        cs.log(f"profile hang: round {i} of the second node's phase in "
               f"{time.perf_counter() - t0:.1f} s")
    cost(cs, args.captures)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
