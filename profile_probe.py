#!/usr/bin/env python3
"""What a device profile costs a serving engine, and whether it can hang
one, on one CUDA card.

Run from the root of a checkout:
python3 profile_probe.py [--captures N] [--rounds R] [--levers L,...]

- The first start. One 0.05 s capture with nothing else running: the
  first start of the profiler in a process brings up CUPTI.
- Hang. ``--rounds`` (default 4) runs of chip_smoke.py's second-node
  phase (``phase_node_prefix``: the node with ``BEE2BEE_PREFIX_CACHE=8``,
  a 1 s profile beside back-to-back streams, its longest stream gap and
  the profiler's seconds per window), with the profiler's own settings
  or ``--round-levers`` in turn. A round still running after 240 s dumps
  every thread's stack to stderr and exits 1.
- Cost. llama-3-8b (32 layers, bf16, random init from seed 0) under the
  engine's default settings serves 32-token greedy streams of the node
  prompt back to back from one thread while ``--captures`` (default 3)
  1 s captures of the profiler behind ``POST /debug/profile``
  (``introspect.DeviceProfiler.capture``) run one after another, for each
  of ``--levers`` (``activities/export/window_s/stop/correlation``, run
  by ``LeverProfiler``, this script's subclass of the profiler): what the
  profiler records (``device``: the card's activity only;
  ``cpu+device``: the CPU's ops beside it), how the trace is exported
  (``fork``: written and zipped by a forked child; ``inline``: in the
  serving process), the seconds of each window (the profiler's spacing
  between windows kept; 1.0: one window for the 1 s capture), how a
  window stops (``raw``: the C++
  disable alone; ``torch``: ``profile.stop()``, which syncs the device
  first), and whether CUPTI's external correlation is kept
  (``on``/``off``). The default runs the
  profiler's own settings, then the capture before the repair (one
  window, inline, ``torch``), then one lever of the repair at a time
  taken back. Per capture:
  the profiler's start, stop and export seconds, the zip's bytes, the
  longest pause of a pure-Python thread that ticks every millisecond (a
  pause there is a pause of every thread: the GIL), and the longest gap
  between a stream's events (what serving felt) against the node's
  queue-wait SLO (4,096 ms). Before the first capture, the same two
  numbers with no profile.

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
QUEUE_SLO_MS = 4096
LEVERS = ("cpu+device/fork/0.05/raw/off", "cpu+device/inline/1.0/torch/on",
          "cpu+device/fork/0.25/raw/off", "cpu+device/fork/1.0/torch/on",
          "cpu+device/fork/0.05/raw/on", "cpu+device/inline/0.05/raw/off",
          "device/fork/0.05/raw/off")


def lever_profiler(profile_dir, lever: str):
    """The node's profiler with ``lever``'s settings in place of its own."""
    from bee2bee_tpu_torch.engine.introspect import DeviceProfiler

    activities, export, window_s, stop, corr = lever.split("/")

    class LeverProfiler(DeviceProfiler):
        WINDOW_S = float(window_s)

        def _profiler(self):
            act = torch.profiler.ProfilerActivity
            return torch.profiler.profile(
                activities=[act.CUDA] if activities == "device" else [act.CPU, act.CUDA],
                record_shapes=False, profile_memory=False, with_stack=False,
                experimental_config=torch._C._profiler._ExperimentalConfig(
                    disable_external_correlation=corr == "off"))

        def _stop(self, prof):
            if stop == "torch":
                prof.stop()
            else:
                super()._stop(prof)

        def _export(self, profs, raw_dir, zip_path):
            if export == "inline":
                self._write_trace(profs, raw_dir)
                return self._zip_dir(raw_dir, zip_path)
            return super()._export(profs, raw_dir, zip_path)

    return LeverProfiler(profile_dir)


def cost(cs, captures: int, levers) -> None:
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
        for lever in levers:
            profiler = lever_profiler(get_profiler().profile_dir, lever)
            for i in range(captures):
                a = time.perf_counter()
                header = profiler.capture(1.0)
                b = time.perf_counter()
                time.sleep(1.0)
                steps = {k: v if isinstance(v, list) else round(v, 3)
                         for k, v in profiler.last_timings.items()}
                gap = longest(events, a, b)
                cs.log(f"profile cost [{lever}]: capture {i}: {b - a:.3f} s, "
                       f"{header['bytes']} B zipped; profiler start, stop, export s "
                       f"{steps}; longest Python pause {longest(ticks, a, b):.1f} ms, "
                       f"longest stream gap {gap:.1f} ms "
                       f"({'under' if gap < QUEUE_SLO_MS else 'OVER'} the {QUEUE_SLO_MS} ms "
                       f"queue-wait SLO)")
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        engine.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--captures", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--round-levers", default="",
                    help="comma-separated levers for the rounds, one round each in "
                         "turn (default: the profiler's own settings)")
    ap.add_argument("--levers", default=",".join(LEVERS),
                    help=f"comma-separated, of {', '.join(LEVERS)}")
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
    from bee2bee_tpu_torch.engine import introspect

    get_profiler = introspect.get_profiler
    get_profiler().capture(0.05)
    steps = {k: v if isinstance(v, list) else round(v, 3)
                     for k, v in get_profiler().last_timings.items()}
    cs.log(f"profile first start: a 0.05 s capture with nothing running: profiler "
           f"start, stop, export s {steps}")
    round_levers = [lv for lv in args.round_levers.split(",") if lv]
    for i in range(args.rounds):
        if round_levers:
            lever = round_levers[i % len(round_levers)]
            # the profiler behind /debug/profile for this round
            introspect._PROFILER = lever_profiler(get_profiler().profile_dir, lever)
            cs.log(f"profile hang: round {i} with the profiler at {lever}")
        faulthandler.dump_traceback_later(ROUND_LIMIT_S, exit=True)
        t0 = time.perf_counter()
        cs.phase_node_prefix(card)
        faulthandler.cancel_dump_traceback_later()
        cs.log(f"profile hang: round {i} of the second node's phase in "
               f"{time.perf_counter() - t0:.1f} s")
    cost(cs, args.captures, [lv for lv in args.levers.split(",") if lv])
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
