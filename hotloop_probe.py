#!/usr/bin/env python3
"""The decode hot loop's two design measurements, on one CUDA card.

Run from the root of a checkout:  python3 hotloop_probe.py [--tokens N] [--pairs P]

For llama-3-8b (32 layers, bf16, random init from seed 0) served by the
port's engine at chip_smoke.py's slice settings (max_batch 8,
decode_chunk 32, 16-token blocks), over the bf16 and then the int8 pool:

- The capture unit. The scheduler captures one decode step per key and
  replays it decode_chunk times a chunk. Beside it, the whole chunk
  captured as one graph: both capture seconds (the step graph's with its
  warm-up), and one chunk replayed both ways from the same state (B=8 at
  ctx about 1024, greedy; host wall to a synchronise), whose tokens must
  be equal. The chunk graph is dropped afterwards.
- The readback ring's look-ahead. 8 concurrent greedy requests of
  ``--tokens`` new tokens each (default 512: windows of 8 chunks, so a
  look-ahead window chains on the one in flight), the bucket held at 8,
  served once to capture every key, then with decode_overlap on and off
  in the order on, off, off, on, ``--pairs`` times (default 2). Each run
  prints its wall seconds, its decode tok/s after the last first token,
  and its windows, host syncs and stalls; the tokens must be equal in
  every run. The last line per pool gives the medians on and off.

The card's name and power limit come first. Exits non-zero without a
CUDA card.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import threading
import time
from pathlib import Path

import torch


def capture_unit(cs, engine, tag: str) -> None:
    from bee2bee_tpu_torch.engine.scheduler import launch_counters

    sch = engine.scheduler
    K = engine.engine_cfg.decode_chunk
    pool = sch._cache
    # an int8 pool's scales only grow: every run starts from the same pool
    saved = {name: t.clone() for name, t in pool.items()}
    key, v, load = cs.decode_state(engine)

    def reload():
        for name, t in pool.items():
            t.copy_(saved[name])
        load()

    reload()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sch._graphs.pop(key, None)
    sch._capture(key)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counters = launch_counters(engine)
    base = [getattr(h, n) for h, n in counters]
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(sch._capture_stream):
        graph.capture_begin(pool=sch._graph_pool, capture_error_mode="thread_local")
        try:
            for _ in range(K):
                sch._decode_step(v)
        finally:
            graph.capture_end()
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    for (h, n), value in zip(counters, base):
        setattr(h, n, value)
    walls, toks = {}, {}
    for unit in ("step", "chunk", "chunk", "step"):
        reload()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if unit == "step":
            sch._decode_chunk(key)
        else:
            graph.replay()
        torch.cuda.synchronize()
        walls.setdefault(unit, []).append((time.perf_counter() - t0) * 1e3)
        toks[unit] = v.toks.clone()
    reload()
    del graph
    cs.log(f"{tag} capture unit at key {key}: one step captured in {step_s:.3f} s "
           f"with its warm-up, the whole {K}-step chunk in {chunk_s:.3f} s; one chunk "
           f"replayed as {K} step graphs {' / '.join(f'{w:.3f}' for w in walls['step'])} "
           f"ms, as one chunk graph {' / '.join(f'{w:.3f}' for w in walls['chunk'])} ms "
           f"(host wall to a synchronise); tokens equal "
           f"{torch.equal(toks['step'], toks['chunk'])}")
    cs.check(torch.equal(toks["step"], toks["chunk"]),
             f"{tag}: the chunk graph's tokens differ from the step graphs'")


def ring_pairs(cs, engine, tag: str, tokens: int, pairs: int) -> None:
    from bee2bee_tpu_torch.engine.scheduler import _C_HOST_SYNCS, _C_SYNC_STALLS

    sch = engine.scheduler
    cs.check(not sch.active and not sch._inflight, f"{tag} ring: scheduler not idle")
    words = ("every window of the ring reads its tokens back while the next "
             "one runs on the card ").split()
    prompts = [" ".join(words[i:] + words[:i]) for i in range(8)]
    idle_s, overlap = sch._sticky_idle_s, sch._overlap
    sch._sticky_idle_s = float("inf")
    sch._resize(8)
    runs: dict = {True: [], False: []}
    outs = []
    try:
        for run, on in enumerate([True] + [True, False, False, True] * pairs):
            sch._overlap = on
            s0, t0, w0 = _C_HOST_SYNCS.value(), _C_SYNC_STALLS.value(), sch.stats.windows
            results: list = [None] * len(prompts)

            def call(i):
                results[i] = engine.generate(prompts[i], max_new_tokens=tokens,
                                             temperature=0.0)

            threads = [threading.Thread(target=call, args=(i,)) for i in range(len(prompts))]
            t1 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t1
            cs.check(all(r is not None for r in results), f"{tag} ring: a request hung")
            while sch._inflight:
                time.sleep(0.01)
            decode_s = wall - max(r.timings["ttft_ms"] for r in results) / 1e3
            n = sum(len(r.token_ids) for r in results) - len(results)
            syncs = _C_HOST_SYNCS.value() - s0
            stalls = _C_SYNC_STALLS.value() - t0
            label = "warm-up" if run == 0 else f"run {run}"
            cs.log(f"{tag} ring {label} (overlap {'on' if on else 'off'}): 8 greedy "
                   f"requests x {tokens} tokens in {wall:.3f} s, {n} decode tokens in "
                   f"{decode_s:.3f} s after the last first token -> {n / decode_s:.2f} "
                   f"decode tok/s; {sch.stats.windows - w0} windows, {syncs:.0f} host "
                   f"syncs, {stalls:.0f} of them stalls")
            outs.append([r.token_ids for r in results])
            if run:
                runs[on].append(n / decode_s)
    finally:
        sch._sticky_idle_s, sch._overlap = idle_s, overlap
    cs.check(all(len(t) == tokens for t in outs[0]),
             f"{tag} ring: a request stopped early ({[len(t) for t in outs[0]]} tokens)")
    cs.check(all(o == outs[0] for o in outs), f"{tag} ring: runs gave different tokens")
    on, off = statistics.median(runs[True]), statistics.median(runs[False])
    cs.log(f"{tag} ring: median decode tok/s overlap on {on:.2f}, off {off:.2f}, "
           f"on / off {on / off:.4f} ({len(runs[True])} runs each)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=512)
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hotloop_probe: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke as cs

    card, _ = cs.phase_device_and_build()
    params = None
    for cache_dtype in ("bfloat16", "int8"):
        svc, load_s = cs.load_slice(cache_dtype, params)
        engine = svc.engine
        params = engine.params
        tag = f"probe[{cache_dtype} pool]"
        cs.log(f"{tag}: loaded in {load_s:.2f} s")
        try:
            # the ring's first run captures its keys and initialises the
            # libraries, so the capture unit's timings see a warm engine
            ring_pairs(cs, engine, tag, args.tokens, args.pairs)
            capture_unit(cs, engine, tag)
        finally:
            engine.close()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
