#!/usr/bin/env python3
"""Where the split-K decode kernel's time goes, on one CUDA card.

Run from the root of a checkout:  python3 decode_probe.py

For llama-3-8b's attention heads (H=32, Hkv=8, hd=128, block size 16), on
the bf16 and the int8 pool, at B=8 over a 1024-token context (table
widths 64 and 128 pages), at B=1 over 2048 tokens and at the serving
slice's mixed lengths, and for gemma-2-9b's (H=16, Hkv=8, hd=256: the
kernel's head_dim-256 form) at B=8 over 1024 and 4096 tokens and at B=1
over 2048, it prints:
- the decode kernel's time under CUDA events with L2 flushed by writing
  a 256 MB buffer (as chip_smoke.py times it) and by reading it (which
  leaves L2 full of clean lines, as a forward's weight reads do);
- the split walk's and the merge's own device time under torch.profiler;
- the same time for each cap on the tiles a split walks
  (DECODE_MAX_SPLIT_TILES 1, 2, 4, 8 and 16), with the split plan each
  gives.
The card's name and power limit come first. Exits non-zero without a
CUDA card.
"""

from __future__ import annotations

import math
import statistics
import sys
from pathlib import Path

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke as cs
    from bee2bee_tpu_torch.ops import ragged as R
    from torch.profiler import ProfilerActivity, profile

    card, _ = cs.phase_device_and_build()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def read_flush_ms(fn, reps=30):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            flush.sum()
            torch.cuda._sleep(cs.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def kernel_split_ms(fn, calls=20):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush.sum()
                fn()
            torch.cuda.synchronize()
        out = {"walk": 0.0, "merge": 0.0}
        for e in prof.key_averages():
            if "ragged_decode_merge" in e.key:
                out["merge"] += e.self_device_time_total / calls / 1e3
            elif "ragged_decode_kernel" in e.key:
                out["walk"] += e.self_device_time_total / calls / 1e3
        return out

    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    shapes = (("B=8 ctx 1024 MB 64", [1023] * 8, 0, {}),
              ("B=8 ctx 1024 MB 128", [1023] * 8, 64, {}),
              ("B=1 ctx 2048 MB 128", [2047], 0, {}),
              ("B=8 slice lengths MB 128", cs.SLICE_OFFSETS, 30, {}),
              ("gemma B=8 ctx 1024 MB 64", [1023] * 8, 0, cs.GEMMA),
              ("gemma B=8 ctx 4096 MB 256", [4095] * 8, 0, cs.GEMMA),
              ("gemma B=1 ctx 2048 MB 128", [2047], 0, cs.GEMMA))
    for int8 in (False, True):
        pool = "int8" if int8 else "bf16"
        for label, offs, extra, heads in shapes:
            q, kp, vp, tb, off = cs.make_case(gen, offs=offs, T=1, extra_tables=extra,
                                              **heads)
            hd = q.shape[3]
            scales = (None, None)
            if int8:
                kp, vp, *scales = cs.int8_pools(gen, kp.shape[1], Hkv=kp.shape[0], hd=hd)
            rows = R.row_offsets(off, q.shape[0], q.device)
            kernel = R.ragged_kernel(q.dtype, 1, hd)

            def fn():
                return R._launch_kernel(q, kp, vp, tb, rows, 0, 1.0 / math.sqrt(hd),
                                        0.0, *scales, kernel=kernel)

            default = R.DECODE_MAX_SPLIT_TILES
            for cap in (1, 2, 4, 8, 16):
                R.DECODE_MAX_SPLIT_TILES = cap
                R.decode_splits.cache_clear()
                write_ms = cs.cuda_time_ms(fn, flush=flush)
                read_ms = read_flush_ms(fn)
                split = kernel_split_ms(fn)
                print(f"probe {pool} {label} cap {cap}{' (kept)' if cap == default else ''} "
                      f"plan {cs.split_plan(q, kp, tb)}: write-flush {write_ms:.4f} ms, "
                      f"read-flush {read_ms:.4f} ms; profiler split walk "
                      f"{split['walk']:.4f} ms, merge {split['merge']:.4f} ms", flush=True)
            R.DECODE_MAX_SPLIT_TILES = default
            R.decode_splits.cache_clear()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
