#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bee2bee_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py
(``python3 chip_smoke.py --ring-repro N`` runs only the build and the ring
check's reproduction, ``ring_repro``; ``--node-profile N`` only the build
and phase 9's second node N times, ``node_profile_rounds``.)

Phases (each prints its numbers on lines of their own; any failure raises
and the script exits non-zero):

1. Device and build: the card's name and power limit, then the CUDA
   kernels built from csrc/ with nvcc (one process per source, all at
   once); ptxas's registers and spills of every instantiation, and a
   failure if a head_dim-256 instantiation the dispatch names (tile, f32
   tile, both decode kernels and their merges, flash tile and f32 tile
   kernels) spills.
2. Ragged paged attention vs plain version at llama-3-8b's attention
   shapes (H=32, Hkv=8, hd=128, block size 16) in bf16, through the
   dispatching wrapper: decode (the split-K decode kernel) at ragged
   offsets across block boundaries with a dead row, null table tails,
   B=1 at a 2048-token context (MB 128), B=8 at the slice's mixed lengths
   41-1565 (MB 128), window 64 + softcap 50 + score scale 1/sqrt(256)
   with offsets where the window cuts pages, block sizes 8 and 32,
   head_dim 64, and a row at offset -1 beside a dead row; then verify
   chunks (one with a dead row) and prefill chunks, T in {5, 16, 17, 300,
   512 @0, 512 @1000, 2048 @0}, window + softcap + scale at T=5 and T=64,
   block sizes 8 and 32 (the tile kernel); then f32 (the f32 split-K
   decode kernel below T_MIN_F32, over an int8 pool T_MIN_F32_INT8, the
   tile kernel's 3xTF32 form from it on): decode with a dead row, at
   offset -1, at head_dim 64, B=1 at a 2048-token context, block sizes 8
   and 32, window + softcap + scale; verify T=3, T=4 and T=5, prefill T in
   {5, 17, 300, 512 @1000, 2048 @0}, window + softcap + scale at T=5 and
   T=64, block sizes 8 and 32, head_dim 64; then head_dim 256 at
   gemma-2-9b's heads (16/8, window 4096, softcap 50, scale 1/16) in bf16
   (the decode and tile kernels' head_dim-256 forms) and f32 (the f32
   decode kernel below T_MIN_F32_HD256, over an int8 pool
   T_MIN_F32_INT8_HD256, the f32 tile form from it on): decode with
   window cuts, at offset -1 beside a dead row and null tails, B=8 ctx
   1024, block sizes 8 and 32; verify
   T=5 with a dead row, chunks of 17 and 300 cut by the window, prefill
   T=512 @1000, T=100 at block sizes 8 and 32; the row kernel is forced
   as well on the decode and T=17 cases in both types (those it served
   at head_dim 256 before). Each
   case checks that exactly the kernel the dispatch rule names launched,
   once, and each decode case that a second call gives the same bytes.
   Tolerance: max abs error <= 2e-2 against the plain version run in f32
   on the same bf16 inputs (bf16 output rounding is ~4e-3 at these
   magnitudes; the decode and tile kernels also round P to bf16, as the
   JAX kernel does; the f32 decode kernel computes in IEEE f32, so 1e-6
   is what to expect there), 1e-4 in f32. Then times, each beside the
   plain version, SDPA over the gathered view in q's type (the library
   yardstick, never used by the port; the backend it ran is printed once)
   and the bound (f32 tile form: three TF32 products at the TF32 peak,
   with the CUDA-core FFMA bound beside it; f32 decode kernel: the FFMA
   products at the f32 CUDA-core peak): the decode kernel at B=8 over a
   1024-token context and at B=1 over 2048 (with its split plan), the row
   and the tile kernel forced at the same decode inputs, the f32 decode
   kernel at the same two shapes (its plan; the f32 tile form and the row
   kernel forced beside it), the tile kernel and its f32 form at a
   512-token prefill chunk at offset 1000; at gemma heads (window 4096
   and scale 1/16; no softcap, which SDPA cannot apply) the head_dim-256
   decode form at B=8 ctx 1024 and tile form at T=512 @1000, each with the
   other kernels that take the inputs forced beside it (the row kernel
   among them), and the same in f32 (the f32 decode kernel, the f32 tile
   form and the row kernel); the crossovers over T at llama-3-8b's and at
   gemma heads: bf16, the row and the tile kernel; f32, the f32 decode
   kernel and the f32 tile form (the dispatch's T_MIN_F32 and its kin);
   then the decode sweep, 32 launches back to back over a 32-layer copy of
   the pool, in ms per launch.
3. The same cases for the int8-pool form: random int8 pages, random
   per-(kv head, block) scales, and a null block of +-127 under a scale
   of 1e3 that no reader may touch. Tolerance 2e-2 in bf16 and 1e-4 in
   f32 against the plain version on the same inputs. Times as in phase
   2, SDPA over the host-dequantized gathered view, the bound in int8
   bytes plus the scales.
4. Flash attention vs plain version (contiguous K/V, llama-3-8b heads):
   causal T=S=2048, decode B=8 T=1 S=2048 with ragged offsets and one
   empty row (offset -1), T=512 at offset 1000 over S=2048, non-causal
   T=S=256 in bf16 (the tile kernel); T=64 S=256 at per-row offsets,
   causal T=S=2048, the decode case, non-causal T=S=256 and head_dim 64
   in f32 (the f32 tile kernel); head_dim 256 at gemma heads in bf16 (the
   tile kernel's head_dim-256 form: T=64 S=256 at per-row offsets, causal
   T=S=2048, the decode case, T=100 S=300 @200, non-causal T=S=256) and
   f32 (the f32 tile kernel: T=64 S=256, causal T=S=2048, the decode
   case, non-causal T=S=256); the row kernel, which the rule no longer
   names, forced on the two T=64 S=256 cases at gemma heads. Tolerance
   2e-2 / 1e-4. Times of causal
   T=S=2048 through the tile kernel (bf16), the f32 tile kernel and the
   row kernel forced (f32), and at gemma heads the head_dim-256 tile form
   (bf16) and the f32 tile kernel, each with the row kernel forced beside
   it; each beside the plain version, SDPA(is_causal=True) and the bound.
   No serving path calls this op.
5. A whole forward at llama-3-8b width, 2 layers: a 300-token prefill and
   8 greedy decode steps through the kernels and through the plain
   version (asked for explicitly, here only), in f32 over an f32 pool and
   over an int8 pool (each forward through the kernels the rule names:
   the f32 tile form for the prefill, the f32 decode kernel for the decode
   steps; logits within 2e-3, greedy tokens equal;
   the int8-vs-f32 pool logit gap printed for information; each forward's
   device busy time under torch.profiler), then in bf16 over a bf16 pool
   and an int8 pool, whose 300-token prefill goes through the tile kernel
   and whose 8 decode steps go through the decode kernel: logits within
   the gap between the plain bf16 and the plain f32 forward (the kernels
   may not add more error than bf16 itself carries). Then the same bf16
   forward, over a bf16 and an int8 pool, at gemma-2-9b's attention
   geometry on the llama architecture (d 3584, 16/8 heads at head_dim
   256, window 4096 every 2 layers, softcap 50): it must launch only the
   head_dim-256 tile form (the prefill) and decode form (the steps), meet
   the same bf16 criterion and give the plain forward's greedy tokens.
6. The slice: CUDAService("llama-3-8b"), 32 layers, bf16, random init
   from a seed, answers 8 concurrent execute calls and one
   execute_stream. Every decode step is a replay of a captured CUDA
   graph of the scheduler's decode step, which adds back the launch and
   forward counts of its capture: the decode kernel's launches plus the
   tile kernel's must equal n_layers x the engine's forward calls, the
   forwards the prefill chunks plus the replayed decode steps (> 0), the
   decode kernel's n_layers x the replayed steps, the tile kernel's
   n_layers x the prefill-chunk forwards (both > 0), and the row
   kernel's 0; the only eager decode forwards are those of the graphs'
   warm-up and capture. Prints the captures (by key, with their
   seconds), the replays and the readback ring's windows, host syncs and
   stalls. Then the ring: 2 greedy requests of 320 tokens with overlap on
   and off (equal tokens, fewer stalls than syncs with it on, a stall at
   every sync with it off). Then one decode chunk (32 steps, B=8 at ctx
   about 1024, over random pages) run eagerly and by replay from the same
   state: greedy tokens, cur, offsets and the pool's bytes outside the
   null block equal bit for bit; two replays of a graph with a row at
   temperature 1 from one state: greedy rows equal, the sampled row's
   draws different. Every prefill chunk and first token the slice serves
   is a replay of the prefill and first-token roots' graphs too: the
   tile launches equal n_layers x the prefill replays, the only eager
   prefill forwards are the captures' warm-up and capture, one
   first-token replay per request. Then a prefill chunk run eagerly and
   by replay from the same random pool: a miss (1,000 tokens at bucket
   1024) and a hit (104 new tokens at bucket 128 from offset 1000, after
   a CoW copy, floored there): last logits and the pool's bytes (and
   scales) outside the null block equal bit for bit, n_layers tile
   launches a replay (in every slice, phases 6-8). Then a breakdown of a
   decode step (the bare forward,
   the scheduler's step eager and graph-replayed) and a prefill chunk:
   host wall, device busy, idle share and the attention kernels' ms per
   launch inside the step (the decode kernel's two CUDA kernels summed).
7. The int8 slice: the same parameters served by an engine with
   cache_dtype="int8" inside CUDAService, the same requests and the same
   launch, graph and replay checks on the int8 counters (the bf16 pool's
   stay 0; the replay check compares the scales too); pool bytes beside
   the bf16 pool's.
8. The f32 slice: the same weights cast to f32 (the bf16 copy freed),
   served by CUDAService("llama-3-8b") with EngineConfig(dtype="float32")
   over an int8 pool and then an f32 pool, the same 8 execute calls and
   one execute_stream (no ring check). On each pool every decode step is
   a graph replay; the kernels the rule names for f32 queries (the f32
   decode kernel for the decode steps, the f32 tile form for the prefill
   chunks) launch n_layers x the forward calls between them, the decode
   kernel n_layers x the replayed steps; the row kernel's counters stay
   0. Over the int8 pool one decode chunk replayed and run eagerly from
   one state gives bit-equal tokens, cur, offsets, pages and scales.
   Prints, beside the card's name and power limit, TTFT, decode tok/s,
   peak memory and pool bytes, and the replayed B=8 ctx-1024 step's host
   wall, device busy, idle share and attention ms per launch.
   Economics, in each slice of phases 6-8, over its traffic: the HBM
   ledger's ``weights`` and ``kv_pool`` equal the tensors' storage bytes
   (the pool also its geometry's), 0 < headroom < 1 (the device's used
   memory from ``mem_get_info``), ``engine.compiles{root="decode"}``
   equals the scheduler's graph captures with no retrace storm, MFU x
   peak over the meter's window equals the FLOPs model over the
   dispatches recorded in it within 10%, the goodput fraction is in
   (0, 1].
   The prefix cache, between phases 7 and 8 over the same bf16 weights
   (bf16 and int8 pools, ``prefix_cache_entries`` 16 and the slices'
   config: 3,089 blocks, 2,048 of them pin room) and in phase 8 over the
   f32 weights (f32 pool): 8 conversations of 985-1019 byte tokens. Turn
   1 sends them at once (8 misses); turn 2 resends each with its 64-token
   reply and 40 new tokens (8 hits), then one exact repeat (a hit at
   n - 1). Checks: the hits, tokens saved and CoW copies the traffic
   implies; each hit's first chunk at offset = its match, floored there,
   at the bucket of the remaining length, n_layers launches of the tile
   kernel the rule names; the slices' launch identities; the shared
   donor blocks' bytes (and scales) bit-equal before and after the
   borrowers' prefill and decode; each CoW target's pages and scales
   equal to its donor's at the copy. The same turn 2 on a cache-off
   engine: bf16 and int8 pools, a hit's first-token logits no further from
   the f32 forward's (cache off) than twice the cache-off run's of the
   same pool, prompt by prompt; f32, the hits' greedy tokens equal the
   cache-off engine's. Then one admission into a pool of one row and 40
   blocks that must evict a pinned entry under pressure (each pool).
   Prints hit, miss and cache-off TTFT (median and range of each burst)
   with the card's name and power limit; each burst runs with every
   prefill and first-token graph it replays captured before it (the
   captures printed apart).
   Speculative decoding, model tier (after the bf16 prefix phase): the
   bf16 weights serve 8 prompts without n-gram repeats (64 greedy tokens
   each, concurrently, K=4) with llama-3-8b itself as the drafter at the
   engine's seed (weight-identical; a second 16 GB beside the target):
   the n-gram tier fails its probe at its first miss and rows escalate;
   acceptance, agreement with the spec-off engine and the spec-off logit
   gap at each row's first divergence (bf16 near-ties) are printed; the
   draft and prime roots are captured once each; the tile kernel
   launches n_layers x (verify + prefill replays). Then one verify step
   (B=8 ctx 1024, K=4, drafts whose first token is the row's greedy next
   token) run eagerly and by replay over a bf16 and an int8 pool: tokens,
   accepted counts, offsets and pool bytes equal bit for bit.
   Speculative decoding, n-gram tier (after the f32 prefix phase): f32
   weights over an f32 pool, 8 periodic prompts, 64 greedy tokens each,
   K=4: the tokens equal the spec-off engine's, 8 x 64; every verify
   replay launches the f32 decode kernel (T = 5) n_layers times.
9. The node (serve-cuda's path): the port's run_p2p_node boots a mesh
   node with its aiohttp gateway on free loopback ports and
   CUDAService("llama-3-8b") from the port's NodeConfig defaults (bf16
   pool, random init from seed 0), loaded in an executor while the
   gateway already answers. One greedy prompt of about 300 bytes (32 new
   tokens) goes to the service once cold, then through the gateway's
   /chat, svc.execute, the gateway's streamed /v1/chat/completions, the
   service's execute_stream and, from a second node that joins through
   the first one's join link, a mesh gen_request (stdlib urllib, no HTTP
   client package): the six texts must be equal, /providers must list
   llama-3-8b with backend "cuda", /metrics must carry the engine.*
   names, decode + tile launches must equal n_layers x forward calls
   (both > 0, every other counter 0), the decode launches n_layers x the
   replayed decode steps (> 0), and the node must stop in time and
   take its engine thread down. Prints the packages the node may lack,
   the boot and the service's load seconds, the event loop's longest
   stall during the load, and TTFT and tok/s through the gateway against
   the direct call (medians of 3 alternating pairs), with the card's name
   and power limit. Then a second node, booted with
   ``BEE2BEE_PREFIX_CACHE=8`` (read by ``load_config`` as ``serve-cuda``
   reads it): the prompt once (a miss) and again (an exact-repeat hit,
   counted, the reference text: a hit recomputes the last prompt position
   at another chunk width, so at a bf16 near-tie its greedy text can
   leave the miss's, which is why the route checks above run without the
   cache); a ``POST /debug/profile`` of 1 s while streams of the prompt
   run back to back (their texts equal the hit's), listed and fetched by
   ``GET``, its chrome trace naming the decode kernel, the longest gap
   of the streams' events under the node's queue-wait SLO (4,096 ms),
   and, sent once the trace's export starts, a stream needing a prefill
   key not yet captured, whose first token comes before the export ends
   and whose longest gap is under the SLO; the profiler's windows,
   export and the gaps on one clock, its start, stop and export seconds
   and the trace's kernel events printed; ``/metrics``
   samples of ``engine.mfu``, ``engine.goodput_tokens_per_s``,
   ``engine.hbm_bytes``, ``engine.hbm_headroom_frac`` and
   ``engine.compiles``; and a second turn (the first's transcript, its
   reply and a new user line) that counts one hit over the whole
   first-turn prompt.
10. The kernel table as one JSON line (the head_dim-256 forms' launches
   from phase 5's gemma-geometry forward; the bf16 decode and tile
   kernels' from phases 6, 7, 9, the prefix phase over the same pool and
   the model-tier spec phase; the f32 decode kernel's and the f32 tile
   forms' from phase 8, its prefix phase, the n-gram spec phase and phase
   5's f32 forwards; phase 2 times the tile kernel and the f32 decode
   kernel at the verify shape, B=8 T=5 ctx 1024), then the result line.

Exits non-zero, printing no result, when no CUDA card is present or
when the package is not beside this script. Each phase's start goes to
stderr with the seconds since launch; a run still going after 1080 s
dumps every thread's stack to stderr and exits 1. The nodes keep their
state under build/bee2bee_home unless BEE2BEE_TPU_HOME names another
directory.
"""

from __future__ import annotations

import faulthandler
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
TF32_FLOPS_PER_S = 494.7e12  # H100 SXM dense TF32 tensor-core peak
# f32-accurate products on the tensor cores take three TF32 products
# (3xTF32): the f32 bound counts the flops three times at the TF32 peak
TF32_PRODUCTS = 3
KERNEL_TOL = 2e-2
F32_TOL = 1e-4
FORWARD_TOL = 2e-3
SEED = 0
# a run still going after this many seconds dumps every thread's stack to
# stderr and exits 1 (the smoke is given 1200 s; it takes about 330)
WATCHDOG_S = 1080
SPIN_CYCLES = 200_000  # ~0.1 ms at the H100's 1.98 GHz boost clock


def log(msg: str) -> None:
    print(msg, flush=True)


_T0 = time.perf_counter()


def stage(name: str) -> None:
    """Marks a phase's start on stderr with the seconds since the start,
    so the end of stderr names the phase a stopped run was in."""
    print(f"chip_smoke: {time.perf_counter() - _T0:.1f} s: {name}", file=sys.stderr,
          flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_time_ms(fn, reps: int = 30, flush: torch.Tensor | None = None,
                 spin: int = SPIN_CYCLES) -> float:
    """Median of ``reps`` single-launch CUDA-event timings, after a warm-up;
    ``flush`` (a buffer larger than L2) is rewritten before each launch so
    every launch reads its inputs from device memory, as a layer of a real
    forward does. The card spins ``spin`` cycles (~0.1 ms by default)
    before each start event, so the host has queued the launches by then:
    the time excludes the host's launch latency, which would otherwise
    count whenever the card drains its queue first."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------ phase 1


def phase_device_and_build():
    from bee2bee_tpu_torch.ops import _build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, cuda {torch.version.cuda})")
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    log(f"build: {len(libs)} kernel source(s) in {build_s:.1f} s")
    for source, path in libs.items():
        log_path = path.with_suffix(".log")
        report = log_path.read_text() if log_path.exists() else ""
        spills = [ln.strip() for ln in report.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
        regs = [ln.strip() for ln in report.splitlines() if "registers" in ln]
        log(f"build: {source}: {len(regs)} kernels; ptxas spill lines "
            f"{sorted(set(spills)) or 'none'}")
        # every instantiation's registers and spills; the head_dim-256
        # forms the dispatch names must not spill
        for name, line in ptxas_entries(report):
            hd256 = name.split("<")[1].startswith("256")
            log(f"build: {source}: {name}: {line}")
            if hd256 and name.startswith(HD256_FORMS):
                check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                      f"{source}: {name} spills: {line}")
    return card, build_s


# the kernels whose head_dim-256 instantiations the dispatch names
HD256_FORMS = ("ragged_prefill_kernel", "ragged_prefill_f32_kernel",
               "ragged_decode_kernel", "ragged_decode_merge", "ragged_decode_f32_kernel",
               "ragged_decode_f32_merge", "flash_tile_kernel", "flash_tile_f32_kernel")


def ptxas_entries(report: str):
    """(kernel, "registers; spills") for each entry function of a ptxas -v
    report, the kernel named by its mangled name's tail."""
    entries, name, spill = [], None, ""
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            base = re.search(r"\d+((?:ragged|flash)_\w+?)I", mangled)
            args = re.findall(r"L[ib](\d+)E", mangled)
            name = f"{base.group(1) if base else mangled[-48:]}<{','.join(args)}>"
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "registers" in ln and name:
            entries.append((name, f"{ln.split(':', 1)[-1].strip()}; {spill}"))
            name = None
    return entries


# ------------------------------------------------------------ phase 2


def make_case(gen, offs, T, H=32, Hkv=8, hd=128, BS=16, extra_tables=0,
              dead=(), dtype=torch.bfloat16):
    """A pool + per-row tables covering offs[b] + T positions (null-block
    tails of ``extra_tables`` entries; rows in ``dead`` get an all-null
    table), with q, on the card."""
    B = len(offs)
    need = [-(-(o + T) // BS) for o in offs]
    MB = max(need) + extra_tables
    tables = torch.zeros((B, MB), dtype=torch.int32)
    nxt = 1
    for b in range(B):
        if b in dead:
            continue
        for i in range(need[b]):
            tables[b, i] = nxt
            nxt += 1
    NB = nxt + 1
    dev = "cuda"
    kp = torch.randn((Hkv, NB, BS, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((Hkv, NB, BS, hd), generator=gen, device=dev).to(dtype)
    # the null block holds garbage by design: make it loud
    kp[:, 0] = 1e4
    vp[:, 0] = -1e4
    q = torch.randn((B, T, H, hd), generator=gen, device=dev).to(dtype)
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    return q, kp, vp, tables.to(dev), off


def attention_work(offs, T, H, Hkv, hd, BS, window, elem_bytes, MB,
                   kv_bytes=None, scale_bytes=0):
    """(bytes, flops) the function needs on these inputs: q read once, the
    visible K/V pages of every (row, kv head) read once (``kv_bytes`` an
    element, plus ``scale_bytes`` per page of an int8 pool), the output
    written once; 4*hd flops per visible (query, key) pair."""
    pages = 0
    pairs = 0
    for off in offs:
        for t in range(T):
            pos = off + t
            lo = max(0, pos - window + 1) if window > 0 else 0
            pairs += min(pos, MB * BS - 1) - lo + 1
        hi = min((off + T - 1) // BS, MB - 1)
        lo_page = max(0, off - window + 1) // BS if window > 0 else 0
        pages += hi - lo_page + 1
    B = len(offs)
    qo = 2 * B * T * H * hd * elem_bytes
    kv_bytes = elem_bytes if kv_bytes is None else kv_bytes
    kv = 2 * pages * Hkv * (BS * hd * kv_bytes + scale_bytes)
    tables = B * MB * 4 + B * 4
    return qo + kv + tables, 4 * hd * pairs * H


WINDOW_KW = dict(window=64, logit_softcap=50.0, sm_scale=1.0 / math.sqrt(256))
# the prompts' token counts in the slice, less one: the positions of their
# first decode step
SLICE_OFFSETS = [40, 120, 260, 400, 640, 900, 1200, 1564]
RAGGED_CASES = [
    # the decode kernel
    ("decode ragged + dead row", dict(
        offs=[0, 15, 16, 17, 500, 1023, 2047, 300], T=1, dead=(7,)), {}),
    ("decode pow2 null tails", dict(
        offs=[3, 40, 100, 255], T=1, extra_tables=9), {}),
    ("decode B=1 ctx 2048", dict(offs=[2047], T=1), {}),
    ("decode B=8 slice lengths MB 128", dict(
        offs=SLICE_OFFSETS, T=1, extra_tables=30), {}),
    ("decode window+softcap+scale", dict(
        offs=[5, 70, 129, 1000, 71, 1500], T=1), WINDOW_KW),
    ("decode BS=8 + null tails", dict(offs=[3, 40, 100, 255], T=1, BS=8,
                                      extra_tables=9), {}),
    ("decode BS=32", dict(offs=[3, 40, 100, 1000], T=1, BS=32, extra_tables=3), {}),
    ("decode hd=64", dict(offs=[3, 40, 100, 1000], T=1, hd=64), {}),
    ("decode offset -1 + dead row", dict(offs=[-1, 300, 57, 1000], T=1, dead=(1,)),
     {}),
    # the tile kernel: verify and prefill chunks
    ("verify T=5 + dead row", dict(offs=[10, 31, 64, 700, 300], T=5, dead=(4,)), {}),
    ("window+softcap+scale T=5", dict(offs=[5, 70, 129, 1000], T=5), WINDOW_KW),
    ("prefill T=16", dict(offs=[0, 40], T=16), {}),
    ("prefill T=17", dict(offs=[5, 33], T=17), {}),
    ("window+softcap+scale T=64", dict(offs=[5, 70, 129, 1000], T=64), WINDOW_KW),
    ("prefill T=300", dict(offs=[0], T=300), {}),
    ("prefill T=512 @0", dict(offs=[0], T=512), {}),
    ("prefill T=512 @1000", dict(offs=[1000], T=512), {}),
    ("prefill T=2048 @0", dict(offs=[0], T=2048), {}),
    ("BS=8 T=100 + null tails", dict(offs=[3, 77], T=100, BS=8, extra_tables=4), {}),
    ("BS=32 T=100", dict(offs=[3, 77], T=100, BS=32), {}),
]
F32 = dict(dtype=torch.float32)
# f32: the f32 decode kernel (decode and the chunks shorter than the f32
# tile form's crossover), the f32 tile form (3xTF32) from the crossover on
F32_RAGGED_CASES = [
    ("f32 decode + dead row", dict(offs=[0, 17, 300, 1023], T=1, dead=(2,), **F32), {}),
    ("f32 decode offset -1 + dead row", dict(offs=[-1, 300, 57, 1000], T=1, dead=(1,),
                                             **F32), {}),
    ("f32 decode hd=64", dict(offs=[3, 40, 100, 1000], T=1, hd=64, **F32), {}),
    ("f32 decode B=1 ctx 2048", dict(offs=[2047], T=1, **F32), {}),
    ("f32 decode BS=8 + null tails", dict(offs=[3, 40, 100, 255], T=1, BS=8,
                                          extra_tables=9, **F32), {}),
    ("f32 decode BS=32", dict(offs=[3, 40, 100, 1000], T=1, BS=32, extra_tables=3,
                              **F32), {}),
    ("f32 decode window+softcap+scale", dict(offs=[5, 70, 129, 1000, 71, 1500], T=1,
                                             **F32), WINDOW_KW),
    ("f32 verify T=3", dict(offs=[7, 300, 1023], T=3, **F32), {}),
    ("f32 verify T=4", dict(offs=[7, 300, 1023], T=4, **F32), {}),
    ("f32 verify T=5", dict(offs=[7, 300, 1023], T=5, **F32), {}),
    ("f32 window+softcap+scale T=5", dict(offs=[5, 70, 129, 1000], T=5, **F32),
     WINDOW_KW),
    ("f32 prefill T=5 + dead row", dict(offs=[10, 31, 64, 700, 300], T=5, dead=(4,),
                                        **F32), {}),
    ("f32 prefill T=17", dict(offs=[5, 33], T=17, **F32), {}),
    ("f32 window+softcap+scale T=64", dict(offs=[5, 70, 129, 1000], T=64, **F32),
     WINDOW_KW),
    ("f32 prefill T=300", dict(offs=[0], T=300, **F32), {}),
    ("f32 prefill T=512 @1000", dict(offs=[1000], T=512, **F32), {}),
    ("f32 prefill T=2048 @0", dict(offs=[0], T=2048, **F32), {}),
    ("f32 BS=8 T=100 + null tails", dict(offs=[3, 77], T=100, BS=8, extra_tables=4,
                                         **F32), {}),
    ("f32 BS=32 T=100", dict(offs=[3, 77], T=100, BS=32, **F32), {}),
    ("f32 prefill hd=64 T=40", dict(offs=[3, 100], T=40, hd=64, **F32), {}),
]
# gemma-2-9b's attention (models/config.py): 16 heads over 8 kv heads at
# head_dim 256, a 4096-key window, softcap 50, score scale 1/sqrt(256): in
# bf16 the decode and tile kernels' head_dim-256 forms, in f32 the f32
# decode kernel below T_MIN_F32_HD256 (T_MIN_F32_INT8_HD256), the f32 tile
# form from it on
GEMMA = dict(H=16, Hkv=8, hd=256)
GEMMA_KW = dict(window=4096, logit_softcap=50.0, sm_scale=1.0 / math.sqrt(256))
HD256_RAGGED_CASES = [
    (f"hd256 {name} {str(dt)[6:]}", dict(geo, dtype=dt, **GEMMA), GEMMA_KW)
    for dt in (torch.bfloat16, torch.float32)
    for name, geo in (
        ("decode window-cut", dict(offs=[0, 700, 4500, 5000], T=1)),
        ("decode offset -1 + dead row + null tails", dict(
            offs=[-1, 300, 57, 1000], T=1, dead=(1,), extra_tables=5)),
        ("decode B=8 ctx 1024", dict(offs=[1023] * 8, T=1)),
        ("decode BS=8", dict(offs=[3, 40, 100, 1000], T=1, BS=8)),
        ("decode BS=32 + null tails", dict(offs=[3, 40, 100, 1000], T=1, BS=32,
                                           extra_tables=3)),
        ("verify T=5 + dead row", dict(offs=[10, 31, 64, 700, 300], T=5, dead=(4,))),
        ("chunk T=17 window-cut", dict(offs=[5, 4200], T=17)),
        ("prefill T=300 window-cut", dict(offs=[4000], T=300)),
        ("prefill T=512 @1000", dict(offs=[1000], T=512)),
        ("BS=8 T=100 + null tails", dict(offs=[3, 77], T=100, BS=8, extra_tables=4)),
        ("BS=32 T=100", dict(offs=[3, 77], T=100, BS=32)),
    )
]
# the cases the row kernel served at head_dim 256 before its head_dim-256
# forms existed: there it is forced as well, in bf16 and f32, so that its
# error is held against the plain version in both types
ROW_FORCED_CASES = {f"hd256 {name} {dt}" for dt in ("bfloat16", "float32")
                    for name in ("decode window-cut", "chunk T=17 window-cut")}
# the timed hd-256 calls keep gemma's window and score scale but not its
# cap: SDPA, the yardstick, cannot cap scores (the cases above keep it)
GEMMA_TIMED_KW = dict(window=4096, sm_scale=1.0 / math.sqrt(256))


def int8_pools(gen, NB, Hkv=8, BS=16, hd=128):
    """Random int8 pages and per-(kv head, block) scales in [0.005, 0.02]
    (values up to ~2.5 in magnitude), with a loud null block: +-127
    under a scale of 1e3, so any read of it shows in the result."""
    def pages():
        return torch.randint(-127, 128, (Hkv, NB, BS, hd), generator=gen,
                             device="cuda", dtype=torch.int32).to(torch.int8)

    def scales():
        return 0.005 + 0.015 * torch.rand((Hkv, NB), generator=gen, device="cuda")

    kq, vq, ks, vs = pages(), pages(), scales(), scales()
    kq[:, 0] = 127
    vq[:, 0] = -127
    ks[:, 0] = 1e3
    vs[:, 0] = 1e3
    return kq, vq, ks, vs


def split_plan(q, kp, tb, kernel: str = "decode") -> str:
    """The split plan of a decode kernel (``kernel``: "decode",
    "decode_hd256" or "decode_f32") for these inputs, as printed."""
    from bee2bee_tpu_torch.ops.ragged import _sm_count, decode_f32_splits, decode_splits

    plan = decode_f32_splits if kernel == "decode_f32" else decode_splits
    splits, pages = plan(q.shape[0], kp.shape[0], tb.shape[1], kp.shape[2],
                         _sm_count(q.device.index))
    return f"{splits} splits x {pages} pages"


def bounds(nbytes: int, flops: int, dtype, kernel: str = "") -> dict:
    """The least time the card could take: max(bytes at the HBM rate, flops
    at the peak of the products the kernel does). f32: three TF32 products
    at the TF32 tensor-core peak (f32-accurate work on the tensor cores),
    the CUDA-core f32 time (one FFMA product) kept beside it; the f32
    decode kernel (``kernel`` "decode_f32") does FFMA products, so its
    bound is that FFMA time."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if dtype == torch.bfloat16:
        t_ops, peak = flops / BF16_FLOPS_PER_S * 1e3, "bf16 989 TFLOP/s"
    elif kernel == "decode_f32":
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        peak = f"f32 FFMA at {F32_FLOPS_PER_S / 1e12} TFLOP/s"
    else:
        t_ops = TF32_PRODUCTS * flops / TF32_FLOPS_PER_S * 1e3
        peak = f"{TF32_PRODUCTS}xTF32 at {TF32_FLOPS_PER_S / 1e12} TFLOP/s"
    bound_ms = max(t_bytes, t_ops)
    out = dict(bound_ms=bound_ms, bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops)
    text = (f"bound {bound_ms:.4f} ms ({out['bound_by']}: {nbytes} B -> "
            f"{t_bytes:.4f} ms, {flops} flop, {peak} -> {t_ops:.4f} ms)")
    if dtype == torch.float32 and kernel != "decode_f32":
        out["ffma_bound_ms"] = max(t_bytes, flops / F32_FLOPS_PER_S * 1e3)
        text += f", FFMA bound {out['ffma_bound_ms']:.4f} ms (f32 at 67 TFLOP/s)"
    out["text"] = text
    return out


_SDPA_SEEN: set = set()


def log_sdpa_backend(label: str, fn, tries: int = 3) -> None:
    """Once per label: the CUDA kernels one SDPA call runs, under
    torch.profiler, which name the backend PyTorch chose (a capture that
    saw no kernel is taken again, up to ``tries`` times)."""
    if label in _SDPA_SEEN:
        return
    _SDPA_SEEN.add(label)
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names: list = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.key[:72] for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
        if names:
            break
    log(f"sdpa backend ({label}): kernels {names}")


def time_ragged(label, q, kp, vp, tb, off, offs, T, flush, scales=None, window=0,
                sm_scale=None):
    """The kernel's time beside the plain version's, SDPA's over the
    gathered (for an int8 pool: dequantized) view in q's type with the
    same mask and score scale, and the bound (at the peak rate of q's
    type; f32: the 3xTF32 and the FFMA bounds)."""
    from bee2bee_tpu_torch.ops.ragged import (
        ragged_paged_attention, ragged_paged_attention_ref, ragged_kernel,
    )

    H, hd = q.shape[2], q.shape[3]
    Hkv, _, BS, _ = kp.shape
    MB = tb.shape[1]
    kw = {} if scales is None else dict(k_scale=scales[0], v_scale=scales[1])
    kw.update(window=window, sm_scale=sm_scale)
    ms = cuda_time_ms(lambda: ragged_paged_attention(q, kp, vp, tb, off, **kw),
                      flush=flush)
    plain_ms = cuda_time_ms(
        lambda: ragged_paged_attention_ref(q, kp, vp, tb, off, **kw), flush=flush
    )
    # library yardstick: SDPA over the pre-gathered view with an explicit
    # mask (the gather and any dequantization are not timed)
    B = len(offs)
    S = MB * BS
    G = H // Hkv

    def gathered(pool, scale):  # [B, H, S, hd], kv heads repeated per group
        g = pool[:, tb.long()]
        if scale is not None:
            g = (g.float() * scale[:, tb.long()][..., None, None]).to(q.dtype)
        g = g.reshape(Hkv, B, S, hd).transpose(0, 1)
        return g.repeat_interleave(G, dim=1).contiguous()

    kg = gathered(kp, None if scales is None else scales[0])
    vg = gathered(vp, None if scales is None else scales[1])
    qs = q.transpose(1, 2).contiguous()  # [B, H, T, hd]
    qpos = off.long()[:, None] + torch.arange(T, device="cuda")[None, :]
    kpos = torch.arange(S, device="cuda")[None, None, :]
    mask = kpos <= qpos[:, :, None]
    if window:
        mask = mask & (kpos > qpos[:, :, None] - window)
    mask = mask[:, None]  # [B, 1, T, S]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_time_ms(
        lambda: sdpa(qs, kg, vg, attn_mask=mask, scale=sm_scale), flush=flush
    )
    log_sdpa_backend(f"ragged, {q.dtype}, hd {hd}, mask",
                     lambda: sdpa(qs, kg, vg, attn_mask=mask, scale=sm_scale))
    kv_bytes = kp.element_size()
    nbytes, flops = attention_work(offs, T, H, Hkv, hd, BS, window, q.element_size(),
                                   MB, kv_bytes=kv_bytes,
                                   scale_bytes=0 if scales is None else 4)
    kernel = ragged_kernel(q.dtype, T, hd, scales is not None, G)
    b = bounds(nbytes, flops, q.dtype, kernel)
    plan = f", plan {split_plan(q, kp, tb, kernel)}" if kernel.startswith("decode") else ""
    log(f"timing {label} B={B} T={T} ctx={offs[0] + T} H={H}/{Hkv} hd={hd} "
        f"({q.dtype}{plan}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"{library_ms:.4f} ms, {b['text']}, share of bound {b['bound_ms'] / ms:.3f}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **{k: v for k, v in b.items() if k != "text"})


def time_decode_sweep(label, q, kp, vp, tb, off, scales=None, layers=32):
    """ms per launch of ``layers`` launches back to back, one for each
    layer slice of a ``layers``-deep copy of the pool, as a decode step
    issues them (without the projections in between)."""
    from bee2bee_tpu_torch.ops.ragged import ragged_paged_attention

    def stack(t):
        return None if t is None else t.unsqueeze(0).repeat(layers, *([1] * t.dim()))

    k, v = stack(kp), stack(vp)
    ks, vs = (None, None) if scales is None else (stack(scales[0]), stack(scales[1]))

    def sweep():
        for i in range(layers):
            kw = {} if ks is None else dict(k_scale=ks[i], v_scale=vs[i])
            ragged_paged_attention(q, k[i], v[i], tb, off, **kw)

    # a spin long enough for the host to queue all the launches (about
    # 0.06 ms of host time each) before the card starts on them
    ms = cuda_time_ms(sweep, spin=SPIN_CYCLES * layers) / layers
    log(f"timing {label} sweep: {layers} launches back to back over a "
        f"{layers}-layer pool, {ms:.4f} ms per launch")
    return ms


# read_counts()'s name of each ragged kernel's counter over the pool in q's
# type; the int8 pool form's carries an "_int8" suffix
RAGGED_COUNTERS = {"row": "ragged", "tile": "ragged_prefill",
                   "tile_hd256": "ragged_prefill_hd256",
                   "tile_f32": "ragged_prefill_f32", "decode": "ragged_decode",
                   "decode_hd256": "ragged_decode_hd256",
                   "decode_f32": "ragged_decode_f32"}


def ragged_counter(q, Hkv: int, int8: bool) -> str:
    """The launch counter the dispatch rule names for these queries over
    ``Hkv`` kv heads."""
    from bee2bee_tpu_torch.ops.ragged import ragged_kernel

    kernel = ragged_kernel(q.dtype, q.shape[1], q.shape[3], int8, q.shape[2] // Hkv)
    return RAGGED_COUNTERS[kernel] + ("_int8" if int8 else "")


def check_one_launch(label: str, counter: str) -> None:
    counts = read_counts()
    check(counts[counter] == 1 and sum(counts.values()) == 1,
          f"{label}: expected one {counter} launch, counted {counts}")


def time_crossover(label, gen, flush, int8, dtype=torch.bfloat16, heads=None):
    """Two kernels of q's type forced at the same inputs over T, at
    llama-3-8b's heads or ``heads`` (GEMMA: the head_dim-256 forms). bf16:
    the row kernel and the tile kernel (where the tile kernel starts to
    win, the dispatch's T_MIN; and the row kernel at the timed prefill
    chunk). f32: the f32 decode kernel, at each T whose G * T rows it
    holds, and the f32 tile form (where the tile form starts to win, the
    dispatch's T_MIN_F32 and its kin)."""
    from bee2bee_tpu_torch.ops.ragged import (
        DECODE_F32_MAX_ROWS, _launch_kernel, row_offsets,
    )

    heads = heads or {}
    hd = heads.get("hd", 128)
    if dtype == torch.float32:
        first, tile = "decode_f32", "tile_f32"
        shapes = ((8, 1000, (1, 2, 3, 4, 5, 6, 8, 12, 16, 32)),)
    else:
        first, tile = "row", "tile_hd256" if hd == 256 else "tile"
        shapes = ((8, 1000, (1, 2, 4, 8, 16, 32)), (1, 48, (2, 8, 16)), (1, 1000, (512,)))
    for B, off0, Ts in shapes:
        for T in Ts:
            q, kp, vp, tb, off = make_case(gen, offs=[off0] * B, T=T, dtype=dtype,
                                           **heads)
            scales = (None, None)
            if int8:
                kp, vp, *scales = int8_pools(gen, kp.shape[1], Hkv=kp.shape[0], hd=hd)
            rows = row_offsets(off, B, q.device)

            def run(kernel):
                return _launch_kernel(q, kp, vp, tb, rows, 0, 1.0 / math.sqrt(hd),
                                      0.0, *scales, kernel=kernel)

            kernels = (first, tile)
            if first == "decode_f32" and q.shape[2] // kp.shape[0] * T > DECODE_F32_MAX_ROWS:
                kernels = (tile,)
            ms = {k: cuda_time_ms(lambda: run(k), flush=flush) for k in kernels}
            log(f"crossover {label} B={B} T={T} ctx={off0 + T} H={q.shape[2]}/"
                f"{kp.shape[0]} hd={hd} ({dtype}): "
                + ", ".join(f"{k} kernel {t:.4f} ms" for k, t in ms.items()))


def forced_kernels(q, Hkv: int) -> tuple:
    """The ragged kernels that take these queries over ``Hkv`` kv heads:
    bf16, the decode kernel (T = 1), the tile kernel and the row kernel,
    the first two in their head_dim-256 forms where hd is 256; f32, the f32
    decode kernel (where it holds the G * T rows), the f32 tile form and
    the row kernel."""
    from bee2bee_tpu_torch.ops.ragged import DECODE_F32_MAX_ROWS

    T, hd = q.shape[1], q.shape[3]
    sfx = "_hd256" if hd == 256 else ""
    if q.dtype == torch.bfloat16:
        return (("decode" + sfx,) if T == 1 else ()) + ("tile" + sfx, "row")
    fits = q.shape[2] // Hkv * T <= DECODE_F32_MAX_ROWS
    return (("decode_f32",) if fits else ()) + ("tile_f32", "row")


def time_forced(label, q, kp, vp, tb, off, flush, scales=None, window=0,
                sm_scale=None):
    """Each kernel that takes these queries (``forced_kernels``) forced at
    the same inputs."""
    from bee2bee_tpu_torch.ops.ragged import _launch_kernel, row_offsets

    rows = row_offsets(off, q.shape[0], q.device)
    sc = (None, None) if scales is None else scales
    scale = sm_scale or 1.0 / math.sqrt(q.shape[3])
    ms = {k: cuda_time_ms(lambda: _launch_kernel(
        q, kp, vp, tb, rows, window, scale, 0.0, *sc, kernel=k),
        flush=flush) for k in forced_kernels(q, kp.shape[0])}
    plan = "".join(f" ({k} plan {split_plan(q, kp, tb, k)})" for k in ms
                   if k.startswith("decode"))
    log(f"forced {label} B={q.shape[0]} T={q.shape[1]} hd={q.shape[3]} ({q.dtype})"
        f"{plan}: " + ", ".join(f"{k} kernel {t:.4f} ms" for k, t in ms.items()))
    return ms


def phase_ragged_vs_plain(flush, int8=False):
    """Phase 2 (the pool in q's type) or phase 3 (int8 pool): each case, in
    bf16 and f32 and at head_dim 256, through the dispatching wrapper
    against the plain version, the kernel the rule names launched once;
    then the timings. Returns (max abs error per kernel, timings)."""
    from bee2bee_tpu_torch.ops.ragged import (
        _launch_kernel, ragged_paged_attention, ragged_paged_attention_ref, row_offsets,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + int8)
    tag = "int8 kernel vs plain" if int8 else "kernel vs plain"
    errs = {k: 0.0 for k in RAGGED_COUNTERS}
    for label, geo, kw in RAGGED_CASES + F32_RAGGED_CASES + HD256_RAGGED_CASES:
        q, kp, vp, tb, off = make_case(gen, **geo)
        if int8:
            kp, vp, ks, vs = int8_pools(gen, kp.shape[1], Hkv=kp.shape[0],
                                        BS=kp.shape[2], hd=kp.shape[3])
            kw = dict(kw, k_scale=ks, v_scale=vs)
        counter = ragged_counter(q, kp.shape[0], int8)
        reset_counts()
        got = ragged_paged_attention(q, kp, vp, tb, off, **kw)
        torch.cuda.synchronize()
        check_one_launch(f"{tag}: {label}", counter)
        if int8:  # the plain version dequantizes and rounds to q's type
            want = ragged_paged_attention_ref(q, kp, vp, tb, off, **kw).float()
        else:
            want = ragged_paged_attention_ref(
                q.float(), kp.float(), vp.float(), tb, off, **kw)
        tol = KERNEL_TOL if q.dtype == torch.bfloat16 else F32_TOL
        check(bool(torch.isfinite(got).all()), f"{tag}: {label}: non-finite output")
        err = (got.float() - want).abs().max().item()
        log(f"{tag}: {label} ({q.dtype}, {counter} kernel): max abs err "
            f"{err:.3e} (tol {tol})")
        check(err <= tol, f"{tag}: {label}: max abs err {err} > {tol}")
        if "offset -1" in label:
            check(not bool(got[0].any()), f"{tag}: {label}: the row at -1 is not 0")
        if counter.startswith("ragged_decode"):
            # the split-K merges run in a fixed order: a second call repeats
            # the first bit for bit
            again = ragged_paged_attention(q, kp, vp, tb, off, **kw)
            check(torch.equal(got, again), f"{tag}: {label}: a second call differs")
        kernel = next(k for k, c in RAGGED_COUNTERS.items()
                      if counter in (c, c + "_int8"))
        errs[kernel] = max(errs[kernel], err)
        if label in ROW_FORCED_CASES:
            forced = _launch_kernel(
                q, kp, vp, tb, row_offsets(off, q.shape[0], q.device), kw["window"],
                kw["sm_scale"], kw["logit_softcap"], kw.get("k_scale"), kw.get("v_scale"),
                kernel="row")
            err = (forced.float() - want).abs().max().item()
            log(f"{tag}: {label} (row kernel forced): max abs err {err:.3e} (tol {tol})")
            check(err <= tol, f"{tag}: {label}: row kernel forced: max abs err {err} > {tol}")
            errs["row"] = max(errs["row"], err)

    timings = {}
    label0 = "int8 " if int8 else ""
    # llama-3-8b's heads, then gemma-2-9b's (window and score scale, no cap:
    # GEMMA_TIMED_KW); the forced timings put every kernel that takes the
    # inputs beside the one the rule names
    for label, offs, T, dtype, heads, forced in (
            ("decode", [1023] * 8, 1, torch.bfloat16, {}, True),
            ("decode_b1", [2047], 1, torch.bfloat16, {}, True),
            ("decode_f32", [1023] * 8, 1, torch.float32, {}, True),
            ("decode_f32_b1", [2047], 1, torch.float32, {}, True),
            ("prefill", [1000], 512, torch.bfloat16, {}, False),
            ("prefill_f32", [1000], 512, torch.float32, {}, False),
            # the speculative verify shape: B=8, T=K+1=5 over a 1024 context
            ("verify", [1023] * 8, 5, torch.bfloat16, {}, False),
            ("verify_f32", [1023] * 8, 5, torch.float32, {}, False),
            ("decode_hd256", [1023] * 8, 1, torch.bfloat16, GEMMA, True),
            ("prefill_hd256", [1000], 512, torch.bfloat16, GEMMA, True),
            ("decode_hd256_f32", [1023] * 8, 1, torch.float32, GEMMA, True),
            ("prefill_hd256_f32", [1000], 512, torch.float32, GEMMA, True)):
        q, kp, vp, tb, off = make_case(gen, offs=offs, T=T, dtype=dtype, **heads)
        scales = None
        if int8:
            kp, vp, *scales = int8_pools(gen, kp.shape[1], Hkv=kp.shape[0],
                                         hd=kp.shape[3])
        kw = GEMMA_TIMED_KW if heads else {}
        timings[label] = time_ragged(f"{label0}{label} ({ragged_counter(q, kp.shape[0], int8)} "
                                     f"kernel)", q, kp, vp, tb, off, offs, T, flush,
                                     scales=scales, **kw)
        if forced:
            timings[label]["forced"] = time_forced(f"{label0}{label}", q, kp, vp, tb,
                                                   off, flush, scales=scales, **kw)
        if label == "decode":
            time_decode_sweep(f"{label0}{label}", q, kp, vp, tb, off, scales=scales)
    time_crossover(f"{label0}pool".strip(), gen, flush, int8)
    time_crossover(f"{label0}pool".strip(), gen, flush, int8, dtype=torch.float32)
    time_crossover(f"{label0}pool".strip(), gen, flush, int8, heads=GEMMA)
    time_crossover(f"{label0}pool".strip(), gen, flush, int8, dtype=torch.float32,
                   heads=GEMMA)
    return errs, timings


# ------------------------------------------------------------ phase 4


def time_flash(label, q, k, v, flush, kernel=None):
    """Causal flash attention's time (the kernel the rule names, or
    ``kernel`` forced) beside the plain version's, SDPA(is_causal)'s in q's
    type and the bound (f32: the 3xTF32 and the FFMA bounds)."""
    from bee2bee_tpu_torch.ops.flash import (
        _launch_kernel, flash_attention_ref, flash_kernel,
    )

    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    kernel = kernel or flash_kernel(q.dtype, hd)
    off = torch.zeros(B, dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(hd)
    ms = cuda_time_ms(lambda: _launch_kernel(q, k, v, off, True, scale, kernel=kernel),
                      flush=flush)
    plain_ms = cuda_time_ms(lambda: flash_attention_ref(q, k, v), flush=flush)
    qs = q.transpose(1, 2).contiguous()  # [B, H, T, hd]
    ks = k.transpose(1, 2).repeat_interleave(H // Hkv, dim=1).contiguous()
    vs = v.transpose(1, 2).repeat_interleave(H // Hkv, dim=1).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_time_ms(lambda: sdpa(qs, ks, vs, is_causal=True), flush=flush)
    log_sdpa_backend(f"flash, {q.dtype}, hd {hd}, is_causal",
                     lambda: sdpa(qs, ks, vs, is_causal=True))
    # q, k, v read once, the output written once; 4*hd flops per visible
    # (query, key) pair of each head
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * hd * H * B * (T * (T + 1) // 2)
    b = bounds(nbytes, flops, q.dtype)
    log(f"timing flash {label} causal B={B} T=S={T} H={H}/{Hkv} hd={hd} ({q.dtype}, "
        f"{kernel} kernel): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa(is_causal) {library_ms:.4f} ms, {b['text']}, share of bound "
        f"{b['bound_ms'] / ms:.3f}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **{k: v for k, v in b.items() if k != "text"})


# read_counts()'s name of each flash kernel's counter
FLASH_COUNTERS = {"row": "flash", "tile": "flash_tile", "tile_hd256": "flash_tile_hd256",
                  "tile_f32": "flash_tile_f32"}


def phase_flash_vs_plain(flush):
    from bee2bee_tpu_torch.ops.flash import (
        _launch_kernel, flash_attention, flash_attention_ref, flash_kernel,
    )
    from bee2bee_tpu_torch.ops.ragged import row_offsets

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)

    def qkv(B, T, S, dtype=torch.bfloat16, H=32, Hkv=8, hd=128):
        return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                     for shape in ((B, T, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))

    def offsets(offs):
        return torch.tensor(offs, dtype=torch.int32, device="cuda")

    f32 = torch.float32
    cases = [
        ("causal T=S=2048", qkv(1, 2048, 2048), dict(offset=None)),
        ("decode B=8 T=1 S=2048 ragged + empty row", qkv(8, 1, 2048), dict(
            offset=offsets([0, 1, 31, 32, 700, 1500, 2047, -1]))),
        ("T=512 @1000 S=2048", qkv(1, 512, 2048), dict(offset=1000)),
        ("non-causal T=S=256", qkv(2, 256, 256), dict(causal=False)),
        ("f32 T=64 S=256 @[10,150]", qkv(2, 64, 256, f32), dict(
            offset=offsets([10, 150]))),
        ("f32 causal T=S=2048", qkv(1, 2048, 2048, f32), dict(offset=None)),
        ("f32 decode B=8 T=1 S=2048 ragged + empty row", qkv(8, 1, 2048, f32), dict(
            offset=offsets([0, 1, 31, 32, 700, 1500, 2047, -1]))),
        ("f32 non-causal T=S=256", qkv(2, 256, 256, f32), dict(causal=False)),
        ("f32 hd=64 T=100 S=300 @200", qkv(2, 100, 300, f32, hd=64), dict(offset=200)),
        ("hd256 gemma bf16 T=64 S=256 @[10,150]", qkv(2, 64, 256, **GEMMA), dict(
            offset=offsets([10, 150]))),
        ("hd256 gemma bf16 causal T=S=2048", qkv(1, 2048, 2048, **GEMMA),
         dict(offset=None)),
        ("hd256 gemma bf16 decode B=8 T=1 S=2048 ragged + empty row",
         qkv(8, 1, 2048, **GEMMA), dict(
             offset=offsets([0, 1, 31, 32, 700, 1500, 2047, -1]))),
        ("hd256 gemma bf16 T=100 S=300 @200", qkv(2, 100, 300, **GEMMA),
         dict(offset=200)),
        ("hd256 gemma bf16 non-causal T=S=256", qkv(2, 256, 256, **GEMMA),
         dict(causal=False)),
        ("hd256 gemma f32 T=64 S=256 @[10,150]", qkv(2, 64, 256, f32, **GEMMA), dict(
            offset=offsets([10, 150]))),
        ("hd256 gemma f32 causal T=S=2048", qkv(1, 2048, 2048, f32, **GEMMA),
         dict(offset=None)),
        ("hd256 gemma f32 decode B=8 T=1 S=2048 ragged + empty row",
         qkv(8, 1, 2048, f32, **GEMMA), dict(
             offset=offsets([0, 1, 31, 32, 700, 1500, 2047, -1]))),
        ("hd256 gemma f32 non-causal T=S=256", qkv(2, 256, 256, f32, **GEMMA),
         dict(causal=False)),
    ]
    errs = {k: 0.0 for k in FLASH_COUNTERS}
    for label, (q, k, v), kw in cases:
        kernel = flash_kernel(q.dtype, q.shape[3])
        counter = FLASH_COUNTERS[kernel]
        reset_counts()
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        check_one_launch(f"flash {label}", counter)
        want = flash_attention_ref(q, k, v, **kw)
        tol = KERNEL_TOL if q.dtype == torch.bfloat16 else F32_TOL
        check(bool(torch.isfinite(got).all()), f"flash {label}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        log(f"flash vs plain: {label} ({q.dtype}, {counter} kernel): max abs err "
            f"{err:.3e} (tol {tol})")
        check(err <= tol, f"flash {label}: max abs err {err} > {tol}")
        if "empty row" in label:
            check(not bool(got[7].any()), "flash: the empty row is not 0")
        errs[kernel] = max(errs[kernel], err)
        if label.endswith("T=64 S=256 @[10,150]") and label.startswith("hd256"):
            # the row kernel, which the rule no longer names, forced where it
            # served head_dim 256 before
            forced = _launch_kernel(q, k, v, row_offsets(kw["offset"], q.shape[0], q.device),
                                    True, 1.0 / math.sqrt(q.shape[3]), kernel="row")
            err = (forced.float() - want.float()).abs().max().item()
            log(f"flash vs plain: {label} (row kernel forced): max abs err {err:.3e} "
                f"(tol {tol})")
            check(err <= tol, f"flash {label}: row kernel forced: max abs err {err} > {tol}")
            errs["row"] = max(errs["row"], err)

    q, k, v = cases[0][1]
    timings = {"tile": time_flash("tile kernel", q, k, v, flush)}
    q, k, v = cases[5][1]
    timings["tile_f32"] = time_flash("f32 tile kernel", q, k, v, flush)
    timings["row_f32_hd128"] = time_flash("row kernel forced", q, k, v, flush,
                                          kernel="row")
    # gemma heads: the tile kernel's head_dim-256 form (bf16) and the f32
    # tile kernel, each with the row kernel forced beside it
    by_label = {label: qkv_ for label, qkv_, _ in cases}
    q, k, v = by_label["hd256 gemma bf16 causal T=S=2048"]
    timings["tile_hd256"] = time_flash("tile kernel hd256 gemma", q, k, v, flush)
    timings["row_hd256"] = time_flash("row kernel forced hd256 gemma", q, k, v, flush,
                                      kernel="row")
    q, k, v = by_label["hd256 gemma f32 causal T=S=2048"]
    timings["tile_f32_hd256"] = time_flash("f32 tile kernel hd256 gemma", q, k, v, flush)
    timings["row_hd256_f32"] = time_flash("row kernel forced hd256 gemma", q, k, v,
                                          flush, kernel="row")
    return errs, timings


# ------------------------------------------------------------ phase 5


def gemma_attention_config():
    """gemma-2-9b's attention geometry (models/config.py) on the llama
    architecture the port runs, 2 layers: d_model 3584, 16 heads over 8 kv
    heads at head_dim 256 (override), a 4096-key window on every second
    layer, scores capped at 50, score scale 1/sqrt(256); llama-3-8b's
    vocabulary, MLP and norms."""
    from bee2bee_tpu_torch.models.config import get_config

    return replace(get_config("llama-3-8b"), name="llama-gemma-2-9b-attention",
                   n_layers=2, d_model=3584, n_heads=16, n_kv_heads=8,
                   head_dim_override=256, sliding_window=4096, sliding_window_every=2,
                   attn_logit_softcap=50.0)


def forward_setup(cfg=None):
    """Phase 5's model and inputs: ``cfg`` (default llama-3-8b at full
    width with 2 layers), f32 weights from SEED, a 300-token prompt and the
    block table for it and 8 greedy decode steps. Returns (cfg, params,
    run): run(attn_fn, pool_dtype, weights) -> (prefill logits, stacked
    step logits, greedy tokens)."""
    from bee2bee_tpu_torch.models import core
    from bee2bee_tpu_torch.models.config import get_config
    from bee2bee_tpu_torch.models.params import init_params

    cfg = cfg or replace(get_config("llama-3-8b"), n_layers=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = init_params(cfg, gen, "cuda", torch.float32)
    BS, n_prompt, n_steps = 16, 300, 8
    nblocks = -(-(n_prompt + n_steps) // BS)
    MB = 1 << (nblocks - 1).bit_length()
    tables = torch.zeros((1, MB), dtype=torch.int32, device="cuda")
    tables[0, :nblocks] = torch.arange(1, nblocks + 1, dtype=torch.int32)
    ids = torch.randint(3, 259, (1, n_prompt), generator=gen, device="cuda")

    def run(attn_fn, pool_dtype=torch.float32, weights=params):
        pool = core.init_paged_pool(cfg, nblocks + 1, BS, pool_dtype, "cuda")
        logits, _ = core.forward(weights, cfg, ids, pool, 0, tables, attn_fn=attn_fn)
        steps = [logits[:, -1]]
        toks = []
        for i in range(n_steps):
            tok = torch.argmax(steps[-1], dim=-1)
            toks.append(int(tok))
            lg, _ = core.forward(weights, cfg, tok[:, None], pool, n_prompt + i,
                                 tables, attn_fn=attn_fn)
            steps.append(lg[:, -1])
        return logits, torch.stack(steps), toks

    return cfg, params, run


def forward_device_ms(run, pool_dtype) -> tuple[float, float]:
    """(device busy ms, attention kernels' ms) of one of phase 5's forward
    runs through the kernels the package's dispatch names, under
    torch.profiler (after a warm-up run). It reads no launch counter, so it
    times another tree's package as well: put that tree first on sys.path
    and load this file by its path."""
    from torch.profiler import ProfilerActivity, profile

    from bee2bee_tpu_torch.ops.ragged import ragged_paged_attention

    run(ragged_paged_attention, pool_dtype)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(ragged_paged_attention, pool_dtype)
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(t for _, t in kernels) / 1e3
    attn = sum(t for k, t in kernels if any(n in k for n in ATTENTION_KERNELS)) / 1e3
    return busy, attn


def phase_forward_parity():
    from bee2bee_tpu_torch.ops.ragged import (
        ragged_kernel, ragged_paged_attention, ragged_paged_attention_ref,
    )

    cfg, params, run = forward_setup()
    n_prompt, n_steps = 300, 8
    f32_launches: dict = {}

    def check_f32_launches(tag, int8):
        # the prefill and each decode step through the kernel the rule
        # names for its chunk length and pool form, and no other
        want: dict = {}
        for T, n in ((n_prompt, 1), (1, n_steps)):
            kernel = ragged_kernel(torch.float32, T, cfg.head_dim, int8,
                                   cfg.n_heads // cfg.n_kv_heads)
            counter = RAGGED_COUNTERS[kernel] + ("_int8" if int8 else "")
            want[counter] = want.get(counter, 0) + cfg.n_layers * n
        got = {k: v for k, v in read_counts().items() if v}
        check(got == want, f"{tag}: launches {got}, expected {want}")
        log(f"{tag}: launches {got}")
        f32_launches.update(got)

    reset_counts()
    k_logits, k_steps, k_toks = run(ragged_paged_attention)
    torch.cuda.synchronize()
    check_f32_launches("forward f32 pool", False)
    p_logits, p_steps, p_toks = run(ragged_paged_attention_ref)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(k_logits).all() and torch.isfinite(k_steps).all()),
          "forward: non-finite logits")
    err_prefill = (k_logits - p_logits).abs().max().item()
    err_decode = (k_steps - p_steps).abs().max().item()
    log(f"forward 2x llama-3-8b width f32: prefill {n_prompt} logits max abs err "
        f"{err_prefill:.3e}, decode {n_steps} steps max abs err {err_decode:.3e} "
        f"(tol {FORWARD_TOL}); greedy kernel {k_toks} plain {p_toks}")
    check(max(err_prefill, err_decode) <= FORWARD_TOL,
          f"forward logits differ by {max(err_prefill, err_decode)}")
    check(k_toks == p_toks, f"greedy tokens differ: {k_toks} vs {p_toks}")

    # the same over an int8 pool: both quantize on write with the same
    # torch ops; the kernel reads the int8 pages with their scales
    reset_counts()
    q_logits, q_steps, q_toks = run(ragged_paged_attention, torch.int8)
    torch.cuda.synchronize()
    check_f32_launches("forward f32, int8 pool", True)
    qp_logits, qp_steps, qp_toks = run(ragged_paged_attention_ref, torch.int8)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(q_logits).all() and torch.isfinite(q_steps).all()),
          "int8 forward: non-finite logits")
    q_err = max((q_logits - qp_logits).abs().max().item(),
                (q_steps - qp_steps).abs().max().item())
    gap = max((q_logits - k_logits).abs().max().item(),
              (q_steps - k_steps).abs().max().item())
    log(f"forward 2x llama-3-8b width f32, int8 pool: logits max abs err "
        f"{q_err:.3e} (tol {FORWARD_TOL}); greedy kernel {q_toks} plain {qp_toks}; "
        f"int8-vs-f32 pool logit gap {gap:.3e} (for information), greedy "
        f"tokens {'equal' if q_toks == k_toks else 'differ'} to the f32 pool's")
    check(q_err <= FORWARD_TOL, f"int8 forward logits differ by {q_err}")
    check(q_toks == qp_toks, f"int8 greedy tokens differ: {q_toks} vs {qp_toks}")
    for pool_dtype in (torch.float32, torch.int8):
        busy, attn = forward_device_ms(run, pool_dtype)
        log(f"forward 2x llama-3-8b width f32, {str(pool_dtype)[6:]} pool: device busy "
            f"{busy:.3f} ms for the {n_prompt}-token prefill + {n_steps} decode steps, "
            f"attention kernels {attn:.3f} ms")

    # bf16, where the 300-token prefill goes through the tile kernel (P
    # rounded to bf16, other summation order). Tolerance: the kernels may
    # move the prefill logits no further from the plain bf16 forward than
    # bf16 itself moves the plain forward from the f32 one on the same
    # weights. Greedy tokens may part at bf16 near-ties and are printed.
    bparams = cast_tree(params, torch.bfloat16)
    for pool_dtype, f32_logits in ((torch.bfloat16, p_logits), (torch.int8, qp_logits)):
        tag = f"forward 2x llama-3-8b width bf16, {str(pool_dtype)[6:]} pool"
        tile = "ragged_prefill" + ("_int8" if pool_dtype == torch.int8 else "")
        dec = "ragged_decode" + ("_int8" if pool_dtype == torch.int8 else "")
        reset_counts()
        b_logits, _, b_toks = run(ragged_paged_attention, pool_dtype, bparams)
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts[tile] == cfg.n_layers and counts[dec] == cfg.n_layers * n_steps
              and sum(counts.values()) == cfg.n_layers * (n_steps + 1),
              f"{tag}: launches {counts}: expected the prefill through {tile}, "
              f"the {n_steps} decode steps through {dec}")
        bp_logits, _, bp_toks = run(ragged_paged_attention_ref, pool_dtype, bparams)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(b_logits).all()), f"{tag}: non-finite logits")
        err = (b_logits - bp_logits).abs().max().item()
        tol = (bp_logits - f32_logits).abs().max().item()
        log(f"{tag}: prefill {n_prompt} logits max abs err {err:.3e} (tol {tol:.3e}, "
            f"the plain bf16 forward's gap to the plain f32 forward); launches "
            f"{counts}; greedy kernel {b_toks} plain {bp_toks}")
        check(err <= tol, f"{tag}: logits differ by {err} > {tol}")
    del params, bparams
    torch.cuda.empty_cache()
    return f32_launches


def phase_gemma_forward() -> dict:
    """Phase 5, head_dim 256: one bf16 forward (300-token prefill, 8 greedy
    decode steps) at gemma-2-9b's attention geometry, over a bf16 pool and
    an int8 pool. Each must launch only the head_dim-256 forms of the tile
    kernel (the prefill) and the decode kernel (the steps) of its pool,
    n_layers times a forward; its prefill logits stay within the plain
    bf16 forward's gap to the plain f32 forward, and its greedy tokens
    equal the plain bf16 forward's. Returns the launch counts per pool,
    zeroed just before and read just after each kernel forward."""
    from bee2bee_tpu_torch.ops.ragged import ragged_paged_attention, ragged_paged_attention_ref

    cfg, params, run = forward_setup(gemma_attention_config())
    n_steps = 8
    bparams = cast_tree(params, torch.bfloat16)
    launches = {}
    for pool_dtype in (torch.bfloat16, torch.int8):
        pool = str(pool_dtype)[6:]
        sfx = "_int8" if pool_dtype == torch.int8 else ""
        tag = f"forward 2x gemma-2-9b attention geometry bf16, {pool} pool"
        f32_logits, _, _ = run(ragged_paged_attention_ref,
                               torch.int8 if sfx else torch.float32)
        reset_counts()
        b_logits, _, b_toks = run(ragged_paged_attention, pool_dtype, bparams)
        torch.cuda.synchronize()
        counts = read_counts()
        launches[pool] = counts
        got = {k: v for k, v in counts.items() if v}
        want = {"ragged_prefill_hd256" + sfx: cfg.n_layers,
                "ragged_decode_hd256" + sfx: cfg.n_layers * n_steps}
        check(got == want, f"{tag}: launches {got}, expected {want}")
        bp_logits, _, bp_toks = run(ragged_paged_attention_ref, pool_dtype, bparams)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(b_logits).all()), f"{tag}: non-finite logits")
        err = (b_logits - bp_logits).abs().max().item()
        tol = (bp_logits - f32_logits).abs().max().item()
        log(f"{tag}: prefill 300 logits max abs err {err:.3e} (tol {tol:.3e}, the "
            f"plain bf16 forward's gap to the plain f32 forward); launches {got}; "
            f"greedy kernel {b_toks} plain {bp_toks}")
        check(err <= tol, f"{tag}: logits differ by {err} > {tol}")
        check(b_toks == bp_toks, f"{tag}: greedy tokens differ: {b_toks} vs {bp_toks}")
    del params, bparams
    torch.cuda.empty_cache()
    return launches


def cast_tree(tree, dtype):
    """A copy of a parameter tree (dicts, lists, tensors) with its floating
    tensors cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


# ------------------------------------------------------------ phases 6-8


# the port's attention kernels by (part of) name: the ragged kernels (the
# decode kernel's split walk and merge) and the flash kernels, f32 forms too
ATTENTION_KERNELS = ("attention_kernel", "ragged_prefill_kernel", "ragged_decode_",
                     "flash_tile_kernel", "ragged_prefill_f32_kernel",
                     "flash_tile_f32_kernel")


def device_profile(fn, calls: int, launches: int, tries: int = 3):
    """(device busy ms per call, attention kernels' ms per call, [(kernel,
    share of device time)] top 4): the kernels' own device time under
    torch.profiler, summed. A capture that saw fewer than ``launches``
    launches of an attention kernel (it has lost some of the calls'
    kernels) is taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        seen = [e.count for e in events if any(n in e.key for n in ATTENTION_KERNELS)]
        if seen and min(seen) >= launches:
            break
        log(f"profile: attention kernel launches seen {seen}, expected {launches} "
            f"each; capture {attempt + 1} of {tries} lost kernels")
    check(bool(seen) and min(seen) >= launches,
          f"the profiler saw {seen} attention launches of {launches}")
    kernels = [(e.key, e.self_device_time_total) for e in events]
    busy_us = sum(t for _, t in kernels)
    check(busy_us > 0, "the profiler saw no device time")
    attn_us = sum(t for k, t in kernels if any(n in k for n in ATTENTION_KERNELS))
    top = sorted(kernels, key=lambda kt: -kt[1])[:4]
    return (busy_us / 1e3 / calls, attn_us / 1e3 / calls,
            [(k[:48], round(t / busy_us, 3)) for k, t in top])


def step_breakdown(engine, card: str, B=8, ctx=1024, steps=10, prefill=2048, full=True):
    """Where the serving forwards' time goes: a B-row decode step at
    context ``ctx`` and one ``prefill``-token prefill chunk. Host wall time
    (synchronised, profiler off) beside the device's busy time (kernel
    durations under torch.profiler); 1 - busy/wall is the device's idle
    share. The decode step three ways: the bare forward, the scheduler's
    decode step run eagerly (forward, greedy sampling, the in-place state
    updates) and the same step replayed from its captured CUDA graph, as
    the served path runs it; and replayed at batch 1 (phase 9's batch).
    Not ``full``: the B-row step replayed from its graph alone."""
    from bee2bee_tpu_torch.models import core

    cfg = engine.model_cfg
    BS = engine.engine_cfg.kv_block_size
    nblocks = -(-max(ctx + steps, prefill) // BS)
    pool = core.init_paged_pool(cfg, 1 + B * nblocks, BS, engine.cache_dtype, "cuda")
    tables = (1 + torch.arange(B * nblocks, dtype=torch.int32, device="cuda")
              ).reshape(B, nblocks)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    tok = torch.randint(3, 259, (B, 1), generator=gen, device="cuda")
    off = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    ids = torch.randint(3, 259, (1, prefill), generator=gen, device="cuda")
    last = torch.tensor([prefill - 1], device="cuda")

    def decode():
        engine.forward(tok, pool, off, tables)

    def prefill_chunk():
        engine.forward(ids, pool, 0, tables[:1], logits_index=last)

    sch = engine.scheduler
    kv = engine.engine_cfg.cache_dtype
    if engine.engine_cfg.dtype != "bfloat16":
        kv = f"{engine.engine_cfg.dtype} queries, {kv}"
    steps_of = []
    for rows in (B, 1) if full else (B,):  # at batch 1 too: phase 9's traffic
        key, views, load = decode_state(engine, rows, ctx)
        graph = sch._graphs.get(key) or sch._capture(key)
        label = f"decode step B={rows} ctx={ctx}, scheduler step"
        if rows == B and full:
            steps_of.append((f"{label} eager ({kv} pool)",
                             functools.partial(sch._decode_step, views), steps, load))
        steps_of.append((f"{label} graph-replayed ({kv} pool)", graph.replay, steps,
                         load))
    if full:
        steps_of = [(f"decode step B={B} ctx={ctx} ({kv} pool)", decode, steps, None),
                    *steps_of,
                    (f"prefill chunk T={prefill} ({kv} pool)", prefill_chunk, 2, None)]
    for label, fn, calls, load in steps_of:
        if load is not None:
            load()
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
        busy_ms, attn_ms, top = device_profile(fn, calls, cfg.n_layers * calls)
        log(f"breakdown {label}: host wall {wall_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms, device idle share {1 - busy_ms / wall_ms:.3f}; "
            f"attention kernels {attn_ms / cfg.n_layers:.4f} ms per launch "
            f"({attn_ms / busy_ms:.3f} of busy); "
            f"top kernels by device time {top}; card {card}")
    weight_bytes = engine.info["n_params"] * engine.dtype.itemsize
    log(f"breakdown: weights {weight_bytes} B -> "
        f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms per step at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s")


def decode_state(engine, B=8, ctx=1024, sampled_row=None):
    """Put the idle scheduler into a B-row decode state at about ``ctx``
    tokens: bucket B, each row's table over its own pool blocks (the
    table width the scheduler would pick), offsets ctx - (ctx // 32) b, random
    tokens, greedy knobs (``sampled_row`` at temperature 1), the chunk's
    step index 0. Returns (the decode key, its views, a function that
    loads the offsets, tokens and step index again). The pool keeps its
    bytes; the scheduler thread must be idle (nothing queued or active)."""
    sch = engine.scheduler
    check(not sch.active and not sch._inflight and not sch._queue,
          "decode state: the scheduler is not idle")
    K = engine.engine_cfg.decode_chunk
    BS = engine.engine_cfg.kv_block_size
    nb = -(-(ctx + K) // BS)
    tw = sch._table_width(nb)
    sch._resize(B)
    key = (B, tw, False, False, False, sampled_row is not None)
    v = sch._views(key)
    tables = torch.zeros((B, tw), dtype=torch.int32)
    tables[:, :nb] = 1 + torch.arange(B * nb, dtype=torch.int32).reshape(B, nb)
    v.tables.copy_(tables)
    for i, neutral in enumerate((0.0, 1.0, 0.0, 1.0, 0.0, 0.0)):
        sch._d_knobs_f[i, :B] = neutral
    sch._d_top_k[:B] = 0
    if sampled_row is not None:
        sch._d_knobs_f[0, sampled_row] = 1.0
    sch._row_params_dirty = True  # the next dispatch stages its own knobs
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    cur = torch.randint(3, engine.model_cfg.vocab_size, (B,), generator=gen,
                        device="cuda")
    off = torch.tensor([ctx - ctx // 32 * b for b in range(B)], dtype=torch.int32,
                       device="cuda")

    def load():
        v.cur.copy_(cur)
        v.off.copy_(off)
        v.step.zero_()

    load()
    return key, v, load


def graph_vs_eager(engine, tag: str, ctx: int = 1024) -> None:
    """One decode chunk of the scheduler's decode step run eagerly and one
    by replays of its captured graph, from the same state (pool pages and
    an int8 pool's scales over random content, tokens, offsets, tables):
    the greedy tokens and the pool's bytes (and scales) must be equal bit
    for bit, except the null block 0, which the capture's warm-up writes
    and every reader masks. Then two replays of the sampled graph from the
    same state, a row at temperature 1: the greedy rows equal, the sampled
    row's draws different (the generator is registered with the graph, so
    each replay draws fresh noise)."""
    sch = engine.scheduler
    K = engine.engine_cfg.decode_chunk
    pool = sch._cache
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    if engine.kv_quantized:
        for name in ("k", "v"):
            pool[name].copy_(torch.randint(-127, 128, pool[name].shape, generator=gen,
                                           device="cuda", dtype=torch.int8))
            pool[name + "_scale"].copy_(
                torch.rand(pool[name + "_scale"].shape, generator=gen, device="cuda")
                * 0.02)
    else:
        for name in ("k", "v"):
            pool[name].normal_(generator=gen)
    saved = {name: t.clone() for name, t in pool.items()}

    def reload(load):
        for name, t in pool.items():
            t.copy_(saved[name])
        load()

    key, v, load = decode_state(engine, ctx=ctx)
    reload(load)
    for _ in range(K):
        sch._decode_step(v)
    torch.cuda.synchronize()
    # the pool's block axis is 2 in the pages and the scales alike
    eager = (v.toks.clone(), v.cur.clone(), v.off.clone(),
             {n: t[:, :, 1:].clone() for n, t in pool.items()})
    reload(load)
    sch._decode_chunk(key)
    torch.cuda.synchronize()
    same_pool = all(torch.equal(eager[3][n], t[:, :, 1:]) for n, t in pool.items())
    log(f"{tag} graph vs eager: one chunk of {K} steps at B=8 ctx {ctx} key {key}: "
        f"tokens equal {torch.equal(eager[0], v.toks)}, cur/offsets equal "
        f"{torch.equal(eager[1], v.cur) and torch.equal(eager[2], v.off)}, pool bytes "
        f"outside the null block equal {same_pool} ({sorted(pool)})")
    check(torch.equal(eager[0], v.toks), f"{tag}: replayed greedy tokens differ "
          "from the eager chunk's")
    check(torch.equal(eager[1], v.cur) and torch.equal(eager[2], v.off),
          f"{tag}: replayed cur/offsets differ from the eager chunk's")
    check(same_pool, f"{tag}: replayed pool bytes differ from the eager chunk's")
    del eager
    key_s, v_s, load_s = decode_state(engine, ctx=ctx, sampled_row=7)
    draws = []
    for _ in range(2):
        reload(load_s)
        sch._decode_chunk(key_s)
        draws.append(v_s.toks.clone())
    torch.cuda.synchronize()
    differ = int((draws[0][7] != draws[1][7]).sum())
    log(f"{tag} sampled replays (row 7 at temperature 1, key {key_s}): greedy rows "
        f"equal {torch.equal(draws[0][:7], draws[1][:7])}, row 7 differs at "
        f"{differ} of {K} steps")
    check(torch.equal(draws[0][:7], draws[1][:7]),
          f"{tag}: two replays from one state gave different greedy tokens")
    check(differ > 0, f"{tag}: two sampled replays drew the same tokens")
    reload(load)


def random_pool(engine, seed: int) -> dict:
    """Fill the scheduler's pool with random content (an int8 pool's pages
    and scales too); returns a copy to reload it from."""
    pool = engine.scheduler._cache
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    if engine.kv_quantized:
        for name in ("k", "v"):
            pool[name].copy_(torch.randint(-127, 128, pool[name].shape, generator=gen,
                                           device="cuda", dtype=torch.int8))
            pool[name + "_scale"].copy_(
                torch.rand(pool[name + "_scale"].shape, generator=gen, device="cuda")
                * 0.02)
    else:
        for name in ("k", "v"):
            pool[name].normal_(generator=gen)
    return {name: t.clone() for name, t in pool.items()}


def prefill_vs_eager(engine, tag: str) -> None:
    """A prefill chunk of the scheduler's prefill root run eagerly and by a
    replay of its captured graph, from the same state (random pool pages,
    an int8 pool's scales too): a miss (1,000 tokens at offset 0, floor
    0, bucket 1024) and a hit (104 new tokens at offset 1000 over the
    first's 62 full blocks, its partial block copied first as a CoW hit
    does, floor 1000, bucket 128). The last logits and the pool's bytes
    (and scales) outside the null block must be equal bit for bit, and
    each replay must launch the tile kernel the rule names n_layers
    times. Prints the captures (by key, with their seconds)."""
    from bee2bee_tpu_torch.engine.scheduler import copy_block
    from bee2bee_tpu_torch.ops.ragged import ragged_kernel

    sch = engine.scheduler
    cfg = engine.model_cfg
    check(not sch.active and not sch._inflight and not sch._queue,
          f"{tag} prefill vs eager: the scheduler is not idle")
    pool = sch._cache
    saved = random_pool(engine, SEED + 3)
    G = cfg.n_heads // cfg.n_kv_heads
    kernel = RAGGED_COUNTERS[ragged_kernel(engine.dtype, 128, cfg.head_dim,
                                           engine.kv_quantized, G)]
    kernel += "_int8" if engine.kv_quantized else ""
    gen = np.random.default_rng(SEED)
    prompt = gen.integers(3, cfg.vocab_size, size=1104).tolist()
    donor = np.arange(1, 64, dtype=np.int32)  # the miss's 63 blocks
    fresh = np.arange(100, 107, dtype=np.int32)  # the hit's CoW copy + 6 more
    hit_table = np.zeros(128, np.int32)
    hit_table[:62], hit_table[62:69] = donor[:62], fresh
    cases = (("miss", prompt[:1000], 1024, 0, np.pad(donor, (0, 1)), 0, 1000),
             ("hit", prompt[1000:], 128, 1000, hit_table, 1000, 1104))
    since = graph_stats(engine, tag)
    out = []
    for name, chunk, bucket, pos, table, floor, ceil in cases:
        for t, v in zip(pool.values(), saved.values()):
            t.copy_(v)
        if name == "hit":
            copy_block(pool, int(donor[62]), int(fresh[0]))
        before = {n: t.clone() for n, t in pool.items()}
        key = sch._stage_prefill(chunk, bucket, pos, table, floor, ceil)
        sch._prefill_step(sch._prefill_views(key))
        torch.cuda.synchronize()
        eager = (sch._p_logits.clone(), {n: t[:, :, 1:].clone() for n, t in pool.items()})
        for t, v in zip(pool.values(), before.values()):
            t.copy_(v)
        sch._stage_prefill(chunk, bucket, pos, table, floor, ceil)
        if ("prefill", key) not in sch._graphs:
            sch._capture(key, "prefill")
        c0 = read_counts()
        sch._run_root("prefill", key)
        c1 = read_counts()
        torch.cuda.synchronize()
        launched = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
        same_logits = torch.equal(eager[0], sch._p_logits)
        same_pool = all(torch.equal(eager[1][n], t[:, :, 1:]) for n, t in pool.items())
        out.append((name, key, same_logits, same_pool, launched))
        check(same_logits, f"{tag} prefill vs eager ({name}): replayed logits differ")
        check(same_pool, f"{tag} prefill vs eager ({name}): replayed pool bytes differ")
        check(launched == {kernel: cfg.n_layers},
              f"{tag} prefill vs eager ({name}): a replay launched {launched}")
        del eager, before
    graph_stats(engine, f"{tag} prefill vs eager", since)
    log(f"{tag} prefill graph vs eager: (case, key (bucket, table width), last logits "
        f"equal, pool bytes outside the null block equal ({sorted(pool)}), launches "
        f"per replay) {out}")
    for t, v in zip(pool.values(), saved.values()):
        t.copy_(v)


def verify_vs_eager(engine, tag: str, ctx: int = 1024) -> dict:
    """The verify step of the scheduler's spec_verify root run eagerly and
    by a replay of its captured graph, from the same decode state (B=8 at
    about ``ctx``, random pool, greedy rows): drafts whose first token is
    the row's greedy next token (from a draft-less eager verify) and the
    rest random, lengths 0..K. Tokens, accepted counts, offsets and the
    pool's bytes outside the null block must be equal bit for bit, a
    replay must launch the kernel the rule names n_layers times, and
    (pool in q's type) every drafting row accepts its first draft. Returns
    the accepted counts."""
    sch = engine.scheduler
    cfg = engine.model_cfg
    K = engine.engine_cfg.spec_tokens
    pool = sch._cache
    saved = random_pool(engine, SEED + 4)
    key, v, load = decode_state(engine, ctx=ctx)
    vkey = key + (K,)
    vv = sch._verify_views(vkey)

    def reload():
        for t, s_ in zip(pool.values(), saved.values()):
            t.copy_(s_)
        load()

    reload()
    vv.drafts.zero_()
    vv.lens.zero_()
    sch._verify_step(vv)
    first = vv.cur.clone()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    drafts = torch.randint(3, cfg.vocab_size, vv.drafts.shape, generator=gen, device="cuda")
    drafts[:, 0] = first
    lens = torch.tensor([b % (K + 1) for b in range(vv.lens.shape[0])], dtype=torch.int32,
                        device="cuda")

    def load_verify():
        reload()
        vv.drafts.copy_(drafts)
        vv.lens.copy_(lens)

    load_verify()
    sch._verify_step(vv)
    torch.cuda.synchronize()
    eager = (vv.cur.clone(), vv.acc.clone(), vv.off.clone(),
             {n: t[:, :, 1:].clone() for n, t in pool.items()})
    load_verify()
    if ("spec_verify", vkey) not in sch._graphs:
        sch._capture(vkey, "spec_verify")
    c0 = read_counts()
    sch._run_root("spec_verify", vkey)
    c1 = read_counts()
    torch.cuda.synchronize()
    launched = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
    same = [torch.equal(a, b) for a, b in zip(eager[:3], (vv.cur, vv.acc, vv.off))]
    same_pool = all(torch.equal(eager[3][n], t[:, :, 1:]) for n, t in pool.items())
    acc = vv.acc.tolist()
    log(f"{tag} verify graph vs eager: B=8 ctx {ctx} K={K} key {vkey}, lengths "
        f"{lens.tolist()}, accepted {acc}: tokens, accepted, offsets equal {same}, pool "
        f"bytes outside the null block equal {same_pool}; launches per replay {launched}")
    check(all(same) and same_pool, f"{tag}: the replayed verify step differs from the eager one")
    check(len(launched) == 1 and list(launched.values()) == [cfg.n_layers],
          f"{tag}: a verify replay launched {launched}")
    # position 0's logits see no later position of the chunk, so a first
    # draft equal to the draft-less verify's token is accepted; over an int8
    # pool the chunk's later writes can grow a page's scale and requantize
    # the keys position 0 reads, so there it is only printed
    if not engine.kv_quantized:
        check(all(a >= 1 for a, n in zip(acc, lens.tolist()) if n),
              f"{tag}: a row whose first draft is its greedy token accepted nothing: "
              f"{acc}")
    reload()
    return {"accepted": acc, "launched": launched}


def ring_check(engine, tag: str, new_tokens: int = 320, burst: bool = True) -> bool:
    """The readback ring on the card: two greedy requests long enough that
    a window is capped at max_inflight_chunks chunks, so a look-ahead
    window chains on the device's own cur and offsets while the host
    reads the one before; served with overlap on and again with it off,
    the bucket held at 8 so both runs replay the same graphs in the same
    order: the same tokens, and fewer stalls than host syncs with overlap
    on, a stall at every sync with it off. Each run logs its admissions
    (scheduler pass, row, bucket, start) and the roots it ran in order
    (root, key, steps). ``burst``: both requests are queued before the
    scheduler's next pass, so both runs admit them in one burst; without
    it (``--ring-repro``) they are sent one after the other, and a
    difference is logged, not failed. Returns whether the tokens agree."""
    from bee2bee_tpu_torch.engine.introspect import (
        _C_HOST_SYNCS, _C_SYNC_STALLS, device_gate,
    )

    sch = engine.scheduler
    check(not sch.active and not sch._inflight, f"{tag} ring: scheduler not idle")
    prompts = [" ".join(["paged", "ring", "window", "token"][i:] * 8) for i in range(2)]
    idle_s, overlap = sch._sticky_idle_s, sch._overlap
    sch._sticky_idle_s = float("inf")
    sch._resize(8)
    runs = {}
    # what the scheduler thread admits and runs, from wrappers of its own
    trace = {"passes": 0, "admits": [], "roots": []}
    real = {n: getattr(sch, n) for n in ("_pass", "_paged_prefill", "_run_root")}

    def counted_pass():
        trace["passes"] += 1
        return real["_pass"]()

    def paged_prefill(req, b, bucket, start, *args, **kw):
        trace["admits"].append((trace["passes"], b, bucket, start))
        return real["_paged_prefill"](req, b, bucket, start, *args, **kw)

    def run_root(root, key, times=1):
        roots = trace["roots"]
        if roots and roots[-1][:2] == [root, key]:
            roots[-1][2] += times
        else:
            roots.append([root, key, times])
        return real["_run_root"](root, key, times)

    sch._pass, sch._paged_prefill, sch._run_root = counted_pass, paged_prefill, run_root
    try:
        for sch._overlap in (True, False):
            s0, t0, w0 = _C_HOST_SYNCS.value(), _C_SYNC_STALLS.value(), sch.stats.windows
            trace.update(passes=0, admits=[], roots=[])
            out: list = [None] * len(prompts)

            def run(i):
                out[i] = engine.generate(prompts[i], max_new_tokens=new_tokens,
                                         temperature=0.0).token_ids

            threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
            t1 = time.perf_counter()
            if burst:
                # both requests queued before the scheduler's next pass, so
                # both runs admit them in one burst: the same rows, table
                # widths and split plans, hence the same bf16 rounding
                with device_gate.transition():
                    for t in threads:
                        t.start()
                    while len(sch._queue) < len(prompts):
                        time.sleep(0.001)
            else:
                for t in threads:
                    t.start()
            for t in threads:
                t.join(timeout=300)
            wall = time.perf_counter() - t1
            while sch._inflight:
                time.sleep(0.01)
            runs[sch._overlap] = (out, _C_HOST_SYNCS.value() - s0,
                                  _C_SYNC_STALLS.value() - t0, sch.stats.windows - w0)
            log(f"{tag} ring (overlap {'on' if sch._overlap else 'off'}, "
                f"{'one admission burst' if burst else 'sent one after the other'}): "
                f"2 greedy requests x {new_tokens} tokens in {wall:.3f} s; "
                f"{runs[sch._overlap][3]} windows, {runs[sch._overlap][1]:.0f} host "
                f"syncs, {runs[sch._overlap][2]:.0f} of them stalls; admissions "
                f"(pass, row, bucket, start) {trace['admits']}; roots in order (root, "
                f"key, steps) {[tuple(r) for r in trace['roots']]}")
    finally:
        sch._sticky_idle_s, sch._overlap = idle_s, overlap
        for n in real:
            delattr(sch, n)
    (on, syncs_on, stalls_on, _), (off, syncs_off, stalls_off, _) = runs[True], runs[False]
    check(all(len(t) == new_tokens for t in on),
          f"{tag} ring: a request stopped early ({[len(t) for t in on]} tokens), so "
          "the ring was not filled")
    first = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
             for a, b in zip(on, off)]
    if not burst:
        log(f"{tag} ring: overlap on and off gave "
            f"{'the same tokens' if on == off else 'different tokens'}; the first "
            f"differing token of each request {first}")
        return on == off
    check(on == off, f"{tag} ring: overlap on and off gave different tokens (the "
          f"first differing token of each request {first})")
    check(stalls_on < syncs_on, f"{tag} ring: overlap on stalled {stalls_on} of "
          f"{syncs_on} syncs")
    check(stalls_off == syncs_off > 0, f"{tag} ring: overlap off stalled "
          f"{stalls_off} of {syncs_off} syncs")
    return True


def node_profile_rounds(card: str, rounds: int) -> int:
    """``--node-profile N``: the profiler's first start (CUPTI's bring-up,
    which the full run pays in its earlier phases), then phase 9's second
    node N times; each round's profile lines, and each failed check, are
    logged. Returns 1 when a round failed."""
    from bee2bee_tpu_torch.engine.introspect import get_profiler

    get_profiler().capture(0.05)
    log(f"node profile: the first start {get_profiler().last_timings}")
    failed = 0
    for i in range(rounds):
        t0 = time.perf_counter()
        try:
            phase_node_prefix(card)
            log(f"node profile: round {i} passed in {time.perf_counter() - t0:.1f} s")
        except AssertionError as e:
            failed += 1
            log(f"node profile: round {i} FAILED: {e}")
    log(f"card: {card}")
    return 1 if failed else 0


def ring_repro(card: str, rounds: int) -> None:
    """``--ring-repro N``: the bf16 slice's engine (random init from the
    seed), then N ring checks with the two requests sent one after the
    other (the traffic before the one-burst admission), each logging its
    admissions, roots and whether overlap on and off agree, then one ring
    check in one admission burst, which must agree."""
    svc, load_s = load_slice("bfloat16", None, "bfloat16")
    engine = svc.engine
    try:
        log(f"ring repro: {engine.model_cfg.name} loaded in {load_s:.2f} s; card {card}")
        agreed = [ring_check(engine, f"ring repro {i}", burst=False) for i in range(rounds)]
        log(f"ring repro: sent one after the other, overlap on and off agreed in "
            f"{sum(agreed)} of {rounds} rounds")
        ring_check(engine, "ring repro, one burst")
    finally:
        engine.close()


def graph_stats(engine, tag: str, since: dict | None = None) -> dict:
    """The scheduler's decode-graph and readback numbers now; with
    ``since`` (such a snapshot) print and return what moved since."""
    from bee2bee_tpu_torch.engine.introspect import _C_HOST_SYNCS, _C_SYNC_STALLS

    st = engine.scheduler.stats
    now = dict(windows=st.windows, host_syncs=_C_HOST_SYNCS.value(),
               stalls=_C_SYNC_STALLS.value(),
               roots={r: dict(g, keys=dict(g["keys"])) for r, g in st.root_graphs.items()},
               spec_steps=st.spec_steps)
    base = since or dict(windows=0, host_syncs=0.0, stalls=0.0, roots={}, spec_steps=0)

    def key_delta(now_keys, base_keys):
        return {k: (n - base_keys.get(k, (0, 0.0))[0],
                    round(t - base_keys.get(k, (0, 0.0))[1], 4))
                for k, (n, t) in now_keys.items() if n != base_keys.get(k, (0, 0.0))[0]}

    d = {k: now[k] - base[k] for k in now if k != "roots"}
    d["roots"] = {}
    for root in ("prefill", "first_token", "spec_verify", "decode"):
        g, g0 = now["roots"].get(root, {}), base["roots"].get(root, {})
        r = {k: g.get(k, 0) - g0.get(k, 0)
             for k in ("captures", "capture_s", "warmup_s", "setup_forwards", "replays")}
        r["keys"] = key_delta(g.get("keys", {}), g0.get("keys", {}))
        d["roots"][root] = r
    # the decode root's numbers at the top level
    d.update(d["roots"]["decode"])
    if since is not None:
        for root, label in (("prefill", "prefill graphs"),
                            ("first_token", "first-token graphs"),
                            ("spec_verify", "verify graphs")):
            r = d["roots"][root]
            if r["captures"] or r["replays"]:
                log(f"{tag}: {label}: {r['captures']} captures in {r['capture_s']:.3f} s, "
                    f"{r['warmup_s']:.3f} s of it warm-up ({r['setup_forwards']} eager "
                    f"forwards in warm-up and capture), {r['replays']} replays; "
                    f"captures by key: (captures, s) {r['keys']}")
        log(f"{tag}: decode graphs: {d['captures']} captures in "
            f"{d['capture_s']:.3f} s, {d['warmup_s']:.3f} s of it warm-up "
            f"({d['setup_forwards']} eager forwards in warm-up and capture), "
            f"{d['replays']} replays; captures by key (bucket, table "
            f"width, min_p, adapters, counts, sampled): (captures, s) "
            f"{d['keys']}; {d['windows']} windows, {d['host_syncs']:.0f} host syncs, "
            f"{d['stalls']:.0f} of them stalls")
        return d
    return now


def reset_counts():
    from bee2bee_tpu_torch.ops.flash import flash_attention
    from bee2bee_tpu_torch.ops.ragged import LAUNCH_COUNTERS, ragged_paged_attention

    for name in LAUNCH_COUNTERS:
        setattr(ragged_paged_attention, name, 0)
    flash_attention.launches = 0
    flash_attention.tile_launches = 0
    flash_attention.hd256_tile_launches = 0
    flash_attention.f32_tile_launches = 0


def read_counts() -> dict:
    from bee2bee_tpu_torch.ops.flash import flash_attention
    from bee2bee_tpu_torch.ops.ragged import ragged_paged_attention

    return {
        "ragged": ragged_paged_attention.launches,
        "ragged_int8": ragged_paged_attention.int8_launches,
        "ragged_prefill": ragged_paged_attention.prefill_launches,
        "ragged_prefill_int8": ragged_paged_attention.int8_prefill_launches,
        "ragged_prefill_f32": ragged_paged_attention.f32_prefill_launches,
        "ragged_prefill_f32_int8": ragged_paged_attention.int8_f32_prefill_launches,
        "ragged_decode": ragged_paged_attention.decode_launches,
        "ragged_decode_int8": ragged_paged_attention.int8_decode_launches,
        "ragged_prefill_hd256": ragged_paged_attention.hd256_prefill_launches,
        "ragged_prefill_hd256_int8": ragged_paged_attention.int8_hd256_prefill_launches,
        "ragged_decode_hd256": ragged_paged_attention.hd256_decode_launches,
        "ragged_decode_hd256_int8": ragged_paged_attention.int8_hd256_decode_launches,
        "ragged_decode_f32": ragged_paged_attention.f32_decode_launches,
        "ragged_decode_f32_int8": ragged_paged_attention.int8_f32_decode_launches,
        "flash": flash_attention.launches,
        "flash_tile": flash_attention.tile_launches,
        "flash_tile_hd256": flash_attention.hd256_tile_launches,
        "flash_tile_f32": flash_attention.f32_tile_launches,
    }


def pool_bytes(engine) -> int:
    return sum(t.numel() * t.element_size()
               for t in engine.scheduler._cache.values())


def load_slice(cache_dtype="bfloat16", params=None, dtype="bfloat16"):
    """CUDAService over llama-3-8b computing in ``dtype``: a random init
    from SEED, or the given parameters (in ``dtype``) shared with another
    engine (no second init)."""
    from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
    from bee2bee_tpu_torch.services import CUDAService

    ecfg = EngineConfig(
        max_seq_len=2048, max_batch=8, kv_block_size=16, decode_chunk=32,
        rng_seed=SEED, dtype=dtype, cache_dtype=cache_dtype,
    )
    t0 = time.perf_counter()
    engine = None
    if params is not None:
        engine = InferenceEngine("llama-3-8b", params=params, engine_config=ecfg)
    svc = CUDAService("llama-3-8b", max_new_tokens=64, engine=engine,
                      engine_config=ecfg).load_sync()
    torch.cuda.synchronize()
    return svc, time.perf_counter() - t0


def storage_bytes(tree) -> int:
    """Device bytes of a tensor tree, each storage once."""
    seen: dict = {}
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        else:
            seen[node.untyped_storage().data_ptr()] = node.untyped_storage().nbytes()
    return sum(seen.values())


def record_dispatches(engine) -> list:
    """(time, positions, ctx, scheduled) of every dispatch the scheduler
    books with the engine's goodput meter from now on."""
    meter = engine.introspect.meter
    book = meter.record_dispatch
    out: list = []

    def recorded(positions, ctx, scheduled):
        out.append((time.time(), positions, ctx, scheduled))
        book(positions, ctx, scheduled=scheduled)

    meter.record_dispatch = recorded
    return out


def check_economics(engine, tag: str, card: str, dispatches: list, wall: float) -> None:
    """The economics plane over one slice's traffic: the ledger's weights
    and KV pool equal their tensors' storage bytes (the pool also its
    geometry's), the device's headroom is in (0, 1); each root's compiles
    equal the scheduler's graph captures of it and nothing stormed;
    MFU x peak over the meter's window equals the FLOPs model over the
    dispatches recorded in that window (within 10%); goodput fraction in
    (0, 1]."""
    from bee2bee_tpu_torch.engine.introspect import FlopsModel
    from bee2bee_tpu_torch.metrics import get_registry

    cfg, ecfg = engine.model_cfg, engine.engine_cfg
    ic = engine.introspect
    snap = ic.refresh()
    now = time.time()
    hbm, comps = snap["hbm"], snap["hbm"]["components"]
    weights, pool = storage_bytes(engine.params), pool_bytes(engine)
    per = cfg.n_layers * cfg.n_kv_heads * engine.pool_blocks
    geometry = (2 * per * ecfg.kv_block_size * cfg.head_dim * engine.cache_dtype.itemsize
                + (2 * per * 4 if engine.kv_quantized else 0))
    check(comps.get("weights") == weights and comps.get("kv_pool") == pool == geometry,
          f"{tag}: ledger {comps} vs weights {weights} B, pool {pool} B "
          f"(geometry {geometry} B)")
    frac = hbm.get("headroom_frac")
    check(frac is not None and 0.0 < frac < 1.0
          and hbm["bytes_in_use"] >= hbm["accounted_bytes"],
          f"{tag}: HBM ledger {hbm}")
    compiles = snap["compiles"]
    st = engine.scheduler.stats
    captures = {root: g["captures"] for root, g in st.root_graphs.items()}
    check(compiles["decode"]["traces"] == captures["decode"] > 0
          and compiles["prefill"]["traces"] == captures["prefill"] > 0
          and all(compiles[root]["traces"] == n for root, n in captures.items())
          and compiles["cow_copy"]["traces"] == 0
          and not any(v["storms"] for v in compiles.values())
          and not ic.sentinel.storming()
          and not get_registry().get("engine.retrace_storms").total(),
          f"{tag}: compiles {compiles} vs {captures} graph captures")
    g = snap["goodput"]
    fm = FlopsModel(cfg)
    t0 = now - g["window_s"]
    in_window = sum(fm.flops(p, c) for t, p, c, _ in dispatches if t > t0)
    measured = g["mfu"] * snap["peak_flops"] * g["window_s"]
    check(in_window > 0 and abs(measured - in_window) <= 0.10 * in_window,
          f"{tag}: MFU x peak x window {measured:.4e} FLOPs, the FLOPs model over "
          f"the window's dispatches {in_window:.4e}")
    check(0.0 < g["goodput_fraction"] <= 1.0, f"{tag}: goodput {g}")
    total = sum(fm.flops(p, c) for _, p, c, _ in dispatches)
    log(f"{tag}: economics: ledger weights {comps['weights']} B, kv_pool "
        f"{comps['kv_pool']} B, workspace/other {comps.get('workspace_other')} B, "
        f"in use {hbm['bytes_in_use']} of {hbm['bytes_limit']} B, headroom "
        f"{frac}; compiles {compiles}; MFU {g['mfu']} over a {g['window_s']} s "
        f"window (peak {snap['peak_flops']:.4g}), the traffic's {total:.4e} model "
        f"FLOPs over its {wall:.3f} s wall = {total / wall / snap['peak_flops']:.4f} "
        f"of peak; goodput {g['goodput_tokens_per_s']} tok/s, fraction "
        f"{g['goodput_fraction']} ({g['useful_tokens_total']} useful of "
        f"{g['scheduled_tokens_total']} scheduled); card {card}")


def phase_slice(card: str, cache_dtype="bfloat16", params=None, dtype="bfloat16"):
    """Serve 8 concurrent requests and one stream; the counts are zeroed
    just before and read just after. The bf16 slices (phases 6-7) then run
    the ring check, the replayed-vs-eager chunk and the whole breakdown;
    the f32 slice (phase 8) the replayed-vs-eager chunk over the int8 pool
    and the replayed B=8 step's breakdown. Returns (the launch counts,
    pool bytes, the engine's params)."""
    from bee2bee_tpu_torch.ops.ragged import ragged_kernel

    int8 = cache_dtype == "int8"
    bf16 = dtype == "bfloat16"
    torch.cuda.reset_peak_memory_stats()
    svc, load_s = load_slice(cache_dtype, params, dtype)
    engine = svc.engine
    cfg = engine.model_cfg
    G = cfg.n_heads // cfg.n_kv_heads
    # the kernels the rule names for a decode step and for a prefill chunk
    # (every prefill bucket is 64 tokens or more)
    dec_kernel = ragged_kernel(engine.dtype, 1, cfg.head_dim, int8, G)
    tile_kernel = ragged_kernel(engine.dtype, 64, cfg.head_dim, int8, G)
    suffix = "_int8" if int8 else ""
    dec, tile = RAGGED_COUNTERS[dec_kernel] + suffix, RAGGED_COUNTERS[tile_kernel] + suffix
    tag = f"slice[{cache_dtype} pool]" if bf16 else f"slice[{dtype}, {cache_dtype} pool]"
    log(f"{tag}: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"loaded ({'shared params' if params is not None else 'random init'}, "
        f"seed {SEED}) in {load_s:.2f} s; {engine.info['n_params']} params")
    kv_meta = svc.get_metadata()["engine"]["kv"]
    check(kv_meta["cache_dtype"] == cache_dtype,
          f"{tag}: metadata kv {kv_meta} does not name the {cache_dtype} pool")
    try:
        words = ("the paged pool maps every row onto blocks of sixteen tokens "
                 "and the kernel reads them through the tables ").split()
        sizes = [40, 120, 260, 400, 640, 900, 1200, 1500]
        prompts = []
        for n in sizes:
            text, i = "", 0
            while len(text) < n:
                text += words[(i * 7 + n) % len(words)] + " "
                i += 1
            prompts.append(text[:n])
        knobs = [dict(temperature=0.0)] * 6 + [
            dict(temperature=0.8, top_p=0.9),
            dict(temperature=0.0, repetition_penalty=1.2),
        ]
        results: list = [None] * len(prompts)
        errors: list = []

        def call(i):
            try:
                results[i] = svc.execute(
                    {"prompt": prompts[i], "max_new_tokens": 64, **knobs[i]}
                )
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append((i, repr(e)))

        # the chunk length of every forward the engine runs, to name the
        # kernel each one's attention must launch
        chunks: list = []
        forward = engine.forward

        def counted_forward(tokens, *args, **kw):
            chunks.append(tokens.shape[1])
            return forward(tokens, *args, **kw)

        engine.forward = counted_forward
        dispatches = record_dispatches(engine)
        since = graph_stats(engine, tag)
        reset_counts()
        engine.forward_calls = 0
        t1 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t1
        check(not any(t.is_alive() for t in threads), "execute calls hung")
        check(not errors, f"execute failed: {errors}")
        stream = list(svc.execute_stream(
            {"prompt": prompts[3], "max_new_tokens": 64, "temperature": 0.0}
        ))
        torch.cuda.synchronize()
        counts = read_counts()
        forwards = engine.forward_calls
        engine.forward = forward
        graphs = graph_stats(engine, tag, since)
        for i, r in enumerate(results):
            check(r is not None and isinstance(r.get("text"), str),
                  f"request {i}: no result")
            check(r["tokens"] > 0, f"request {i}: no tokens")
            log(f"{tag} request {i}: prompt {len(prompts[i])} B / "
                f"{r['prompt_tokens']} tok, {r['tokens']} new, ttft {r['ttft_ms']} ms, "
                f"{r['tokens_per_sec']} tok/s, finish {r['finish_reason']}, "
                f"knobs {knobs[i]}")
        lines = [json.loads(s) for s in stream]
        check(not any(ln.get("status") == "error" for ln in lines),
              f"execute_stream error: {lines}")
        check(lines and lines[-1].get("done") and lines[-1].get("tokens", 0) > 0,
              f"execute_stream ended without a done line: {lines[-1:]}")
        new_tokens = sum(r["tokens"] for r in results)
        # decode window: from the last first-token to the end of the burst
        decode_s = wall - max(r["ttft_ms"] for r in results) / 1e3
        nbytes = pool_bytes(engine)
        log(f"{tag} stream: {len(lines)} lines, {lines[-1]['tokens']} tokens")
        log(f"{tag}: 8 concurrent requests, {new_tokens} tokens in {wall:.3f} s "
            f"-> {new_tokens / wall:.2f} tok/s aggregate incl. prefill, "
            f"{new_tokens - len(results)} decode tokens in {decode_s:.3f} s after "
            f"the last first token -> {(new_tokens - len(results)) / decode_s:.2f} "
            f"decode tok/s; TTFT {min(r['ttft_ms'] for r in results)}-"
            f"{max(r['ttft_ms'] for r in results)} ms; peak memory "
            f"{torch.cuda.max_memory_allocated()} B; pool {nbytes} B "
            f"({engine.pool_blocks} blocks); card {card}")
        # every prefill chunk and decode step the path served is a graph
        # replay (one forward each, counted back by the replay); the eager
        # forwards are the captures' warm-up and capture steps
        roots = graphs["roots"]
        prefills = roots["prefill"]["replays"]
        eager_prefills = [T for T in chunks if T > 1]
        named = [ragged_kernel(engine.dtype, T, cfg.head_dim, int8, G) for T in eager_prefills]
        decodes = graphs["replays"]
        eager_decodes = sum(T == 1 for T in chunks)
        log(f"{tag}: kernel launches {counts}, forward calls {forwards} "
            f"({prefills} prefill chunks replayed from graphs, whose captures ran "
            f"through the {tile_kernel} kernel; {decodes} decode steps replayed from "
            f"graphs, whose captures ran through the {dec_kernel} kernel; "
            f"{len(eager_prefills)} prefill and {eager_decodes} decode forwards run "
            f"eagerly, all in warm-up and capture; {roots['first_token']['replays']} "
            f"first tokens replayed), n_layers {cfg.n_layers}")
        check(decodes > 0 and prefills > 0,
              f"{tag}: {decodes} decode and {prefills} prefill graph replays")
        check(eager_decodes == graphs["setup_forwards"],
              f"{tag}: {eager_decodes} eager decode forwards, "
              f"{graphs['setup_forwards']} of them in warm-up and capture")
        check(len(eager_prefills) == roots["prefill"]["setup_forwards"]
              and named.count(tile_kernel) == len(eager_prefills),
              f"{tag}: {len(eager_prefills)} eager prefill forwards, "
              f"{roots['prefill']['setup_forwards']} of them in warm-up and capture")
        check(roots["first_token"]["replays"] == len(results) + 1,
              f"{tag}: {roots['first_token']['replays']} first-token replays for "
              f"{len(results) + 1} requests")
        check(forwards == prefills + decodes,
              f"{tag}: {forwards} forwards != {prefills} prefill chunks + "
              f"{decodes} replayed decode steps")
        check(counts[dec] + counts[tile] == cfg.n_layers * forwards,
              f"{tag}: launches {counts[dec]} + {counts[tile]} != {cfg.n_layers} x "
              f"{forwards} forwards")
        check(counts[tile] > 0 and counts[tile] == cfg.n_layers * prefills,
              f"{tag}: tile launches {counts[tile]} != {cfg.n_layers} x {prefills} "
              f"prefill chunks")
        check(counts[dec] > 0 and counts[dec] == cfg.n_layers * decodes,
              f"{tag}: decode launches {counts[dec]} != {cfg.n_layers} x {decodes} "
              f"decode steps")
        others = {k: v for k, v in counts.items() if k not in (dec, tile) and v}
        check(not others, f"{tag}: other kernel forms launched: {others}")
        check_economics(engine, tag, card, dispatches, wall)
        if bf16:
            ring_check(engine, tag)
        if bf16 or int8:
            graph_vs_eager(engine, tag)
        prefill_vs_eager(engine, tag)
        step_breakdown(engine, card, full=bf16)
        return counts, nbytes, engine.params
    finally:
        engine.close()


# ------------------------------------------------------------ prefix phase


# the prefix phase's traffic: conversations of about 1,000 byte tokens, a
# 64-token reply, then 40 new tokens. Turn 1's histories have distinct
# lengths (a hit is told by its length), most not a multiple of the block
# size (a hit then copies one partial block)
PREFIX_LENGTHS = (1000, 1003, 990, 1011, 997, 1019, 985, 1008)
PREFIX_REPLY = 64
PREFIX_NEW = 40
# one entry per turn-1 prompt and one per turn-2 prompt: with one entry
# per conversation, each turn-2 pin would evict (LRU) the entry of a
# conversation not yet admitted, and the burst would hit once
PREFIX_ENTRIES = 2 * len(PREFIX_LENGTHS)


def prefix_histories(tokenizer) -> list:
    """The turn-1 prompts (token ids), one distinct history each."""
    words = ("the cache pins every prompt's blocks and a later turn that "
             "extends it reads them again through its own table ").split()
    out = []
    for c, n in enumerate(PREFIX_LENGTHS):
        text, i = f"conversation {c}: ", 0
        while len(text) < 2 * n:
            text += words[(i * (c + 3) + c) % len(words)] + " "
            i += 1
        ids = tokenizer.encode(text)[:n]
        check(len(ids) == n, f"prefix: history {c} has {len(ids)} tokens, not {n}")
        out.append(ids)
    return out


def prefix_engine(params, cache_dtype, dtype, entries, pool_blocks=None):
    from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine

    ecfg = EngineConfig(
        max_seq_len=2048, max_batch=8, kv_block_size=16, decode_chunk=32,
        rng_seed=SEED, dtype=dtype, cache_dtype=cache_dtype,
        prefix_cache_entries=entries, kv_pool_blocks=pool_blocks,
    )
    return InferenceEngine("llama-3-8b", params=params, engine_config=ecfg)


class PrefillWatch:
    """Wraps a scheduler's prefill chunk (a replay of the prefill root):
    for every chunk, its offset, its write floor and ceil (the prompt's
    length), its width, and the attention launches it added (host
    counters, read around the call: no sync; a capture's are put back);
    the last chunk's first-token logits by prompt length. Lengths
    identify the prompts of a burst (each distinct)."""

    def __init__(self, engine):
        self.sch = engine.scheduler
        self.chunks: list = []
        self.logits: dict = {}
        self._orig = self.sch._prefill_chunk
        self.sch._prefill_chunk = self._wrapped

    def _wrapped(self, chunk, bucket, pos, table, floor, ceil):
        before = read_counts()
        out = self._orig(chunk, bucket, pos, table, floor, ceil)
        after = read_counts()
        self.chunks.append(dict(
            offset=pos, floor=floor, n=ceil, T=bucket,
            launched={k: after[k] - before[k] for k in after if after[k] != before[k]},
        ))
        if pos + bucket >= ceil:  # the prompt's last chunk
            self.logits[ceil] = out.float().clone()
        return out

    def close(self):
        del self.sch._prefill_chunk


def warm_prefill_keys(engine, tag: str, prompts, starts) -> None:
    """Capture, before a timed burst, every prefill graph its admissions
    will replay (the chunk walk's keys: the bucket of the length left
    after the match, by the pow2 width of the blocks each chunk covers)
    and the greedy first-token graph, so the burst's TTFT holds no
    capture; prints the captures apart."""
    from bee2bee_tpu_torch.engine.paged import ceil_div, prefill_chunk_positions

    sch = engine.scheduler
    BS = engine.engine_cfg.kv_block_size
    C = engine.engine_cfg.prefill_chunk
    keys = set()
    for p, start in zip(prompts, starts):
        n = len(p)
        bucket = C if C is not None and n - start > C else engine._bucket_for(n - start)
        for pos in prefill_chunk_positions(n, start, bucket, engine.max_seq_len):
            keys.add(("prefill", (bucket, sch._table_width(ceil_div(min(pos + bucket, n), BS)))))
    keys.add(("first_token", (False, False, False)))
    todo = sorted(k for k in keys if k not in sch._graphs)
    t0 = time.perf_counter()
    for root, key in todo:
        sch._capture(key, root)
    log(f"{tag}: warmed {len(todo)} graphs before the burst in "
        f"{time.perf_counter() - t0:.3f} s: {todo}")


def burst(engine, prompts, new_tokens, together: bool = False):
    """Greedy requests, all at once (threads); returns (results, wall s).
    ``together``: every request is queued before the scheduler's next
    pass, so one admission burst takes them all (the same rows and table
    widths from run to run)."""
    from bee2bee_tpu_torch.engine.introspect import device_gate

    results: list = [None] * len(prompts)
    errors: list = []

    def call(i):
        try:
            results[i] = engine.generate(prompts[i], max_new_tokens=new_tokens,
                                         temperature=0.0)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append((i, repr(e)))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(prompts))]
    if together:
        sch = engine.scheduler
        with device_gate.transition():
            for t in threads:
                t.start()
            while len(sch._queue) < len(prompts):
                time.sleep(0.001)
    else:
        for t in threads:
            t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "prefix: generate calls hung")
    check(not errors, f"prefix: generate failed: {errors}")
    return results, wall


def ttft_summary(results) -> str:
    ms = sorted(r.ttft_s * 1e3 for r in results)
    return (f"median {statistics.median(ms):.1f} ms, range {ms[0]:.1f}-{ms[-1]:.1f} ms "
            f"over {len(ms)}")


def phase_prefix(card: str, params, cache_dtype: str, dtype="bfloat16",
                 prompts2=None) -> dict:
    """The prompt prefix cache on llama-3-8b at full width and depth, over
    the shared weights (see the module docstring). Turn 1: 8 concurrent
    misses; turn 2: each turn-1 prompt with its reply and 40 new tokens, 8
    concurrent hits; an exact repeat; the same turn 2 on a cache-off
    engine (the first-token logits and tokens a hit is held to). With
    ``prompts2`` (the f32 run, on the bf16 run's turn-2 prompts) turn 2 is
    those prompts. Returns the counts, the turn-2 prompts, and by prompt
    length the first-token logits and tokens of the hits and of the
    cache-off run."""
    from bee2bee_tpu_torch.engine import scheduler as sched_mod
    from bee2bee_tpu_torch.ops.ragged import ragged_kernel

    int8 = cache_dtype == "int8"
    tag = f"prefix[{dtype}, {cache_dtype} pool]"
    engine = prefix_engine(params, cache_dtype, dtype, PREFIX_ENTRIES)
    cfg = engine.model_cfg
    BS = engine.engine_cfg.kv_block_size
    G = cfg.n_heads // cfg.n_kv_heads
    suffix = "_int8" if int8 else ""
    log(f"{tag}: {cfg.name} {cfg.n_layers} layers, prefix_cache_entries "
        f"{PREFIX_ENTRIES}, pool {engine.pool_blocks} blocks ({pool_bytes(engine)} B)")
    turn1 = prefix_histories(engine.tokenizer)
    watch = PrefillWatch(engine)
    copies: list = []
    copy_block = sched_mod.copy_block

    def watched_copy(pool, src, dst):
        copy_block(pool, src, dst)
        # queued right behind the copy on the same stream: the target's
        # pages and scales against the donor's at the moment of the copy
        same = [(t[:, :, dst] == t[:, :, src]).all() for t in pool.values()]
        copies.append((src, dst, torch.stack(same)))

    sched_mod.copy_block = watched_copy
    out: dict = {}
    try:
        sch = engine.scheduler
        reset_counts()
        engine.forward_calls = 0
        since = graph_stats(engine, tag)
        warm_prefill_keys(engine, f"{tag}: turn 1", turn1, [0] * len(turn1))
        r1, wall1 = burst(engine, turn1, PREFIX_REPLY)
        entries = dict(sch._prefix_cache._entries)
        check(len(entries) == len(turn1) and all(tuple(p) in entries for p in turn1),
              f"{tag}: turn 1 pinned {len(entries)} entries")
        # the blocks turn 2 will share: each entry's full blocks
        shared = sorted({b for p in turn1 for b in entries[tuple(p)][:len(p) // BS]})
        idx = torch.tensor(shared, device="cuda")
        before = {k: t.index_select(2, idx).clone() for k, t in sch._cache.items()}
        if prompts2 is None:
            prompts2 = [p + r.token_ids + p[:PREFIX_NEW] for p, r in zip(turn1, r1)]
        check(len({len(p) for p in prompts2}) == len(prompts2),
              f"{tag}: turn-2 prompt lengths collide")
        st0 = (sch.stats.prefix_hits, sch.stats.prefix_tokens_saved,
               sch.stats.paged_blocks_copied)
        n_chunks = len(watch.chunks)
        repeat = prompts2[0]
        warm_prefill_keys(engine, f"{tag}: turn 2", prompts2 + [repeat],
                          [len(p) for p in turn1] + [len(repeat) - 1])
        r2, wall2 = burst(engine, prompts2, PREFIX_REPLY)
        hit_logits = {len(p): watch.logits[len(p)] for p in prompts2}
        n_chunks2 = len(watch.chunks)
        t1 = time.perf_counter()
        rr = engine.generate(repeat, max_new_tokens=PREFIX_REPLY, temperature=0.0)
        repeat_wall = time.perf_counter() - t1
        torch.cuda.synchronize()
        counts = read_counts()
        forwards = engine.forward_calls
        graphs = graph_stats(engine, tag, since)
        after = {k: t.index_select(2, idx) for k, t in sch._cache.items()}
        st = sch.stats
        starts = [len(p) for p in turn1] + [len(repeat) - 1]
        want = (len(starts), sum(starts), sum(s % BS != 0 for s in starts))
        got = (st.prefix_hits - st0[0], st.prefix_tokens_saved - st0[1],
               st.paged_blocks_copied - st0[2])
        check(st0 == (0, 0, 0) and got == want,
              f"{tag}: prefix hits, tokens saved, CoW copies {got} after {st0}, "
              f"the traffic implies {want}")
        # each hit's first chunk: at the match, floored there, at the bucket
        # of the remaining length, through the tile kernel, n_layers launches
        chunks2 = watch.chunks[n_chunks:n_chunks2]
        for p, start, chunks in zip(prompts2 + [repeat], starts,
                                    [chunks2] * len(prompts2) + [watch.chunks[n_chunks2:]]):
            first = [c for c in chunks if c["n"] == len(p)][0]
            bucket = engine._bucket_for(len(p) - start)
            kernel = RAGGED_COUNTERS[ragged_kernel(engine.dtype, bucket, cfg.head_dim,
                                                   int8, G)] + suffix
            check(first["offset"] == start and first["floor"] == start
                  and first["T"] == bucket and first["launched"] == {kernel: cfg.n_layers},
                  f"{tag}: the hit of the {len(p)}-token prompt ran {first}, "
                  f"expected offset {start}, bucket {bucket}, {cfg.n_layers} "
                  f"{kernel} launches")
        # every copy: the target's pages and scales equal the donor's
        same = torch.stack([s for _, _, s in copies]).cpu() if copies else None
        check(len(copies) == want[2] and bool(same.all()),
              f"{tag}: {len(copies)} CoW copies, target == donor per tensor "
              f"{same.tolist() if same is not None else None}")
        # the shared donor blocks, bit for bit, after the borrowers' prefill
        # and decode (their scales too over the int8 pool)
        for k in before:
            check(torch.equal(before[k], after[k]),
                  f"{tag}: shared donor blocks' {k} changed under the borrowers")
        log(f"{tag}: turn 1, 8 misses: TTFT {ttft_summary(r1)}; burst wall {wall1:.3f} s")
        log(f"{tag}: turn 2, 8 hits: TTFT {ttft_summary(r2)}; burst wall {wall2:.3f} s; "
            f"exact repeat (start n-1): TTFT {rr.ttft_s * 1e3:.1f} ms, wall "
            f"{repeat_wall:.3f} s; card {card}")
        log(f"{tag}: {got[0]} hits saved {got[1]} prompt tokens with {got[2]} CoW "
            f"copies; {len(shared)} shared donor blocks bit-equal before and after; "
            f"suffix buckets {sorted({engine._bucket_for(len(p) - s) for p, s in zip(prompts2, starts)})}; "
            f"launches {counts}, forwards {forwards}, graph replays {graphs['replays']}")
        # the launch identities of phases 6-8
        dec = [k for k in counts if k.startswith("ragged_decode") and counts[k]]
        tile = [k for k in counts if k.startswith("ragged_prefill") and counts[k]]
        others = {k: v for k, v in counts.items() if k not in dec + tile and v}
        n_dec, n_tile = sum(counts[k] for k in dec), sum(counts[k] for k in tile)
        check(len(dec) == 1 and len(tile) == 1 and not others
              and n_dec + n_tile == cfg.n_layers * forwards
              and n_dec == cfg.n_layers * graphs["replays"] > 0,
              f"{tag}: launches {counts} vs {cfg.n_layers} x {forwards} forwards, "
              f"{graphs['replays']} replays")
        out.update(counts=counts, prompts2=prompts2,
                   hit_logits=hit_logits,
                   tokens={len(p): r.token_ids for p, r in zip(prompts2, r2)},
                   ttft=dict(miss=[r.ttft_s for r in r1], hit=[r.ttft_s for r in r2]))
    finally:
        sched_mod.copy_block = copy_block
        watch.close()
        engine.close()
    del engine, before, after
    gc.collect()
    torch.cuda.empty_cache()
    # the same turn 2 without the cache: its tokens and first-token logits
    off = prefix_engine(params, cache_dtype, dtype, 0)
    watch = PrefillWatch(off)
    try:
        warm_prefill_keys(off, f"{tag}: cache off", prompts2, [0] * len(prompts2))
        r_off, wall_off = burst(off, prompts2, PREFIX_REPLY)
        log(f"{tag}: turn 2 cache off, 8 misses: TTFT {ttft_summary(r_off)}; burst "
            f"wall {wall_off:.3f} s; card {card}")
        out["off_logits"] = {len(p): watch.logits[len(p)] for p in prompts2}
        out["off_tokens"] = {len(p): r.token_ids for p, r in zip(prompts2, r_off)}
        out["ttft"]["off"] = [r.ttft_s for r in r_off]
    finally:
        watch.close()
        off.close()
    del off
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_prefix_pressure(card: str, params, cache_dtype: str) -> None:
    """One admission into a pool sized (kv_pool_blocks) so that it must
    evict a pinned entry: one row's blocks and 40 more. A 1,000-token
    prompt pins 63 blocks; a 1,900-token prompt then needs 119 with 107
    free, and the admission's precheck evicts the pin."""
    tag = f"prefix pressure[{cache_dtype} pool]"
    pool_blocks = 1 + -(-(2048 + 32) // 16) + 40  # the null block, one row, 40
    engine = prefix_engine(params, cache_dtype, "bfloat16", PREFIX_ENTRIES,
                           pool_blocks=pool_blocks)
    try:
        sch = engine.scheduler
        first, other = prefix_histories(engine.tokenizer)[:2]
        engine.generate(first, max_new_tokens=8, temperature=0.0)
        free = sch._alloc.free_count
        big = (other * 2)[:1900]  # shares no prefix with the pinned entry
        need = -(-len(big) // engine.engine_cfg.kv_block_size)
        check(need > free and tuple(first) in sch._prefix_cache._entries,
              f"{tag}: {need} blocks needed, {free} free: no pressure")
        r = engine.generate(big, max_new_tokens=8, temperature=0.0)
        keys = [len(k) for k in sch._prefix_cache._entries]
        check(r.new_tokens > 0 and keys == [len(big)] and sch.stats.paged_alloc_waits == 0,
              f"{tag}: after the admission the entries are {keys}, "
              f"{sch.stats.paged_alloc_waits} waits")
        log(f"{tag}: pool {pool_blocks} blocks; the {len(big)}-token admission needed "
            f"{need} blocks with {free} free and evicted the pinned {len(first)}-token "
            f"entry; card {card}")
    finally:
        engine.close()
    del engine
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------ spec phases


SPEC_K = 4
SPEC_NEW = 64


def spec_prompts(tokenizer, periodic: bool) -> list:
    """8 prompts of 200 token ids: a period-5..12 walk (the JAX spec test's
    periodic prompt, one period per row), or a period-499 walk (no n-gram
    repeats, the JAX drafter test's), one offset per row."""
    out = []
    for r in range(8):
        if periodic:
            period = [5 + (r * 31 + j * 7) % 997 for j in range(5 + r)]
            out.append((period * (200 // len(period) + 1))[:200])
        else:
            out.append([1 + (r * 53 + j * 97) % 499 for j in range(200)])
    return out


def spec_engine(params, dtype, cache_dtype, **spec):
    from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine

    ecfg = EngineConfig(max_seq_len=2048, max_batch=8, kv_block_size=16, decode_chunk=32,
                        rng_seed=SEED, dtype=dtype, cache_dtype=cache_dtype, **spec)
    return InferenceEngine("llama-3-8b", params=params, engine_config=ecfg)


def spec_burst(engine, prompts) -> tuple[list, float]:
    results, wall = burst(engine, prompts, SPEC_NEW, together=True)
    return [r.token_ids for r in results], wall


def spec_counts(engine, tag: str, since: dict, counts: dict) -> dict:
    """The spec run's graph and launch accounting: every forward is a
    replay (prefill, decode, verify), verify launches are n_layers x the
    verify replays through one kernel, the eager forwards all in warm-up
    and capture."""
    cfg = engine.model_cfg
    g = graph_stats(engine, tag, since)
    roots = g["roots"]
    verifies = roots["spec_verify"]["replays"]
    prefills = roots["prefill"]["replays"]
    decodes = g["replays"]
    st = engine.scheduler.stats
    log(f"{tag}: {g['spec_steps']} spec steps ({verifies} verify replays), "
        f"{prefills} prefill and {decodes} decode replays; drafted {st.spec_drafted}, "
        f"accepted {st.spec_accepted} (acceptance {st.spec_acceptance:.4f}), tiers "
        f"{st.spec_tiers}; launches {counts}")
    check(verifies == g["spec_steps"] > 0 and st.spec_drafted > 0,
          f"{tag}: {verifies} verify replays, {g['spec_steps']} spec steps, "
          f"{st.spec_drafted} drafted")
    return dict(verifies=verifies, prefills=prefills, decodes=decodes)


def phase_spec_ngram(card: str, params) -> dict:
    """Speculative decoding, n-gram tier, in f32 over an f32 pool, K=4: 8
    periodic prompts, 64 greedy tokens each, concurrently; the tokens
    must equal the spec-off engine's (8 x 64), every verify replay must
    launch the f32 decode kernel n_layers times (T = K+1 = 5 < T_MIN_F32),
    and drafts must have been proposed. Returns the counts."""
    from bee2bee_tpu_torch.ops.ragged import ragged_kernel

    tag = "spec[ngram, float32, float32 pool]"
    off = spec_engine(params, "float32", "float32")
    prompts = spec_prompts(off.tokenizer, periodic=True)
    try:
        want, wall_off = spec_burst(off, prompts)
    finally:
        off.close()
    del off
    gc.collect()
    torch.cuda.empty_cache()
    # the probe never retires the n-gram tier: every row is offered to it
    # for all 64 tokens
    engine = spec_engine(params, "float32", "float32", spec_tokens=SPEC_K,
                         spec_min_match=1, spec_probe_tokens=1 << 20)
    cfg = engine.model_cfg
    try:
        since = graph_stats(engine, tag)
        reset_counts()
        got, wall = spec_burst(engine, prompts)
        torch.cuda.synchronize()
        counts = read_counts()
        n = spec_counts(engine, tag, since, counts)
        G = cfg.n_heads // cfg.n_kv_heads
        kernel = RAGGED_COUNTERS[ragged_kernel(torch.float32, SPEC_K + 1, cfg.head_dim,
                                               False, G)]
        equal = sum(a == b for a, b in zip(got, want))
        log(f"{tag}: 8 x {SPEC_NEW} greedy tokens in {wall:.3f} s (spec off "
            f"{wall_off:.3f} s); {equal} of 8 rows equal to the spec-off engine's; the "
            f"verify shape's kernel {kernel}; card {card}")
        check(equal == len(prompts) and all(len(t) == SPEC_NEW for t in got),
              f"{tag}: spec-on tokens differ from spec-off: "
              f"{[(a[:8], b[:8]) for a, b in zip(got, want) if a != b][:2]}")
        check(kernel == "ragged_decode_f32"
              and counts["ragged_decode_f32"] == cfg.n_layers * (n["verifies"] + n["decodes"])
              and counts["ragged_prefill_f32"] == cfg.n_layers * n["prefills"],
              f"{tag}: launches {counts} vs {cfg.n_layers} x ({n['verifies']} verify + "
              f"{n['decodes']} decode, {n['prefills']} prefill) replays")
        others = {k: v for k, v in counts.items()
                  if k not in ("ragged_decode_f32", "ragged_prefill_f32") and v}
        check(not others, f"{tag}: other kernel forms launched: {others}")
        return counts
    finally:
        engine.close()
        del engine
        gc.collect()
        torch.cuda.empty_cache()


def phase_spec_model(card: str, params) -> dict:
    """Speculative decoding, model tier, bf16 over a bf16 pool, K=4: the
    drafter is llama-3-8b itself at the engine's seed (weight-identical
    to the target, a second 16 GB beside it), 8 prompts without n-gram
    repeats, 64 greedy tokens each, concurrently; the n-gram tier fails
    its probe at its first miss (K tokens: a miss costs a 32-token decode
    chunk) and rows escalate. Reports acceptance, agreement
    with the spec-off engine and, where a row diverges, the spec-off
    logit gap between the two tokens at the first divergence (a bf16
    near-tie); the draft and prime roots are captured once each; verify
    launches through the tile kernel n_layers x the verify replays. Then
    the verify step replayed vs eager over a bf16 and an int8 pool.
    Returns the counts (the bf16 run's)."""
    tag = "spec[model, bfloat16 pool]"
    off = spec_engine(params, "bfloat16", "bfloat16")
    prompts = spec_prompts(off.tokenizer, periodic=False)
    watch = PrefillWatch(off)
    try:
        want, wall_off = spec_burst(off, prompts)
        t0 = time.perf_counter()
        engine = spec_engine(params, "bfloat16", "bfloat16", spec_tokens=SPEC_K,
                             spec_probe_tokens=SPEC_K, drafter="llama-3-8b")
        load_s = time.perf_counter() - t0
        cfg = engine.model_cfg
        try:
            dm = engine.drafter_model
            since = graph_stats(engine, tag)
            reset_counts()
            got, wall = spec_burst(engine, prompts)
            torch.cuda.synchronize()
            counts = read_counts()
            n = spec_counts(engine, tag, since, counts)
            agree = []
            for p, a, b in zip(prompts, got, want):
                d = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
                gap = None
                if d is not None:
                    # the spec-off engine's logits at the divergence
                    off.generate(p + b[:d], max_new_tokens=1, temperature=0.0)
                    lg = watch.logits[len(p) + d][0]
                    gap = round((lg[b[d]] - lg[a[d]]).item(), 4)
                agree.append((len(a) if d is None else d, gap))
            st = engine.scheduler.stats
            model = st.spec_tiers.get("model", {"drafted": 0, "accepted": 0})
            log(f"{tag}: drafter {dm.cfg.name} loaded beside the target in {load_s:.2f} s "
                f"(seed {engine.engine_cfg.drafter_seed}); 8 x {SPEC_NEW} greedy tokens in "
                f"{wall:.3f} s (spec off {wall_off:.3f} s); model tier drafted "
                f"{model['drafted']}, accepted {model['accepted']}; draft root runs "
                f"{dm.runs}, captures (n, s) {dm.captures}; per row (tokens equal to "
                f"spec-off before the first divergence, spec-off logit gap there) "
                f"{agree}; card {card}")
            check(model["drafted"] > 0, f"{tag}: the model tier never drafted")
            check(dm.captures["draft"][0] == 1 and dm.captures["draft_prime"][0] == 1,
                  f"{tag}: draft/prime captures {dm.captures}")
            check(counts["ragged_prefill"] == cfg.n_layers * (n["verifies"] + n["prefills"])
                  and counts["ragged_decode"] == cfg.n_layers * n["decodes"],
                  f"{tag}: launches {counts} vs {cfg.n_layers} x ({n['verifies']} verify + "
                  f"{n['prefills']} prefill, {n['decodes']} decode) replays")
            verify_vs_eager(engine, tag)
        finally:
            engine.close()
    finally:
        watch.close()
        off.close()
    del engine, off
    gc.collect()
    torch.cuda.empty_cache()
    int8 = spec_engine(params, "bfloat16", "int8", spec_tokens=SPEC_K)
    try:
        verify_vs_eager(int8, "spec[int8 pool]")
    finally:
        int8.close()
    del int8
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def check_prefix_logits(tag: str, run: dict, f32_off: dict) -> None:
    """A hit's first-token logits are as close to the f32 forward's (cache
    off) as the cache-off run's of the same pool are: no further than
    twice that distance, prompt by prompt. The hit and the cache-off run
    are two computations of one f32 result in the pool's precision (other
    chunk widths, so other GEMM shapes; the reply's K/V from decode
    steps), each its own rounding history; a hit that read a wrong block,
    a stale copy or a zeroed scale lands orders of magnitude outside. The
    direct distance |hit - cache off| is printed beside, with the bf16
    forward's distance to the f32 one (PERF.md §2's bf16 yardstick): two
    rounding histories can be up to twice one history's distance apart
    (triangle inequality), so that yardstick alone is not a bound here."""
    gaps = []
    for n, hit in run["hit_logits"].items():
        off, ref = run["off_logits"][n], f32_off[n]
        d_hit = (hit - ref).abs().max().item()
        d_off = (off - ref).abs().max().item()
        gaps.append((n, round((hit - off).abs().max().item(), 4), round(d_hit, 4),
                     round(d_off, 4)))
        check(d_hit <= 2 * d_off, f"{tag}: the {n}-token hit's logits are {d_hit} from "
              f"the f32 forward's, the cache-off run's {d_off}")
    log(f"{tag}: first-token logits, (prompt tokens, |hit - cache off|, "
        f"|hit - f32|, |cache off - f32|): {gaps}")


# ------------------------------------------------------------ phase 9


# the node's packages that the card's machine may lack: the node picks the
# loopback transport without websockets, reports 0 cpu/ram without psutil,
# and cannot run its aiohttp gateway without aiohttp
NODE_PACKAGES = ("aiohttp", "websockets", "click", "psutil", "httpx", "ml_dtypes")
NODE_NEW_TOKENS = 32
NODE_ROUNDS = 3
NODE_BOOT_TIMEOUT_S = 600
NODE_PREFIX_ENTRIES = 8
NODE_PROFILE_S = 1.0
# the node's queue-wait SLO (health.py, engine.queue_wait_ms): a stream beside a
# profile must not stall this long
NODE_QUEUE_SLO_MS = 4096
# the economics gauges and counters /metrics must carry
NODE_ECONOMICS = ("bee2bee_engine_mfu", "bee2bee_engine_goodput_tokens_per_s",
                  "bee2bee_engine_hbm_bytes", "bee2bee_engine_hbm_headroom_frac",
                  "bee2bee_engine_compiles_total")
NODE_STOP_TIMEOUT_S = 60


def node_prompt() -> str:
    """One user turn of about 300 bytes; every route turns it into the same
    "user: ...\nassistant:" prompt (the gateway's /v1 messages too)."""
    words = ("a mesh node on the card answers the gateway the stream and its "
             "peers with the same greedy tokens from one engine ").split()
    text, i = "", 0
    while len(text) < 294:
        text += words[(i * 5 + 3) % len(words)] + " "
        i += 1
    return "user: " + text[:294].strip()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http_json(method: str, url: str, body=None, timeout: float = 600):
    """(status, parsed JSON or text) of one request over stdlib urllib."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read().decode()
        kind = r.headers.get("Content-Type", "")
        return r.status, (json.loads(raw) if "json" in kind else raw)


def http_sse_text(url: str, body, timeout: float = 600, gaps: list | None = None):
    """Stream an OpenAI chat completion: (joined deltas, s to the first
    delta, s to the end, events) on the client's clock. With ``gaps``, each
    event's (time, seconds from the request or the event before) is
    appended there."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    t0 = last = time.perf_counter()
    first, parts, events = None, [], 0
    with urllib.request.urlopen(req, timeout=timeout) as r:
        check(r.status == 200, f"node: stream answered {r.status}")
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                break
            event = json.loads(line[len("data: "):])
            check("error" not in event, f"node: stream error {event}")
            events += 1
            if gaps is not None:
                now = time.perf_counter()
                gaps.append((now, now - last))
                last = now
            delta = event["choices"][0].get("delta", {}).get("content")
            if delta:
                if first is None:
                    first = time.perf_counter() - t0
                parts.append(delta)
    return "".join(parts), first, time.perf_counter() - t0, events


def direct_stream_text(svc, params):
    """The service's own stream: (joined text, s to the first visible text,
    s to the end, lines) on the caller's clock."""
    t0 = time.perf_counter()
    first, parts, lines = None, [], 0
    for raw in svc.execute_stream(params):
        line = json.loads(raw)
        check(line.get("status") != "error", f"node: execute_stream error {line}")
        lines += 1
        if line.get("text"):
            if first is None:
                first = time.perf_counter() - t0
            parts.append(line["text"])
    check(first is not None, "node: execute_stream carried no text")
    return "".join(parts), first, time.perf_counter() - t0, lines


def http_bytes(url: str, timeout: float = 120):
    """(status, body bytes) of a GET."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def phase_node_prefix(card: str) -> None:
    """Phase 9, second node: serve-cuda's path with
    ``BEE2BEE_PREFIX_CACHE=8`` read by ``load_config`` as ``serve-cuda``
    reads it. One greedy request of the node prompt (a miss) and one more
    (an exact-repeat hit, the reference text: a hit recomputes the last
    prompt position in another chunk width, so at a bf16 near-tie its
    greedy text can leave the miss's); then a device profile (``POST
    /debug/profile``) while streams of the prompt run back to back (each
    text equal to the reference) and, once the trace's export starts, a
    stream of a longer prompt that needs a prefill key not yet captured
    (its capture runs beside the export: its first token comes before the
    export ends, its longest gap under the queue-wait SLO), listed and
    fetched through ``GET``, its
    chrome trace naming the decode kernel; ``/metrics`` samples of the
    economics names; and a second turn extending the first, admitted as
    one hit over the whole first-turn prompt."""
    import asyncio
    import io
    import zipfile

    from bee2bee_tpu_torch.config import load_config
    from bee2bee_tpu_torch.meshnet.runtime import run_p2p_node

    os.environ["BEE2BEE_PREFIX_CACHE"] = str(NODE_PREFIX_ENTRIES)
    try:
        cfg = replace(load_config(), host="127.0.0.1", port=free_port(),
                      api_port=free_port(), bootstrap_url="")
    finally:
        del os.environ["BEE2BEE_PREFIX_CACHE"]
    check(cfg.prefix_cache_entries == NODE_PREFIX_ENTRIES,
          f"node+prefix: BEE2BEE_PREFIX_CACHE gave {cfg.prefix_cache_entries} entries")
    base = f"http://127.0.0.1:{cfg.api_port}"
    prompt = node_prompt()
    ask = {"prompt": prompt, "model": "llama-3-8b", "max_new_tokens": NODE_NEW_TOKENS,
           "temperature": 0.0}
    body = {"model": "llama-3-8b", "stream": True, "temperature": 0.0,
            "max_tokens": NODE_NEW_TOKENS,
            "messages": [{"role": "user", "content": prompt[len("user: "):]}]}
    holder: dict = {}

    async def drive():
        loop = asyncio.get_running_loop()
        ready, stop = asyncio.Event(), asyncio.Event()
        booted: list = []

        async def post_start(node):
            booted.append(node)

        task = asyncio.create_task(run_p2p_node(
            backend="cuda", model="llama-3-8b", cfg=cfg, serve_api=True,
            registry_sync=False, ready_event=ready, shutdown_event=stop,
            post_start=post_start,
        ))
        try:
            await asyncio.wait_for(ready.wait(), NODE_BOOT_TIMEOUT_S)
            engine = booted[0].local_services["cuda"].engine
            holder["engine"] = engine
            st = engine.scheduler.stats
            check(engine.engine_cfg.prefix_cache_entries == NODE_PREFIX_ENTRIES,
                  f"node+prefix: the engine runs {engine.engine_cfg.prefix_cache_entries} entries")
            turn1 = []
            for _ in range(2):  # the miss, then the reference hit
                status, r = await loop.run_in_executor(None, http_json, "POST",
                                                       base + "/chat", ask)
                check(status == 200 and r.get("tokens"), f"node+prefix: /chat {status} {r}")
                turn1.append(r)
            miss, hit = turn1
            check((st.prefix_hits, st.prefix_tokens_saved)
                  == (1, hit["prompt_tokens"] - 1),
                  f"node+prefix: the repeat counted {st.prefix_hits} hits, "
                  f"{st.prefix_tokens_saved} tokens saved")
            from bee2bee_tpu_torch.engine.introspect import get_profiler

            # the profiler's windows and export on this clock, from
            # wrappers of its own
            profiler = get_profiler()
            exporting, spans = threading.Event(), {"windows": [], "export": []}
            real = {n: getattr(profiler, n) for n in ("_window", "_export")}

            def window(*args):
                t = time.perf_counter()
                try:
                    return real["_window"](*args)
                finally:
                    spans["windows"].append((t, time.perf_counter()))

            def export(*args):
                t = time.perf_counter()
                exporting.set()
                try:
                    return real["_export"](*args)
                finally:
                    spans["export"] = [t, time.perf_counter()]

            # a prompt of no shared block and a bucket no earlier request used
            words = prompt[len("user: "):].split()
            long_body = dict(body, messages=[{"role": "user", "content": " ".join(
                (words[::-1] + words[1::2]) * 2)}])
            new_key: dict = {}

            def new_key_stream():
                exporting.wait(300)
                keys = dict(st.root_graphs.get("prefill", {}).get("keys", {}))
                new_key["sent"] = time.perf_counter()
                new_key["gaps"] = []
                http_sse_text(base + "/v1/chat/completions", long_body, 600, new_key["gaps"])
                new_key["keys"] = sorted(set(st.root_graphs["prefill"]["keys"]) - set(keys))

            profiler._window, profiler._export = window, export
            try:
                t0 = time.perf_counter()
                profile = loop.run_in_executor(None, http_json, "POST",
                                               base + "/debug/profile",
                                               {"duration_s": NODE_PROFILE_S}, 300)
                beside = loop.run_in_executor(None, new_key_stream)
                streamed, gaps = [], []
                while not profile.done():
                    got, *_ = await loop.run_in_executor(
                        None, http_sse_text, base + "/v1/chat/completions", body, 600, gaps)
                    streamed.append(got)
                status, header = await profile
                profile_s = time.perf_counter() - t0
                await beside
            finally:
                for n in real:
                    delattr(profiler, n)

            def since(t):
                return round(t - t0, 3)

            end, gap = max(gaps, key=lambda g: g[1])
            gap_ms = gap * 1e3
            t_export, t_exported = spans["export"]
            new_end, new_gap = max(new_key["gaps"], key=lambda g: g[1])
            new_first = new_key["gaps"][0][0]
            log(f"node+prefix: on the client's clock from the POST (s): the profiler's "
                f"windows {[(since(a), since(b)) for a, b in spans['windows']]}, its "
                f"export ({since(t_export)}, {since(t_exported)}); the streams' longest "
                f"gap {gap_ms:.1f} ms ending at {since(end)}; a stream needing the new "
                f"prefill keys {new_key['keys']} sent at {since(new_key['sent'])} (the "
                f"export's start) got its first token at {since(new_first)}, its longest "
                f"gap {new_gap * 1e3:.1f} ms ending at {since(new_end)}; the queue-wait "
                f"SLO {NODE_QUEUE_SLO_MS} ms")
            check(gap_ms < NODE_QUEUE_SLO_MS,
                  f"node+prefix: the longest stream gap beside the profile is {gap_ms:.1f} "
                  f"ms, over the queue-wait SLO of {NODE_QUEUE_SLO_MS} ms")
            check(new_key["keys"] and new_first < t_exported
                  and new_gap * 1e3 < NODE_QUEUE_SLO_MS,
                  f"node+prefix: the stream needing new prefill keys did not get its "
                  f"first token inside the export, or waited over the SLO (line above)")
            check(status == 200 and str(header.get("id", "")).startswith("prof-"),
                  f"node+prefix: POST /debug/profile answered {status} {header}")
            check(streamed and all(s == hit["text"] for s in streamed),
                  f"node+prefix: {len(streamed)} streams during the profile, texts "
                  f"{streamed[:3]} against {hit['text']!r}")
            status, listing = await loop.run_in_executor(None, http_json, "GET",
                                                         base + "/debug/profile")
            check(status == 200 and listing["active"] is None
                  and header["id"] in [p["id"] for p in listing["profiles"]],
                  f"node+prefix: GET /debug/profile listed {listing}")
            status, blob = await loop.run_in_executor(
                None, http_bytes, f"{base}/debug/profile?id={header['id']}")
            check(status == 200, f"node+prefix: GET /debug/profile?id= answered {status}")
            zf = zipfile.ZipFile(io.BytesIO(blob))
            # the chrome trace's device kernels: calls and microseconds by name
            kernels: dict = {}
            for ev in json.loads(zf.read("trace.json"))["traceEvents"]:
                if ev.get("cat") == "kernel":
                    calls, us = kernels.get(ev["name"], (0, 0.0))
                    kernels[ev["name"]] = (calls + 1, us + float(ev.get("dur", 0.0)))
            events = sum(calls for calls, _ in kernels.values())
            top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
            decode = [(k[:40], v) for k, v in top if "ragged_decode" in k]
            check(bool(decode),
                  f"node+prefix: the profile's trace names no decode kernel: {top[:6]}")
            steps = {k: v if isinstance(v, list) else round(v, 3)
                     for k, v in get_profiler().last_timings.items()}
            log(f"node+prefix: /debug/profile {NODE_PROFILE_S} s capture {header} in "
                f"{profile_s:.2f} s beside {len(streamed)} streams (texts equal to the "
                f"hit's; the longest stream gap {gap_ms:.1f} ms against the queue-wait "
                f"SLO of {NODE_QUEUE_SLO_MS} ms); profiler start, stop, export s {steps}; the zip {len(blob)} B holds {zf.namelist()}, {events} kernel events; its top kernels "
                f"(calls, us) {[(k[:40], v) for k, v in top[:4]]}; decode kernels "
                f"{decode}; card {card}")
            status, prom = await loop.run_in_executor(None, http_bytes, base + "/metrics")
            lines = [ln for ln in prom.decode().splitlines()
                     if ln.startswith(NODE_ECONOMICS)]
            missing = [n for n in NODE_ECONOMICS
                       if not any(re.match(rf"{n}[{{ ]", ln) for ln in lines)]
            check(status == 200 and not missing,
                  f"node+prefix: /metrics has no sample of {missing}")
            log(f"node+prefix: /metrics economics {lines}")
            # turn 2: the first turn's transcript, its reply and a new line
            before = (st.prefix_hits, st.prefix_tokens_saved)
            turn2 = dict(ask, prompt=f"{prompt}\nassistant: {hit['text']}\nuser: and "
                                     "what does the second turn reuse?")
            status, r2 = await loop.run_in_executor(None, http_json, "POST",
                                                    base + "/chat", turn2)
            got = (st.prefix_hits - before[0], st.prefix_tokens_saved - before[1])
            check(status == 200 and got == (1, hit["prompt_tokens"]),
                  f"node+prefix: the second turn counted (hits, tokens saved) {got}, "
                  f"expected (1, {hit['prompt_tokens']}): {status} {r2}")
            log(f"node+prefix: the miss ttft {miss['ttft_ms']} ms, the repeat (a hit at "
                f"n - 1) {hit['ttft_ms']} ms, texts {'equal' if miss['text'] == hit['text'] else 'different'}; "
                f"the second turn of {r2.get('prompt_tokens')} prompt tokens admitted as "
                f"one hit over the first turn's {hit['prompt_tokens']}, ttft "
                f"{r2.get('ttft_ms')} ms; card {card}")
        finally:
            stop.set()
            node_obj = await asyncio.wait_for(task, NODE_STOP_TIMEOUT_S)
            check(node_obj._stopped, "node+prefix: not stopped")

    asyncio.run(drive())
    engine = holder.pop("engine", None)
    if engine is not None:
        thread = engine.scheduler._thread
        engine.close()
        check(not thread.is_alive(), "node+prefix: the engine's thread outlived the node")
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def phase_node(card: str) -> dict:
    """Phase 9: serve-cuda's path in this process (see the module
    docstring). The counts are zeroed once the node is ready and read
    after the last request. Returns the counts."""
    import asyncio
    import importlib.util

    from bee2bee_tpu_torch.config import NodeConfig
    from bee2bee_tpu_torch.meshnet.node import P2PNode
    from bee2bee_tpu_torch.meshnet.runtime import run_p2p_node
    from bee2bee_tpu_torch.metrics import get_registry

    have = {name: importlib.util.find_spec(name) is not None for name in NODE_PACKAGES}
    log(f"node: packages {have}")
    serve_api = have["aiohttp"]
    if not serve_api:
        log("gateway: not run (aiohttp absent on this machine)")
    cfg = NodeConfig(host="127.0.0.1", port=free_port(), api_port=free_port(),
                     bootstrap_url="")
    base = f"http://127.0.0.1:{cfg.api_port}"
    prompt = node_prompt()
    ask = {"max_new_tokens": NODE_NEW_TOKENS, "temperature": 0.0}
    out: dict = {}

    async def drive():
        loop = asyncio.get_running_loop()
        ready, stop = asyncio.Event(), asyncio.Event()
        booted: list = []

        async def post_start(node):
            booted.append(node)

        async def heartbeat(gaps):
            # the event loop's longest stall while the service loads (from
            # the gateway's first answer on: the load follows the gateway's
            # start): the 16 GB init runs in an executor, so the loop ticks
            last = time.perf_counter()
            while not ready.is_set():
                await asyncio.sleep(0.01)
                now = time.perf_counter()
                gaps.append(now - last)
                last = now

        gaps: list = []
        beat = None
        t0 = time.perf_counter()
        task = asyncio.create_task(run_p2p_node(
            backend="cuda", model="llama-3-8b", cfg=cfg, serve_api=serve_api,
            registry_sync=False, ready_event=ready, shutdown_event=stop,
            post_start=post_start,
        ))
        client = P2PNode(host="127.0.0.1", port=0)
        try:
            # the gateway starts before the load: time its first answer
            answered = None
            while serve_api and answered is None and not ready.is_set():
                check(not task.done(), "node: boot failed before ready")
                try:
                    t1 = time.perf_counter()
                    status, _ = await loop.run_in_executor(
                        None, http_json, "GET", base + "/", None, 5)
                    answered = (status, time.perf_counter() - t1, ready.is_set())
                    beat = asyncio.create_task(heartbeat(gaps))
                except OSError:
                    await asyncio.sleep(0.05)
            await asyncio.wait_for(ready.wait(), NODE_BOOT_TIMEOUT_S)
            boot_s = time.perf_counter() - t0
            if serve_api and answered is None:  # the load beat the first answer
                t1 = time.perf_counter()
                status, _ = await loop.run_in_executor(None, http_json, "GET", base + "/")
                answered = (status, time.perf_counter() - t1, True)
            if beat is not None:
                await beat
            node = booted[0]
            svc = node.local_services["cuda"]
            engine = svc.engine
            stall = (f"{max(gaps) * 1e3:.1f} ms over {len(gaps)} 10 ms ticks" if gaps
                     else "not measured")
            log(f"node: booted in {boot_s:.2f} s (the service's load in an executor "
                f"inside it); the event loop's longest stall from the gateway's first "
                f"answer to ready: {stall}")
            if serve_api:
                check(answered is not None and answered[0] == 200,
                      f"node: the gateway's GET / answered {answered}")
                t1 = time.perf_counter()
                status, _ = await loop.run_in_executor(None, http_json, "GET", base + "/")
                log(f"node: the gateway's first GET / {answered[1] * 1e3:.1f} ms "
                    f"({'after' if answered[2] else 'during'} the load), the next "
                    f"{(time.perf_counter() - t1) * 1e3:.1f} ms")
            since = graph_stats(engine, "node")
            reset_counts()
            engine.forward_calls = 0
            # the node's first request pays its engine's first-use costs:
            # it goes straight to the service and is timed on its own
            t1 = time.perf_counter()
            cold = await loop.run_in_executor(None, svc.execute, {"prompt": prompt, **ask})
            log(f"node: first request (direct, cold) {cold['tokens']} tokens in "
                f"{(time.perf_counter() - t1) * 1e3:.1f} ms (engine ttft "
                f"{cold['ttft_ms']} ms)")
            texts = {"cold": cold["text"]}
            # the decode at batch 1 is host-bound, and the host's clock
            # varies from request to request: the gateway's /chat and the
            # direct call take turns, NODE_ROUNDS times each
            runs: dict = {"gateway": [], "direct": []}
            for i in range(NODE_ROUNDS):
                if serve_api:
                    t1 = time.perf_counter()
                    status, chat = await loop.run_in_executor(
                        None, http_json, "POST", base + "/chat",
                        {"prompt": prompt, "model": "llama-3-8b", **ask})
                    check(status == 200 and isinstance(chat.get("text"), str),
                          f"node: /chat answered {status} {chat}")
                    runs["gateway"].append((time.perf_counter() - t1, chat))
                    texts[f"gateway{i}"] = chat["text"]
                t1 = time.perf_counter()
                direct = await loop.run_in_executor(
                    None, svc.execute, {"prompt": prompt, **ask})
                runs["direct"].append((time.perf_counter() - t1, direct))
                texts[f"direct{i}"] = direct["text"]
            streams = {}
            if serve_api:
                body = {"model": "llama-3-8b", "stream": True, "temperature": 0.0,
                        "max_tokens": NODE_NEW_TOKENS,
                        "messages": [{"role": "user", "content": prompt[len("user: "):]}]}
                texts["stream"], *streams["gateway"] = await loop.run_in_executor(
                    None, http_sse_text, base + "/v1/chat/completions", body)
            texts["direct_stream"], *streams["direct"] = await loop.run_in_executor(
                None, direct_stream_text, svc, {"prompt": prompt, **ask})
            for path, rows in runs.items():
                if not rows:
                    continue
                walls = [w * 1e3 for w, _ in rows]
                ttfts = [r["ttft_ms"] for _, r in rows]
                rates = [r["tokens_per_sec"] for _, r in rows]
                first, end, events = streams[path]
                summary = dict(wall_ms=statistics.median(walls), ttft_ms=statistics.median(ttfts),
                               tok_s=statistics.median(rates), first_ms=first * 1e3,
                               end_ms=end * 1e3, tokens=rows[0][1]["tokens"])
                out[path] = summary
                log(f"node: {path}: {summary['tokens']} tokens, client wall {walls} ms, "
                    f"engine ttft {ttfts} ms, engine tok/s {rates}; its stream: first "
                    f"visible text {first * 1e3:.1f} ms, end {end * 1e3:.1f} ms, "
                    f"{events} events (client clock)")
            await client.start()
            link = node.join_link()
            check(await client.connect_bootstrap(link), f"node: join through {link} failed")
            for _ in range(200):
                if client.list_providers("llama-3-8b"):
                    break
                await asyncio.sleep(0.05)
            provs = client.list_providers("llama-3-8b")
            check([p["provider_id"] for p in provs] == [node.peer_id]
                  and provs[0].get("backend") == "cuda",
                  f"node: the joined peer sees providers {provs}")
            t1 = time.perf_counter()
            mesh = await client.request_generation(
                node.peer_id, prompt, model="llama-3-8b", **ask)
            mesh_s = time.perf_counter() - t1
            texts["mesh"] = mesh["text"]
            log(f"node: mesh gen_request {mesh['tokens']} tokens in {mesh_s * 1e3:.1f} ms")
            torch.cuda.synchronize()
            counts = read_counts()
            forwards = engine.forward_calls
            out["graphs"] = graph_stats(engine, "node", since)
            if serve_api:
                status, listed = await loop.run_in_executor(
                    None, http_json, "GET", base + "/providers")
                mine = [p for p in listed["providers"] if "llama-3-8b" in p.get("models", [])]
                check(status == 200 and len(mine) == 1 and mine[0].get("backend") == "cuda",
                      f"node: /providers lists {listed}")
                status, prom = await loop.run_in_executor(
                    None, http_json, "GET", base + "/metrics")
                status_j, snap = await loop.run_in_executor(
                    None, http_json, "GET", base + "/metrics?format=json")
                engine_names = {n for n in get_registry().snapshot() if n.startswith("engine.")}
                missing = engine_names - set(snap["metrics"])
                check(status == status_j == 200 and engine_names and not missing
                      and "bee2bee_engine_ttft_ms" in prom,
                      f"node: /metrics lacks {sorted(missing)}")
                log(f"node: /providers lists llama-3-8b with backend cuda; /metrics "
                    f"carries {len(engine_names)} engine.* names")
            log(f"node: texts {json.dumps(texts)[:600]}")
            check(len(set(texts.values())) == 1 and texts["cold"],
                  f"node: the routes' texts differ: {texts}")
            out.update(counts=counts, forwards=forwards, engine=engine, boot_s=boot_s)
        finally:
            await client.stop()
            stop.set()
            t1 = time.perf_counter()
            node_obj = await asyncio.wait_for(task, NODE_STOP_TIMEOUT_S)
            out["stop_s"] = time.perf_counter() - t1
            check(node_obj._stopped, "node: not stopped")

    # time the service's load where run_p2p_node runs it (in an executor)
    from bee2bee_tpu_torch.services.cuda import CUDAService

    load_sync = CUDAService.load_sync

    def timed_load(svc):
        t1 = time.perf_counter()
        svc = load_sync(svc)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t1
        return svc

    CUDAService.load_sync = timed_load
    try:
        asyncio.run(drive())
    finally:
        CUDAService.load_sync = load_sync
    log(f"node: the service's load {out['load_s']:.2f} s of the {out['boot_s']:.2f} s boot")
    engine = out.pop("engine")
    cfg_m = engine.model_cfg
    thread = engine.scheduler._thread
    engine.close()
    check(not thread.is_alive(), "node: the engine's scheduler thread outlived the node")
    counts, forwards = out["counts"], out["forwards"]
    log(f"node: stopped in {out['stop_s']:.2f} s; kernel launches {counts}, forward "
        f"calls {forwards}, n_layers {cfg_m.n_layers}")
    dec, tile = counts["ragged_decode"], counts["ragged_prefill"]
    check(dec > 0 and tile > 0 and dec + tile == cfg_m.n_layers * forwards,
          f"node: decode {dec} + tile {tile} launches != {cfg_m.n_layers} x {forwards}")
    replays = out["graphs"]["replays"]
    check(replays > 0 and dec == cfg_m.n_layers * replays,
          f"node: decode launches {dec} != {cfg_m.n_layers} x {replays} replayed "
          f"decode steps")
    others = {k: v for k, v in counts.items()
              if k not in ("ragged_decode", "ragged_prefill") and v}
    check(not others, f"node: other kernel forms launched: {others}")
    if "gateway" in out:
        g, d = out["gateway"], out["direct"]
        log(f"node: medians of {NODE_ROUNDS}, through the gateway vs direct: TTFT "
            f"{g['ttft_ms']} vs {d['ttft_ms']} ms (engine clock), {g['tok_s']} vs "
            f"{d['tok_s']} tok/s (engine clock), {g['tokens']} tokens in "
            f"{g['wall_ms']:.1f} vs {d['wall_ms']:.1f} ms (client clock); first visible "
            f"text of a stream {g['first_ms']:.1f} vs {d['first_ms']:.1f} ms; card {card}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    if not (here / "bee2bee_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: bee2bee_tpu_torch/ not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(here))
    # the nodes' state (identity, incidents, profiles) stays in the checkout
    os.environ.setdefault("BEE2BEE_TPU_HOME", str(here / "build" / "bee2bee_home"))
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    stage("device and build")
    card, _ = phase_device_and_build()
    if len(sys.argv) == 3 and sys.argv[1] == "--ring-repro":
        ring_repro(card, int(sys.argv[2]))
        log(f"card: {card}")
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--node-profile":
        return node_profile_rounds(card, int(sys.argv[2]))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    stage("ragged vs plain")
    errs, timings = phase_ragged_vs_plain(flush)
    int8_errs, int8_timings = phase_ragged_vs_plain(flush, int8=True)
    stage("flash vs plain")
    flash_errs, flash_timings = phase_flash_vs_plain(flush)
    del flush
    stage("forward parity")
    fwd_counts = phase_forward_parity()
    gemma_counts = phase_gemma_forward()
    stage("slice")
    counts, bf16_pool, params = phase_slice(card)
    int8_counts, int8_pool = phase_slice(card, "int8", params=params)[:2]
    ratio = int8_pool / bf16_pool
    log(f"pool bytes: int8 {int8_pool} B vs bf16 {bf16_pool} B -> {ratio:.4f}x "
        f"(scales included)")
    check(ratio <= 0.502, f"int8 pool is {ratio:.4f}x the bf16 pool's bytes")
    # the prefix cache over the same bf16 weights, bf16 and int8 pools
    stage("prefix")
    prefix = {pool: phase_prefix(card, params, pool) for pool in ("bfloat16", "int8")}
    for pool in ("bfloat16", "int8"):
        phase_prefix_pressure(card, params, pool)
    stage("spec, model tier")
    spec_model = phase_spec_model(card, params)
    # phase 8: the same weights cast to f32 (the bf16 copy freed first: the
    # node phase loads its own), over an int8 pool and then an f32 pool
    gc.collect()
    params = cast_tree(params, torch.float32)
    gc.collect()
    torch.cuda.empty_cache()
    stage("f32 slice")
    f32_counts = {pool: phase_slice(card, pool, params=params, dtype="float32")[0]
                  for pool in ("int8", "float32")}
    # the prefix cache in f32 (f32 pool) on the bf16 run's turn-2 prompts:
    # a hit's greedy tokens equal the cache-off engine's, and the cache-off
    # first-token logits are the f32 side of the bf16 logits rule
    stage("f32 prefix")
    prefix_f32 = phase_prefix(card, params, "float32", dtype="float32",
                              prompts2=prefix["bfloat16"]["prompts2"])
    diverged = {n: (toks, prefix_f32["off_tokens"][n])
                for n, toks in prefix_f32["tokens"].items()
                if toks != prefix_f32["off_tokens"][n]}
    check(not diverged, f"prefix[float32]: turn-2 hits' greedy tokens differ from the "
          f"cache-off engine's: {diverged}")
    log(f"prefix[float32]: the 8 hits' greedy tokens ({PREFIX_REPLY} each) equal the "
        f"cache-off engine's, token for token")
    for pool in ("bfloat16", "int8"):
        check_prefix_logits(f"prefix[{pool} pool]", prefix[pool], prefix_f32["off_logits"])
    stage("spec, n-gram tier")
    spec_ngram = phase_spec_ngram(card, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    stage("node")
    node_counts = phase_node(card)
    stage("node with the prefix cache")
    phase_node_prefix(card)
    stage("kernel table")

    # the prefix phases' launches join the main path's
    for name, n in prefix["bfloat16"]["counts"].items():
        counts[name] += n
    for name, n in prefix["int8"]["counts"].items():
        int8_counts[name] += n
    for name, n in prefix_f32["counts"].items():
        f32_counts["float32"][name] += n
    # and the speculative phases' (bf16 model tier, f32 n-gram tier)
    for name, n in spec_model.items():
        counts[name] += n
    for name, n in spec_ngram.items():
        f32_counts["float32"][name] += n

    def row(name, source, replaces, n, err, t):
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": n,
            "max_abs_err": err,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        }

    def forced_row(t):  # a timing with the row kernel's forced time as ms
        return dict(t, ms=t["forced"]["row"])

    ragged_src = "bee2bee_tpu_torch/csrc/ragged_attention.cu"
    prefill_src = "bee2bee_tpu_torch/csrc/ragged_prefill_attention.cu"
    decode_src = "bee2bee_tpu_torch/csrc/ragged_decode_attention.cu"
    decode_f32_src = "bee2bee_tpu_torch/csrc/ragged_decode_attention_f32.cu"
    f32_int8, f32_f32 = f32_counts["int8"], f32_counts["float32"]
    flash_src = "bee2bee_tpu_torch/csrc/flash_attention.cu"
    bf16_g, int8_g = gemma_counts["bfloat16"], gemma_counts["int8"]
    kernels = [
        row("ragged_decode_attention", decode_src, "bee2bee_tpu/ops/ragged.py:84",
            counts["ragged_decode"] + node_counts["ragged_decode"], errs["decode"],
            timings["decode"]),
        row("ragged_decode_attention_int8", decode_src,
            "bee2bee_tpu/ops/ragged.py:107", int8_counts["ragged_decode_int8"],
            int8_errs["decode"], int8_timings["decode"]),
        # the row kernel, forced in bf16 at gemma-2-9b's heads at the decode
        # shape (beside the same inputs' plain, SDPA and bound), and flash's
        # forced at causal T=S=2048 there
        row("ragged_paged_attention", ragged_src, "bee2bee_tpu/ops/ragged.py:84",
            counts["ragged"], errs["row"], forced_row(timings["decode_hd256"])),
        row("ragged_paged_attention_int8", ragged_src,
            "bee2bee_tpu/ops/ragged.py:107", int8_counts["ragged_int8"],
            int8_errs["row"], forced_row(int8_timings["decode_hd256"])),
        row("flash_attention", flash_src, "bee2bee_tpu/ops/flash.py:46",
            counts["flash"] + int8_counts["flash"], flash_errs["row"],
            flash_timings["row_hd256"]),
        # the head_dim-256 forms at gemma-2-9b's heads: launches from the
        # gemma-geometry forward (phase 5), times at decode B=8 ctx 1024,
        # prefill T=512 @1000 and flash causal T=S=2048
        row("ragged_prefill_attention_hd256", prefill_src,
            "bee2bee_tpu/ops/ragged.py:84", bf16_g["ragged_prefill_hd256"],
            errs["tile_hd256"], timings["prefill_hd256"]),
        row("ragged_prefill_attention_hd256_int8", prefill_src,
            "bee2bee_tpu/ops/ragged.py:107", int8_g["ragged_prefill_hd256_int8"],
            int8_errs["tile_hd256"], int8_timings["prefill_hd256"]),
        row("ragged_decode_attention_hd256", decode_src, "bee2bee_tpu/ops/ragged.py:84",
            bf16_g["ragged_decode_hd256"], errs["decode_hd256"],
            timings["decode_hd256"]),
        row("ragged_decode_attention_hd256_int8", decode_src,
            "bee2bee_tpu/ops/ragged.py:107", int8_g["ragged_decode_hd256_int8"],
            int8_errs["decode_hd256"], int8_timings["decode_hd256"]),
        row("flash_attention_tile_hd256", flash_src, "bee2bee_tpu/ops/flash.py:46",
            counts["flash_tile_hd256"] + int8_counts["flash_tile_hd256"],
            flash_errs["tile_hd256"], flash_timings["tile_hd256"]),
        row("ragged_prefill_attention", prefill_src, "bee2bee_tpu/ops/ragged.py:84",
            counts["ragged_prefill"] + node_counts["ragged_prefill"], errs["tile"],
            timings["prefill"]),
        row("ragged_prefill_attention_int8", prefill_src,
            "bee2bee_tpu/ops/ragged.py:107", int8_counts["ragged_prefill_int8"],
            int8_errs["tile"], int8_timings["prefill"]),
        row("flash_attention_tile", flash_src, "bee2bee_tpu/ops/flash.py:46",
            counts["flash_tile"] + int8_counts["flash_tile"], flash_errs["tile"],
            flash_timings["tile"]),
        # the f32 tile forms (3xTF32), timed at the prefill chunk and causal
        # T=S=2048; bound: three TF32 products at the TF32 peak; the ragged
        # forms' launches from the f32 slice's prefill chunks (phase 8)
        row("ragged_prefill_attention_f32", prefill_src, "bee2bee_tpu/ops/ragged.py:84",
            f32_f32["ragged_prefill_f32"], errs["tile_f32"], timings["prefill_f32"]),
        row("ragged_prefill_attention_f32_int8", prefill_src,
            "bee2bee_tpu/ops/ragged.py:107", f32_int8["ragged_prefill_f32_int8"],
            int8_errs["tile_f32"], int8_timings["prefill_f32"]),
        row("flash_attention_tile_f32", flash_src, "bee2bee_tpu/ops/flash.py:46",
            counts["flash_tile_f32"] + int8_counts["flash_tile_f32"],
            flash_errs["tile_f32"], flash_timings["tile_f32"]),
        # the f32 decode kernel: launches from the f32 slice (phase 8) and
        # phase 5's f32 forwards at llama-3-8b's heads, times at decode B=8
        # ctx 1024 (llama-3-8b's and gemma-2-9b's heads); bound: the bytes
        # or the FFMA products at the f32 CUDA-core peak
        row("ragged_decode_attention_f32", decode_f32_src, "bee2bee_tpu/ops/ragged.py:84",
            f32_f32["ragged_decode_f32"] + fwd_counts.get("ragged_decode_f32", 0),
            errs["decode_f32"], timings["decode_f32"]),
        row("ragged_decode_attention_f32_int8", decode_f32_src,
            "bee2bee_tpu/ops/ragged.py:107",
            f32_int8["ragged_decode_f32_int8"] + fwd_counts.get("ragged_decode_f32_int8", 0),
            int8_errs["decode_f32"], int8_timings["decode_f32"]),
        row("ragged_decode_attention_f32_hd256", decode_f32_src,
            "bee2bee_tpu/ops/ragged.py:84", 0, errs["decode_f32"],
            timings["decode_hd256_f32"]),
        row("ragged_decode_attention_f32_hd256_int8", decode_f32_src,
            "bee2bee_tpu/ops/ragged.py:107", 0, int8_errs["decode_f32"],
            int8_timings["decode_hd256_f32"]),
    ]
    log("kernels: the flash kernels have 0 launches on the main path: no "
        "serving path calls flash_attention (the engines attend through the "
        "ragged op); the ragged row kernel has 0 there too: the rule names it "
        "for no query type the kernels take (it is forced, and timed, at "
        "gemma-2-9b's heads). The f32 decode kernel and the f32 tile forms "
        "serve the f32 slice (phase 8: decode and prefill at head_dim 128, over "
        "an int8 and an f32 pool) and phase 5's f32 forwards; the head_dim-256 "
        "forms' launches are those of phase 5's gemma-geometry forward (bf16), "
        "and their f32 forms have none on a served path. All are held against "
        "the plain version and timed above")
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
