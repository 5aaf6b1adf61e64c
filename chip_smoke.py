#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bee2bee_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its numbers on lines of their own; any failure raises
and the script exits non-zero):

1. Device and build: the card's name and power limit, then the CUDA
   kernels built from csrc/ with nvcc (one process per source, all at
   once); ptxas's registers and spills of every decode, f32 and head_dim
   256 instantiation, and a failure if a head_dim-256 instantiation the
   dispatch names (tile, f32 tile, decode and merge, flash tile and f32
   tile kernels) spills.
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
   block sizes 8 and 32 (the tile kernel); then f32 (the tile kernel's
   3xTF32 form; over an int8 pool the row kernel below T_MIN_F32_INT8):
   decode with a dead row, at offset -1 and at head_dim 64, verify T=3
   and T=4, prefill T in {5, 17, 300, 512 @1000, 2048 @0}, window +
   softcap + scale at T=5 and T=64, block sizes 8 and 32, head_dim 64;
   then head_dim 256 at gemma-2-9b's heads (16/8, window 4096, softcap 50,
   scale 1/16) in bf16 (the decode and tile kernels' head_dim-256 forms)
   and f32 (the row kernel below T_MIN_F32_HD256, the f32 tile form from
   it on; over an int8 pool T_MIN_F32_INT8_HD256): decode with window cuts, at offset -1 beside
   a dead row and null tails, B=8 ctx 1024, block sizes 8 and 32; verify
   T=5 with a dead row, chunks of 17 and 300 cut by the window, prefill
   T=512 @1000, T=100 at block sizes 8 and 32; the row kernel is forced
   as well on the decode and T=17 cases in both types (those it served
   at head_dim 256 before). Each
   case checks that exactly the kernel the dispatch rule names launched,
   once, and each decode case that a second call gives the same bytes.
   Tolerance: max abs error <= 2e-2 against the plain version run in f32
   on the same bf16 inputs (bf16 output rounding is ~4e-3 at these
   magnitudes; the decode and tile kernels also round P to bf16, as the
   JAX kernel does), 1e-4 in f32. Then times, each beside the plain
   version, SDPA over the gathered view in q's type (the library
   yardstick, never used by the port; the backend it ran is printed once)
   and the bound (f32: three TF32 products at the TF32 peak, with the
   CUDA-core FFMA bound beside it): the decode kernel at B=8 over a
   1024-token context and at B=1 over 2048 (with its split plan), the row
   and the tile kernel forced at the same decode inputs, the f32 tile
   form at the B=8 decode shape (and the row kernel forced there), the
   tile kernel and its f32 form at a 512-token prefill chunk at offset
   1000; at gemma heads (window 4096 and scale 1/16; no softcap, which
   SDPA cannot apply) the head_dim-256 decode form at B=8 ctx 1024 and
   tile form at T=512 @1000, each with the other kernels that take the
   inputs forced beside it (the row kernel among them), and the same in
   f32 (the row kernel and the f32 tile form); the crossover of the row
   and tile kernels over T, bf16 and f32, at llama-3-8b's and at gemma
   heads; then the decode
   sweep, 32 launches back to back over a 32-layer copy of the pool, in
   ms per launch.
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
   over an int8 pool (each forward through the kernel the rule names:
   the f32 tile form, and over the int8 pool the row kernel for the
   decode steps; logits within 2e-3, greedy tokens equal;
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
   execute_stream; the decode kernel's launches plus the tile kernel's
   must equal n_layers x the engine's forward calls, the decode kernel's
   n_layers x the decode forwards (chunk length 1), the tile kernel's
   n_layers x the prefill-chunk forwards (both > 0), and the row
   kernel's 0. Then a breakdown of a decode step and a prefill chunk:
   host wall, device busy, idle share and the attention kernels' ms per
   launch inside the step (the decode kernel's two CUDA kernels summed).
7. The int8 slice: the same parameters served by an engine with
   cache_dtype="int8" inside CUDAService, the same requests and the same
   launch checks on the int8 counters (the bf16 pool's stay 0); pool
   bytes beside the bf16 pool's.
8. The node (serve-cuda's path): the port's run_p2p_node boots a mesh
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
   (both > 0, every other counter 0), and the node must stop in time and
   take its engine thread down. Prints the packages the node may lack,
   the boot and the service's load seconds, the event loop's longest
   stall during the load, and TTFT and tok/s through the gateway against
   the direct call (medians of 3 alternating pairs), with the card's name
   and power limit.
9. The kernel table as one JSON line (the head_dim-256 forms' launches
   from phase 5's gemma-geometry forward; the decode and tile kernels'
   from phases 6-8), then the result line.

Exits non-zero, printing no result, when no CUDA card is present or
when the package is not beside this script.
"""

from __future__ import annotations

import gc
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
from dataclasses import replace
from pathlib import Path

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
SPIN_CYCLES = 200_000  # ~0.1 ms at the H100's 1.98 GHz boost clock


def log(msg: str) -> None:
    print(msg, flush=True)


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
        # every instantiation of the decode kernel, of the f32 tile forms
        # and at head_dim 256; the tile and decode kernels' head_dim-256
        # forms must not spill
        for name, line in ptxas_entries(report):
            hd256 = name.split("<")[1].startswith("256")
            if source == "ragged_decode_attention.cu" or "_f32_" in name or hd256:
                log(f"build: {source}: {name}: {line}")
            if hd256 and name.startswith(HD256_FORMS):
                check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                      f"{source}: {name} spills: {line}")
    return card, build_s


# the kernels whose head_dim-256 instantiations the dispatch names
HD256_FORMS = ("ragged_prefill_kernel", "ragged_prefill_f32_kernel",
               "ragged_decode_kernel", "ragged_decode_merge", "flash_tile_kernel",
               "flash_tile_f32_kernel")


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
# the f32 tile form (3xTF32), decode included
F32_RAGGED_CASES = [
    ("f32 decode + dead row", dict(offs=[0, 17, 300, 1023], T=1, dead=(2,), **F32), {}),
    ("f32 decode offset -1 + dead row", dict(offs=[-1, 300, 57, 1000], T=1, dead=(1,),
                                             **F32), {}),
    ("f32 decode hd=64", dict(offs=[3, 40, 100, 1000], T=1, hd=64, **F32), {}),
    ("f32 verify T=3", dict(offs=[7, 300, 1023], T=3, **F32), {}),
    ("f32 verify T=4", dict(offs=[7, 300, 1023], T=4, **F32), {}),
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
# bf16 the decode and tile kernels' head_dim-256 forms, in f32 the row
# kernel
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


def split_plan(q, kp, tb) -> str:
    """The decode kernel's split plan for these inputs, as printed."""
    from bee2bee_tpu_torch.ops.ragged import _sm_count, decode_splits

    splits, pages = decode_splits(q.shape[0], kp.shape[0], tb.shape[1], kp.shape[2],
                                  _sm_count(q.device.index))
    return f"{splits} splits x {pages} pages"


def bounds(nbytes: int, flops: int, dtype) -> dict:
    """The least time the card could take: max(bytes at the HBM rate, flops
    at the peak of the type's products). f32: three TF32 products at the
    TF32 tensor-core peak (f32-accurate work on the tensor cores); the
    CUDA-core f32 time (one FFMA product) is kept beside it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if dtype == torch.bfloat16:
        t_ops, peak = flops / BF16_FLOPS_PER_S * 1e3, "bf16 989 TFLOP/s"
    else:
        t_ops = TF32_PRODUCTS * flops / TF32_FLOPS_PER_S * 1e3
        peak = f"{TF32_PRODUCTS}xTF32 at {TF32_FLOPS_PER_S / 1e12} TFLOP/s"
    bound_ms = max(t_bytes, t_ops)
    out = dict(bound_ms=bound_ms, bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops)
    text = (f"bound {bound_ms:.4f} ms ({out['bound_by']}: {nbytes} B -> "
            f"{t_bytes:.4f} ms, {flops} flop, {peak} -> {t_ops:.4f} ms)")
    if dtype == torch.float32:
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
    b = bounds(nbytes, flops, q.dtype)
    plan = (f", plan {split_plan(q, kp, tb)}"
            if ragged_kernel(q.dtype, T, hd).startswith("decode") else "")
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
                   "decode_hd256": "ragged_decode_hd256"}


def ragged_counter(q, int8: bool) -> str:
    """The launch counter the dispatch rule names for these queries."""
    from bee2bee_tpu_torch.ops.ragged import ragged_kernel

    kernel = ragged_kernel(q.dtype, q.shape[1], q.shape[3], int8)
    return RAGGED_COUNTERS[kernel] + ("_int8" if int8 else "")


def check_one_launch(label: str, counter: str) -> None:
    counts = read_counts()
    check(counts[counter] == 1 and sum(counts.values()) == 1,
          f"{label}: expected one {counter} launch, counted {counts}")


def time_crossover(label, gen, flush, int8, dtype=torch.bfloat16, heads=None):
    """The row kernel and the tile kernel of q's type forced at the same
    inputs, over T, at llama-3-8b's heads or ``heads`` (GEMMA: the tile
    kernel's head_dim-256 form): where the tile kernel starts to win (the
    dispatch's T_MIN, T_MIN_F32), and the row kernel at the timed prefill
    chunk."""
    from bee2bee_tpu_torch.ops.ragged import _launch_kernel, row_offsets

    heads = heads or {}
    hd = heads.get("hd", 128)
    tile = ("tile_f32" if dtype == torch.float32
            else "tile_hd256" if hd == 256 else "tile")
    shapes = ((8, 1000, (1, 2, 4, 8, 16, 32)), (1, 48, (2, 8, 16)), (1, 1000, (512,)))
    if dtype == torch.float32:
        shapes = ((8, 1000, (1, 2, 4, 8, 16, 32)), (1, 1000, (512,)))
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

            row_ms = cuda_time_ms(lambda: run("row"), flush=flush)
            tile_ms = cuda_time_ms(lambda: run(tile), flush=flush)
            log(f"crossover {label} B={B} T={T} ctx={off0 + T} H={q.shape[2]}/"
                f"{kp.shape[0]} hd={hd} ({dtype}): row kernel {row_ms:.4f} ms, {tile} "
                f"kernel {tile_ms:.4f} ms")


def forced_kernels(q) -> tuple:
    """The ragged kernels that take these queries: bf16, the decode kernel
    (T = 1), the tile kernel and the row kernel, the first two in their
    head_dim-256 forms where hd is 256; f32, the f32 tile form and the row
    kernel."""
    T, hd = q.shape[1], q.shape[3]
    sfx = "_hd256" if hd == 256 else ""
    if q.dtype == torch.bfloat16:
        return (("decode" + sfx,) if T == 1 else ()) + ("tile" + sfx, "row")
    return ("tile_f32", "row")


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
        flush=flush) for k in forced_kernels(q)}
    plan = (f" (plan {split_plan(q, kp, tb)})"
            if any(k.startswith("decode") for k in ms) else "")
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
        counter = ragged_counter(q, int8)
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
            # the split-K merge runs in a fixed order: a second call repeats
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
            ("prefill", [1000], 512, torch.bfloat16, {}, False),
            ("prefill_f32", [1000], 512, torch.float32, {}, False),
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
        timings[label] = time_ragged(f"{label0}{label} ({ragged_counter(q, int8)} "
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

    def check_f32_launches(tag, int8):
        # the prefill and each decode step through the kernel the rule
        # names for its chunk length and pool form, and no other
        want: dict = {}
        for T, n in ((n_prompt, 1), (1, n_steps)):
            kernel = ragged_kernel(torch.float32, T, cfg.head_dim, int8)
            counter = RAGGED_COUNTERS[kernel] + ("_int8" if int8 else "")
            want[counter] = want.get(counter, 0) + cfg.n_layers * n
        got = {k: v for k, v in read_counts().items() if v}
        check(got == want, f"{tag}: launches {got}, expected {want}")
        log(f"{tag}: launches {got}")

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


# ------------------------------------------------------------ phases 6-7


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


def step_breakdown(engine, B=8, ctx=1024, steps=10, prefill=2048):
    """Where the serving forwards' time goes: a B-row decode step at
    context ``ctx`` and one ``prefill``-token prefill chunk. Host wall time
    (synchronised, profiler off) beside the device's busy time (kernel
    durations under torch.profiler); 1 - busy/wall is the device's idle
    share."""
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

    kv = engine.engine_cfg.cache_dtype
    for label, fn, calls in ((f"decode step B=8 ctx=1024 ({kv} pool)", decode, steps),
                             (f"prefill chunk T={prefill} ({kv} pool)",
                              prefill_chunk, 2)):
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
            f"top kernels by device time {top}")
    weight_bytes = engine.info["n_params"] * engine.dtype.itemsize
    log(f"breakdown: weights {weight_bytes} B -> "
        f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms per step at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s")


def reset_counts():
    from bee2bee_tpu_torch.ops.flash import flash_attention
    from bee2bee_tpu_torch.ops.ragged import ragged_paged_attention

    for name in ("launches", "int8_launches", "prefill_launches",
                 "int8_prefill_launches", "f32_prefill_launches",
                 "int8_f32_prefill_launches", "decode_launches", "int8_decode_launches",
                 "hd256_prefill_launches", "int8_hd256_prefill_launches",
                 "hd256_decode_launches", "int8_hd256_decode_launches"):
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
        "flash": flash_attention.launches,
        "flash_tile": flash_attention.tile_launches,
        "flash_tile_hd256": flash_attention.hd256_tile_launches,
        "flash_tile_f32": flash_attention.f32_tile_launches,
    }


def pool_bytes(engine) -> int:
    return sum(t.numel() * t.element_size()
               for t in engine.scheduler._cache.values())


def load_slice(cache_dtype="bfloat16", params=None):
    """CUDAService over llama-3-8b: a random init from SEED, or the given
    parameters shared with another engine (no second 16 GB init)."""
    from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
    from bee2bee_tpu_torch.services import CUDAService

    ecfg = EngineConfig(
        max_seq_len=2048, max_batch=8, kv_block_size=16, decode_chunk=32,
        rng_seed=SEED, cache_dtype=cache_dtype,
    )
    t0 = time.perf_counter()
    engine = None
    if params is not None:
        engine = InferenceEngine("llama-3-8b", params=params, engine_config=ecfg)
    svc = CUDAService("llama-3-8b", max_new_tokens=64, engine=engine,
                      engine_config=ecfg).load_sync()
    torch.cuda.synchronize()
    return svc, time.perf_counter() - t0


def phase_slice(cache_dtype="bfloat16", params=None):
    """Serve 8 concurrent requests and one stream; the counts are zeroed
    just before and read just after. Returns (the launch counts, pool
    bytes, the engine's params)."""
    from bee2bee_tpu_torch.ops.ragged import ragged_kernel

    suffix = "_int8" if cache_dtype == "int8" else ""
    dec, tile = "ragged_decode" + suffix, "ragged_prefill" + suffix
    torch.cuda.reset_peak_memory_stats()
    svc, load_s = load_slice(cache_dtype, params)
    engine = svc.engine
    cfg = engine.model_cfg
    tag = f"slice[{cache_dtype} pool]"
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
            f"decode tok/s; peak memory {torch.cuda.max_memory_allocated()} B; "
            f"pool {nbytes} B ({engine.pool_blocks} blocks)")
        named = [ragged_kernel(engine.dtype, T, cfg.head_dim) for T in chunks]
        prefills = sum(T > 1 for T in chunks)
        decodes = sum(T == 1 for T in chunks)
        log(f"{tag}: kernel launches {counts}, forward calls {forwards} "
            f"({prefills} prefill chunks, {named.count('tile')} of them through the "
            f"tile kernel; {decodes} decode steps, {named.count('decode')} of them "
            f"through the decode kernel), n_layers {cfg.n_layers}")
        check(len(chunks) == forwards,
              f"{tag}: {len(chunks)} forwards seen of {forwards}")
        check(counts[dec] + counts[tile] == cfg.n_layers * forwards,
              f"{tag}: launches {counts[dec]} + {counts[tile]} != {cfg.n_layers} x "
              f"{forwards} forwards")
        check(counts[tile] > 0 and named.count("tile") == prefills
              and counts[tile] == cfg.n_layers * prefills,
              f"{tag}: tile launches {counts[tile]} != {cfg.n_layers} x {prefills} "
              f"prefill chunks")
        check(counts[dec] > 0 and named.count("decode") == decodes
              and counts[dec] == cfg.n_layers * decodes,
              f"{tag}: decode launches {counts[dec]} != {cfg.n_layers} x {decodes} "
              f"decode steps")
        others = {k: v for k, v in counts.items() if k not in (dec, tile) and v}
        check(not others, f"{tag}: other kernel forms launched: {others}")
        step_breakdown(engine)
        return counts, nbytes, engine.params
    finally:
        engine.close()


# ------------------------------------------------------------ phase 8


# the node's packages that the card's machine may lack: the node picks the
# loopback transport without websockets, reports 0 cpu/ram without psutil,
# and cannot run its aiohttp gateway without aiohttp
NODE_PACKAGES = ("aiohttp", "websockets", "click", "psutil", "httpx", "ml_dtypes")
NODE_NEW_TOKENS = 32
NODE_ROUNDS = 3
NODE_BOOT_TIMEOUT_S = 600
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


def http_sse_text(url: str, body, timeout: float = 600):
    """Stream an OpenAI chat completion: (joined deltas, s to the first
    delta, s to the end, events) on the client's clock."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
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


def phase_node(card: str) -> dict:
    """Phase 8: serve-cuda's path in this process (see the module
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
    card, _ = phase_device_and_build()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    errs, timings = phase_ragged_vs_plain(flush)
    int8_errs, int8_timings = phase_ragged_vs_plain(flush, int8=True)
    flash_errs, flash_timings = phase_flash_vs_plain(flush)
    del flush
    phase_forward_parity()
    gemma_counts = phase_gemma_forward()
    counts, bf16_pool, params = phase_slice()
    int8_counts, int8_pool, _ = phase_slice("int8", params=params)
    ratio = int8_pool / bf16_pool
    log(f"pool bytes: int8 {int8_pool} B vs bf16 {bf16_pool} B -> {ratio:.4f}x "
        f"(scales included)")
    check(ratio <= 0.502, f"int8 pool is {ratio:.4f}x the bf16 pool's bytes")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    node_counts = phase_node(card)

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
        # T=S=2048; bound: three TF32 products at the TF32 peak
        row("ragged_prefill_attention_f32", prefill_src, "bee2bee_tpu/ops/ragged.py:84",
            counts["ragged_prefill_f32"], errs["tile_f32"], timings["prefill_f32"]),
        row("ragged_prefill_attention_f32_int8", prefill_src,
            "bee2bee_tpu/ops/ragged.py:107", int8_counts["ragged_prefill_f32_int8"],
            int8_errs["tile_f32"], int8_timings["prefill_f32"]),
        row("flash_attention_tile_f32", flash_src, "bee2bee_tpu/ops/flash.py:46",
            counts["flash_tile_f32"] + int8_counts["flash_tile_f32"],
            flash_errs["tile_f32"], flash_timings["tile_f32"]),
    ]
    log("kernels: the flash kernels have 0 launches on the main path: no "
        "serving path calls flash_attention (the engines attend through the "
        "ragged op); the ragged row kernel and the f32 tile forms have 0 there "
        "too: the slice serves bf16 at head_dim 128, the f32 tile forms take f32 "
        "queries (phase 5 runs them at head_dim 128) and the row kernel the "
        "shorter f32 chunks; the head_dim-256 forms' launches are those of "
        "phase 5's gemma-geometry forward. All are held against the plain "
        "version and timed above; the row kernels' times are forced at "
        "gemma-2-9b's heads")
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
