#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bee2bee_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its numbers on lines of their own; any failure raises
and the script exits non-zero):

1. Device and build: the card's name and power limit, then the CUDA
   kernels built from csrc/ with nvcc (one process per source, all at
   once).
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
   block sizes 8 and 32 (the tile kernel); then f32 decode and an f32
   verify chunk (the row kernel). Each case checks that exactly the
   kernel the dispatch rule names launched, once, and each decode case
   that a second call gives the same bytes. Tolerance: max abs
   error <= 2e-2 against the plain version run in f32 on the same bf16
   inputs (bf16 output rounding is ~4e-3 at these magnitudes; the decode
   and tile kernels also round P to bf16, as the JAX kernel does), 1e-4
   in f32. Then times, each beside the plain version, SDPA over the
   gathered view (the library yardstick, never used by the port) and the
   bound: the decode kernel at B=8 over a 1024-token context and at B=1
   over 2048 (with its split plan), the row and the tile kernel forced at
   the same decode inputs, the row kernel in f32 at the B=8 decode shape,
   and the tile kernel at a 512-token prefill chunk at offset 1000; the
   crossover of the row and tile kernels over T; then the decode sweep,
   32 launches back to back over a 32-layer copy of the pool, in ms per
   launch.
3. The same cases for the int8-pool form: random int8 pages, random
   per-(kv head, block) scales, and a null block of +-127 under a scale
   of 1e3 that no reader may touch. Tolerance 2e-2 in bf16 and 1e-4 in
   f32 against the plain version on the same inputs. Times as in phase
   2, SDPA over the host-dequantized gathered view, the bound in int8
   bytes plus the scales.
4. Flash attention vs plain version (contiguous K/V, llama-3-8b heads):
   causal T=S=2048, decode B=8 T=1 S=2048 with ragged offsets and one
   empty row (offset -1), T=512 at offset 1000 over S=2048, non-causal
   T=S=256 in bf16 (the tile kernel), and an f32 case (the row kernel).
   Tolerance 2e-2 / 1e-4. Time of the causal T=2048 case through each
   kernel (bf16 for the tile kernel, f32 for the row kernel) beside the
   plain version, SDPA(is_causal=True) and the bound. No serving path
   calls this op.
5. A whole forward at llama-3-8b width, 2 layers: a 300-token prefill and
   8 greedy decode steps through the kernels and through the plain
   version (asked for explicitly, here only), in f32 over an f32 pool and
   over an int8 pool (the row kernel; logits within 2e-3, greedy tokens
   equal; the int8-vs-f32 pool logit gap printed for information), then
   in bf16 over a bf16 pool and an int8 pool, whose 300-token prefill
   goes through the tile kernel and whose 8 decode steps go through the
   decode kernel: logits within the gap between the plain bf16 and the
   plain f32 forward (the kernels may not add more error than bf16 itself
   carries).
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
8. The kernel table as one JSON line, then the result line.

Exits non-zero, printing no result, when no CUDA card is present or
when the package is not beside this script.
"""

from __future__ import annotations

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
KERNEL_TOL = 2e-2
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
        if source == "ragged_decode_attention.cu":
            for name, line in ptxas_entries(report):
                log(f"build: {source}: {name}: {line}")
    return card, build_s


def ptxas_entries(report: str):
    """(kernel, "registers; spills") for each entry function of a ptxas -v
    report, the kernel named by its mangled name's tail."""
    entries, name, spill = [], None, ""
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            base = re.search(r"\d+(ragged_decode_\w+?)I", mangled)
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


def time_ragged(label, q, kp, vp, tb, off, offs, T, flush, scales=None):
    """The kernel's time beside the plain version's, SDPA's over the
    gathered (for an int8 pool: dequantized) view and the bound (at the
    peak rate of q's type)."""
    from bee2bee_tpu_torch.ops.ragged import (
        ragged_paged_attention, ragged_paged_attention_ref, ragged_kernel,
    )

    H, hd = q.shape[2], q.shape[3]
    Hkv, _, BS, _ = kp.shape
    MB = tb.shape[1]
    kw = {} if scales is None else dict(k_scale=scales[0], v_scale=scales[1])
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
    mask = (torch.arange(S, device="cuda")[None, None, :] <= qpos[:, :, None])
    mask = mask[:, None]  # [B, 1, T, S]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_time_ms(
        lambda: sdpa(qs, kg, vg, attn_mask=mask), flush=flush
    )
    kv_bytes = kp.element_size()
    nbytes, flops = attention_work(offs, T, H, Hkv, hd, BS, 0, q.element_size(), MB,
                                   kv_bytes=kv_bytes,
                                   scale_bytes=0 if scales is None else 4)
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else F32_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    plan = (f", plan {split_plan(q, kp, tb)}"
            if ragged_kernel(q.dtype, T, hd) == "decode" else "")
    log(f"timing {label} B={B} T={T} ctx={offs[0] + T} ({q.dtype}{plan}): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {nbytes} B -> {t_bytes:.4f} ms, "
        f"{flops} flop at {peak / 1e12:.0f} TFLOP/s -> {t_ops:.4f} ms), share of "
        f"bound {bound_ms / ms:.3f}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)


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


# read_counts()'s name of each ragged kernel's bf16-pool counter
RAGGED_COUNTERS = {"row": "ragged", "tile": "ragged_prefill", "decode": "ragged_decode"}


def ragged_counter(q, int8: bool) -> str:
    """The launch counter the dispatch rule names for these queries."""
    from bee2bee_tpu_torch.ops.ragged import ragged_kernel

    kernel = ragged_kernel(q.dtype, q.shape[1], q.shape[3])
    return RAGGED_COUNTERS[kernel] + ("_int8" if int8 else "")


def check_one_launch(label: str, counter: str) -> None:
    counts = read_counts()
    check(counts[counter] == 1 and sum(counts.values()) == 1,
          f"{label}: expected one {counter} launch, counted {counts}")


def time_crossover(label, gen, flush, int8):
    """Both ragged kernels forced at the same inputs, over T: where the
    tile kernel starts to win (the dispatch's T_MIN), and the row kernel
    at the timed prefill chunk."""
    from bee2bee_tpu_torch.ops.ragged import _launch_kernel, row_offsets

    for B, off0, Ts in ((8, 1000, (1, 2, 4, 8, 16, 32)), (1, 48, (2, 8, 16)),
                        (1, 1000, (512,))):
        for T in Ts:
            q, kp, vp, tb, off = make_case(gen, offs=[off0] * B, T=T)
            scales = (None, None)
            if int8:
                kp, vp, *scales = int8_pools(gen, kp.shape[1])
            rows = row_offsets(off, B, q.device)

            def run(kernel):
                return _launch_kernel(q, kp, vp, tb, rows, 0, 1.0 / math.sqrt(128),
                                      0.0, *scales, kernel=kernel)

            row_ms = cuda_time_ms(lambda: run("row"), flush=flush)
            tile_ms = cuda_time_ms(lambda: run("tile"), flush=flush)
            log(f"crossover {label} B={B} T={T} ctx={off0 + T}: row kernel "
                f"{row_ms:.4f} ms, tile kernel {tile_ms:.4f} ms")


def time_forced(label, q, kp, vp, tb, off, flush, scales=None):
    """The three ragged kernels forced at the same decode inputs: the
    decode kernel beside the row kernel and the tile kernel at T=1."""
    from bee2bee_tpu_torch.ops.ragged import _launch_kernel, row_offsets

    rows = row_offsets(off, q.shape[0], q.device)
    sc = (None, None) if scales is None else scales
    ms = {k: cuda_time_ms(lambda: _launch_kernel(
        q, kp, vp, tb, rows, 0, 1.0 / math.sqrt(q.shape[3]), 0.0, *sc, kernel=k),
        flush=flush) for k in ("decode", "tile", "row")}
    log(f"forced {label} B={q.shape[0]} T=1 (plan {split_plan(q, kp, tb)}): decode "
        f"kernel {ms['decode']:.4f} ms, tile kernel {ms['tile']:.4f} ms, row kernel "
        f"{ms['row']:.4f} ms")
    return ms


def phase_ragged_vs_plain(flush, int8=False):
    """Phase 2 (bf16 pool and the f32 form) or phase 3 (int8 pool): each
    case through the dispatching wrapper against the plain version, the
    kernel the rule names launched once; then the timings. Returns (max
    abs error per kernel, timings)."""
    from bee2bee_tpu_torch.ops.ragged import (
        ragged_paged_attention, ragged_paged_attention_ref,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + int8)
    tag = "int8 kernel vs plain" if int8 else "kernel vs plain"
    errs = {"row": 0.0, "tile": 0.0, "decode": 0.0}
    # the f32 instantiations the phase-5 forward runs (the row kernel)
    f32_cases = [
        ("f32 decode", dict(offs=[0, 17, 300, 1023], T=1, dead=(2,),
                            dtype=torch.float32), {}),
        ("f32 verify T=3", dict(offs=[7, 300, 1023], T=3, dtype=torch.float32), {}),
    ]
    for label, geo, kw in RAGGED_CASES + f32_cases:
        q, kp, vp, tb, off = make_case(gen, **geo)
        if int8:
            kp, vp, ks, vs = int8_pools(gen, kp.shape[1], BS=kp.shape[2],
                                        hd=kp.shape[3])
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
        tol = KERNEL_TOL if q.dtype == torch.bfloat16 else 1e-4
        check(bool(torch.isfinite(got).all()), f"{tag}: {label}: non-finite output")
        err = (got.float() - want).abs().max().item()
        log(f"{tag}: {label} ({q.dtype}, {counter} kernel): max abs err "
            f"{err:.3e} (tol {tol})")
        check(err <= tol, f"{tag}: {label}: max abs err {err} > {tol}")
        if counter.startswith("ragged_decode"):
            # the split-K merge runs in a fixed order: a second call repeats
            # the first bit for bit
            again = ragged_paged_attention(q, kp, vp, tb, off, **kw)
            check(torch.equal(got, again), f"{tag}: {label}: a second call differs")
        kernel = next(k for k, c in RAGGED_COUNTERS.items()
                      if counter in (c, c + "_int8"))
        errs[kernel] = max(errs[kernel], err)

    timings = {}
    label0 = "int8 " if int8 else ""
    for label, offs, T, dtype in (
            ("decode", [1023] * 8, 1, torch.bfloat16),
            ("decode_b1", [2047], 1, torch.bfloat16),
            ("row_f32", [1023] * 8, 1, torch.float32),
            ("prefill", [1000], 512, torch.bfloat16)):
        q, kp, vp, tb, off = make_case(gen, offs=offs, T=T, dtype=dtype)
        scales = None
        if int8:
            kp, vp, *scales = int8_pools(gen, kp.shape[1])
        timings[label] = time_ragged(f"{label0}{label} ({ragged_counter(q, int8)} "
                                     f"kernel)", q, kp, vp, tb, off, offs, T, flush,
                                     scales=scales)
        if label.startswith("decode"):
            timings[label]["forced"] = time_forced(f"{label0}{label}", q, kp, vp, tb,
                                                   off, flush, scales=scales)
        if label == "decode":
            time_decode_sweep(f"{label0}{label}", q, kp, vp, tb, off, scales=scales)
    time_crossover(f"{label0}pool".strip(), gen, flush, int8)
    return errs, timings


# ------------------------------------------------------------ phase 4


def time_flash(label, q, k, v, flush):
    """Causal flash attention's time beside the plain version's,
    SDPA(is_causal)'s and the bound, at q's type."""
    from bee2bee_tpu_torch.ops.flash import flash_attention, flash_attention_ref

    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    ms = cuda_time_ms(lambda: flash_attention(q, k, v), flush=flush)
    plain_ms = cuda_time_ms(lambda: flash_attention_ref(q, k, v), flush=flush)
    qs = q.transpose(1, 2).contiguous()  # [B, H, T, hd]
    ks = k.transpose(1, 2).repeat_interleave(H // Hkv, dim=1).contiguous()
    vs = v.transpose(1, 2).repeat_interleave(H // Hkv, dim=1).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_time_ms(lambda: sdpa(qs, ks, vs, is_causal=True), flush=flush)
    # q, k, v read once, the output written once; 4*hd flops per visible
    # (query, key) pair of each head, at the peak rate of q's type
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * hd * H * B * (T * (T + 1) // 2)
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else F32_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"timing flash {label} causal B={B} T=S={T} ({q.dtype}): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa(is_causal) {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {nbytes} B -> {t_bytes:.4f} ms, "
        f"{flops} flop at {peak / 1e12:.0f} TFLOP/s -> {t_ops:.4f} ms), share of "
        f"bound {bound_ms / ms:.3f}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_flash_vs_plain(flush):
    from bee2bee_tpu_torch.ops.flash import (
        flash_attention, flash_attention_ref, use_tile_kernel,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    H, Hkv, hd = 32, 8, 128

    def qkv(B, T, S, dtype=torch.bfloat16):
        return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                     for shape in ((B, T, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))

    def offsets(offs):
        return torch.tensor(offs, dtype=torch.int32, device="cuda")

    cases = [
        ("causal T=S=2048", qkv(1, 2048, 2048), dict(offset=None)),
        ("decode B=8 T=1 S=2048 ragged + empty row", qkv(8, 1, 2048), dict(
            offset=offsets([0, 1, 31, 32, 700, 1500, 2047, -1]))),
        ("T=512 @1000 S=2048", qkv(1, 512, 2048), dict(offset=1000)),
        ("non-causal T=S=256", qkv(2, 256, 256), dict(causal=False)),
        ("f32 T=64 S=256 @[10,150]", qkv(2, 64, 256, torch.float32), dict(
            offset=offsets([10, 150]))),
    ]
    errs = {"row": 0.0, "tile": 0.0}
    for label, (q, k, v), kw in cases:
        counter = "flash_tile" if use_tile_kernel(q.dtype, hd) else "flash"
        reset_counts()
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        check_one_launch(f"flash {label}", counter)
        want = flash_attention_ref(q, k, v, **kw)
        tol = KERNEL_TOL if q.dtype == torch.bfloat16 else 1e-4
        check(bool(torch.isfinite(got).all()), f"flash {label}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        log(f"flash vs plain: {label} ({q.dtype}, {counter} kernel): max abs err "
            f"{err:.3e} (tol {tol})")
        check(err <= tol, f"flash {label}: max abs err {err} > {tol}")
        if "empty row" in label:
            check(not bool(got[7].any()), "flash: the empty row is not 0")
        kernel = "tile" if counter == "flash_tile" else "row"
        errs[kernel] = max(errs[kernel], err)

    q, k, v = cases[0][1]
    timings = {"tile": time_flash("tile kernel", q, k, v, flush)}
    q, k, v = (t.float() for t in (q, k, v))
    timings["row"] = time_flash("row kernel", q, k, v, flush)
    return errs, timings


# ------------------------------------------------------------ phase 5


def phase_forward_parity():
    from bee2bee_tpu_torch.models import core
    from bee2bee_tpu_torch.models.config import get_config
    from bee2bee_tpu_torch.models.params import init_params
    from bee2bee_tpu_torch.ops.ragged import (
        ragged_paged_attention, ragged_paged_attention_ref,
    )

    cfg = replace(get_config("llama-3-8b"), n_layers=2)
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

    k_logits, k_steps, k_toks = run(ragged_paged_attention)
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
    q_logits, q_steps, q_toks = run(ragged_paged_attention, torch.int8)
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


# the port's attention kernels by (part of) name: the three ragged kernels
# (the decode kernel's split walk and merge) and both flash kernels
ATTENTION_KERNELS = ("attention_kernel", "ragged_prefill_kernel", "ragged_decode_",
                     "flash_tile_kernel")


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
                 "int8_prefill_launches", "decode_launches", "int8_decode_launches"):
        setattr(ragged_paged_attention, name, 0)
    flash_attention.launches = 0
    flash_attention.tile_launches = 0


def read_counts() -> dict:
    from bee2bee_tpu_torch.ops.flash import flash_attention
    from bee2bee_tpu_torch.ops.ragged import ragged_paged_attention

    return {
        "ragged": ragged_paged_attention.launches,
        "ragged_int8": ragged_paged_attention.int8_launches,
        "ragged_prefill": ragged_paged_attention.prefill_launches,
        "ragged_prefill_int8": ragged_paged_attention.int8_prefill_launches,
        "ragged_decode": ragged_paged_attention.decode_launches,
        "ragged_decode_int8": ragged_paged_attention.int8_decode_launches,
        "flash": flash_attention.launches,
        "flash_tile": flash_attention.tile_launches,
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
    counts, bf16_pool, params = phase_slice()
    int8_counts, int8_pool, _ = phase_slice("int8", params=params)
    ratio = int8_pool / bf16_pool
    log(f"pool bytes: int8 {int8_pool} B vs bf16 {bf16_pool} B -> {ratio:.4f}x "
        f"(scales included)")
    check(ratio <= 0.502, f"int8 pool is {ratio:.4f}x the bf16 pool's bytes")
    del params
    torch.cuda.empty_cache()

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

    ragged_src = "bee2bee_tpu_torch/csrc/ragged_attention.cu"
    prefill_src = "bee2bee_tpu_torch/csrc/ragged_prefill_attention.cu"
    decode_src = "bee2bee_tpu_torch/csrc/ragged_decode_attention.cu"
    flash_src = "bee2bee_tpu_torch/csrc/flash_attention.cu"
    kernels = [
        row("ragged_decode_attention", decode_src, "bee2bee_tpu/ops/ragged.py:84",
            counts["ragged_decode"], errs["decode"], timings["decode"]),
        row("ragged_decode_attention_int8", decode_src,
            "bee2bee_tpu/ops/ragged.py:107", int8_counts["ragged_decode_int8"],
            int8_errs["decode"], int8_timings["decode"]),
        # the row kernel: f32 queries and head_dim 256, timed in f32 at the
        # decode shape
        row("ragged_paged_attention", ragged_src, "bee2bee_tpu/ops/ragged.py:84",
            counts["ragged"], errs["row"], timings["row_f32"]),
        row("ragged_paged_attention_int8", ragged_src,
            "bee2bee_tpu/ops/ragged.py:107", int8_counts["ragged_int8"],
            int8_errs["row"], int8_timings["row_f32"]),
        row("flash_attention", flash_src, "bee2bee_tpu/ops/flash.py:46",
            counts["flash"] + int8_counts["flash"], flash_errs["row"],
            flash_timings["row"]),
        row("ragged_prefill_attention", prefill_src, "bee2bee_tpu/ops/ragged.py:84",
            counts["ragged_prefill"], errs["tile"], timings["prefill"]),
        row("ragged_prefill_attention_int8", prefill_src,
            "bee2bee_tpu/ops/ragged.py:107", int8_counts["ragged_prefill_int8"],
            int8_errs["tile"], int8_timings["prefill"]),
        row("flash_attention_tile", flash_src, "bee2bee_tpu/ops/flash.py:46",
            counts["flash_tile"] + int8_counts["flash_tile"], flash_errs["tile"],
            flash_timings["tile"]),
    ]
    log("kernels: the flash kernels have 0 launches on the main path: no "
        "serving path calls flash_attention (the engines attend through the "
        "ragged op); the ragged row kernel has 0 there too: the slice serves "
        "bf16 at head_dim 128, and the row kernel takes f32 and head_dim 256 "
        "(phase 5 runs it in f32). All are held against the plain version and "
        "timed above")
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        # the run used one card
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": 1},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
