#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bee2bee_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its numbers on lines of their own; any failure raises
and the script exits non-zero):

1. Device and build: the card's name and power limit, then the CUDA
   kernels built from csrc/ with nvcc (all sources at once).
2. Kernel vs plain version at llama-3-8b's attention shapes (H=32,
   Hkv=8, hd=128, block size 16) in bf16: ragged decode offsets across
   block boundaries, a dead row, null table tails, prefill chunks, a
   verify chunk, and window + softcap + score scale. Tolerance: max abs
   error <= 2e-2 against the plain version run in f32 on the same bf16
   inputs (bf16 output rounding is ~4e-3 at these magnitudes). Then the
   kernel's time at a decode step over a 1024-token context and at a
   512-token prefill chunk, beside the plain version, SDPA over the
   gathered view (the library yardstick, never used by the port) and the
   bound.
3. A whole forward at llama-3-8b width, 2 layers, f32: a 300-token
   prefill and 8 greedy decode steps through the kernel and through the
   plain version (asked for explicitly, here only). Logits agree within
   2e-3 and the greedy tokens are equal.
4. The slice: CUDAService("llama-3-8b"), 32 layers, bf16, random init
   from a seed, answers 8 concurrent execute calls and one
   execute_stream; the kernel's launch count over that run must equal
   n_layers x the engine's forward calls.
5. The kernel table as one JSON line, then the result line.

Exits non-zero, printing no result, when no CUDA card is present or
when the package is not beside this script.
"""

from __future__ import annotations

import json
import math
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
KERNEL_TOL = 2e-2
FORWARD_TOL = 2e-3
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_time_ms(fn, reps: int = 30, flush: torch.Tensor | None = None) -> float:
    """Median of ``reps`` single-launch CUDA-event timings, after a warm-up;
    ``flush`` (a buffer larger than L2) is rewritten before each launch so
    every launch reads its inputs from device memory, as a layer of a real
    forward does."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
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
    return card, build_s


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


def attention_work(offs, T, H, Hkv, hd, BS, window, elem_bytes, MB):
    """(bytes, flops) the function needs on these inputs: q read once, the
    visible K/V pages of every (row, kv head) read once, the output
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
    kv = 2 * pages * Hkv * BS * hd * elem_bytes
    tables = B * MB * 4 + B * 4
    return qo + kv + tables, 4 * hd * pairs * H


def phase_kernel_vs_plain(flush):
    from bee2bee_tpu_torch.ops.ragged import (
        ragged_paged_attention, ragged_paged_attention_ref,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    H, Hkv, hd, BS = 32, 8, 128, 16
    cases = [
        ("decode ragged + dead row", dict(
            offs=[0, 15, 16, 17, 500, 1023, 2047, 300], T=1, dead=(7,)), {}),
        ("decode pow2 null tails", dict(
            offs=[3, 40, 100, 255], T=1, extra_tables=9), {}),
        ("prefill T=512 @0", dict(offs=[0], T=512), {}),
        ("prefill T=512 @1000", dict(offs=[1000], T=512), {}),
        ("verify T=5", dict(offs=[10, 31, 64, 700], T=5), {}),
        ("window+softcap+scale", dict(offs=[5, 70, 129, 1000], T=5), dict(
            window=64, logit_softcap=50.0, sm_scale=1.0 / math.sqrt(256))),
    ]
    max_err = 0.0
    for label, geo, kw in cases:
        q, kp, vp, tb, off = make_case(gen, **geo)
        got = ragged_paged_attention(q, kp, vp, tb, off, **kw)
        torch.cuda.synchronize()
        want = ragged_paged_attention_ref(
            q.float(), kp.float(), vp.float(), tb, off, **kw
        )
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
        err = (got.float() - want).abs().max().item()
        log(f"kernel vs plain: {label}: max abs err {err:.3e} (tol {KERNEL_TOL})")
        check(err <= KERNEL_TOL, f"{label}: max abs err {err} > {KERNEL_TOL}")
        max_err = max(max_err, err)
    # the f32 instantiation the phase-3 forward runs
    q, kp, vp, tb, off = make_case(gen, offs=[7, 300, 1023], T=3, dtype=torch.float32)
    err32 = (ragged_paged_attention(q, kp, vp, tb, off)
             - ragged_paged_attention_ref(q, kp, vp, tb, off)).abs().max().item()
    log(f"kernel vs plain: f32 verify T=3: max abs err {err32:.3e} (tol 1e-4)")
    check(err32 <= 1e-4, f"f32 kernel: max abs err {err32}")

    timings = {}
    for label, offs, T in (("decode", [1023] * 8, 1), ("prefill", [1000], 512)):
        q, kp, vp, tb, off = make_case(gen, offs=offs, T=T)
        MB = tb.shape[1]
        ms = cuda_time_ms(lambda: ragged_paged_attention(q, kp, vp, tb, off),
                          flush=flush)
        plain_ms = cuda_time_ms(
            lambda: ragged_paged_attention_ref(q, kp, vp, tb, off), flush=flush
        )
        # library yardstick: SDPA over the pre-gathered view with an
        # explicit mask (the gather itself is not timed)
        B = len(offs)
        S = MB * BS
        G = H // Hkv

        def gathered(pool):  # [B, H, S, hd], kv heads repeated per group
            g = pool[:, tb.long()].reshape(Hkv, B, S, hd).transpose(0, 1)
            return g.repeat_interleave(G, dim=1).contiguous()

        kg, vg = gathered(kp), gathered(vp)
        qs = q.transpose(1, 2).contiguous()  # [B, H, T, hd]
        qpos = off.long()[:, None] + torch.arange(T, device="cuda")[None, :]
        mask = (torch.arange(S, device="cuda")[None, None, :] <= qpos[:, :, None])
        mask = mask[:, None]  # [B, 1, T, S]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = cuda_time_ms(
            lambda: sdpa(qs, kg, vg, attn_mask=mask), flush=flush
        )
        nbytes, flops = attention_work(offs, T, H, Hkv, hd, BS, 0, 2, MB)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        timings[label] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
            bound_by=bound_by, bytes=nbytes, flops=flops,
        )
        log(f"timing {label} B={B} T={T} ctx={offs[0] + T}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {nbytes} B -> {t_bytes:.4f} ms, "
            f"{flops} flop -> {t_ops:.4f} ms), share of bound "
            f"{bound_ms / ms:.3f}")
    return max(max_err, err32), timings


# ------------------------------------------------------------ phase 3


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

    def run(attn_fn):
        pool = core.init_paged_pool(cfg, nblocks + 1, BS, torch.float32, "cuda")
        logits, _ = core.forward(params, cfg, ids, pool, 0, tables, attn_fn=attn_fn)
        steps = [logits[:, -1]]
        toks = []
        for i in range(n_steps):
            tok = torch.argmax(steps[-1], dim=-1)
            toks.append(int(tok))
            lg, _ = core.forward(params, cfg, tok[:, None], pool, n_prompt + i,
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
    del params
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 4


def device_profile(fn, calls: int):
    """(device busy ms per call, [(kernel, share of device time)] top 4):
    the kernels' own device time under torch.profiler, summed."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(t for _, t in kernels)
    check(busy_us > 0, "the profiler saw no device time")
    top = sorted(kernels, key=lambda kt: -kt[1])[:4]
    return busy_us / 1e3 / calls, [(k[:48], round(t / busy_us, 3)) for k, t in top]


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

    for label, fn, calls in (("decode step B=8 ctx=1024", decode, steps),
                             (f"prefill chunk T={prefill}", prefill_chunk, 2)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
        busy_ms, top = device_profile(fn, calls)
        log(f"breakdown {label}: host wall {wall_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms, device idle share {1 - busy_ms / wall_ms:.3f}; "
            f"top kernels by device time {top}")
    weight_bytes = engine.info["n_params"] * engine.dtype.itemsize
    log(f"breakdown: weights {weight_bytes} B -> "
        f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms per step at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s")


def phase_slice():
    from bee2bee_tpu_torch.engine import EngineConfig
    from bee2bee_tpu_torch.ops.ragged import ragged_paged_attention
    from bee2bee_tpu_torch.services import CUDAService

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    svc = CUDAService(
        "llama-3-8b", max_new_tokens=64,
        engine_config=EngineConfig(
            max_seq_len=2048, max_batch=8, kv_block_size=16, decode_chunk=32,
            rng_seed=SEED,
        ),
    ).load_sync()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    engine = svc.engine
    cfg = engine.model_cfg
    log(f"slice: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"loaded (random init, seed {SEED}) in {load_s:.2f} s; "
        f"{engine.info['n_params']} params")
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

        ragged_paged_attention.launches = 0
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
        launches = ragged_paged_attention.launches
        forwards = engine.forward_calls
        for i, r in enumerate(results):
            check(r is not None and isinstance(r.get("text"), str),
                  f"request {i}: no result")
            check(r["tokens"] > 0, f"request {i}: no tokens")
            log(f"slice request {i}: prompt {len(prompts[i])} B / "
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
        log(f"slice stream: {len(lines)} lines, {lines[-1]['tokens']} tokens")
        log(f"slice: 8 concurrent requests, {new_tokens} tokens in {wall:.3f} s "
            f"-> {new_tokens / wall:.2f} tok/s aggregate incl. prefill, "
            f"{new_tokens - len(results)} decode tokens in {decode_s:.3f} s after "
            f"the last first token -> {(new_tokens - len(results)) / decode_s:.2f} "
            f"decode tok/s; peak memory {torch.cuda.max_memory_allocated()} B")
        log(f"slice: kernel launches {launches}, forward calls {forwards}, "
            f"n_layers {cfg.n_layers}")
        check(launches > 0, "the main path never launched the kernel")
        check(launches == cfg.n_layers * forwards,
              f"launches {launches} != {cfg.n_layers} x {forwards} forwards")
        step_breakdown(engine)
        return launches
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
    max_err, timings = phase_kernel_vs_plain(flush)
    del flush
    phase_forward_parity()
    launches = phase_slice()
    dec = timings["decode"]
    kernels = [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "bee2bee_tpu_torch/csrc/ragged_attention.cu",
        "replaces": "bee2bee_tpu/ops/ragged.py:84",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": dec["ms"],
        "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
    }]
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
