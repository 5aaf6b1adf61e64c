#!/usr/bin/env python3
"""Probes of the port's mixture of experts on one CUDA card. Run from the
root of a checkout:

  python3 moe_probe.py                       # the forwards over an int8 pool
  python3 moe_probe.py --kernel [PARENT_DIR]  # the expert GEMM, its parts, A/B

``--kernel``: the grouped expert GEMM's bf16-x forms (bf16 and int8
experts) at the smoke's shapes (``chip_smoke.MOE_SHAPES``, 8, 40 and 2,048
tokens, the smoke's inputs), both launches of a layer timed (median of 30,
L2 flushed) and each launch apart, beside the bound and
``torch._grouped_mm``; then the same cases through builds of the kernel
that leave a part out (``MOE_PROBE_PART``: 1 no x tiles, 2 no products, 3
no int8 conversion, 4 every item on expert 0's L2-warm weights, 5 no
output stores), which time the parts apart; and, with PARENT_DIR (a
checkout of an earlier commit, e.g. unpacked by ``git archive``), its
``csrc/moe_expert_gemm.cu`` built and timed on the same inputs in turns
(parent, change, change, parent) over a plan of its own tile heights (at
most 64 rows); then the served presets at full width and depth
(qwen3-30b-a3b in bf16, mixtral-8x7b with int8 weights, random from the
smoke's seeds) run a 2,048-token prefill chunk and an eager B=8 decode
step at context 1,024 with the expert product through the change's kernel
and through the parent's, in turns: device busy and the expert GEMM's
share under torch.profiler. ``MOE_PROBE_ONLY=<preset>`` runs one preset.

Without ``--kernel``: the 2-layer f32 forward of each MoE preset at full width
(``chip_smoke.phase_moe_forward``'s model, prompt and 8 greedy steps) over
an f32 and an int8 pool, with the attention and the expert product each
through its kernel or its plain version, all four ways, against the
all-plain forward: the logits' max abs error and whether the greedy tokens
equal. The smoke holds qwen3-30b-a3b's int8-pool forwards per call because
of what this shows (``chip_smoke.MOE_INT8_POOL_PER_CALL``).

Prints the card's name and power limit; exits non-zero without a card.
"""

from __future__ import annotations

import gc
import os
import sys
from dataclasses import replace
from pathlib import Path

import torch


def int8_pool(cs, card: str) -> None:
    from bee2bee_tpu_torch.models.config import get_config
    from bee2bee_tpu_torch.ops.ragged import ragged_paged_attention, ragged_paged_attention_ref

    for name, perturb in (("qwen3-30b-a3b", cs.perturb_qwen), ("mixtral-8x7b", cs.perturb_norms)):
        cfg = replace(get_config(name), n_layers=2, name=f"{name}-2layers")
        cfg, params, run = cs.forward_setup(cfg, cs.MOE_PROMPT)
        perturb(params, cs.SEED + 7)
        for pool in (torch.float32, torch.int8):
            res = {}
            for attn, experts in (("plain", "plain"), ("kernel", "kernel"), ("plain", "kernel"),
                                  ("kernel", "plain")):
                fn = ragged_paged_attention if attn == "kernel" else ragged_paged_attention_ref
                if experts == "plain":
                    with cs.plain_experts():
                        res[(attn, experts)] = run(fn, pool)
                else:
                    res[(attn, experts)] = run(fn, pool)
            torch.cuda.synchronize()
            ref_logits, ref_steps, ref_toks = res[("plain", "plain")]
            for (attn, experts), (logits, steps, toks) in res.items():
                err = max((logits - ref_logits).abs().max().item(),
                          (steps - ref_steps).abs().max().item())
                cs.log(f"moe int8-pool {name} f32 over {str(pool)[6:]} pool: attention {attn}, "
                       f"experts {experts}: logits max abs err vs all-plain {err:.3e}, max "
                       f"|logit| {ref_logits.abs().max().item():.3f}, greedy tokens equal "
                       f"{toks == ref_toks}; card {card}")
        del params, run
        torch.cuda.empty_cache()


def build_variants(parent: Path | None) -> dict:
    """nvcc, all at once, into build/moe_probe/: the kernel with each
    MOE_PROBE_PART, and the parent's source. {name: ctypes function}."""
    import ctypes
    import subprocess

    from bee2bee_tpu_torch.ops import _build, moe

    out_dir = _build.BUILD_DIR.parent / "moe_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {f"part{n}": (_build.CSRC / "moe_expert_gemm.cu", [f"-DMOE_PROBE_PART={n}"])
            for n in PARTS}
    if parent is not None:
        jobs["parent"] = (parent / "bee2bee_tpu_torch" / "csrc" / "moe_expert_gemm.cu", [])
    procs = {name: subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o",
                                     str(out_dir / f"{name}.so"), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, (src, flags) in jobs.items()}
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        fn = fns[name] = ctypes.CDLL(str(out_dir / f"{name}.so")).b2b_moe_expert_gemm
        fn.restype = i
        fn.argtypes = ([p, p, i, i, i] + [p, p, p, i] * 2 + [p, p, p, i, i, i, i, p]
                       if name == "parent" else moe._kernel_fn().argtypes)
    return fns


def parent_call(fn, x, tok, plan, ws) -> list:
    """One launch of the parent's kernel (its C entry: no partials, no tile
    count, no splits) over ``plan``: the outputs [rows, N] per weight."""
    rows, K = plan.tok.shape[0], x.shape[1]
    ys, flat = [], []
    for w in ws:
        q, s = (w["q"], w["s"]) if isinstance(w, dict) else (w, None)
        y = torch.empty((rows, q.shape[2]), dtype=x.dtype, device=x.device)
        ys.append(y)
        flat += [q.data_ptr(), None if s is None else s.data_ptr(), y.data_ptr(), q.shape[2]]
    flat += [None, None, None, 0] * (2 - len(ws))
    err = fn(x.data_ptr(), None if tok is None else tok.data_ptr(), 1,
             int(isinstance(ws[0], dict)), len(ws), *flat, plan.offsets.data_ptr(),
             plan.tile_expert.data_ptr(), plan.tile_row.data_ptr(), plan.n_tiles,
             plan.n_experts, K, plan.br, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent kernel: cuda error {err}")
    return ys


def kernel_probe(cs, card: str, parent: Path | None) -> dict:
    import contextlib
    import math

    import torch.nn.functional as F_

    from bee2bee_tpu_torch.ops import moe

    fns = build_variants(parent)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    only = os.environ.get("MOE_PROBE_ONLY")  # a preset's name: its cases alone

    @contextlib.contextmanager
    def variant(fn):
        kernel_fn = moe._kernel_fn
        moe._kernel_fn = lambda: fn
        try:
            yield
        finally:
            moe._kernel_fn = kernel_fn

    for model, D, F, E, k in cs.MOE_SHAPES:
        if only and only != model:
            continue
        for int8 in (False, True):
            form = cs.moe_form(torch.bfloat16, int8)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(cs.SEED + 31)
            router = torch.randn((D, E), generator=gen, device="cuda",
                                 dtype=torch.bfloat16).mul_(1.0 / math.sqrt(D))
            ws = [cs.moe_stack(gen, E, D, F, torch.bfloat16, int8) for _ in range(2)]
            down = cs.moe_stack(gen, E, F, D, torch.bfloat16, int8)
            for N in cs.MOE_TOKENS:
                x = torch.randn((N, D), generator=gen, device="cuda", dtype=torch.bfloat16)
                logits = (x @ router).float()
                plan = moe.moe_plan(logits, k)
                h = F_.silu(moe.moe_expert_matmul(x, plan.tok, plan, ws)[1]).contiguous()
                nbytes, flops = cs.moe_layer_bytes_flops(plan, D, F, ws, down, x)
                bnd = cs.bounds(nbytes, flops, torch.bfloat16)

                def both():
                    moe.moe_expert_matmul(x, plan.tok, plan, ws)
                    moe.moe_expert_matmul(h, None, plan, [down])

                label = f"{model} {form} N={N}"
                times = {"change": [cs.cuda_time_ms(both, flush=flush)]}
                up = cs.cuda_time_ms(lambda: moe.moe_expert_matmul(x, plan.tok, plan, ws),
                                     flush=flush)
                dn = cs.cuda_time_ms(lambda: moe.moe_expert_matmul(h, None, plan, [down]),
                                     flush=flush)
                parts = {}
                for n in PARTS:
                    if n == 3 and not int8:
                        continue
                    with variant(fns[f"part{n}"]):
                        parts[n] = cs.cuda_time_ms(both, flush=flush)
                text = ""
                if "parent" in fns:
                    old = moe.moe_plan(logits, k, br=moe.tile_rows(plan.tok.shape[0], E,
                                                                   torch.float32))
                    fn = fns["parent"]

                    def parent_both():
                        parent_call(fn, x, old.tok, old, ws)
                        parent_call(fn, h, None, old, [down])

                    times["parent"] = [cs.cuda_time_ms(parent_both, flush=flush)]
                    times["change"].append(cs.cuda_time_ms(both, flush=flush))
                    times["parent"].append(cs.cuda_time_ms(parent_both, flush=flush))
                    text = (f"; parent (tiles of {old.br}) {times['parent'][0]:.4f}, "
                            f"{times['parent'][1]:.4f} ms")
                lib = cs.grouped_mm_ms(x, plan, ws, down, h, flush)[1] if not int8 else "n/a"
                cs.log(f"moe kernel {label}: tiles of {plan.br}, routes "
                       f"{sorted(moe.moe_expert_matmul.routes)}; change "
                       f"{', '.join(f'{t:.4f}' for t in times['change'])} ms (w_up|w_gate "
                       f"{up:.4f}, w_down {dn:.4f}), {bnd['text']} -> "
                       f"{bnd['bound_ms'] / times['change'][0]:.3f} of bound{text}; parts left "
                       f"out: {', '.join(f'{PARTS[n]} {t:.4f}' for n, t in parts.items())} ms; "
                       f"torch._grouped_mm {lib}; card {card}")
                moe.moe_expert_matmul.routes.clear()
            del ws, down
            torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return fns


def served_ab(cs, card: str, fn) -> None:
    """The served presets' prefill chunk and decode step with the expert
    product through the change's kernel and the parent's (``fn``), in
    turns (change, parent, change, parent), one engine each."""
    import contextlib

    from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
    from bee2bee_tpu_torch.models import core
    from bee2bee_tpu_torch.models.config import get_config
    from bee2bee_tpu_torch.models.params import init_params
    from bee2bee_tpu_torch.ops import moe

    @contextlib.contextmanager
    def parent_kernel():
        kernel, heights = core.moe_expert_matmul, moe.TILE_ROWS
        core.moe_expert_matmul = lambda x, tok, plan, ws: parent_call(fn, x, tok, plan, ws)
        moe.TILE_ROWS = moe.TILE_ROWS_F32  # the parent's heights
        try:
            yield
        finally:
            core.moe_expert_matmul, moe.TILE_ROWS = kernel, heights

    B, ctx, T, BS = 8, 1024, 2048, 16
    only = os.environ.get("MOE_PROBE_ONLY")
    for name, quantize in (("qwen3-30b-a3b", "none"), ("mixtral-8x7b", "int8")):
        if only and only != name:
            continue
        cfg = get_config(name)
        if quantize == "int8":
            gen = torch.Generator(device="cuda")
            gen.manual_seed(cs.SEED + 1)
            params = init_params(cfg, gen, "cuda", torch.bfloat16, quantize=True)
        else:
            params = cs.family_params(cfg, torch.bfloat16, cs.SEED)
        engine = InferenceEngine(cfg, params=params, engine_config=EngineConfig(
            max_seq_len=4096, max_batch=B, kv_block_size=BS, decode_chunk=32,
            rng_seed=cs.SEED, dtype="bfloat16", cache_dtype="bfloat16", quantize=quantize))
        nblocks = -(-max(ctx + 1, T) // BS)
        pool = core.init_paged_pool(cfg, 1 + B * nblocks, BS, engine.cache_dtype, "cuda")
        tables = (1 + torch.arange(B * nblocks, dtype=torch.int32, device="cuda")
                  ).reshape(B, nblocks)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cs.SEED)
        tok = torch.randint(3, 259, (B, 1), generator=gen, device="cuda")
        off = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
        ids = torch.randint(3, 259, (1, T), generator=gen, device="cuda")
        last = torch.tensor([T - 1], device="cuda")
        runs = {"prefill chunk T=2048": (
                    lambda: engine.forward(ids, pool, 0, tables[:1], logits_index=last), 2),
                "eager decode step B=8 ctx=1024": (
                    lambda: engine.forward(tok, pool, off, tables), 5)}
        for label, (run, calls) in runs.items():
            res = {"change": [], "parent": []}
            for who in ("change", "parent", "change", "parent"):
                with parent_kernel() if who == "parent" else contextlib.nullcontext():
                    busy, _, _, _, moe_ms = cs.device_profile(run, calls, cfg.n_layers * calls)
                res[who].append((busy, moe_ms))
            cs.log(f"moe served {name} ({quantize} weights) {label}: device busy ms (expert "
                   f"GEMM kernels ms) change "
                   f"{[(round(b, 3), round(m, 3)) for b, m in res['change']]}, parent "
                   f"{[(round(b, 3), round(m, 3)) for b, m in res['parent']]}; card {card}")
        engine.close()
        del engine, params, pool, runs, run
        gc.collect()
        torch.cuda.empty_cache()


# the kernel's parts a MOE_PROBE_PART build leaves out
PARTS = {1: "x rows", 2: "products", 3: "int8 conversion", 4: "expert weights (expert 0's)",
         5: "output stores"}


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_probe: no CUDA device available", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    import chip_smoke as cs

    if len(sys.argv) > 1 and sys.argv[1] == "--kernel":
        from bee2bee_tpu_torch.ops import _build

        name = torch.cuda.get_device_name(0)
        card = cs.subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
        cs.log(f"device: {name}; {card}")
        parent = Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else None
        # the served A/B runs whole models: every kernel then
        _build.build(_build.SOURCES if parent is not None else ("moe_expert_gemm.cu",))
        fns = kernel_probe(cs, card, parent)
        if parent is not None:
            served_ab(cs, card, fns["parent"])
    else:
        card, _ = cs.phase_device_and_build()
        int8_pool(cs, card)
    cs.log(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
