#!/usr/bin/env python3
"""Where the int8-weight GEMM's time goes, on one CUDA card, and how its
kernels compare with another tree's build of the same function.

Run from the root of a checkout:

  python3 int8_gemm_probe.py               # this tree's kernels alone
  python3 int8_gemm_probe.py --kernel DIR  # beside DIR's (a checkout of
                                           # another tree, e.g. the parent
                                           # unpacked under build/parent)
  python3 int8_gemm_probe.py --families DIR  # every served family

``--families DIR``: the decode kernel at every launch of every family
served with int8 weights (chip_smoke.GEMM_FAMILY_LAUNCHES) at M = 8 and
40, bf16, under the plan and every split count, L2 flushed by a read,
DIR's kernel in turns (DIR, this, this, DIR).

1. The kernels at llama-3-8b's launches (wq|wk|wv, wo, w_up|w_gate,
   w_down, and w_up and wk alone): the decode kernel at M in (1, 8, 40,
   64) in bf16 and (8, 40) in f32, the prefill kernel at M in (128, 600,
   2,048), each under ``gemm_plan``'s plan and under every other split
   count the kernel takes, L2 flushed two ways before each launch: by a
   write of 256 MB (the smoke's ``cuda_time_ms``: the reads then write
   back the dirty lines the flush left) and by a read of it (clean
   lines), medians of 20. With ``--kernel`` DIR's kernel runs the same
   inputs in turns (DIR, this, this, DIR), through DIR's own
   ``ops/int8_gemm.py`` wrapper and its own layout, built from DIR's
   ``csrc/int8_weight_gemm.cu`` into build/int8_gemm_probe/ (its wide
   chunks take whatever route DIR's wrapper names).
2. The host's time a call (a layer's 4 launches at M=8, queued 50 times
   back to back), then the replayed decode step's 128 projections: 32
   layers x the 4 launches (distinct random weights, 6.98 GB of int8),
   captured as one CUDA graph at M in (1, 8, 40) and replayed, beside the
   bytes bound; with ``--kernel`` DIR's in turns (DIR, this, this, DIR).
3. llama-3-8b with int8 weights at full depth (a random init, quantized
   on the card as it loads): a replayed B=8 decode step at context 1,024
   and a 2,048-token prefill chunk, device busy time and the GEMM kernels'
   share of it by torch.profiler kernel names (chip_smoke.step_breakdown).

The card's name and power limit come first. Exits non-zero without a CUDA
card.
"""

from __future__ import annotations

import ctypes
import importlib.util
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
# llama-3-8b's launches of one layer: (label, K, widths)
LAUNCHES = (("wq|wk|wv", 4096, (4096, 1024, 1024)), ("wo", 4096, (4096,)),
            ("w_up|w_gate", 4096, (14336, 14336)), ("w_down", 14336, (4096,)),
            ("w_up", 4096, (14336,)), ("wk", 4096, (1024,)))
STEP_LAUNCHES = LAUNCHES[:4]


def their_weight(other, q: torch.Tensor, s: torch.Tensor) -> dict:
    """An int8 weight as ``other``'s wrapper takes it: repacked where that
    tree has a ``pack_weight`` (an earlier layout under the key ``qp``),
    else the JAX layout."""
    if hasattr(other, "pack_weight"):
        return {"qp": other.pack_weight(q), "s": s}
    return {"q": q, "s": s}


def families(cs, G, other, card: str) -> None:
    """``--families``: every served family's launches beside ``other``."""
    from bee2bee_tpu_torch.models.quant import quantize_weight_torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    for family, launches in cs.GEMM_FAMILY_LAUNCHES:
        for label, K, Ns in launches:
            mine, theirs = [], []
            for N in Ns:
                qw = quantize_weight_torch(torch.randn((K, N), generator=gen, device="cuda",
                                                       dtype=torch.bfloat16))
                mine.append(qw)
                theirs.append(their_weight(other, qw["q"], qw["s"]))
            for M in (8, 40):
                x = torch.randn((M, K), generator=gen, device="cuda", dtype=torch.bfloat16)
                N = sum(Ns)
                bnd = cs.bounds(K * N + 4 * N + 2 * M * K + 2 * M * N, 2 * M * K * N,
                                torch.bfloat16)
                plan = G.gemm_plan(M, K, Ns, G._sm_count(0))
                nk = -(-K // 64)
                splits = {(plan[0], s) for s in (1, 2, 3, 4, 6, 8, 12, 16) if s <= nk} | {plan}
                t = {pl[1]: time_ms(lambda pl=pl: G._launch_kernel(x, mine, pl), flush, True)
                     for pl in sorted(splits)}
                a = time_ms(lambda: other.int8_weight_matmul_group(x, theirs), flush, True)
                b = time_ms(lambda: G.int8_weight_matmul_group(x, mine), flush, True)
                c = time_ms(lambda: G.int8_weight_matmul_group(x, mine), flush, True)
                d = time_ms(lambda: other.int8_weight_matmul_group(x, theirs), flush, True)
                print(f"probe families {family} {label} [{K}, {N}] M={M}: plan {plan}, "
                      f"{t[plan[1]]:.4f} ms ({bnd['bound_ms'] / t[plan[1]]:.3f} of bound "
                      f"{bnd['bound_ms']:.4f}); by split { {k: round(v, 4) for k, v in t.items()} }"
                      f"; in turns other {a:.4f}, this {b:.4f}, this {c:.4f}, other {d:.4f} -> "
                      f"this/other {(b + c) / (a + d):.3f}; card {card}", flush=True)
            del mine, theirs


def other_tree(path: Path):
    """DIR's ``ops/int8_gemm.py`` as a module whose kernel is DIR's
    ``csrc/int8_weight_gemm.cu``, built here with this tree's flags."""
    from bee2bee_tpu_torch.ops import _build

    out = HERE / "build" / "int8_gemm_probe"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "other.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
           str(path / "bee2bee_tpu_torch" / "csrc" / "int8_weight_gemm.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    (out / "other.log").write_text(done.stdout + done.stderr)
    if done.returncode:
        raise RuntimeError(f"nvcc failed on {path}:\n{done.stdout}{done.stderr}")
    pkg = types.ModuleType("other_tree_ops")
    pkg.__path__ = []
    build = types.ModuleType("other_tree_ops._build")
    handle = ctypes.CDLL(str(lib))
    build.load = lambda source: handle
    sys.modules["other_tree_ops"] = pkg
    sys.modules["other_tree_ops._build"] = build
    spec = importlib.util.spec_from_file_location(
        "other_tree_ops.int8_gemm", path / "bee2bee_tpu_torch" / "ops" / "int8_gemm.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_tree_ops.int8_gemm"] = mod
    spec.loader.exec_module(mod)
    return mod


def time_ms(fn, flush: torch.Tensor, clean: bool, reps: int = 20) -> float:
    """Median of ``reps`` single-call CUDA-event timings after a warm-up,
    L2 flushed before each by a write of ``flush`` or (``clean``) a read of
    it, the card spinning ~0.1 ms before each start so the host has queued
    the call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if clean:
            flush.view(torch.float32).sum()
        else:
            flush.zero_()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graphed(fn):
    """``fn`` captured as one CUDA graph (the launches' host cost out of the
    timing, as in a replayed decode step); returns its replay."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def main() -> int:
    if not torch.cuda.is_available():
        print("int8_gemm_probe: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from bee2bee_tpu_torch.models.quant import quantize_weight_torch
    from bee2bee_tpu_torch.ops import _build
    from bee2bee_tpu_torch.ops import int8_gemm as G

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card {card}; torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    report = _build.build((G._SOURCE,))[G._SOURCE].with_suffix(".log").read_text()
    for name, line in cs.ptxas_entries(report):
        print(f"ptxas {name}: {line}", flush=True)
    if len(sys.argv) == 3 and sys.argv[1] == "--families":
        families(cs, G, other_tree(Path(sys.argv[2]).resolve()), card)
        return 0
    other = None
    if len(sys.argv) == 3 and sys.argv[1] == "--kernel":
        other = other_tree(Path(sys.argv[2]).resolve())
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    n_sm = G._sm_count(0)

    def weights(K, Ns, dtype):
        """(this tree's weights, the other tree's) for widths Ns."""
        mine, theirs = [], []
        for N in Ns:
            w = torch.randn((K, N), generator=gen, device="cuda", dtype=dtype) / math.sqrt(K)
            qw = quantize_weight_torch(w)
            del w
            mine.append(qw)
            if other is not None:
                theirs.append(their_weight(other, qw["q"], qw["s"]))
        return mine, theirs

    # 1. the kernels alone
    cases = [(torch.bfloat16, M) for M in (1, 8, 40, 64, 128, 600, 2048)]
    cases += [(torch.float32, M) for M in (8, 40)]
    for label, K, Ns in LAUNCHES:
        for dtype in (torch.bfloat16, torch.float32):
            mine, theirs = weights(K, Ns, dtype)
            for dt, M in cases:
                if dt != dtype or (M > 64 and label == "wk") or \
                        (M in (1, 64, 128, 600) and label != "w_up"):
                    continue
                x = torch.randn((M, K), generator=gen, device="cuda", dtype=dtype)
                N, e = sum(Ns), x.element_size()
                bnd = cs.bounds(K * N + 4 * N + e * M * K + e * M * N, 2 * M * K * N, dtype,
                                "2xtf32" if dtype == torch.float32 else "")
                plan = G.gemm_plan(M, K, Ns, n_sm)
                route = G.int8_gemm_route(M, dtype)
                if route == "dequant":
                    continue
                ys = G._launch_kernel(x, mine, plan)
                refs = [G.int8_weight_matmul_ref(x, w["q"], w["s"]) for w in mine]
                err = max(((y.float() - r.float()).abs().max() / r.float().abs().max()).item()
                          for y, r in zip(ys, refs))
                line = (f"probe {label} [{K}, {N}] {str(dtype)[6:]} M={M} ({route}): plan "
                        f"{plan}, max err {err:.2e} of max |y|; bound {bnd['bound_ms']:.4f} ms "
                        f"({bnd['bound_by']})")
                for clean in (False, True):
                    flush_name = "read" if clean else "written"
                    splits = {plan}
                    if plan[0] <= 128 and M <= plan[0]:
                        nk = -(-K // 64)
                        splits |= {(plan[0], s) for s in (1, 2, 3, 4, 6, 8, 12, 16)
                                   if s <= nk}
                    t = {pl: time_ms(lambda pl=pl: G._launch_kernel(x, mine, pl), flush, clean)
                         for pl in sorted(splits)}
                    line += (f"; L2 {flush_name}: this {t[plan]:.4f} ms "
                             f"({bnd['bound_ms'] / t[plan]:.3f} of bound), by split "
                             f"{ {s: round(v, 4) for (_, s), v in t.items()} }")
                    if other is not None:
                        a = time_ms(lambda: other.int8_weight_matmul_group(x, theirs), flush,
                                    clean)
                        b = time_ms(lambda: G.int8_weight_matmul_group(x, mine), flush, clean)
                        c = time_ms(lambda: G.int8_weight_matmul_group(x, mine), flush, clean)
                        d = time_ms(lambda: other.int8_weight_matmul_group(x, theirs), flush,
                                    clean)
                        line += (f"; in turns other {a:.4f}, this {b:.4f}, this {c:.4f}, "
                                 f"other {d:.4f} -> this/other {(b + c) / (a + d):.3f}")
                print(line + f"; card {card}", flush=True)
            del mine, theirs
    torch.cuda.empty_cache()

    # 2. the replayed decode step's 128 projections
    mine, theirs = [], []
    for _ in range(32):
        for label, K, Ns in STEP_LAUNCHES:
            m, t = weights(K, Ns, torch.bfloat16)
            mine.append((K, m))
            theirs.append((K, t))
    int8_bytes = sum(w["q"].numel() + 4 * w["s"].numel() for _, ws in mine for w in ws)
    # the host's time a call: 200 eager calls of the first layer's
    # launches queued back to back (the card keeps up), then one sync
    x8 = {K: torch.randn((8, K), generator=gen, device="cuda", dtype=torch.bfloat16)
          for K in (4096, 14336)}
    for who, fn, seq in (("this", G.int8_weight_matmul_group, mine),
                         ("other", other and other.int8_weight_matmul_group, theirs)):
        if fn is None:
            continue
        for K, ws in seq[:4]:
            fn(x8[K], ws)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            for K, ws in seq[:4]:
                fn(x8[K], ws)
        host = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        print(f"probe host: {who} {host:.1f} us a call queued (a layer's 4 launches at M=8, "
              f"50 times); card {card}", flush=True)
    for M in (8, 1, 40):
        xs = {K: torch.randn((M, K), generator=gen, device="cuda", dtype=torch.bfloat16)
              for K in (4096, 14336)}
        runs = {"this": graphed(lambda: [G.int8_weight_matmul_group(xs[K], ws)
                                         for K, ws in mine])}
        order = ["this"]
        if other is not None:
            runs["other"] = graphed(lambda: [other.int8_weight_matmul_group(xs[K], ws)
                                             for K, ws in theirs])
            order = ["other", "this", "this", "other"]
        times = [cs.cuda_time_ms(runs[who], reps=10) for who in order]
        text = ", ".join(f"{who} {t:.4f}" for who, t in zip(order, times))
        print(f"probe step M={M}: the 128 launches of 32 layers replayed from one graph, "
              f"{text} ms; bound {int8_bytes / cs.HBM_BYTES_PER_S * 1e3:.4f} ms "
              f"({int8_bytes} B); card {card}", flush=True)
        del runs
    del mine, theirs, flush
    torch.cuda.empty_cache()

    # 3. the served step and chunk of llama-3-8b with int8 weights
    svc, load_s = cs.load_slice("bfloat16", quantize="int8")
    print(f"probe: llama-3-8b int8 weights loaded in {load_s:.1f} s; the served step and "
          "chunk", flush=True)
    cs.step_breakdown(svc.engine, card, full=False, chunk=True)
    svc.engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
