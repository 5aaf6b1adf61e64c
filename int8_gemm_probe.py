#!/usr/bin/env python3
"""Where the int8-weight GEMM's time goes, on one CUDA card.

Run from the root of a checkout:  python3 int8_gemm_probe.py

At llama-3-8b's four projection shapes (wq/wo 4096 x 4096, wk/wv 4096 x
1024, w_up/w_gate 4096 x 14336, w_down 14336 x 4096) and M in (1, 8, 40),
it prints the kernel's time (median of 30, L2 flushed, as chip_smoke.py
times it) under the split plan ``gemm_plan`` gives and under every
cluster size 1, 2, 4 and 8, beside the bytes bound and cuBLAS bf16 at the
dequantized weight. Then a decode step's worth of projections: 32 layers
x 7 weights (distinct random weights, 6.98 GB of int8), back to back at
M = 8 and M = 1 and replayed from one CUDA graph (as a decode step is),
as 224 launches and as the forward's 128 (wq|wk|wv and w_up|w_gate each
one launch), against the same sequence through cuBLAS bf16 over the dense
weights (13.96 GB). The card's name and power limit come first.
Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("int8_gemm_probe: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke as cs
    from bee2bee_tpu_torch.ops import int8_gemm as G

    card, _ = cs.phase_device_and_build()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    n_sm = G._sm_count(0)
    fn = G._kernel_fn()

    def launch(x, w, cs_, per):
        M, K = x.shape
        N = w["s"].shape[0]
        y = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
        err = fn(x.data_ptr(), 1, w["qp"].data_ptr(), w["s"].data_ptr(), y.data_ptr(), N,
                 *[None, None, None, 0] * (G.MAX_GROUP - 1), M, K, cs_, per,
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return y

    for name, K, N in cs.GEMM_SHAPES:
        w, dense = cs.int8_weight(gen, K, N)
        plan = G.gemm_plan(K, N, n_sm)
        kc = K // 32
        for M in (1, 8, 40):
            x = torch.randn((M, K), generator=gen, device="cuda", dtype=torch.bfloat16)
            bnd = cs.bounds(K * N + 4 * N + 2 * M * K + 2 * M * N, 2 * M * K * N,
                            torch.bfloat16)
            ref = G.int8_weight_matmul(x, w)
            times = {}
            for c in (1, 2, 4, 8):
                per = -(-kc // c)
                y = launch(x, w, c, per)
                assert torch.equal(y, ref) or c != plan[0]
                times[c] = cs.cuda_time_ms(lambda c=c, per=per: launch(x, w, c, per),
                                           flush=flush)
            cublas = cs.cuda_time_ms(lambda: torch.matmul(x, dense), flush=flush)
            print(f"probe {name} [{K}, {N}] M={M}: plan cluster {plan[0]} -> "
                  f"{times[plan[0]]:.4f} ms; by cluster size "
                  f"{ {c: round(t, 4) for c, t in times.items()} }; bound "
                  f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); cuBLAS bf16 "
                  f"{cublas:.4f} ms; card {card}", flush=True)
        del w, dense
    del flush
    torch.cuda.empty_cache()

    def graphed(fn):
        """``fn`` captured as a CUDA graph (the launches' host cost out of
        the timing, as in a replayed decode step); returns its replay."""
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return graph.replay

    # a decode step's projections, layer after layer, distinct weights
    shapes = [(4096, 4096), (4096, 1024), (4096, 1024), (4096, 4096), (4096, 14336),
              (4096, 14336), (14336, 4096)]
    weights = [cs.int8_weight(gen, K, N)[0] for _ in range(32) for K, N in shapes]
    int8_bytes = sum(w["qp"].numel() + 4 * w["s"].numel() for w in weights)
    for M in (8, 1):
        xs = {K: torch.randn((M, K), generator=gen, device="cuda", dtype=torch.bfloat16)
              for K in (4096, 14336)}
        seq = [(xs[w["qp"].shape[1] * 32], w) for w in weights]

        def run_int8():
            for x, w in seq:
                G.int8_weight_matmul(x, w)

        def run_grouped():  # the forward's 4 launches a layer
            for i in range(0, len(seq), 7):
                (x, wq), (_, wk), (_, wv), (_, wo), (_, up), (_, gate), (xd, down) = \
                    seq[i:i + 7]
                G.int8_weight_matmul_group(x, [wq, wk, wv])
                G.int8_weight_matmul(x, wo)
                G.int8_weight_matmul_group(x, [up, gate])
                G.int8_weight_matmul(xd, down)

        t = cs.cuda_time_ms(graphed(run_int8), reps=10)
        tg = cs.cuda_time_ms(graphed(run_grouped), reps=10)
        print(f"probe step M={M}: 224 int8-weight GEMMs back to back {t:.4f} ms, the "
              f"forward's 128 grouped launches {tg:.4f} ms, bound "
              f"{int8_bytes / cs.HBM_BYTES_PER_S * 1e3:.4f} ms ({int8_bytes} B); card "
              f"{card}", flush=True)
    del weights, seq
    torch.cuda.empty_cache()
    dense = [torch.randn((K, N), generator=gen, device="cuda", dtype=torch.bfloat16)
             for _ in range(32) for K, N in shapes]
    for M in (8, 1):
        xs = {K: torch.randn((M, K), generator=gen, device="cuda", dtype=torch.bfloat16)
              for K in (4096, 14336)}
        seq = [(xs[d.shape[0]], d) for d in dense]
        t = cs.cuda_time_ms(graphed(lambda: [torch.matmul(x, d) for x, d in seq]),
                            reps=10)
        nbytes = sum(d.numel() * 2 for d in dense)
        print(f"probe step M={M}: 224 cuBLAS bf16 GEMMs back to back {t:.4f} ms, bound "
              f"{nbytes / cs.HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} B); card {card}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
