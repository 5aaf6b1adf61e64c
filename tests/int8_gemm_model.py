"""A CPU model of the int8-weight GEMM kernels' arithmetic
(bee2bee_tpu_torch/csrc/int8_weight_gemm.cu), for tests/test_torch_quant.py.

What it models: the weight read in the JAX layout [K, N] in the kernels' k
order, 64-input stages of four 16-input steps, the inputs past K read as
zeros; the plan's K splits (ops/int8_gemm.py ``gemm_plan``), each split's
stages [s * nk / splits, (s + 1) * nk / splits); inside a split the 16-input
steps feed the tile's accumulator chains in turn (step ks of a stage the
chain ks % C: C = 4 for decode tiles of up to 32 rows, 2 for 40 to 64, 1 for
prefill tiles), each kept in f32, one step's products added at a time (a
step's 16 products are exact in float64: bf16 x int8 and TF32 x int8 have
at most 16 significant bits, so what the tensor cores sum inside a step
differs from this by the order of a few f32 roundings), the chains added in
order at the split's end; the partials reduced in split order in f32; the
scale applied once, after the sum. The f32 form (one chain) splits x into
TF32 hi + lo and adds the lo product before the hi one. Row tiles do not
enter the arithmetic: every output row is its own sum. The caller rounds
the f32 result to x's type once, as the kernels' epilogue does.
"""

from __future__ import annotations

import numpy as np

from tf32_attention_model import split

SLAB = 64  # inputs a stage (the kernels' kSlab)
STEP = 16  # inputs a product step (wgmma's k16)


def chains(br: int) -> int:
    """A tile's accumulator chains (the kernel's Chains<BR>)."""
    return 1 if br >= 128 else (4 if br <= 32 else 2)


def gemm(x, q, s, splits: int, f32_form: bool = False, br: int = 128) -> np.ndarray:
    """(x @ q) * s as the kernels sum it: x [M, K] f32 (bf16 values for the
    bf16 form), q int8 [K, N], s f32 [N], the plan's tile height ``br`` ->
    f32 [M, N], before the rounding to x's type."""
    x = np.asarray(x, np.float32)
    M, K = x.shape
    nk = -(-K // SLAB)
    qf = np.asarray(q).astype(np.float64)
    if f32_form:
        parts = [t.astype(np.float64) for t in split(x)][::-1]  # lo, then hi
        n_chains = 1
    else:
        parts = [x.astype(np.float64)]
        n_chains = chains(br)
    total = None
    for sp in range(splits):
        acc = [np.zeros((M, qf.shape[1]), np.float32) for _ in range(n_chains)]
        for st in range(sp * nk // splits, (sp + 1) * nk // splits):
            for ks in range(SLAB // STEP):
                k = slice(SLAB * st + STEP * ks, min(SLAB * st + STEP * (ks + 1), K))
                c = ks % n_chains
                for p in parts:
                    acc[c] = (acc[c] + p[:, k] @ qf[k]).astype(np.float32)
        summed = acc[0]
        for a in acc[1:]:
            summed = (summed + a).astype(np.float32)
        total = summed if total is None else (total + summed).astype(np.float32)
    return (total * np.asarray(s, np.float32)).astype(np.float32)
