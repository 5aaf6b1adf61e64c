"""A CPU model of the f32 tile kernels' arithmetic
(bee2bee_tpu_torch/csrc/tile_attention_f32.cuh), for tests/test_torch_flash.py
and tests/test_torch_ragged.py.

What it models: TF32 rounding as ``cvt.rna.tf32.f32`` does it (to nearest,
ties away from zero, the low 13 mantissa bits cleared), by bit arithmetic on
the f32 pattern; the split x = hi + lo with hi = tf32(x), lo = tf32(x - hi);
the three products of 3xTF32 (a_lo b_hi + a_hi b_lo + a_hi b_hi), or the one
product of 1xTF32 to show what the small products do; P kept in f32 and
split like any other operand, the row sum over the unrounded p; and the key
order of the kernel's C -> A step in P V, derived lane by lane from the
mma.m16n8k8 fragment layouts. Each product of two TF32 values is exact in
float64, and the model sums in float64, so what differs from f32 attention
is what the TF32 operands drop.
"""

from __future__ import annotations

import numpy as np


def tf32(x) -> np.ndarray:
    """x (f32) rounded to TF32, as cvt.rna.tf32.f32: add half of the unit
    the low 13 bits make to the magnitude, then clear them."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x) -> tuple[np.ndarray, np.ndarray]:
    """x = hi + lo, both TF32 (x - hi is exact in f32)."""
    x = np.asarray(x, dtype=np.float32)
    hi = tf32(x)
    return hi, tf32(x - hi)


def matmul_tf32(a, b, products: int = 3) -> np.ndarray:
    """a @ b over the last two axes with TF32 operands, returned as f32:
    three products (3xTF32) or one (1xTF32, a_hi b_hi)."""
    ahi, alo = (t.astype(np.float64) for t in split(a))
    bhi, blo = (t.astype(np.float64) for t in split(b))
    out = ahi @ bhi
    if products == 3:
        out = alo @ bhi + ahi @ blo + out
    return out.astype(np.float32)


# mma.m16n8k8 TF32 fragment layouts (the PTX ISA's), lane = 4 g + t:
# element e of a lane's accumulator C, A fragment and B fragment
def _c_elem(lane: int, e: int) -> tuple[int, int]:  # (row, column)
    g, t = divmod(lane, 4)
    return g + 8 * (e >> 1), 2 * t + (e & 1)


def _a_elem(lane: int, e: int) -> tuple[int, int]:  # (row, k)
    g, t = divmod(lane, 4)
    return g + 8 * (e & 1), t + 4 * (e >> 1)


def _b_elem(lane: int, e: int) -> tuple[int, int]:  # (k, column)
    g, t = divmod(lane, 4)
    return t + 4 * e, g


# the kernel's C -> A step (pv in tile_attention_f32.cuh): a[e] = c[C_OF_A[e]]
C_OF_A = (0, 2, 1, 3)


def kernel_v_row(lane: int, e: int) -> int:
    """The row of its 8-key group that the kernel reads V from for b[e]:
    2t (b0) and 2t + 1 (b1)."""
    return 2 * (lane % 4) + e


def pv_key_orders(c_of_a=C_OF_A, v_row=kernel_v_row):
    """(a_keys, b_keys): for each k of a P V k-step, the key of the 8-key
    group whose probability the A fragment holds, and the key whose V row
    the B fragment holds, derived lane by lane. The C -> A step must keep
    every value in its row, and all lanes must agree on each k."""
    a_keys: list = [None] * 8
    b_keys: list = [None] * 8
    for lane in range(32):
        for e in range(4):
            row, k = _a_elem(lane, e)
            c_row, key = _c_elem(lane, c_of_a[e])
            assert c_row == row, "the C -> A step moves a value to another row"
            assert a_keys[k] in (None, key), "lanes disagree on a key"
            a_keys[k] = key
        for e in range(2):
            k, _ = _b_elem(lane, e)
            assert b_keys[k] in (None, v_row(lane, e)), "lanes disagree on a V row"
            b_keys[k] = v_row(lane, e)
    return a_keys, b_keys


def pv_tf32(p, v, products: int = 3, key_orders=None) -> np.ndarray:
    """P V as the kernel's k-steps take it: keys in groups of 8, the A
    operand from p's columns in a_keys order, the B operand from v's rows
    in b_keys order. p [..., R, S], v [..., S, D]; S is zero-padded to a
    multiple of 8."""
    a_keys, b_keys = key_orders or pv_key_orders()
    S = p.shape[-1]
    pad = -S % 8
    if pad:
        p = np.concatenate([p, np.zeros(p.shape[:-1] + (pad,), p.dtype)], -1)
        v = np.concatenate([v, np.zeros(v.shape[:-2] + (pad, v.shape[-1]), v.dtype)], -2)
    base = np.arange(0, S + pad, 8)[:, None]
    perm_a = (base + np.asarray(a_keys)[None]).reshape(-1)
    perm_b = (base + np.asarray(b_keys)[None]).reshape(-1)
    return matmul_tf32(p[..., perm_a], v[..., perm_b, :], products)


def attention_tf32(q, k, v, vis, sm_scale: float, softcap: float = 0.0,
                   products: int = 3, key_orders=None) -> np.ndarray:
    """The kernel's arithmetic over rows of queries: q [..., R, D], k and v
    [..., S, D], vis [..., R, S] (broadcastable) marks the keys each row
    sees. S = Q K^T in TF32 products, scaled, tanh-capped, masked; p =
    exp(s - m) in f32, 0 where masked; l the row sum of the unrounded p;
    O = P V in TF32 products over l, 0 for a row that sees nothing."""
    s = matmul_tf32(q, np.swapaxes(k, -1, -2), products) * np.float32(sm_scale)
    if softcap:
        s = np.tanh(s / np.float32(softcap)) * np.float32(softcap)
    s = np.where(vis, s, -np.inf).astype(np.float32)
    m = s.max(-1, keepdims=True)
    p = np.where(vis, np.exp(s - np.where(np.isfinite(m), m, 0)), 0).astype(np.float32)
    l = p.sum(-1, keepdims=True, dtype=np.float32)
    o = pv_tf32(p, v, products, key_orders)
    return np.where(l > 0, o / np.where(l > 0, l, 1), 0).astype(np.float32)
