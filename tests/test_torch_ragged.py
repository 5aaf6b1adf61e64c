"""The PyTorch port's ragged paged attention (bee2bee_tpu_torch/ops/ragged.py)
against the JAX kernel (bee2bee_tpu/ops/ragged.py) run in pallas interpret
mode on the CPU.

Both see the same pool, tables, offsets and queries, made from a seed with
numpy, at f32. The cases are those of tests/test_ops_ragged.py: ragged
lengths across block boundaries, null-block table tails, a dead row,
GQA ratios down to MQA, window + softcap + score scale, the verify shape
and prefill row tiling — plus a query that sees nothing (0, not NaN).
Tolerance 2e-5 absolute: the same f32 math, summed in another order.
The int8-pool form sees the same cases over an int8 pool with [Hkv, NB]
scales (the per-page amax recipe of tests/test_ops_ragged.py), at the
same tolerance: both dequantize in f32 before the same softmax.
On the CPU the dispatching wrapper must take the plain version and leave
the kernel's launch counts at 0.

The f32 tile form's arithmetic (3xTF32 products, P kept in f32, the
permuted key order of its C -> A step) is modelled on the CPU by
tests/tf32_attention_model.py and held against the JAX kernel within
1e-5 over both pool forms; a model with one TF32 product must land
further away.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bee2bee_tpu.ops import ragged_paged_attention as jax_ragged
from bee2bee_tpu_torch.ops import ragged as port
from tf32_attention_model import attention_tf32, kernel_v_row, pv_key_orders

ATOL = 2e-5
# the 3xTF32 model against the JAX kernel: what the TF32 operands drop
# (~2^-22 of a product) plus f32 summation order
TF32_ATOL = 1e-5


def _pool_case(offs, T, H, Hkv, hd, BS=8, extra_tables=0, dead=(), seed=0):
    """numpy pool [Hkv, NB, BS, hd] + per-row tables covering offs[b] + T
    positions (``extra_tables`` null entries past every row's extent;
    rows in ``dead`` keep an all-null table) + queries [B, T, H, hd]."""
    rng = np.random.default_rng(seed)
    B = len(offs)
    need = [-(-(o + T) // BS) for o in offs]
    MB = max(need) + extra_tables
    tables = np.zeros((B, MB), np.int32)
    nxt = 1
    for b in range(B):
        if b in dead:
            continue
        for i in range(need[b]):
            tables[b, i] = nxt
            nxt += 1
    NB = nxt + 1
    kp = rng.standard_normal((Hkv, NB, BS, hd)).astype(np.float32)
    vp = rng.standard_normal((Hkv, NB, BS, hd)).astype(np.float32)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    return q, kp, vp, tables, np.asarray(offs, np.int32)


def _both(case, window=None, sm_scale=None, softcap=0.0, block_q=256):
    q, kp, vp, tables, offs = case
    want = jax_ragged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(offs), window=window, sm_scale=sm_scale,
        logit_softcap=softcap, block_q=block_q, interpret=True,
    )
    got = port.ragged_paged_attention_ref(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(offs), window=window,
        sm_scale=sm_scale, logit_softcap=softcap,
    )
    return got.numpy(), np.asarray(want)


CASES = {
    # T=1 decode rows just below, at and past block boundaries (BS=8)
    "block_boundaries": dict(offs=[0, 7, 8, 21], T=1, H=4, Hkv=2, hd=16),
    # pow2 table-width padding: null entries past every live extent
    "null_tail": dict(offs=[3, 12], T=1, H=4, Hkv=2, hd=16, extra_tables=3, seed=1),
    # a retired row: whole table nulled, stale offset — reads the null
    # block like the JAX kernel does, finite
    "dead_row": dict(offs=[9, 4], T=1, H=4, Hkv=2, hd=16, dead=(1,), seed=2),
    "mha": dict(offs=[5, 18], T=2, H=4, Hkv=4, hd=8, seed=3),
    "gqa4": dict(offs=[5, 18], T=2, H=8, Hkv=2, hd=8, seed=3),
    "mqa": dict(offs=[5, 18], T=2, H=4, Hkv=1, hd=8, seed=3),
    # [B, K+1] speculative verify chunk at rows of different depths
    "verify_shape": dict(offs=[2, 15, 24], T=6, H=4, Hkv=2, hd=16, seed=5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ref_matches_jax_kernel(name):
    got, want = _both(_pool_case(**CASES[name]))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_prefill_chunk_rows_match_jax_kernel_tiled():
    """A bucket-wide chunk (T=16) at ragged offsets; the JAX kernel tiles
    the rows (block_q=8), the plain version does not — same result."""
    case = _pool_case(offs=[0, 11], T=16, H=4, Hkv=2, hd=16, seed=6)
    got, want = _both(case, block_q=8)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("window", [9, "tensor"], ids=["int", "tensor"])
def test_window_softcap_and_scale_match_jax_kernel(window):
    """The gemma-2 score stack: sliding window (python int or a [1] int32
    tensor), tanh softcap before the mask, score-scale override."""
    case = _pool_case(offs=[6, 19, 33], T=2, H=4, Hkv=2, hd=16, seed=4)
    got, want = _both(
        case, window=9, sm_scale=1.0 / math.sqrt(13), softcap=30.0
    )
    if window == "tensor":
        q, kp, vp, tables, offs = (torch.from_numpy(a) for a in case)
        got = port.ragged_paged_attention_ref(
            q, kp, vp, tables, offs, window=torch.tensor([9], dtype=torch.int32),
            sm_scale=1.0 / math.sqrt(13), logit_softcap=30.0,
        ).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_query_that_sees_nothing_gets_zero():
    """Offset past the table with a window below it: every page is
    skipped, l == 0, and both implementations write 0 — never NaN."""
    case = _pool_case(offs=[40, 3], T=1, H=4, Hkv=2, hd=16, seed=7)
    q, kp, vp, tables, offs = case
    tables = tables[:, :1].copy()  # row 0 maps only positions 0..7
    got, want = _both((q, kp, vp, tables, offs), window=4)
    assert np.isfinite(got).all()
    assert not got[0].any()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_cpu_dispatch_takes_plain_version_and_counts_no_launch():
    case = [torch.from_numpy(a) for a in
            _pool_case(offs=[4, 9], T=3, H=4, Hkv=2, hd=16, seed=8)]
    before = port.ragged_paged_attention.launches
    got = port.ragged_paged_attention(*case, window=5)
    want = port.ragged_paged_attention_ref(*case, window=5)
    assert torch.equal(got, want)
    assert port.ragged_paged_attention.launches == before == 0


def test_dispatch_raises_off_cpu_and_cuda():
    """No silent fallback: a device with no kernel raises."""
    q = torch.zeros((1, 1, 4, 16), device="meta")
    pool = torch.zeros((2, 3, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        port.ragged_paged_attention(
            q, pool, pool, torch.zeros((1, 1), dtype=torch.int32, device="meta"), 0
        )


def test_bf16_inputs_keep_dtype_and_f32_accumulation():
    q, kp, vp, tables, offs = _pool_case(offs=[10], T=1, H=4, Hkv=2, hd=16, seed=9)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp)]
    got = port.ragged_paged_attention(
        *bf, torch.from_numpy(tables), torch.from_numpy(offs)
    )
    assert got.dtype == torch.bfloat16
    want = port.ragged_paged_attention_ref(
        *(t.float() for t in bf), torch.from_numpy(tables), torch.from_numpy(offs)
    )
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=2e-2)


# ------------------------------------------------------------ int8 pool


def _quantize_pool(p):
    """f32 pool -> (int8 pool, [Hkv, NB] f32 scales): the per-page-per-head
    symmetric amax recipe of core._quantized_page_write."""
    s = np.max(np.abs(p), axis=(2, 3)) / np.float32(127.0)
    safe = np.where(s > 0, s, 1.0).astype(np.float32)
    q = np.clip(np.rint(p / safe[:, :, None, None]), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def _both_int8(case, window=None, sm_scale=None, softcap=0.0, block_q=256):
    q, kp, vp, tables, offs = case
    kq, ks = _quantize_pool(kp)
    vq, vs = _quantize_pool(vp)
    want = jax_ragged(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(tables),
        jnp.asarray(offs), window=window, sm_scale=sm_scale,
        logit_softcap=softcap, block_q=block_q, interpret=True,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
    )
    got = port.ragged_paged_attention(
        torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq),
        torch.from_numpy(tables), torch.from_numpy(offs), window=window,
        sm_scale=sm_scale, logit_softcap=softcap,
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs),
    )
    return got.numpy(), np.asarray(want)


INT8_CASES = {
    "decode_offsets": (dict(offs=[0, 7, 8, 21], T=1, H=4, Hkv=2, hd=16, seed=11), {}),
    "null_tail": (dict(offs=[3, 12], T=1, H=4, Hkv=2, hd=16, extra_tables=3,
                       seed=12), {}),
    "dead_row": (dict(offs=[9, 4], T=1, H=4, Hkv=2, hd=16, dead=(1,), seed=13), {}),
    "verify_shape": (dict(offs=[2, 15, 24], T=6, H=4, Hkv=2, hd=16, seed=14), {}),
    # the JAX kernel tiles the rows (block_q=8); the plain version does not
    "prefill_row_tiling": (dict(offs=[0, 11], T=16, H=4, Hkv=2, hd=16, seed=15),
                           dict(block_q=8)),
    "window_softcap_scale": (dict(offs=[6, 19, 33], T=2, H=4, Hkv=2, hd=16, seed=16),
                             dict(window=9, sm_scale=1.0 / math.sqrt(13),
                                  softcap=30.0)),
}


@pytest.mark.parametrize("name", sorted(INT8_CASES))
def test_int8_pool_ref_matches_jax_kernel(name):
    geo, kw = INT8_CASES[name]
    before = port.ragged_paged_attention.int8_launches
    got, want = _both_int8(_pool_case(**geo), **kw)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert port.ragged_paged_attention.int8_launches == before == 0


def test_int8_pool_needs_both_scales():
    q, kp, vp, tables, offs = (
        torch.from_numpy(a) for a in _pool_case(offs=[4], T=1, H=4, Hkv=2, hd=16)
    )
    ks = torch.ones((2, kp.shape[1]))
    for kw in (dict(k_scale=ks), dict(v_scale=ks)):
        with pytest.raises(ValueError, match="BOTH k_scale and v_scale"):
            port.ragged_paged_attention(q, kp.to(torch.int8), vp.to(torch.int8),
                                        tables, offs, **kw)
        with pytest.raises(ValueError, match="BOTH k_scale and v_scale"):
            port.ragged_paged_attention_ref(q, kp.to(torch.int8), vp.to(torch.int8),
                                            tables, offs, **kw)


def test_int8_pool_rounds_dequantized_pages_to_the_query_dtype():
    """bf16 queries: each dequantized page is rounded to bf16 before the
    dots, so the result equals the bf16 pool holding those rounded values."""
    q, kp, vp, tables, offs = _pool_case(offs=[10, 3], T=2, H=4, Hkv=2, hd=16, seed=17)
    kq, ks = _quantize_pool(kp)
    vq, vs = _quantize_pool(vp)
    qb = torch.from_numpy(q).to(torch.bfloat16)
    got = port.ragged_paged_attention(
        qb, torch.from_numpy(kq), torch.from_numpy(vq), torch.from_numpy(tables),
        torch.from_numpy(offs), k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs),
    )
    kb = (torch.from_numpy(kq).float() * torch.from_numpy(ks)[..., None, None]
          ).to(torch.bfloat16)
    vb = (torch.from_numpy(vq).float() * torch.from_numpy(vs)[..., None, None]
          ).to(torch.bfloat16)
    want = port.ragged_paged_attention(
        qb, kb, vb, torch.from_numpy(tables), torch.from_numpy(offs)
    )
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


# ------------------------------------------------ tile kernel: dispatch


@pytest.mark.parametrize("dtype,T,hd,tile,quantized", [
    (torch.bfloat16, 1, 128, False, False),  # decode: the decode kernel
    (torch.bfloat16, port.T_MIN - 1, 128, False, False),
    (torch.bfloat16, port.T_MIN, 128, True, False),  # the shortest tiled chunk
    (torch.bfloat16, 5, 128, True, False),  # a verify chunk
    (torch.bfloat16, 2048, 128, True, False),  # a prefill bucket
    (torch.bfloat16, 300, 64, True, False),
    (torch.bfloat16, 300, 256, True, False),  # the resident-Q form
    (torch.float32, 300, 128, True, False),  # f32 queries: the f32 tile form
    (torch.float16, 300, 128, False, False),
    (torch.float32, port.T_MIN_F32, 128, True, False),  # the shortest f32 tile chunk
    (torch.float32, port.T_MIN_F32, 64, True, False),
    (torch.float32, 300, 256, True, False),  # head_dim 256: its f32 form too
    (torch.bfloat16, port.T_MIN, 128, True, True),  # bf16: the same over int8
    # f32 over an int8 pool: the f32 decode kernel below T_MIN_F32_INT8
    (torch.float32, port.T_MIN_F32_INT8 - 1, 128, False, True),
    (torch.float32, port.T_MIN_F32_INT8, 128, True, True),
    (torch.float32, 300, 64, True, True),
    # f32 at head_dim 256: the f32 decode kernel below its own crossovers
    (torch.float32, port.T_MIN_F32_HD256 - 1, 256, False, False),
    (torch.float32, port.T_MIN_F32_HD256, 256, True, False),
    (torch.float32, port.T_MIN_F32_INT8_HD256 - 1, 256, False, True),
    (torch.float32, port.T_MIN_F32_INT8_HD256, 256, True, True),
    (torch.bfloat16, port.T_MIN, 256, True, True),
    # phi-3's head_dim 96: the tile kernel (Q in registers), its f32 form
    # and decode_f32 below the crossover at 96, over both pools
    (torch.bfloat16, 5, 96, True, False),
    (torch.bfloat16, port.T_MIN, 96, True, True),
    (torch.float32, port._t_min_f32(96, False) - 1, 96, False, False),
    (torch.float32, port._t_min_f32(96, False), 96, True, False),
    (torch.float32, port._t_min_f32(96, True) - 1, 96, False, True),
    (torch.float32, port._t_min_f32(96, True), 96, True, True),
], ids=["decode", "below_t_min", "t_min", "verify", "prefill", "hd64", "hd256",
        "f32", "f16", "f32_t_min", "f32_hd64", "f32_hd256", "int8_pool_t_min",
        "f32_int8_pool_below_t_min", "f32_int8_pool_t_min", "f32_int8_pool_prefill",
        "f32_hd256_below_t_min", "f32_hd256_t_min", "f32_hd256_int8_below_t_min",
        "f32_hd256_int8_t_min", "hd256_int8_pool_t_min", "hd96_verify",
        "hd96_int8_pool_t_min", "f32_hd96_below_t_min", "f32_hd96_t_min",
        "f32_hd96_int8_below_t_min", "f32_hd96_int8_t_min"])
def test_dispatch_rule(dtype, T, hd, tile, quantized):
    assert port.use_tile_kernel(dtype, T, hd, quantized) is tile
    if tile:
        want = ("tile_f32" if dtype == torch.float32
                else "tile_hd256" if hd == 256 else "tile")
        assert port.ragged_kernel(dtype, T, hd, quantized) == want
    elif dtype == torch.float32:
        # below the f32 tile form's crossover: the f32 decode kernel
        assert port.ragged_kernel(dtype, T, hd, quantized) == "decode_f32"


def _tile_args(T=32, hd=128, int8=False, **over):
    """Arguments of the tile kernel's launch checks, on the CPU."""
    q = torch.zeros((2, T, 8, hd), dtype=torch.bfloat16)
    pool_dtype = torch.int8 if int8 else torch.bfloat16
    kp = torch.zeros((2, 9, 16, hd), dtype=pool_dtype)
    vp = torch.zeros_like(kp)
    ks = vs = torch.ones((2, 9)) if int8 else None
    args = dict(q=q, k_pool=kp, v_pool=vp,
                block_tables=torch.zeros((2, 4), dtype=torch.int32),
                off=torch.zeros(2, dtype=torch.int32), k_scale=ks, v_scale=vs)
    args.update(over)
    return args


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pool", "int8_pool"])
def test_tile_kernel_args_accepted(int8):
    port._check_kernel_args(**_tile_args(int8=int8))


def _misaligned_q(T, hd):
    """A contiguous bf16 q whose data starts 2 bytes past a 16-byte line."""
    n = 2 * T * 8 * hd
    return torch.zeros(n + 8, dtype=torch.bfloat16)[1:n + 1].view(2, T, 8, hd)


def test_tile_kernel_needs_16_byte_aligned_q():
    """The tile kernel copies q rows in 16-byte pieces, its head_dim-256
    form as well, and so does the f32 decode kernel that now takes a
    short f32 chunk at head_dim 256 (the row kernel, which read q by
    elements, served it before)."""
    q = _misaligned_q(32, 128)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match="q is not 16-byte aligned"):
        port._check_kernel_args(**_tile_args(q=q))
    assert port.ragged_kernel(torch.bfloat16, 32, 256) == "tile_hd256"
    with pytest.raises(ValueError, match="q is not 16-byte aligned"):
        port._check_kernel_args(**_tile_args(hd=256, q=_misaligned_q(32, 256)))
    qf = torch.zeros(2 * 4 * 8 * 256 + 1)[1:].view(2, 4, 8, 256)
    kp = torch.zeros((2, 9, 16, 256))
    assert port.ragged_kernel(qf.dtype, 4, 256, group=4) == "decode_f32"
    with pytest.raises(ValueError, match="q is not 16-byte aligned"):
        port._check_kernel_args(**_tile_args(T=4, hd=256, q=qf, k_pool=kp, v_pool=kp))


@pytest.mark.parametrize("bad,err,match", [
    ("pool_dtype", TypeError, "pool dtype"),
    ("scale_shape", ValueError, "k_scale must be float32"),
    ("block_size", ValueError, "block size 12"),
    ("tables_dtype", ValueError, "block_tables must be int32"),
    ("pool_width", ValueError, "do not match head_dim"),
    ("noncontiguous", ValueError, "q is not contiguous"),
])
def test_tile_kernel_args_rejected(bad, err, match):
    args = _tile_args(int8=bad == "scale_shape")
    if bad == "pool_dtype":
        args["k_pool"] = args["v_pool"] = args["k_pool"].float()
    elif bad == "scale_shape":
        args["k_scale"] = torch.ones((2, 8))
    elif bad == "block_size":
        args["k_pool"] = args["v_pool"] = torch.zeros((2, 9, 12, 128),
                                                      dtype=torch.bfloat16)
    elif bad == "tables_dtype":
        args["block_tables"] = args["block_tables"].long()
    elif bad == "pool_width":
        args["k_pool"] = args["v_pool"] = torch.zeros((2, 9, 16, 64),
                                                      dtype=torch.bfloat16)
    elif bad == "noncontiguous":
        args["q"] = torch.zeros((2, 8, 32, 128), dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(err, match=match):
        port._check_kernel_args(**args)


def test_cpu_dispatch_counts_no_tile_launch():
    """A chunk the rule tiles still takes the plain version on the CPU."""
    case = [torch.from_numpy(a) for a in
            _pool_case(offs=[4, 9], T=port.T_MIN + 3, H=4, Hkv=2, hd=16, seed=18)]
    q = case[0].to(torch.bfloat16)
    kp, vp = (t.to(torch.bfloat16) for t in case[1:3])
    got = port.ragged_paged_attention(q, kp, vp, *case[3:])
    assert torch.equal(got, port.ragged_paged_attention_ref(q, kp, vp, *case[3:]))
    assert port.ragged_paged_attention.prefill_launches == 0
    assert port.ragged_paged_attention.int8_prefill_launches == 0


# ------------------------------------- the tile kernel's shapes, scaled down

# The cases chip_smoke.py holds the tile kernel to, at small widths with
# the GQA group of llama-3-8b (4 heads a kv head): a chunk of 17 (one row
# tile plus a ragged edge), a 64-long chunk with window + softcap + score
# scale, and page sizes 8 and 32 — for both pool forms.
TILE_CASES = {
    "t17": (dict(offs=[5, 33], T=17, H=8, Hkv=2, hd=16, seed=21), {}),
    "t64_window_softcap": (dict(offs=[5, 70], T=64, H=8, Hkv=2, hd=16, seed=22),
                           dict(window=24, sm_scale=1.0 / math.sqrt(256),
                                softcap=50.0)),
    "bs8": (dict(offs=[3, 29], T=20, H=8, Hkv=2, hd=16, BS=8, extra_tables=2,
                 seed=23), {}),
    "bs32": (dict(offs=[3, 29], T=20, H=8, Hkv=2, hd=16, BS=32, seed=24), {}),
}


@pytest.mark.parametrize("name", sorted(TILE_CASES))
@pytest.mark.parametrize("int8", [False, True], ids=["pool", "int8_pool"])
def test_tile_shapes_ref_matches_jax_kernel(name, int8):
    geo, kw = TILE_CASES[name]
    case = _pool_case(**geo)
    got, want = (_both_int8 if int8 else _both)(case, **kw)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)


# --------------------------------------------- decode kernel: dispatch


@pytest.mark.parametrize("dtype,T,hd,decode", [
    (torch.bfloat16, 1, 128, True),  # decode at llama-3-8b's head_dim
    (torch.bfloat16, 1, 64, True),
    (torch.bfloat16, 1, 256, True),  # the resident-Q form
    (torch.bfloat16, port.T_MIN, 128, False),  # the tile kernel's
    (torch.bfloat16, 5, 128, False),
    (torch.float32, 1, 128, False),  # f32 queries: the f32 decode kernel
    (torch.float16, 1, 128, False),
    (torch.bfloat16, 1, 96, True),  # phi-3's heads: Q in registers
    (torch.float32, 1, 96, False),
], ids=["hd128", "hd64", "hd256", "t_min", "verify", "f32", "f16", "hd96", "f32_hd96"])
def test_decode_dispatch_rule(dtype, T, hd, decode):
    assert port.use_decode_kernel(dtype, T, hd) is decode
    # the decode kernel takes no case the tile kernel takes
    assert not (decode and port.use_tile_kernel(dtype, T, hd))
    tile = "tile_f32" if dtype == torch.float32 else "tile"
    want = ("decode" if decode else "decode_f32" if port.use_decode_f32_kernel(dtype, T, hd)
            else tile if port.use_tile_kernel(dtype, T, hd) else "row")
    if hd == 256 and want in ("decode", "tile"):
        want += "_hd256"
    assert port.ragged_kernel(dtype, T, hd) == want


@pytest.mark.parametrize("T", [1, 2, 5, 64, 2048])
@pytest.mark.parametrize("hd", [64, 96, 128, 256])
def test_decode_and_tile_rules_are_disjoint(T, hd):
    for dtype in (torch.bfloat16, torch.float32):
        assert not (port.use_decode_kernel(dtype, T, hd)
                    and port.use_tile_kernel(dtype, T, hd))


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("MB,BS", [(128, 16), (256, 8), (64, 32)])
def test_decode_splits_fill_the_card_and_cover_the_table(B, MB, BS):
    """llama-3-8b's 8 kv heads on an H100's 132 SMs over a 2048-key table
    (the slice's MB 128 at BS 16): at least one block per SM at B=1 and
    B=8, whole key tiles per split, and the splits cover the MB pages
    exactly: the last one starts inside the table."""
    n_sm = 132
    splits, pages = port.decode_splits(B, 8, MB, BS, n_sm)
    assert isinstance(splits, int) and isinstance(pages, int)
    assert B * 8 * splits >= n_sm
    assert (pages * BS) % port.DECODE_TILE_KEYS == 0
    assert (splits - 1) * pages < MB <= splits * pages


@pytest.mark.parametrize("B,Hkv,MB,BS,n_sm", [
    (1, 8, 1, 16, 132),  # one page: one split
    (8, 8, 2, 16, 132),
    (64, 8, 128, 16, 132),  # a wide batch fills the card without splits
    (3, 2, 33, 8, 16),
    (1, 1, 1000, 32, 132),
])
def test_decode_splits_cover_any_table(B, Hkv, MB, BS, n_sm):
    splits, pages = port.decode_splits(B, Hkv, MB, BS, n_sm)
    assert splits >= 1 and pages >= 1
    assert (splits - 1) * pages < MB <= splits * pages
    # at most DECODE_MAX_SPLIT_TILES tiles a split, and more than one only
    # where the grid still holds a block per SM
    per = pages * BS // port.DECODE_TILE_KEYS if BS < port.DECODE_TILE_KEYS else pages
    assert per <= port.DECODE_MAX_SPLIT_TILES
    assert per == 1 or B * Hkv * splits >= n_sm


@pytest.mark.parametrize("B,MB,BS,want", [
    (8, 64, 16, (4, 16)),  # the timed decode: B=8 at a 1024-token context
    (1, 128, 16, (32, 4)),  # B=1 over 2048 keys
    (8, 256, 16, (16, 16)),  # a 4096-key window's worth of table
    (4, 40, 8, (5, 8)),
])
def test_decode_splits_at_gemma_heads(B, MB, BS, want):
    """gemma-2-9b's 8 kv heads on an H100's 132 SMs: the head_dim-256 form
    of the decode kernel stages the same 64-key tiles (16 keys a warp, one
    m16n8k16 P V step), so its plan is the one DECODE_TILE_KEYS gives
    (chip_smoke.py prints it beside each decode timing): whole tiles a
    split, at most DECODE_MAX_SPLIT_TILES, covering the table."""
    splits, pages = port.decode_splits(B, 8, MB, BS, 132)
    assert (splits, pages) == want
    assert pages * BS % port.DECODE_TILE_KEYS == 0
    assert pages * BS // port.DECODE_TILE_KEYS <= port.DECODE_MAX_SPLIT_TILES
    assert (splits - 1) * pages < MB <= splits * pages


def test_decode_splits_read_shapes_only():
    """The plan is a function of python ints (cached), never of a tensor:
    reading the offsets would sync the card in every layer."""
    import inspect

    params = inspect.signature(port.decode_splits.__wrapped__).parameters
    assert list(params) == ["B", "Hkv", "MB", "BS", "n_sm"]
    assert all(p.annotation in (int, "int") for p in params.values())
    assert port.decode_splits(8, 8, 128, 16, 132) is port.decode_splits(8, 8, 128, 16, 132)


def _decode_args(hd=128, int8=False, **over):
    return _tile_args(T=1, hd=hd, int8=int8, **over)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pool", "int8_pool"])
@pytest.mark.parametrize("hd", [64, 96, 128, 256])
def test_decode_kernel_args_accepted(int8, hd):
    port._check_kernel_args(**_decode_args(hd=hd, int8=int8))


def test_decode_kernel_needs_16_byte_aligned_q():
    """The decode kernel (its head_dim-256 form too) and the f32 decode
    kernel (f32 decode at every head_dim, 256 included, where the row
    kernel read q by elements before) copy q rows in 16-byte pieces."""
    q = _misaligned_q(1, 128)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match="q is not 16-byte aligned"):
        port._check_kernel_args(**_decode_args(q=q))
    assert port.ragged_kernel(torch.bfloat16, 1, 256) == "decode_hd256"
    with pytest.raises(ValueError, match="q is not 16-byte aligned"):
        port._check_kernel_args(**_decode_args(hd=256, q=_misaligned_q(1, 256)))
    qf = torch.zeros(2 * 8 * 128 + 1)[1:].view(2, 1, 8, 128)
    kp = torch.zeros((2, 9, 16, 128))
    with pytest.raises(ValueError, match="q is not 16-byte aligned"):
        port._check_kernel_args(**_decode_args(q=qf, k_pool=kp, v_pool=kp))
    qf = torch.zeros(2 * 8 * 256 + 1)[1:].view(2, 1, 8, 256)
    kp = torch.zeros((2, 9, 16, 256))
    assert port.ragged_kernel(qf.dtype, 1, 256, group=4) == "decode_f32"
    with pytest.raises(ValueError, match="q is not 16-byte aligned"):
        port._check_kernel_args(**_decode_args(hd=256, q=qf, k_pool=kp, v_pool=kp))


@pytest.mark.parametrize("bad,err,match", [
    ("pool_dtype", TypeError, "pool dtype"),
    ("scale_shape", ValueError, "v_scale must be float32"),
    ("block_size", ValueError, "block size 64"),
    ("tables_dtype", ValueError, "block_tables must be int32"),
    ("offset_device", ValueError, "offset on meta"),
    ("noncontiguous", ValueError, "q is not contiguous"),
])
def test_decode_kernel_args_rejected(bad, err, match):
    args = _decode_args(int8=bad == "scale_shape")
    if bad == "pool_dtype":
        args["k_pool"] = args["v_pool"] = args["k_pool"].to(torch.float16)
    elif bad == "scale_shape":
        args["v_scale"] = torch.ones((2, 9), dtype=torch.float64)
    elif bad == "block_size":
        args["k_pool"] = args["v_pool"] = torch.zeros((2, 9, 64, 128),
                                                      dtype=torch.bfloat16)
    elif bad == "tables_dtype":
        args["block_tables"] = args["block_tables"].to(torch.int16)
    elif bad == "offset_device":
        args["off"] = torch.zeros(2, dtype=torch.int32, device="meta")
    elif bad == "noncontiguous":
        args["q"] = torch.zeros((2, 1, 8, 256), dtype=torch.bfloat16)[..., :128]
    with pytest.raises(err, match=match):
        port._check_kernel_args(**args)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pool", "int8_pool"])
def test_cpu_dispatch_counts_no_decode_launch(int8):
    """A decode step the rule sends to the decode kernel still takes the
    plain version on the CPU, and counts no launch of any kernel."""
    q, kp, vp, tables, offs = (torch.from_numpy(a) for a in _pool_case(
        offs=[4, 9, 30], T=1, H=8, Hkv=2, hd=64, seed=19))
    q = q.to(torch.bfloat16)
    kw = {}
    if int8:
        (kp, ks), (vp, vs) = (tuple(torch.from_numpy(a) for a in _quantize_pool(p.numpy()))
                              for p in (kp, vp))
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    assert port.ragged_kernel(q.dtype, 1, 64) == "decode"
    got = port.ragged_paged_attention(q, kp, vp, tables, offs, **kw)
    assert torch.equal(got, port.ragged_paged_attention_ref(q, kp, vp, tables, offs, **kw))
    for name in ("launches", "int8_launches", "prefill_launches",
                 "int8_prefill_launches", "f32_prefill_launches",
                 "int8_f32_prefill_launches", "decode_launches",
                 "int8_decode_launches"):
        assert getattr(port.ragged_paged_attention, name) == 0, name


# ----------------------------- decode kernel: the split-and-merge, modelled

NEG = float("-inf")


def _split_merge(q, kp, vp, tables, offs, splits, pages, window=None, sm_scale=None,
                 softcap=0.0, k_scale=None, v_scale=None):
    """A plain PyTorch model of the split-K decode kernels' walk over the
    G * T rows of each (batch row, kv head), folded g-major, t-minor (row
    g * T + t sits at position offset + t): each split s of ``pages`` table
    pages gives a partial (m, l, acc) per row over the keys it holds that
    the row sees — (-inf, 0, 0) when it holds none — and the merge weighs
    them in split order, an empty split by exactly 0; a row with no visible
    key gets 0. f32 throughout: P stays in f32, as the f32 decode kernel
    keeps it (the bf16 kernel's rounding of P to bf16 is the identity
    here)."""
    B, T, H, hd = q.shape
    Hkv, _, BS, _ = kp.shape
    MB = tables.shape[1]
    G = H // Hkv
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    win = port._window_int(window)
    tb = tables.long()
    kg = port._gathered(kp, k_scale, tb, q.dtype)  # [B, Hkv, MB*BS, hd]
    vg = port._gathered(vp, v_scale, tb, q.dtype)
    qr = q.reshape(B, T, Hkv, G, hd).permute(0, 2, 3, 1, 4).reshape(B, Hkv, G * T, hd)
    s = torch.einsum("bkrd,bksd->bkrs", qr.float(), kg) * sm_scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qpos = offs.long()[:, None] + torch.arange(T).repeat(G)[None]  # [B, G*T]
    pos = torch.arange(MB * BS)
    parts = []
    for sp in range(splits):
        lo = sp * pages * BS
        hi = min((sp + 1) * pages, MB) * BS - 1
        kmax = torch.clamp(qpos, max=hi)
        kmin = torch.clamp(qpos - win + 1 if win > 0 else torch.zeros_like(qpos), min=lo)
        vis = ((pos >= kmin[..., None]) & (pos <= kmax[..., None]))[:, None]
        sv = torch.where(vis, s, NEG)
        m = sv.amax(-1)  # -inf where the split holds no visible key
        p = torch.where(vis, torch.exp(sv - torch.where(m == NEG, 0.0, m)[..., None]), 0.0)
        parts.append((m, p.sum(-1), torch.einsum("bkrs,bksd->bkrd", p, vg)))
    m_all = torch.stack([m for m, l, _ in parts])
    l_all = torch.stack([l for _, l, _ in parts])
    mx = torch.where(l_all > 0, m_all, NEG).amax(0)
    L = torch.zeros_like(mx)
    O = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(l > 0, torch.exp(m - torch.where(mx == NEG, 0.0, mx)), 0.0)
        L = L + l * w
        O = O + acc * w[..., None]
    O = O / torch.where(L > 0, L, 1.0)[..., None]
    return O.reshape(B, Hkv, G, T, hd).permute(0, 3, 1, 2, 4).reshape(B, T, H * hd)


# rows ragged over a 256-key table (BS 8: four key tiles), so the planned
# splits include empty ones for the short rows; a dead row (all-null
# table, stale offset), a row at offset -1, window + softcap + score scale
DECODE_CASES = {
    "ragged_lengths": (dict(offs=[0, 7, 8, 21, 100, 200], T=1, H=8, Hkv=2, hd=16,
                            extra_tables=6, seed=31), {}),
    "dead_row_and_minus_one": (dict(offs=[-1, 50, 130, 90], T=1, H=8, Hkv=2, hd=16,
                                    dead=(1,), extra_tables=10, seed=32), {}),
    "window_softcap_scale": (dict(offs=[5, 70, 129, 200], T=1, H=8, Hkv=2, hd=16,
                                  extra_tables=5, seed=33),
                             dict(window=24, sm_scale=1.0 / math.sqrt(256),
                                  softcap=30.0)),
}


def _decode_plans(B, Hkv, MB, BS):
    """The kernel's plan on a card of 24 SMs (two to four splits of whole
    key tiles at these shapes), and one page a split (the most empty
    splits)."""
    return {"planned": port.decode_splits(B, Hkv, MB, BS, 24), "page_a_split": (MB, 1)}


@pytest.mark.parametrize("plan", ["planned", "page_a_split"])
@pytest.mark.parametrize("name", sorted(DECODE_CASES))
@pytest.mark.parametrize("int8", [False, True], ids=["pool", "int8_pool"])
def test_decode_split_merge_model_matches_jax_kernel(name, int8, plan):
    geo, kw = DECODE_CASES[name]
    q, kp, vp, tables, offs = _pool_case(**geo)
    scales = {}
    if int8:
        (kp, ks), (vp, vs) = _quantize_pool(kp), _quantize_pool(vp)
        scales = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    want = np.asarray(jax_ragged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(offs), window=kw.get("window"), sm_scale=kw.get("sm_scale"),
        logit_softcap=kw.get("softcap", 0.0), interpret=True, **scales,
    ))
    B, Hkv, MB, BS = len(offs), kp.shape[0], tables.shape[1], kp.shape[2]
    splits, pages = _decode_plans(B, Hkv, MB, BS)[plan]
    assert splits > 1
    t = {k: torch.from_numpy(np.array(v)) for k, v in scales.items()}
    got = _split_merge(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(offs), splits, pages,
        **kw, **t,
    ).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)
    if name == "dead_row_and_minus_one":
        assert not got[0].any()  # offset -1: every split empty, the row is 0


# ------------------------------- the f32 decode kernel: rule, plan, model


@functools.lru_cache(maxsize=None)
def _jax_decode_case(name, int8, T):
    """(numpy inputs, kwargs, the JAX interpret kernel's result) of a
    DECODE_CASES geometry with chunks of T queries, for both plans."""
    geo, kw = DECODE_CASES[name]
    q, kp, vp, tables, offs = _pool_case(**dict(geo, T=T))
    scales = {}
    if int8:
        (kp, ks), (vp, vs) = _quantize_pool(kp), _quantize_pool(vp)
        scales = dict(k_scale=ks, v_scale=vs)
    want = np.asarray(jax_ragged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(offs), window=kw.get("window"), sm_scale=kw.get("sm_scale"),
        logit_softcap=kw.get("softcap", 0.0), interpret=True,
        **{k: jnp.asarray(v) for k, v in scales.items()},
    ))
    return (q, kp, vp, tables, offs), dict(kw, **scales), want


@pytest.mark.parametrize("plan", ["planned", "page_a_split"])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("name", sorted(DECODE_CASES))
@pytest.mark.parametrize("int8", [False, True], ids=["pool", "int8_pool"])
def test_decode_f32_split_merge_model_matches_jax_kernel(name, int8, T, plan):
    """The f32 decode kernel's walk (decode and a 3-long chunk: G * T = 12
    rows a kv head, each at its own position) with its own plan (32-key
    tiles, on a card of 24 SMs) and with one page a split, within 2e-5 of
    the JAX kernel on both pool forms."""
    (q, kp, vp, tables, offs), kw, want = _jax_decode_case(name, int8, T)
    B, Hkv, MB, BS = len(offs), kp.shape[0], tables.shape[1], kp.shape[2]
    splits, pages = {"planned": port.decode_f32_splits(B, Hkv, MB, BS, 24),
                     "page_a_split": (MB, 1)}[plan]
    assert splits > 1
    t = {k: torch.from_numpy(v) for k, v in kw.items() if k in ("k_scale", "v_scale")}
    rest = {k: v for k, v in kw.items() if k not in t}
    got = _split_merge(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(offs), splits, pages, **rest, **t,
    ).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)
    if name == "dead_row_and_minus_one":
        assert not got[0, 0].any()  # offset -1: the first query sees nothing


@pytest.mark.parametrize("hd", [64, 96, 128, 256])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32_pool", "int8_pool"])
def test_decode_tile_and_decode_f32_rules_are_disjoint(quantized, hd):
    """Each f32 chunk goes to exactly one of the f32 decode kernel and the
    f32 tile form (never to the row kernel), each bf16 chunk to exactly one
    of the decode and tile kernels; the f32 decode kernel takes what fits
    its rows below the crossover."""
    for T in (1, 2, 3, 5, 8, 9, 16, 17, 64):
        for group in (1, 2, 4, 8, 32):
            for dtype in (torch.bfloat16, torch.float32):
                rules = [port.use_decode_kernel(dtype, T, hd),
                         port.use_tile_kernel(dtype, T, hd, quantized, group),
                         port.use_decode_f32_kernel(dtype, T, hd, quantized, group)]
                assert sum(rules) == 1, (dtype, T, group)
                assert port.ragged_kernel(dtype, T, hd, quantized, group) != "row"
            fits = (group * T <= port.DECODE_F32_MAX_ROWS
                    and T < port._t_min_f32(hd, quantized))
            assert port.use_decode_f32_kernel(torch.float32, T, hd, quantized,
                                              group) is fits, (T, group)


@pytest.mark.parametrize("heads", ["llama-3-8b", "gemma-2-9b", "phi-3-mini"])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32_pool", "int8_pool"])
def test_f32_rule_names_no_row_kernel_at_served_heads(quantized, heads):
    """At llama-3-8b's heads (32/8, hd 128) and gemma-2-9b's (16/8, hd 256)
    f32 decode and every short chunk go to the f32 decode kernel (as far as
    its 32 rows hold them, every chunk below the crossover) or the f32 tile
    form, never to the row kernel; decode always to the f32 decode
    kernel."""
    group, hd = {"llama-3-8b": (4, 128), "gemma-2-9b": (2, 256),
                 "phi-3-mini": (1, 96)}[heads]
    for T in (1, 2, 3, 4, 5, 8, 16, 17, 64):
        kernel = port.ragged_kernel(torch.float32, T, hd, quantized, group)
        fits = group * T <= port.DECODE_F32_MAX_ROWS
        assert kernel == ("decode_f32" if fits and T < port._t_min_f32(hd, quantized)
                          else "tile_f32"), T
    assert port.ragged_kernel(torch.float32, 1, hd, quantized, group) == "decode_f32"


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("MB,BS", [(128, 16), (256, 8), (64, 32), (5, 8), (33, 16)])
def test_decode_f32_splits_cover_the_table_in_whole_tiles(B, MB, BS):
    """The f32 plan at llama-3-8b's 8 kv heads on 132 SMs: whole 32-key
    tiles a split (the C entry point refuses others), at most
    DECODE_F32_MAX_SPLIT_TILES, more than one only where the grid holds a
    block per SM, and the splits cover the MB pages exactly."""
    n_sm = 132
    splits, pages = port.decode_f32_splits(B, 8, MB, BS, n_sm)
    assert isinstance(splits, int) and isinstance(pages, int)
    assert (pages * BS) % port.DECODE_F32_TILE_KEYS == 0
    tiles = pages * BS // port.DECODE_F32_TILE_KEYS
    assert 1 <= tiles <= port.DECODE_F32_MAX_SPLIT_TILES
    assert tiles == 1 or B * 8 * splits >= n_sm
    assert (splits - 1) * pages < MB <= splits * pages


@pytest.mark.parametrize("B,MB,BS,want", [
    (8, 64, 16, (4, 16)),  # the timed decode: B=8 at a 1024-token context
    (1, 128, 16, (22, 6)),  # B=1 over 2048 keys
    (8, 128, 16, (8, 16)),  # the slice's 2048-token tables
])
def test_decode_f32_splits_at_the_timed_shapes(B, MB, BS, want):
    """The plans chip_smoke.py prints beside the f32 decode timings (8 kv
    heads, 132 SMs); the bf16 decode kernel's plan is not touched."""
    assert port.decode_f32_splits(B, 8, MB, BS, 132) == want
    assert port.decode_splits(8, 8, 64, 16, 132) == (4, 16)


def test_decode_f32_splits_read_shapes_only():
    """The plan is a function of python ints (cached), never of a tensor,
    as the bf16 decode kernel's."""
    import inspect

    params = inspect.signature(port.decode_f32_splits.__wrapped__).parameters
    assert list(params) == ["B", "Hkv", "MB", "BS", "n_sm"]
    assert all(p.annotation in (int, "int") for p in params.values())
    assert port.decode_f32_splits(8, 8, 128, 16, 132) is port.decode_f32_splits(
        8, 8, 128, 16, 132)


@pytest.mark.parametrize("T", [1, "below_t_min"])
@pytest.mark.parametrize("hd", [64, 96, 128, 256])
@pytest.mark.parametrize("int8", [False, True], ids=["f32_pool", "int8_pool"])
def test_f32_decode_kernel_args_accepted(int8, hd, T):
    """Decode and the longest chunk below the crossover whose rows still
    fit (8 query heads over 2 kv heads: G = 4)."""
    if T == "below_t_min":
        T = min(port._t_min_f32(hd, int8) - 1, port.DECODE_F32_MAX_ROWS // 4)
    assert port.ragged_kernel(torch.float32, T, hd, int8, group=4) == "decode_f32"
    port._check_kernel_args(**_f32_args(T=T, hd=hd, int8=int8))


@pytest.mark.parametrize("bad,err,match", [
    ("misaligned_q", ValueError, "q is not 16-byte aligned"),
    ("misaligned_pool", ValueError, "k_pool is not 16-byte aligned"),
    ("bf16_pool", TypeError, "pool dtype"),
    ("f32_scales_missing_pool", TypeError, "pool dtype"),
    ("head_dim", ValueError, "head_dim 80"),
    ("pool_width", ValueError, "do not match head_dim"),
    ("scale_shape", ValueError, "k_scale must be float32"),
])
def test_f32_decode_kernel_args_rejected(bad, err, match):
    """The f32 decode kernel copies q rows and pages in 16-byte pieces and
    takes an f32 pool, or an int8 pool with [Hkv, NB] scales, at a
    head_dim it is built for."""
    args = _f32_args(T=1, int8=bad == "scale_shape")
    if bad == "misaligned_q":
        args["q"] = torch.zeros(2 * 8 * 128 + 1)[1:].view(2, 1, 8, 128)
    elif bad == "misaligned_pool":
        n = 2 * 9 * 16 * 128
        args["k_pool"] = torch.zeros(n + 1)[1:].view(2, 9, 16, 128)
    elif bad == "bf16_pool":
        args["k_pool"] = args["v_pool"] = args["k_pool"].to(torch.bfloat16)
    elif bad == "f32_scales_missing_pool":
        args["k_scale"] = args["v_scale"] = torch.ones((2, 9))
    elif bad == "head_dim":
        args = _f32_args(T=1, hd=80)
    elif bad == "pool_width":
        args["k_pool"] = args["v_pool"] = torch.zeros((2, 9, 16, 64))
    elif bad == "scale_shape":
        args["k_scale"] = torch.ones((2, 8))
    assert port.ragged_kernel(torch.float32, 1, 128, group=4) == "decode_f32"
    with pytest.raises(err, match=match):
        port._check_kernel_args(**args)


def test_forced_f32_decode_launch_refuses_rows_past_its_block():
    """Forced by name, the f32 decode kernel refuses G * T rows past the 32
    a block holds, before anything reaches the card; the rule sends such a
    chunk to the f32 tile form."""
    a = _f32_args(T=9, hd=128)  # 4 query heads a kv head: 36 rows
    with pytest.raises(ValueError, match="ragged decode_f32 kernel: 4 x 9 query rows"):
        port._launch_kernel(a["q"], a["k_pool"], a["v_pool"], a["block_tables"], a["off"],
                            0, 0.125, 0.0, None, None, kernel="decode_f32")
    assert port.ragged_kernel(torch.float32, 9, 128, group=4) == "tile_f32"


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("int8", [False, True], ids=["f32_pool", "int8_pool"])
def test_cpu_dispatch_counts_no_f32_decode_launch(int8, T):
    """f32 decode and a short f32 chunk, which the rule sends to the f32
    decode kernel, take the plain version on the CPU and leave every
    counter at 0, the f32 decode kernel's two included."""
    q, kp, vp, tables, offs = (torch.from_numpy(a) for a in _pool_case(
        offs=[4, 9, 30], T=T, H=8, Hkv=2, hd=64, seed=27))
    kw = {}
    if int8:
        (kp, ks), (vp, vs) = (tuple(torch.from_numpy(a) for a in _quantize_pool(p.numpy()))
                              for p in (kp, vp))
        kw = dict(k_scale=ks, v_scale=vs)
    assert port.ragged_kernel(q.dtype, T, 64, int8, group=4) == "decode_f32"
    got = port.ragged_paged_attention(q, kp, vp, tables, offs, **kw)
    assert torch.equal(got, port.ragged_paged_attention_ref(q, kp, vp, tables, offs, **kw))
    for name in port.LAUNCH_COUNTERS:
        assert getattr(port.ragged_paged_attention, name) == 0, name


def test_launch_counters_name_the_f32_decode_kernel():
    """The counters a captured decode graph's replay adds back include the
    f32 decode kernel's, for both pool forms."""
    assert {"f32_decode_launches", "int8_f32_decode_launches"} <= set(port.LAUNCH_COUNTERS)
    assert port._COUNTERS["decode_f32"] == "f32_decode_launches"
    assert port.ragged_paged_attention.f32_decode_launches == 0
    assert port.ragged_paged_attention.int8_f32_decode_launches == 0


# ------------------------------------------ the f32 tile form's checks


def _f32_args(T=32, hd=128, int8=False, **over):
    """Arguments of the f32 tile form's launch checks, on the CPU."""
    args = _tile_args(T=T, hd=hd, int8=int8)
    args["q"] = args["q"].float()
    if not int8:
        args["k_pool"] = args["k_pool"].float()
        args["v_pool"] = args["v_pool"].float()
    args.update(over)
    return args


@pytest.mark.parametrize("T", ["t_min", 32])
@pytest.mark.parametrize("hd", [64, 96, 128, 256])
@pytest.mark.parametrize("int8", [False, True], ids=["f32_pool", "int8_pool"])
def test_f32_tile_kernel_args_accepted(int8, hd, T):
    if T == "t_min" and hd == 256:
        T = port.T_MIN_F32_INT8_HD256 if int8 else port.T_MIN_F32_HD256
    elif T == "t_min":
        T = port._t_min_f32(hd, int8)
    assert port.ragged_kernel(torch.float32, T, hd, int8) == "tile_f32"
    port._check_kernel_args(**_f32_args(T=T, hd=hd, int8=int8))


@pytest.mark.parametrize("bad,err,match", [
    ("misaligned_q", ValueError, "q is not 16-byte aligned"),
    ("bf16_pool", TypeError, "pool dtype"),
    ("f32_scales_missing_pool", TypeError, "pool dtype"),
    ("head_dim", ValueError, "head_dim 80"),
    ("pool_width", ValueError, "do not match head_dim"),
])
def test_f32_tile_kernel_args_rejected(bad, err, match):
    """The f32 tile form copies q rows in 16-byte pieces and takes an f32
    pool, or an int8 pool with scales, at a head_dim it is built for."""
    args = _f32_args()
    if bad == "misaligned_q":
        n = 2 * 32 * 8 * 128
        args["q"] = torch.zeros(n + 1)[1:].view(2, 32, 8, 128)
    elif bad == "bf16_pool":
        args["k_pool"] = args["v_pool"] = args["k_pool"].to(torch.bfloat16)
    elif bad == "f32_scales_missing_pool":  # scales beside an f32 pool
        args["k_scale"] = args["v_scale"] = torch.ones((2, 9))
    elif bad == "head_dim":
        args = _f32_args(hd=80)
    elif bad == "pool_width":
        args["k_pool"] = args["v_pool"] = torch.zeros((2, 9, 16, 64))
    with pytest.raises(err, match=match):
        port._check_kernel_args(**args)


@pytest.mark.parametrize("kernel,dtype", [("tile_f32", torch.bfloat16),
                                          ("tile", torch.float32),
                                          ("decode", torch.float32),
                                          ("decode_f32", torch.bfloat16)])
def test_forced_launch_needs_the_kernels_query_type(kernel, dtype):
    """A kernel forced by name refuses queries of a type it is not built
    for, before anything reaches the card."""
    a = _f32_args(T=1)
    q = a["q"].to(dtype)
    kp, vp = (a[n].to(dtype) for n in ("k_pool", "v_pool"))
    with pytest.raises(TypeError, match=f"ragged {kernel} kernel"):
        port._launch_kernel(q, kp, vp, a["block_tables"], a["off"], 0, 0.125, 0.0,
                            None, None, kernel=kernel)


@pytest.mark.parametrize("kernel,hd", [("tile", 256), ("decode", 256),
                                       ("tile_hd256", 128), ("decode_hd256", 64),
                                       ("tile_f32", 80), ("decode_f32", 80)])
def test_forced_launch_needs_the_kernels_head_dim(kernel, hd):
    """A kernel forced by name refuses a head_dim it is not built for: the
    bf16 head_dim-256 forms take 256 only, the others never 256; the f32
    tile form and the f32 decode kernel take 64, 96, 128 and 256."""
    dtype = torch.float32 if kernel.endswith("f32") else torch.bfloat16
    a = _tile_args(T=1, hd=hd)
    q, kp, vp = (a[n].to(dtype) for n in ("q", "k_pool", "v_pool"))
    with pytest.raises(ValueError, match=f"ragged {kernel} kernel: head_dim {hd}"):
        port._launch_kernel(q, kp, vp, a["block_tables"], a["off"], 0, 0.0625, 0.0,
                            None, None, kernel=kernel)


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pool", "int8_pool"])
def test_cpu_dispatch_counts_no_hd256_launch(int8, T):
    """bf16 at head_dim 256, which the rule sends to the decode and tile
    kernels' head_dim-256 forms, still takes the plain version on the CPU
    and counts no launch."""
    q, kp, vp, tables, offs = (torch.from_numpy(a) for a in _pool_case(
        offs=[4, 30], T=T, H=2, Hkv=1, hd=256, seed=26))
    q = q.to(torch.bfloat16)
    kw = {}
    if int8:
        (kp, ks), (vp, vs) = (tuple(torch.from_numpy(a) for a in _quantize_pool(p.numpy()))
                              for p in (kp, vp))
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    assert port.ragged_kernel(q.dtype, T, 256, int8).endswith("_hd256")
    got = port.ragged_paged_attention(q, kp, vp, tables, offs, **kw)
    assert torch.equal(got, port.ragged_paged_attention_ref(q, kp, vp, tables, offs, **kw))
    for name in ("hd256_prefill_launches", "int8_hd256_prefill_launches",
                 "hd256_decode_launches", "int8_hd256_decode_launches", "launches",
                 "int8_launches"):
        assert getattr(port.ragged_paged_attention, name) == 0, name


@pytest.mark.parametrize("int8", [False, True], ids=["f32_pool", "int8_pool"])
def test_cpu_dispatch_counts_no_f32_tile_launch(int8):
    """f32 queries the rule sends to the f32 tile form still take the plain
    version on the CPU and count no launch."""
    T = port.T_MIN_F32_INT8 if int8 else port.T_MIN_F32
    q, kp, vp, tables, offs = (torch.from_numpy(a) for a in _pool_case(
        offs=[4, 9, 30], T=T, H=8, Hkv=2, hd=64, seed=20))
    kw = {}
    if int8:
        (kp, ks), (vp, vs) = (tuple(torch.from_numpy(a) for a in _quantize_pool(p.numpy()))
                              for p in (kp, vp))
        kw = dict(k_scale=ks, v_scale=vs)
    assert port.ragged_kernel(q.dtype, T, 64, int8, group=4) == "tile_f32"
    got = port.ragged_paged_attention(q, kp, vp, tables, offs, **kw)
    assert torch.equal(got, port.ragged_paged_attention_ref(q, kp, vp, tables, offs, **kw))
    assert port.ragged_paged_attention.f32_prefill_launches == 0
    assert port.ragged_paged_attention.int8_f32_prefill_launches == 0


# ------------------- the f32 tile form's arithmetic, modelled on the CPU


def _ragged_model(q, kp, vp, tables, offs, window=None, sm_scale=None, softcap=0.0,
                  k_scale=None, v_scale=None, products=3, key_orders=None):
    """The f32 tile form's arithmetic (tests/tf32_attention_model.py) over
    the rows' gathered pages, an int8 page dequantized in f32."""
    B, T, H, hd = q.shape
    Hkv, _, BS, _ = kp.shape
    MB = tables.shape[1]
    G = H // Hkv
    tb = torch.from_numpy(tables).long()
    kg, vg = (port._gathered(torch.from_numpy(p), None if s is None else torch.from_numpy(s),
                             tb, torch.float32).numpy()
              for p, s in ((kp, k_scale), (vp, v_scale)))  # [B, Hkv, MB*BS, hd]
    qr = q.reshape(B, T, Hkv, G, hd).transpose(0, 2, 3, 1, 4)  # [B, Hkv, G, T, hd]
    pos = offs.astype(np.int64)[:, None] + np.arange(T)[None]  # [B, T]
    kpos = np.arange(MB * BS)[None, None]
    vis = kpos <= pos[:, :, None]
    if window:
        vis &= kpos > pos[:, :, None] - window
    o = attention_tf32(qr, kg[:, :, None], vg[:, :, None], vis[:, None, None],
                       sm_scale or 1.0 / math.sqrt(hd), softcap, products, key_orders)
    return o.transpose(0, 3, 1, 2, 4).reshape(B, T, H * hd)


# f32 pool: decode with a dead row, a chunk with window + softcap + score
# scale, a row at offset -1; int8 pool: a ragged chunk, window + softcap
TF32_CASES = {
    "f32_decode_dead_row": (dict(offs=[9, 4, 30], T=1, H=8, Hkv=2, hd=16, dead=(1,),
                                 extra_tables=2, seed=41), {}, False),
    "f32_window_softcap": (dict(offs=[5, 40], T=20, H=8, Hkv=2, hd=16, seed=42),
                           dict(window=9, sm_scale=1.0 / math.sqrt(13), softcap=30.0),
                           False),
    "f32_offset_minus_one": (dict(offs=[-1, 12], T=1, H=8, Hkv=2, hd=16, seed=43), {},
                             False),
    "int8_chunk": (dict(offs=[3, 29], T=17, H=8, Hkv=2, hd=16, seed=44), {}, True),
    "int8_window_softcap": (dict(offs=[6, 19, 33], T=2, H=8, Hkv=2, hd=16, seed=45),
                            dict(window=9, sm_scale=1.0 / math.sqrt(13), softcap=30.0),
                            True),
}


def _tf32_case(name):
    """(model arguments, the JAX interpret kernel's result) of a case."""
    geo, kw, int8 = TF32_CASES[name]
    q, kp, vp, tables, offs = _pool_case(**geo)
    scales = {}
    if int8:
        (kp, ks), (vp, vs) = _quantize_pool(kp), _quantize_pool(vp)
        scales = dict(k_scale=ks, v_scale=vs)
    want = np.asarray(jax_ragged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(offs), window=kw.get("window"), sm_scale=kw.get("sm_scale"),
        logit_softcap=kw.get("softcap", 0.0), interpret=True,
        **{k: jnp.asarray(v) for k, v in scales.items()},
    ))
    return (q, kp, vp, tables, offs), dict(kw, **scales), want


@pytest.mark.parametrize("name", sorted(TF32_CASES))
def test_tf32_model_matches_jax_kernel(name):
    """3xTF32 within 1e-5 of the JAX kernel (interpret mode); one TF32
    product lands further away on the same inputs."""
    args, kw, want = _tf32_case(name)
    got = _ragged_model(*args, **kw)
    one = _ragged_model(*args, **kw, products=1)
    err3 = np.abs(got - want).max()
    err1 = np.abs(one - want).max()
    assert np.isfinite(got).all()
    assert err3 <= TF32_ATOL
    assert err1 > max(err3, TF32_ATOL)
    if name == "f32_offset_minus_one":
        assert not got[0].any()  # the row sees nothing: 0, not NaN


def test_tf32_model_needs_the_kernels_key_order():
    """The C -> A step must keep each value in its row, and the V rows the
    B fragment reads must follow the keys the A fragment holds: with V
    read in the fragment's own order (rows t, t + 4) the model misses the
    JAX kernel by far more than the tolerance."""
    with pytest.raises(AssertionError, match="another row"):
        pv_key_orders(c_of_a=(0, 1, 2, 3))
    a_keys, b_keys = pv_key_orders()
    assert a_keys == b_keys == [0, 2, 4, 6, 1, 3, 5, 7]
    assert [kernel_v_row(lane, e) for lane in range(4) for e in range(2)] == list(range(8))
    args, kw, want = _tf32_case("int8_chunk")
    naive = pv_key_orders(v_row=lambda lane, e: lane % 4 + 4 * e)
    err = np.abs(_ragged_model(*args, **kw, key_orders=naive) - want).max()
    assert err > 100 * TF32_ATOL
