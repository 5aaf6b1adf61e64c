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
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bee2bee_tpu.ops import ragged_paged_attention as jax_ragged
from bee2bee_tpu_torch.ops import ragged as port

ATOL = 2e-5


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


@pytest.mark.parametrize("dtype,T,hd,tile", [
    (torch.bfloat16, 1, 128, False),  # decode: the row kernel
    (torch.bfloat16, port.T_MIN - 1, 128, False),
    (torch.bfloat16, port.T_MIN, 128, True),  # the shortest tiled chunk
    (torch.bfloat16, 5, 128, True),  # a verify chunk
    (torch.bfloat16, 2048, 128, True),  # a prefill bucket
    (torch.bfloat16, 300, 64, True),
    (torch.bfloat16, 300, 256, False),  # no tile instantiation
    (torch.float32, 300, 128, False),  # f32 queries: the row kernel
    (torch.float16, 300, 128, False),
], ids=["decode", "below_t_min", "t_min", "verify", "prefill", "hd64", "hd256",
        "f32", "f16"])
def test_dispatch_rule(dtype, T, hd, tile):
    assert port.use_tile_kernel(dtype, T, hd) is tile


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
    """The tile kernel copies q rows in 16-byte pieces; the row kernel
    (decode) reads q by elements and takes the same storage."""
    q = _misaligned_q(32, 128)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match="q is not 16-byte aligned"):
        port._check_kernel_args(**_tile_args(q=q))
    port._check_kernel_args(**_tile_args(q=_misaligned_q(1, 128)))


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
