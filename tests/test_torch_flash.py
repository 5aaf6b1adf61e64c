"""The PyTorch port's flash attention (bee2bee_tpu_torch/ops/flash.py)
against the JAX kernel (bee2bee_tpu/ops/flash.py) run in pallas interpret
mode on the CPU.

Both see the same queries, keys and values, made from a seed with numpy.
The cases are those of tests/test_ops_flash.py: MHA, GQA, lengths that do
not divide the blocks, a scalar and per-row offsets, bf16, T=1 decode
with per-row lengths, and an empty row (offset -1 gives 0), all inside
the contract offset + T <= S; plus the non-causal form and its shape
rule. Tolerance 2e-5 absolute at f32 (the same math, summed in another
order); 2e-2 at bf16, where both round the output (and the JAX kernel its
probabilities) to bf16. On the CPU the wrapper takes the plain version
and counts no launch.

The f32 tile kernel's arithmetic (3xTF32 products, P kept in f32, the
permuted key order of its C -> A step) is modelled on the CPU by
tests/tf32_attention_model.py and held against the JAX kernel within
1e-5; a model with one TF32 product must land further away.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bee2bee_tpu.ops import flash_attention as jax_flash
from bee2bee_tpu_torch.ops import flash as port
from tf32_attention_model import attention_tf32

ATOL = 2e-5
BF16_ATOL = 2e-2
# the 3xTF32 model against the JAX kernel: what the TF32 operands drop
# (~2^-22 of a product) plus f32 summation order
TF32_ATOL = 1e-5


def _qkv(B, T, H, Hkv, hd, S=None, seed=0):
    rng = np.random.default_rng(seed)
    S = S or T
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    return q, k, v


def _both(q, k, v, offset=None, causal=True, block_q=128, block_k=128,
          dtype=torch.float32):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    joff = None if offset is None else jnp.asarray(offset, jnp.int32)
    want = jax_flash(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        offset=joff, causal=causal, block_q=block_q, block_k=block_k,
        interpret=True,
    )
    toff = None if offset is None else torch.as_tensor(np.asarray(offset, np.int32))
    got = port.flash_attention(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)), offset=toff,
        causal=causal, block_q=block_q, block_k=block_k,
    )
    return got, np.asarray(want.astype(jnp.float32))


CASES = {
    "mha": (dict(B=2, T=64, H=4, Hkv=4, hd=16), dict(block_q=16, block_k=16)),
    "gqa": (dict(B=2, T=32, H=8, Hkv=2, hd=8, seed=1), dict(block_q=16, block_k=8)),
    # 33 % 16 != 0: the JAX kernel pads T and S, the port does not
    "nondivisible": (dict(B=1, T=33, H=4, Hkv=4, hd=8, seed=2),
                     dict(block_q=16, block_k=16)),
    "scalar_offset": (dict(B=1, T=8, H=4, Hkv=4, hd=8, S=64, seed=3),
                      dict(offset=20, block_q=8, block_k=16)),
    "per_row_offsets": (dict(B=2, T=4, H=2, Hkv=2, hd=8, S=32, seed=5),
                        dict(offset=[3, 17], block_q=8, block_k=8)),
    # decode: one query per row at offset = length - 1
    "decode_t1_per_row_lengths": (dict(B=2, T=1, H=8, Hkv=2, hd=8, S=64, seed=8),
                                  dict(offset=[39, 8], block_k=16)),
    # lengths [0, 5]: row 0 is empty (offset -1) and must give 0
    "empty_row": (dict(B=2, T=1, H=4, Hkv=2, hd=8, S=32, seed=11),
                  dict(offset=[-1, 4], block_k=16)),
    "non_causal": (dict(B=2, T=16, H=4, Hkv=2, hd=8, S=32, seed=12),
                   dict(causal=False, block_q=8, block_k=16)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ref_matches_jax_kernel(name):
    geo, kw = CASES[name]
    got, want = _both(*_qkv(**geo), **kw)
    assert got.dtype == torch.float32
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    if name == "empty_row":
        assert not got[0].any()


def test_bf16_keeps_dtype_and_matches_jax_kernel():
    got, want = _both(*_qkv(1, 32, 4, 4, 16, seed=7), block_q=16, block_k=16,
                      dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL)


@pytest.mark.parametrize("fn", [port.flash_attention, jax_flash],
                         ids=["port", "jax"])
def test_non_causal_needs_s_divisible_by_block_k(fn):
    q, k, v = _qkv(1, 8, 2, 2, 8, S=20)
    lib = torch.from_numpy if fn is port.flash_attention else jnp.asarray
    with pytest.raises(ValueError, match="S divisible by block_k"):
        fn(lib(q), lib(k), lib(v), causal=False, block_k=8)


def test_cpu_dispatch_takes_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 4, 4, 2, 8, S=16, seed=13))
    off = torch.tensor([2, 9], dtype=torch.int32)
    got = port.flash_attention(q, k, v, offset=off)
    want = port.flash_attention_ref(q, k, v, offset=off)
    assert torch.equal(got, want)
    assert port.flash_attention.launches == 0


def test_dispatch_raises_off_cpu_and_cuda():
    """No silent fallback: a device with no kernel raises."""
    q = torch.zeros((1, 1, 4, 16), device="meta")
    kv = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        port.flash_attention(q, kv, kv)


@pytest.mark.parametrize("dtype,hd,kernel", [
    (torch.bfloat16, 128, "tile"),
    (torch.bfloat16, 64, "tile"),
    (torch.bfloat16, 256, "tile_hd256"),  # the resident-Q form
    (torch.float32, 128, "tile_f32"),  # f32: the 3xTF32 tile kernel
    (torch.float32, 64, "tile_f32"),
    (torch.float32, 256, "tile_f32"),
    (torch.float16, 128, "row"),  # no kernel takes f16: the checks raise
    (torch.bfloat16, 96, "tile"),  # phi-3's heads: Q in registers
    (torch.float32, 96, "tile_f32"),
], ids=["bf16_hd128", "bf16_hd64", "bf16_hd256", "f32", "f32_hd64", "f32_hd256",
        "f16", "bf16_hd96", "f32_hd96"])
def test_dispatch_rule(dtype, hd, kernel):
    assert port.use_tile_kernel(dtype, hd) is (kernel != "row")
    assert port.flash_kernel(dtype, hd) == kernel


def test_kernel_args_need_16_byte_aligned_q():
    """Both kernels copy q in 16-byte pieces or rows."""
    n = 2 * 4 * 4 * 128
    q = torch.zeros(n + 8, dtype=torch.bfloat16)[1:n + 1].view(2, 4, 4, 128)
    kv = torch.zeros((2, 16, 2, 128), dtype=torch.bfloat16)
    off = torch.zeros(2, dtype=torch.int32)
    port._check_kernel_args(q.clone(), kv, kv, off)
    with pytest.raises(ValueError, match="q is not 16-byte aligned"):
        port._check_kernel_args(q, kv, kv, off)


def test_cpu_dispatch_counts_no_tile_launch():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 16, 4, 2, 16, S=32, seed=14))
    got = port.flash_attention(q, k, v, offset=8)
    assert torch.equal(got, port.flash_attention_ref(q, k, v, offset=8))
    assert port.flash_attention.tile_launches == 0


@pytest.mark.parametrize("kernel,hd,dtype", [("tile", 256, torch.bfloat16),
                                             ("tile_hd256", 128, torch.bfloat16),
                                             ("tile_f32", 80, torch.float32)])
def test_forced_launch_needs_the_kernels_head_dim(kernel, hd, dtype):
    """A kernel forced by name refuses a head_dim it is not built for."""
    q = torch.zeros((1, 4, 2, hd), dtype=dtype)
    kv = torch.zeros((1, 16, 1, hd), dtype=dtype)
    off = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match=f"flash {kernel} kernel: head_dim {hd}"):
        port._launch_kernel(q, kv, kv, off, True, 0.0625, kernel=kernel)


def test_cpu_dispatch_counts_no_hd256_tile_launch():
    """bf16 at head_dim 256, which the rule sends to the tile kernel's
    head_dim-256 form, still takes the plain version on the CPU."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 8, 2, 1, 256, S=16, seed=16))
    assert port.flash_kernel(q.dtype, 256) == "tile_hd256"
    got = port.flash_attention(q, k, v, offset=8)
    assert torch.equal(got, port.flash_attention_ref(q, k, v, offset=8))
    assert port.flash_attention.hd256_tile_launches == 0
    assert port.flash_attention.launches == 0


def test_cpu_dispatch_counts_no_f32_tile_launch():
    """f32 at a head_dim the rule tiles still takes the plain version on
    the CPU."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 4, 2, 64, S=32, seed=15))
    assert port.flash_kernel(q.dtype, 64) == "tile_f32"
    got = port.flash_attention(q, k, v, offset=8)
    assert torch.equal(got, port.flash_attention_ref(q, k, v, offset=8))
    assert port.flash_attention.f32_tile_launches == 0


# ------------------------------------------- the f32 tile kernel's checks


def _f32_args(hd=128, **over):
    args = dict(q=torch.zeros((2, 4, 4, hd)), k=torch.zeros((2, 16, 2, hd)),
                v=torch.zeros((2, 16, 2, hd)), off=torch.zeros(2, dtype=torch.int32))
    args.update(over)
    return args


@pytest.mark.parametrize("hd", [64, 96, 128, 256])
def test_f32_tile_kernel_args_accepted(hd):
    port._check_kernel_args(**_f32_args(hd))


@pytest.mark.parametrize("bad,err,match", [
    ("misaligned_q", ValueError, "q is not 16-byte aligned"),
    ("bf16_kv", TypeError, "k/v dtype"),
    ("head_dim", ValueError, "head_dim 80"),
    ("kv_width", ValueError, "do not match"),
])
def test_f32_tile_kernel_args_rejected(bad, err, match):
    """The f32 tile kernel copies q, k and v rows in 16-byte pieces and
    takes f32 k/v beside f32 queries at a head_dim it is built for."""
    args = _f32_args()
    if bad == "misaligned_q":
        n = 2 * 4 * 4 * 128
        args["q"] = torch.zeros(n + 1)[1:].view(2, 4, 4, 128)
    elif bad == "bf16_kv":
        args["k"] = args["v"] = args["k"].to(torch.bfloat16)
    elif bad == "head_dim":
        args = _f32_args(80)
    elif bad == "kv_width":
        args["k"] = args["v"] = torch.zeros((2, 16, 2, 64))
    with pytest.raises(err, match=match):
        port._check_kernel_args(**args)


@pytest.mark.parametrize("kernel,dtype", [("tile_f32", torch.bfloat16),
                                          ("tile", torch.float32)])
def test_forced_launch_needs_the_kernels_query_type(kernel, dtype):
    """A tile kernel forced by name refuses queries of the other type
    before anything reaches the card."""
    a = _f32_args()
    q, k, v = (a[n].to(dtype) for n in ("q", "k", "v"))
    with pytest.raises(TypeError, match=f"flash {kernel} kernel"):
        port._launch_kernel(q, k, v, a["off"], True, 0.125, kernel=kernel)


# ---------------------- the f32 tile kernel's arithmetic, modelled on the CPU


def _flash_model(q, k, v, offset=None, causal=True, products=3):
    """The f32 tile kernel's arithmetic (tests/tf32_attention_model.py)
    over flash's layout: rows of (kv head, group, position), keys [0, S)."""
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qr = q.reshape(B, T, Hkv, G, hd).transpose(0, 2, 3, 1, 4)  # [B, Hkv, G, T, hd]
    kr = k.transpose(0, 2, 1, 3)[:, :, None]  # [B, Hkv, 1, S, hd]
    vr = v.transpose(0, 2, 1, 3)[:, :, None]
    vis = np.ones((1, 1, 1, T, S), bool)
    if causal:
        off = np.broadcast_to(np.asarray(offset or 0, np.int64).reshape(-1), (B,))
        qpos = off[:, None] + np.arange(T)[None]
        vis = (np.arange(S)[None, None] <= qpos[:, :, None])[:, None, None]
    o = attention_tf32(qr, kr, vr, vis, 1.0 / np.sqrt(hd), products=products)
    return o.transpose(0, 3, 1, 2, 4).reshape(B, T, H * hd)


@pytest.mark.parametrize("name", ["gqa", "per_row_offsets", "empty_row", "non_causal"])
def test_tf32_model_matches_jax_kernel(name):
    """3xTF32 within 1e-5 of the JAX kernel (interpret mode) on the cases
    above; one TF32 product lands further away on the same inputs."""
    geo, kw = CASES[name]
    q, k, v = _qkv(**geo)
    joff = kw.get("offset")
    want = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        offset=None if joff is None else jnp.asarray(joff, jnp.int32),
        causal=kw.get("causal", True), block_q=kw.get("block_q", 128),
        block_k=kw.get("block_k", 128), interpret=True,
    ))
    got = _flash_model(q, k, v, joff, kw.get("causal", True))
    one = _flash_model(q, k, v, joff, kw.get("causal", True), products=1)
    err3 = np.abs(got - want).max()
    err1 = np.abs(one - want).max()
    assert err3 <= TF32_ATOL
    assert err1 > max(err3, TF32_ATOL)
    if name == "empty_row":
        assert not got[0].any()
