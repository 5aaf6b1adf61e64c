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
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bee2bee_tpu.ops import flash_attention as jax_flash
from bee2bee_tpu_torch.ops import flash as port

ATOL = 2e-5
BF16_ATOL = 2e-2


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
