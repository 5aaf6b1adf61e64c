"""phi-3-mini's geometry in the PyTorch port against the JAX package, at
tiny size: head_dim 96 (32 query heads over 32 kv heads, G = 1, at full
width), where the card's kernels gained their head_dim-96 forms, and a
sliding window that binds.

- The plain ragged version (what the card's kernels are held to) against
  JAX's ``ragged_paged_attention`` in pallas interpret mode at head_dim 96
  and G = 1: decode across block boundaries, a verify chunk, a prefill
  chunk, each with the window binding, and the same over an int8 pool.
  Tolerance 2e-5 absolute: the same f32 math, summed in another order.
- The plain flash version against JAX's ``flash_attention`` in interpret
  mode at head_dim 96, at the same tolerance.
- ``tiny-phi3-hd96`` (phi-3's llama branch: 2 heads of 96 over 2, a
  16-token window on every layer, an untied head; norm scales drawn 1 +
  N(0, 0.01) in place of JAX's ones), one numpy tree in both packages: a
  40-token prefill (past the window) and 3 decode steps give JAX's logits
  within 1e-4 over an f32 pool and 1e-3 over an int8 pool (int8 rounding
  of a value on a grid boundary can flip one step); the engines' greedy
  tokens equal the JAX engine's over both pools, on prompts longer than
  the window.
- The dispatch at head_dim 96, G = 1, names the forms the card runs, and
  the card check takes phi-3-mini.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee2bee_tpu.engine import EngineConfig as JaxEngineConfig
from bee2bee_tpu.engine import InferenceEngine as JaxEngine
from bee2bee_tpu.models import config as jconfig
from bee2bee_tpu.models import core as jcore
from bee2bee_tpu.ops import flash_attention as jax_flash
from bee2bee_tpu.ops import ragged_paged_attention as jax_ragged
from bee2bee_tpu.ops.ragged import make_ragged_attn_fn
from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
from bee2bee_tpu_torch.engine.engine import check_card_supported
from bee2bee_tpu_torch.models import config, core
from bee2bee_tpu_torch.models.params import params_from_numpy
from bee2bee_tpu_torch.ops import flash, ragged
from test_torch_ragged import _pool_case, _quantize_pool

ATOL = 2e-5
LOGIT_ATOL = 1e-4
INT8_LOGIT_ATOL = 1e-3
HD = 96
WINDOW = 16
# phi-3's llama branch at tiny width: head_dim 96, G = 1, every layer
# windowed, untied head
TINY = dict(name="tiny-phi3-hd96", d_model=2 * HD, n_heads=2, n_kv_heads=2, d_ff=256,
            sliding_window=WINDOW, tie_embeddings=False)
KW = dict(max_seq_len=128, kv_block_size=16, decode_chunk=4, prefill_buckets=(32,),
          max_batch=2)
# two prompts of one prefill bucket, both past the window
PROMPTS = ([5, 6, 7, 8, 9, 10, 11, 12] * 3 + [40, 41], [400, 3, 77] * 9)
NEW = 10


# ------------------------------------------------------------ the ops


RAGGED_CASES = {
    # decode rows below, at and past block boundaries; two past the window
    "decode": (dict(offs=[0, 7, 8, 21, 40], T=1), {}),
    "decode_window": (dict(offs=[3, 15, 16, 17, 40], T=1), dict(window=WINDOW)),
    # a speculative verify chunk (K + 1 = 5) at rows of different depths
    "verify_window": (dict(offs=[2, 15, 24, 37], T=5), dict(window=WINDOW)),
    # a prefill chunk the window cuts mid-chunk; a null-block table tail
    "prefill_window": (dict(offs=[0, 11], T=32, extra_tables=2), dict(window=WINDOW)),
    # a retired row: its whole table null, a stale offset
    "dead_row": (dict(offs=[9, 30], T=1, dead=(1,)), dict(window=WINDOW)),
}


def _ragged_both(case, int8: bool, window=None):
    q, kp, vp, tables, offs = case
    scales, tscales = {}, {}
    if int8:
        (kp, ks), (vp, vs) = _quantize_pool(kp), _quantize_pool(vp)
        scales = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tscales = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    want = jax_ragged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
                      jnp.asarray(offs), window=window, interpret=True, **scales)
    got = ragged.ragged_paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(offs), window=window, **tscales)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("int8", [False, True], ids=["f32_pool", "int8_pool"])
@pytest.mark.parametrize("name", sorted(RAGGED_CASES))
def test_ragged_at_head_dim_96_matches_jax_kernel(name, int8):
    """The plain version at phi-3's head_dim and G = 1 against the JAX
    kernel in interpret mode (2e-5): the CPU wrapper takes it and counts
    no launch."""
    geo, kw = RAGGED_CASES[name]
    case = _pool_case(**geo, H=2, Hkv=2, hd=HD, BS=8, seed=sorted(RAGGED_CASES).index(name))
    before = dict(vars(ragged.ragged_paged_attention))
    got, want = _ragged_both(case, int8, **kw)
    assert got.shape == (case[0].shape[0], case[0].shape[1], 2 * HD)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert dict(vars(ragged.ragged_paged_attention)) == before


def test_window_binds_at_head_dim_96():
    """The window changes the result of a row past it (the cases above
    would pass with a window that binds on nothing)."""
    case = _pool_case(offs=[40], T=1, H=2, Hkv=2, hd=HD, BS=8, seed=9)
    windowed, _ = _ragged_both(case, False, window=WINDOW)
    full, _ = _ragged_both(case, False)
    assert np.abs(windowed - full).max() > 1e-2


FLASH_CASES = {
    "causal": (dict(B=2, T=48, S=48), dict(block_q=16, block_k=16)),
    "offsets": (dict(B=2, T=8, S=64), dict(offset=[3, 40], block_q=8, block_k=16)),
    "non_causal": (dict(B=1, T=16, S=32), dict(causal=False, block_q=8, block_k=16)),
}


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_at_head_dim_96_matches_jax_kernel(name):
    geo, kw = FLASH_CASES[name]
    rng = np.random.default_rng(sorted(FLASH_CASES).index(name))
    B, T, S = geo["B"], geo["T"], geo["S"]
    q = rng.standard_normal((B, T, 2, HD)).astype(np.float32)
    k = rng.standard_normal((B, S, 2, HD)).astype(np.float32)
    v = rng.standard_normal((B, S, 2, HD)).astype(np.float32)
    off = kw.pop("offset", None)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     offset=None if off is None else jnp.asarray(off, jnp.int32),
                     interpret=True, **kw)
    got = flash.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        offset=None if off is None else torch.tensor(off, dtype=torch.int32), **kw)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# ------------------------------------------------------------ the model


def _cfgs():
    return (dataclasses.replace(jconfig.get_config("tiny-llama"), **TINY),
            dataclasses.replace(config.get_config("tiny-llama"), **TINY))


@functools.lru_cache(maxsize=None)
def _tree() -> dict:
    """The JAX init of tiny-phi3-hd96 (layers stacked) with every norm scale
    drawn 1 + N(0, 0.01): read only."""
    jcfg, _ = _cfgs()
    tree = jax.device_get(jcore.init_params(jcfg, jax.random.key(0), dtype=jnp.float32))
    rng = np.random.default_rng(1)
    for norm in (tree["final_norm"], tree["layers"]["ln1"], tree["layers"]["ln2"]):
        norm["scale"] = (1.0 + 0.1 * rng.standard_normal(norm["scale"].shape)).astype(
            np.float32)
    return tree


def test_tiny_config_has_phi3_geometry():
    jcfg, cfg = _cfgs()
    assert cfg.head_dim == jcfg.head_dim == HD
    assert cfg.n_heads == cfg.n_kv_heads
    assert (cfg.sliding_window, cfg.sliding_window_every) == (WINDOW, 1)
    core.check_supported(cfg)
    # the preset it stands in for
    mini, jmini = config.get_config("phi-3-mini"), jconfig.get_config("phi-3-mini")
    assert (mini.head_dim, mini.n_heads, mini.n_kv_heads, mini.sliding_window,
            mini.max_seq_len, mini.tie_embeddings) == (96, 32, 32, 2047, 4096, False)
    assert dataclasses.asdict(mini) == dataclasses.asdict(jmini)


@pytest.mark.parametrize("pool", ["float32", "int8"])
def test_forward_prefill_past_the_window_then_decode_matches_jax(pool):
    """A 40-token prefill (positions past the 16-token window) and 3
    greedy decode steps, JAX on its ragged kernel in interpret mode: the
    logits of every call within 1e-4 (f32 pool) or 1e-3 (int8 pool)."""
    jcfg, cfg = _cfgs()
    tree = _tree()
    params = params_from_numpy(tree, cfg, "cpu", torch.float32)
    int8 = pool == "int8"
    atol = INT8_LOGIT_ATOL if int8 else LOGIT_ATOL
    BS, NB, T = 8, 8, 40
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 500, size=(1, T)).astype(np.int32)
    tables = np.arange(1, 7, dtype=np.int32)[None]  # 48 positions
    attn = make_ragged_attn_fn(interpret=True)
    jpool = jcore.init_paged_pool(jcfg, NB, BS, jnp.int8 if int8 else jnp.float32)
    tpool = core.init_paged_pool(cfg, NB, BS, torch.int8 if int8 else torch.float32)
    toks = ids
    for step in range(4):
        off = 0 if step == 0 else T + step - 1
        jl, jpool = jcore.forward(tree, jcfg, jnp.asarray(toks), jpool,
                                  jnp.asarray([off], jnp.int32), attn_fn=attn,
                                  block_tables=jnp.asarray(tables))
        tl, tpool = core.forward(params, cfg, torch.from_numpy(toks).long(), tpool,
                                 torch.tensor([off], dtype=torch.int32),
                                 torch.from_numpy(tables))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol, rtol=0)
        toks = np.asarray(jl)[:, -1:].argmax(-1).astype(np.int32)


def _jax_tokens(cache_dtype: str) -> tuple:
    jcfg, _ = _cfgs()
    eng = JaxEngine(jcfg, params=_tree(), engine_config=JaxEngineConfig(
        dtype="float32", cache_dtype=cache_dtype, **KW))
    try:
        return tuple(tuple(eng.generate(p, max_new_tokens=NEW, temperature=0.0).token_ids)
                     for p in PROMPTS)
    finally:
        eng.close()


@pytest.mark.parametrize("pool", ["float32", "int8"])
def test_engine_greedy_tokens_equal_jax(pool):
    """The port's engine (block tables, the scheduler, sampling) on prompts
    past the window: the JAX engine's greedy tokens, token for token."""
    _, cfg = _cfgs()
    eng = InferenceEngine(cfg, params=params_from_numpy(_tree(), cfg, "cpu", torch.float32),
                          device="cpu", engine_config=EngineConfig(
                              dtype="float32", cache_dtype=pool, **KW))
    try:
        got = tuple(tuple(eng.generate(p, max_new_tokens=NEW, temperature=0.0).token_ids)
                    for p in PROMPTS)
    finally:
        eng.close()
    assert got == _jax_tokens(pool)


# ------------------------------------------------------------ the card's rules


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_or_f32_pool", "int8_pool"])
def test_dispatch_at_head_dim_96(int8):
    """phi-3's heads (G = 1, hd 96): bf16 decode the decode kernel, bf16
    chunks the tile kernel; f32 chunks below the f32 crossover at hd 96
    decode_f32, from it the f32 tile form; every form is built at 96."""
    t_min = ragged._t_min_f32(HD, int8)
    assert ragged.ragged_kernel(torch.bfloat16, 1, HD, int8, group=1) == "decode"
    for T in (2, 5, 512):
        assert ragged.ragged_kernel(torch.bfloat16, T, HD, int8, group=1) == "tile"
    for T in (1, 5, t_min - 1):
        assert ragged.ragged_kernel(torch.float32, T, HD, int8, group=1) == "decode_f32"
    for T in (t_min, 512):
        assert ragged.ragged_kernel(torch.float32, T, HD, int8, group=1) == "tile_f32"
    assert all(HD in dims for dims in (ragged._KERNEL_HEAD_DIMS[k] for k in
                                       ("decode", "tile", "tile_f32", "decode_f32", "row")))
    assert flash.flash_kernel(torch.bfloat16, HD) == "tile"
    assert flash.flash_kernel(torch.float32, HD) == "tile_f32"


@pytest.mark.parametrize("over", [
    dict(), dict(cache_dtype="int8"), dict(dtype="float32", cache_dtype="float32"),
    dict(cache_dtype="int8", quantize="int8")], ids=["bf16", "int8_pool", "f32", "int8_int8"])
def test_card_takes_phi3_mini(over):
    check_card_supported(config.get_config("phi-3-mini"), EngineConfig(**over), "cuda")
