"""The PyTorch port's models (bee2bee_tpu_torch/models) against the JAX
package's (bee2bee_tpu/models).

- The config registry is a copy: every entry equals the JAX one.
- ``params_from_numpy`` carries the JAX parameter tree across, stacked
  and unstacked, element for element.
- The paged ``forward`` (prefill chunk, then decode steps) matches
  ``bee2bee_tpu.models.core.forward`` on the block-tables path, with the
  JAX side on its dense attention and on the ragged kernel in interpret
  mode: logits within 1e-4 (f32, same weights; the sums run in another
  order) and the pool blocks written, including the write-ceil/floor
  redirects into the null block, within 1e-5.
- ``_quantized_page_write`` (the int8 pool's quantize-on-write) matches
  ``bee2bee_tpu.models.core._quantized_page_write`` on the same inputs:
  scales equal and int8 bytes equal on every written slot (tolerance 0:
  the same f32 operations in the same order). Slots not yet written may
  differ by design (the port requantizes without a branch).
- The paged ``forward`` over an int8 pool (prefill, then decode) matches
  the JAX ``forward`` with the ragged kernel in interpret mode.
- A config switch the port does not implement raises by name (qwen2's
  q/k/v biases, qwen3's head-wise q/k norms and yarn run:
  tests/test_torch_qwen.py; the gemma family's switches run:
  tests/test_torch_gemma.py).
- The same prefill-then-decode parity at head_dim 256 (the gemma family's,
  which the kernels' head_dim-256 forms serve), with a score softcap and a
  sliding window on every second layer, on a tiny llama-architecture
  config.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bee2bee_tpu.models import config as jconfig
from bee2bee_tpu.models import core as jcore
from bee2bee_tpu.ops.ragged import make_ragged_attn_fn
from bee2bee_tpu_torch.models import config, core
from bee2bee_tpu_torch.models.params import init_params, params_from_numpy

LOGIT_ATOL = 1e-4
POOL_ATOL = 1e-5
INT8_LOGIT_ATOL = 1e-3


@pytest.mark.parametrize("name", sorted(jconfig.CONFIGS))
def test_config_registry_matches_jax(name):
    assert dataclasses.asdict(config.CONFIGS[name]) == dataclasses.asdict(
        jconfig.CONFIGS[name]
    )


@pytest.mark.parametrize("query", ["llama-3-8b", "meta-llama/Meta-Llama-3-8B",
                                   "llama-3", "TINY-LLAMA", "mistral-7b"])
def test_get_config_resolves_like_jax(query):
    assert config.get_config(query).name == jconfig.get_config(query).name


@pytest.mark.parametrize("name", ["tiny-llama", "llama-3-8b", "llama-3-70b", "tiny-mixtral",
                                  "mixtral-8x7b", "qwen3-30b-a3b"])
def test_matmul_params_per_token_matches_jax(name):
    assert core.matmul_params_per_token(config.get_config(name)) == (
        jcore.matmul_params_per_token(jconfig.get_config(name))
    )


@pytest.mark.parametrize("name,switch", [
    ("tiny-bloom", "pos_embedding"),
    ("tiny-gptj", "mlp_bias"),
    ("tiny-mpt", "pos_embedding"),
    ("tiny-olmo2", "no_pre_norms"),
    ("tiny-phi", "parallel_block"),
    ("tiny-olmo2", "qk_norm_full"),
])
def test_unported_switch_raises_by_name(name, switch):
    # qwen3's qk_norm, the yarn rope scaling, the gemma family's switches,
    # the gpt2 block and mixture-of-experts layers run (queue A items 11.3,
    # 11.1, 11.5, 11.4 and 11.7);
    # bloom's alibi, gpt-j's mlp-only bias and olmo2's post-norm-only
    # blocks do not yet
    with pytest.raises(NotImplementedError, match=switch):
        core.check_supported(config.get_config(name))


@functools.lru_cache(maxsize=None)
def _jax_params(name="tiny-llama", seed=0):
    """(config, numpy parameter tree) — built once per name; read only."""
    cfg = jconfig.get_config(name)
    return cfg, jax.device_get(
        jcore.init_params(cfg, jax.random.key(seed), dtype=jnp.float32)
    )


@pytest.mark.parametrize("form", ["stacked", "unstacked"])
def test_params_from_numpy_carries_the_jax_tree(form):
    jcfg, tree = _jax_params()
    if form == "unstacked":
        tree = jcore.unstack_layers(tree)
    got = params_from_numpy(tree, config.get_config("tiny-llama"), "cpu")
    layers = tree["layers"]
    for i, lp in enumerate(got["layers"]):
        for group, leaves in lp.items():
            for leaf, t in leaves.items():
                src = (layers[i][group][leaf] if form == "unstacked"
                       else layers[group][leaf][i])
                np.testing.assert_array_equal(t.numpy(), np.asarray(src))
    np.testing.assert_array_equal(got["tok_embed"].numpy(), tree["tok_embed"])
    assert "lm_head" not in got  # tiny-llama ties its head


def test_init_params_schema_matches_jax():
    """Same tree structure and shapes as core.init_params (the draws
    differ by construction)."""
    jcfg, tree = _jax_params()
    gen = torch.Generator().manual_seed(0)
    got = init_params(config.get_config("tiny-llama"), gen, "cpu", torch.float32)
    want = jcore.unstack_layers(tree)
    assert set(got) == set(want)
    for lp, jlp in zip(got["layers"], want["layers"]):
        assert jax.tree.map(np.shape, jlp) == {
            g: {k: tuple(v.shape) for k, v in d.items()} for g, d in lp.items()
        }


def _run_jax(jcfg, params, ids, tables, offset, pool, attn, **kw):
    return jcore.forward(
        params, jcfg, jnp.asarray(ids), pool, jnp.asarray(offset, jnp.int32),
        attn_fn=attn, block_tables=jnp.asarray(tables), **kw,
    )


@pytest.mark.parametrize("jax_attention", ["dense", "ragged_interpret"])
def test_paged_forward_prefill_then_decode_matches_jax(jax_attention):
    name = "tiny-llama"
    jcfg, tree = _jax_params(name)
    cfg = config.get_config(name)
    params = params_from_numpy(tree, cfg, "cpu")
    attn = make_ragged_attn_fn(interpret=True) if jax_attention != "dense" else None
    BS, NB, B, Tb = 8, 12, 2, 16
    rng = np.random.default_rng(3)
    lens = [11, 16]  # row 0's bucket tail is dropped by the write ceil
    ids = rng.integers(3, 500, size=(B, Tb)).astype(np.int32)
    tables = np.zeros((B, 4), np.int32)  # pow2 width, null tails
    tables[0, :2] = [3, 7]
    tables[1, :3] = [1, 2, 5]
    jpool = jcore.init_paged_pool(jcfg, NB, BS, jnp.float32)
    pool = core.init_paged_pool(cfg, NB, BS, torch.float32)
    # prefill: one [B, Tb] chunk at offset 0; the ceil (11) keeps row 0's
    # padded tail — and row 1's positions >= 11 — out of their blocks
    jl, jpool = _run_jax(jcfg, tree, ids, tables, [0, 0], jpool, attn,
                         paged_write_ceil=jnp.int32(11))
    tl, pool = core.forward(params, cfg, torch.from_numpy(ids).long(), pool, 0,
                            torch.from_numpy(tables), paged_write_ceil=11)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    # decode: two steps at per-row offsets, tokens fed from the JAX argmax
    offs = np.asarray(lens, np.int32)
    cur = np.asarray(jl)[np.arange(B), offs - 1].argmax(-1).astype(np.int32)
    for _ in range(2):
        jl, jpool = _run_jax(jcfg, tree, cur[:, None], tables, offs, jpool, attn)
        tl, pool = core.forward(params, cfg, torch.from_numpy(cur[:, None]).long(),
                                pool, torch.from_numpy(offs),
                                torch.from_numpy(tables))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
        cur = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
        offs = offs + 1
    # every block but the garbage null block 0 holds the same K/V
    for key in ("k", "v"):
        np.testing.assert_allclose(
            pool[key][:, :, 1:].numpy(), np.asarray(jpool[key])[:, :, 1:],
            atol=POOL_ATOL,
        )


# gemma-2's attention geometry on a tiny llama-architecture model: head_dim
# 256 by override, 2 query heads over 1 kv head, scores capped at 50, and a
# 6-key window on every second layer (layer 0) so the 11/16-token prompts
# and the decode steps cross it
HD256 = dict(name="tiny-llama-hd256", n_layers=2, n_heads=2, n_kv_heads=1,
             head_dim_override=256, attn_logit_softcap=50.0, sliding_window=6,
             sliding_window_every=2)


@pytest.mark.parametrize("jax_attention", ["dense", "ragged_interpret"])
def test_paged_forward_at_head_dim_256_matches_jax(jax_attention):
    jcfg = dataclasses.replace(jconfig.get_config("tiny-llama"), **HD256)
    cfg = dataclasses.replace(config.get_config("tiny-llama"), **HD256)
    assert cfg.head_dim == jcfg.head_dim == 256
    core.check_supported(cfg)
    tree = jax.device_get(jcore.init_params(jcfg, jax.random.key(5), dtype=jnp.float32))
    params = params_from_numpy(tree, cfg, "cpu")
    attn = make_ragged_attn_fn(interpret=True) if jax_attention != "dense" else None
    BS, NB, B, Tb = 8, 12, 2, 16
    rng = np.random.default_rng(6)
    ids = rng.integers(3, 500, size=(B, Tb)).astype(np.int32)
    tables = np.zeros((B, 4), np.int32)
    tables[0, :2] = [3, 7]
    tables[1, :3] = [1, 2, 5]
    jpool = jcore.init_paged_pool(jcfg, NB, BS, jnp.float32)
    pool = core.init_paged_pool(cfg, NB, BS, torch.float32)
    jl, jpool = _run_jax(jcfg, tree, ids, tables, [0, 0], jpool, attn,
                         paged_write_ceil=jnp.int32(11))
    tl, pool = core.forward(params, cfg, torch.from_numpy(ids).long(), pool, 0,
                            torch.from_numpy(tables), paged_write_ceil=11)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    offs = np.asarray([11, 16], np.int32)
    cur = np.asarray(jl)[np.arange(B), offs - 1].argmax(-1).astype(np.int32)
    for _ in range(3):
        jl, jpool = _run_jax(jcfg, tree, cur[:, None], tables, offs, jpool, attn)
        tl, pool = core.forward(params, cfg, torch.from_numpy(cur[:, None]).long(),
                                pool, torch.from_numpy(offs), torch.from_numpy(tables))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
        cur = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
        offs = offs + 1
    for key in ("k", "v"):
        np.testing.assert_allclose(
            pool[key][:, :, 1:].numpy(), np.asarray(jpool[key])[:, :, 1:],
            atol=POOL_ATOL,
        )


def test_paged_write_floor_ceil_and_out_of_table_redirect_to_null_block():
    """Positions below the floor, at/after the ceil, or past the table
    write into block 0 only: the mapped blocks keep their old content
    there, exactly as in the JAX forward."""
    name = "tiny-llama"
    jcfg, tree = _jax_params(name)
    cfg = config.get_config(name)
    params = params_from_numpy(tree, cfg, "cpu")
    BS, NB = 8, 6
    rng = np.random.default_rng(4)
    ids = rng.integers(3, 500, size=(1, 16)).astype(np.int32)
    tables = np.asarray([[2, 4]], np.int32)  # covers positions 0..15
    init = rng.standard_normal(
        (cfg.n_layers, cfg.n_kv_heads, NB, BS, cfg.head_dim)
    ).astype(np.float32)
    jpool = {"k": jnp.asarray(init), "v": jnp.asarray(-init)}
    pool = {"k": torch.from_numpy(init.copy()), "v": torch.from_numpy(-init)}
    # offset 4: positions 4..19 — 16..19 fall past the table
    jl, jpool = _run_jax(jcfg, tree, ids, tables, [4], jpool, None,
                         paged_write_floor=jnp.int32(6),
                         paged_write_ceil=jnp.int32(13))
    tl, pool = core.forward(params, cfg, torch.from_numpy(ids).long(), pool, 4,
                            torch.from_numpy(tables), paged_write_floor=6,
                            paged_write_ceil=13)
    for key in ("k", "v"):
        got = pool[key].numpy()
        np.testing.assert_allclose(got[:, :, 1:], np.asarray(jpool[key])[:, :, 1:],
                                   atol=POOL_ATOL)
        # slots 4, 5 (below the floor) and 13..15 (past the ceil) untouched
        block2 = (init if key == "k" else -init)[:, :, 2]
        np.testing.assert_array_equal(got[:, :, 2, 4:6], block2[:, :, 4:6])
        block4 = (init if key == "k" else -init)[:, :, 4]
        np.testing.assert_array_equal(got[:, :, 4, 5:], block4[:, :, 5:])
    # the ceil only drops writes: attention still reads the old content
    # there and the logits agree (positions >= 13 read old pool slots)
    np.testing.assert_allclose(tl.numpy()[:, :9], np.asarray(jl)[:, :9],
                               atol=LOGIT_ATOL)


def test_sliding_window_forward_matches_jax():
    """tiny-mistral's window (4 < the prompt) rides the ragged op's window
    argument; the JAX dense path masks it from the same config."""
    name = "tiny-mistral"
    jcfg, tree = _jax_params(name)
    cfg = config.get_config(name)
    params = params_from_numpy(tree, cfg, "cpu")
    BS, NB = 8, 4
    ids = np.random.default_rng(5).integers(3, 500, size=(1, 12)).astype(np.int32)
    tables = np.asarray([[1, 2]], np.int32)
    jl, _ = _run_jax(jcfg, tree, ids, tables, [0],
                     jcore.init_paged_pool(jcfg, NB, BS, jnp.float32), None)
    tl, _ = core.forward(params, cfg, torch.from_numpy(ids).long(),
                         core.init_paged_pool(cfg, NB, BS, torch.float32), 0,
                         torch.from_numpy(tables))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)


def test_logits_index_selects_rows_before_the_head():
    cfg = config.get_config("tiny-llama")
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu", torch.float32)
    ids = torch.randint(3, 500, (2, 8), generator=torch.Generator().manual_seed(4))
    tables = torch.tensor([[1], [2]], dtype=torch.int32)
    full, _ = core.forward(params, cfg, ids, core.init_paged_pool(cfg, 3, 8, torch.float32),
                           0, tables)
    last, _ = core.forward(params, cfg, ids, core.init_paged_pool(cfg, 3, 8, torch.float32),
                           0, tables, logits_index=torch.tensor([7, 2]))
    assert last.shape == (2, 1, cfg.vocab_size)
    torch.testing.assert_close(last[:, 0], full[torch.arange(2), torch.tensor([7, 2])])


# ------------------------------------------------------------ int8 pool

Q_HKV, Q_NB, Q_BS, Q_HD = 2, 9, 8, 16
Q_TABLES = np.asarray([[1, 4, 7, 2], [3, 5, 8, 6]], np.int32)  # rows own blocks

# each scenario is a list of writes; a write is (offsets, T, amplitude)
# plus optional floor / ceil redirects and blocks whose scales the
# scheduler zeroes (recycles) before the write
WRITE_SCENARIOS = {
    # a prefill, then decode steps under the page's scale and one above it
    "decode": [([0, 0], 12, 1.0), ([12, 12], 1, 0.5), ([13, 13], 1, 0.25),
               ([14, 14], 1, 4.0)],
    # a chunk at a slot offset that crosses two page boundaries
    "prefill_crossing_pages": [([5, 3], 13, 1.0)],
    # a louder write into a page that already holds content
    "scale_grows": [([0, 0], 4, 1.0), ([4, 4], 4, 3.0), ([8, 8], 3, 0.1)],
    # a page recycled to a new tenant: scale zeroed, stale bytes left
    "fresh_zeroed_page": [([0, 0], 16, 2.0), ([0, 0], 5, 0.5, None, None, [1, 3])],
    # positions below the floor / at or past the ceil go to the null block
    "floor_ceil_redirects": [([0, 0], 16, 1.0, 3, 11), ([11, 11], 4, 2.0, 12, 14)],
}


def _write_maps(offs, T, floor=None, ceil=None):
    """blk/slot/wslot [B, T] exactly as both forwards build them."""
    pos = np.asarray(offs, np.int64)[:, None] + np.arange(T)[None, :]
    blk = np.take_along_axis(Q_TABLES, pos // Q_BS, axis=1).astype(np.int64)
    if floor is not None:
        blk = np.where(pos >= floor, blk, 0)
    if ceil is not None:
        blk = np.where(pos < ceil, blk, 0)
    wslot = pos // Q_BS - (np.asarray(offs, np.int64) // Q_BS)[:, None]
    return blk, pos % Q_BS, wslot


@pytest.mark.parametrize("scenario", sorted(WRITE_SCENARIOS))
def test_quantized_page_write_matches_jax(scenario):
    rng = np.random.default_rng(21)
    jpool = jnp.zeros((Q_HKV, Q_NB, Q_BS, Q_HD), jnp.int8)
    jscale = jnp.zeros((Q_HKV, Q_NB), jnp.float32)
    pool = torch.zeros((Q_HKV, Q_NB, Q_BS, Q_HD), dtype=torch.int8)
    scale = torch.zeros((Q_HKV, Q_NB), dtype=torch.float32)
    written = np.zeros((Q_NB, Q_BS), bool)
    for offs, T, amp, *rest in WRITE_SCENARIOS[scenario]:
        floor, ceil, recycle = (rest + [None, None, None])[:3]
        if recycle:
            jscale = jscale.at[:, np.asarray(recycle)].set(0.0)
            scale[:, recycle] = 0.0
            written[recycle] = False
        blk, slot, wslot = _write_maps(offs, T, floor, ceil)
        x = (amp * rng.standard_normal((Q_HKV, len(offs), T, Q_HD))).astype(np.float32)
        jpool, jscale = jcore._quantized_page_write(
            jpool, jscale, jnp.asarray(blk, jnp.int32), jnp.asarray(slot, jnp.int32),
            jnp.asarray(wslot, jnp.int32), jnp.asarray(x),
        )
        core._quantized_page_write(
            pool, scale, torch.from_numpy(blk), torch.from_numpy(slot),
            torch.from_numpy(wslot), torch.from_numpy(x),
        )
        written[blk, slot] = True
        written[0] = False  # the null block is garbage by design
        np.testing.assert_array_equal(scale.numpy()[:, 1:], np.asarray(jscale)[:, 1:])
        np.testing.assert_array_equal(
            pool.numpy()[:, written], np.asarray(jpool)[:, written]
        )
    assert written.any()


def test_int8_pool_forward_prefill_then_decode_matches_jax():
    """tiny-llama, f32 compute, int8 pool: a [B, 16] prefill chunk under a
    write ceil, then two decode steps. Logits within 1e-3: both sides
    quantize the same K/V, but the projections differ by f32 rounding
    (~1e-6), which can move a value across a rounding midpoint and change
    one int8 step of a page (a few 1e-3 of that value)."""
    name = "tiny-llama"
    jcfg, tree = _jax_params(name)
    cfg = config.get_config(name)
    params = params_from_numpy(tree, cfg, "cpu")
    attn = make_ragged_attn_fn(interpret=True)
    BS, NB, B, Tb = 8, 12, 2, 16
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 500, size=(B, Tb)).astype(np.int32)
    tables = np.zeros((B, 4), np.int32)
    tables[0, :2] = [3, 7]
    tables[1, :3] = [1, 2, 5]
    jpool = jcore.init_paged_pool(jcfg, NB, BS, jnp.int8)
    pool = core.init_paged_pool(cfg, NB, BS, torch.int8)
    assert set(pool) == set(jpool) == {"k", "v", "k_scale", "v_scale"}
    jl, jpool = _run_jax(jcfg, tree, ids, tables, [0, 0], jpool, attn,
                         paged_write_ceil=jnp.int32(11))
    tl, pool = core.forward(params, cfg, torch.from_numpy(ids).long(), pool, 0,
                            torch.from_numpy(tables), paged_write_ceil=11)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=INT8_LOGIT_ATOL)
    offs = np.asarray([11, 11], np.int32)
    cur = np.asarray(jl)[:, 10].argmax(-1).astype(np.int32)
    for _ in range(2):
        jl, jpool = _run_jax(jcfg, tree, cur[:, None], tables, offs, jpool, attn)
        tl, pool = core.forward(params, cfg, torch.from_numpy(cur[:, None]).long(),
                                pool, torch.from_numpy(offs),
                                torch.from_numpy(tables))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=INT8_LOGIT_ATOL)
        cur = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
        offs = offs + 1
    for key in ("k_scale", "v_scale"):
        np.testing.assert_allclose(pool[key][:, :, 1:].numpy(),
                                   np.asarray(jpool[key])[:, :, 1:], rtol=1e-5)


def test_int8_pool_without_scales_raises():
    cfg = config.get_config("tiny-llama")
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu", torch.float32)
    pool = core.init_paged_pool(cfg, 3, 8, torch.int8)
    del pool["k_scale"], pool["v_scale"]
    with pytest.raises(ValueError, match="k_scale/v_scale"):
        core.forward(params, cfg, torch.ones((1, 2), dtype=torch.long), pool, 0,
                     torch.tensor([[1]], dtype=torch.int32))
