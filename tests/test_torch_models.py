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
- A config switch the port does not implement raises by name.
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


@pytest.mark.parametrize("name", sorted(jconfig.CONFIGS))
def test_config_registry_matches_jax(name):
    assert dataclasses.asdict(config.CONFIGS[name]) == dataclasses.asdict(
        jconfig.CONFIGS[name]
    )


@pytest.mark.parametrize("query", ["llama-3-8b", "meta-llama/Meta-Llama-3-8B",
                                   "llama-3", "TINY-LLAMA", "mistral-7b"])
def test_get_config_resolves_like_jax(query):
    assert config.get_config(query).name == jconfig.get_config(query).name


@pytest.mark.parametrize("name", ["tiny-llama", "llama-3-8b", "llama-3-70b"])
def test_matmul_params_per_token_matches_jax(name):
    assert core.matmul_params_per_token(config.get_config(name)) == (
        jcore.matmul_params_per_token(jconfig.get_config(name))
    )


@pytest.mark.parametrize("name,switch", [
    ("tiny-gpt2", "pos_embedding"),
    ("tiny-qwen3", "qk_norm"),
    ("tiny-mixtral", "MoE"),
    ("tiny-gemma", "activation"),
    ("tiny-phi", "parallel_block"),
    ("llama-3.1-8b", "rope_scaling"),
])
def test_unported_switch_raises_by_name(name, switch):
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
