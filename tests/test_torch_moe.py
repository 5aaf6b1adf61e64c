"""Mixture of experts in the PyTorch port against the JAX package, at tiny
size: ``tiny-mixtral`` (4 experts of width 128, 2 a token) and
``tiny-qwen3moe`` (qwen3's q/k norms beside 4 experts of width 32), on the
CPU, where the grouped expert GEMM runs its plain version.

- The port's ``_moe`` against JAX ``_moe`` (dense) and ``_moe_routed``
  (with a capacity factor that drops assignments): f32 within 1e-5 of the
  largest |output|; bf16 (bf16 and int8 experts) by the relative rule,
  the port no further from the f32 function than twice JAX's own bf16
  result is, with the router logits rounded alike.
- The plan: JAX's top-k on tied logits (the lower expert first), the
  softmax weights, and the counts, offsets, row order and tile map on
  hand-checked inputs, with and without a capacity.
- The plain grouped product against a per-token loop, for dense and int8
  experts.
- Engines: greedy tokens equal to the JAX engine's in f32 over an f32 and
  an int8 pool in both ``moe_impl``s, a prefix-cache hit and an n-gram
  spec run among them; attention-target adapter rows on tiny-mixtral
  equal the JAX adapter engine's, and MLP targets are refused as JAX
  refuses them.
- The random init of an int8 engine quantizes as it draws: its CPU peak
  within 1.05 x (the int8 model + its largest dense tensor), its values
  those of quantizing the dense init; the card check takes the MoE
  presets and refuses an expert width the kernel does not take.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bee2bee_tpu.engine import EngineConfig as JaxEngineConfig
from bee2bee_tpu.engine import InferenceEngine as JaxEngine
from bee2bee_tpu.models import config as jconfig
from bee2bee_tpu.models import core as jcore
from bee2bee_tpu.models import quant as jquant
from bee2bee_tpu.train import lora as jlora
from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
from bee2bee_tpu_torch.engine.engine import check_card_supported
from bee2bee_tpu_torch.models import config, core, quant
from bee2bee_tpu_torch.models.params import init_params, params_from_numpy
from bee2bee_tpu_torch.ops import moe
from bee2bee_tpu_torch.train import lora

NAMES = ["tiny-mixtral", "tiny-qwen3moe"]
F32_TOL = 1e-5
KW = dict(max_seq_len=128, kv_block_size=16, decode_chunk=4, prefill_buckets=(16, 32, 64),
          max_batch=4)
PROMPTS = ([5, 6, 7, 8, 9, 10, 11, 12], [400, 3, 77] * 5)
NEW = 12
# a factor under 1 makes JAX's routed impl drop assignments at these sizes
DROP_FACTOR = 0.5


@functools.lru_cache(maxsize=None)
def _tree(name: str, seed: int = 0) -> dict:
    """The JAX init's numpy tree (f32, layers stacked), read only."""
    jcfg = jconfig.get_config(name)
    return jax.device_get(jcore.init_params(jcfg, jax.random.key(seed), dtype=jnp.float32))


def _moe_layer(name: str) -> dict:
    """Layer 0's moe subtree of the JAX init, numpy f32."""
    return {k: np.asarray(v[0]) for k, v in _tree(name)["layers"]["moe"].items()}


def _torch_tree(p: dict, dtype=torch.float32) -> dict:
    """A numpy moe subtree as tensors: int8 {"q", "s"} kept, the rest
    ``dtype`` (bf16 from its f32 values)."""
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out[k] = {"q": torch.from_numpy(np.array(v["q"])),
                      "s": torch.from_numpy(np.array(v["s"], np.float32))}
        else:
            out[k] = torch.from_numpy(np.array(v, np.float32)).to(dtype)
    return out


def _cfgs(name: str, impl: str = "dense", factor: float = 1.25, group: int = 512):
    over = dict(moe_impl=impl, moe_capacity_factor=factor, moe_group_size=group)
    return (dataclasses.replace(jconfig.get_config(name), **over),
            dataclasses.replace(config.get_config(name), **over))


def _x(cfg, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((3, 7, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------------- the layer


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("impl,factor,group", [("dense", 1.25, 512), ("routed", 1.25, 512),
                                               ("routed", DROP_FACTOR, 8)])
@pytest.mark.parametrize("name", NAMES)
def test_moe_f32_matches_jax(name, impl, factor, group, int8):
    jcfg, cfg = _cfgs(name, impl, factor, group)
    p = _moe_layer(name)
    if int8:
        p = jquant.quantize_params({"moe": p})["moe"]
    x = _x(cfg)
    want = np.asarray(jcore._moe(jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg))
    got = core._moe(torch.from_numpy(x), _torch_tree(p), cfg).numpy()
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()
    if factor == DROP_FACTOR:  # the routed impl really dropped assignments
        plan = moe.moe_plan((torch.from_numpy(x.reshape(-1, cfg.d_model))
                             @ _torch_tree(p)["router"]).float(), cfg.n_experts_per_tok,
                            moe.routed_capacity(21, cfg.n_experts_per_tok, cfg.n_experts,
                                                group, factor))
        assert 0 < int(plan.keep.sum()) < 21 * cfg.n_experts_per_tok
        dense = np.asarray(jcore._moe(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                                      dataclasses.replace(jcfg, moe_impl="dense")))
        assert np.abs(dense - want).max() > 1e-3


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_moe_bf16_by_the_relative_rule(name, int8):
    """bf16 x and experts (or int8 experts): the router logits equal
    JAX's bit for bit (the product in bf16, then f32), and the port's
    output is no further from the f32 function of the same bf16 values, in
    the relative Frobenius norm, than twice JAX's bf16 output is."""
    jcfg, cfg = _cfgs(name)
    p = {k: np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
         for k, v in _moe_layer(name).items()}
    if int8:
        p = dict(p, **{k: v for k, v in jquant.quantize_params({"moe": p})["moe"].items()
                       if k != "router"})
    x = np.asarray(jnp.asarray(_x(cfg), jnp.bfloat16).astype(jnp.float32))
    jp16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16)
                        if np.asarray(a).dtype == np.float32 and a.ndim > 1 else jnp.asarray(a),
                        p)
    want16 = np.asarray(jcore._moe(jnp.asarray(x, jnp.bfloat16), jp16, jcfg)
                        .astype(jnp.float32))
    f32 = np.asarray(jcore._moe(jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg))
    tp = _torch_tree(p, torch.bfloat16)
    x16 = torch.from_numpy(np.array(x)).to(torch.bfloat16)
    jlog = np.asarray((jnp.asarray(x, jnp.bfloat16) @ jp16["router"]).astype(jnp.float32))
    tlog = (x16 @ tp["router"]).float().numpy()
    assert np.array_equal(jlog, tlog)
    got = core._moe(x16, tp, cfg).float().numpy()
    rel = np.linalg.norm(got - f32) / np.linalg.norm(f32)
    jrel = np.linalg.norm(want16 - f32) / np.linalg.norm(f32)
    assert 0 < rel <= 2 * jrel


# ------------------------------------------------------------- the plan


def _experts_of(plan) -> torch.Tensor:
    """Each assignment's expert from the plan (E where dropped)."""
    return torch.searchsorted(plan.offsets.long(), plan.inv, right=True) - 1


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_on_tied_logits_picks_jax_experts(k):
    """Logits over 3 levels tie at the k-th place in most rows: the plan's
    experts are ``lax.top_k``'s, in its order (the lower index first), and
    the weights its softmax over the k."""
    logits = np.random.default_rng(7).integers(0, 3, (64, 8)).astype(np.float32)
    plan = moe.moe_plan(torch.from_numpy(logits), k)
    topv, topi = jax.lax.top_k(jnp.asarray(logits), k)
    assert np.array_equal(_experts_of(plan).reshape(64, k).numpy(), np.asarray(topi))
    np.testing.assert_allclose(plan.weights.reshape(64, k).numpy(),
                               np.asarray(jax.nn.softmax(topv, axis=-1)), rtol=1e-6)


# tokens 0..4 route (by descending logit) to experts (2, 0), (2, 1), (3, 2),
# (0, 2), (2, 3): assignments 0..9 go to experts 2 0 2 1 3 2 0 2 2 3
HAND_LOGITS = [[2, 0, 3, 1], [0, 2, 3, 1], [0, 1, 2, 3], [3, 0, 2, 1], [1, 0, 3, 2]]


def test_plan_counts_offsets_and_tiles_by_hand():
    plan = moe.moe_plan(torch.tensor(HAND_LOGITS, dtype=torch.float32), 2, br=2)
    # expert 0: assignments 1, 6; 1: 3; 2: 0, 2, 5, 7, 8; 3: 4, 9
    order = [1, 6, 3, 0, 2, 5, 7, 8, 4, 9]
    assert plan.offsets.tolist() == [0, 2, 3, 8, 10]
    assert plan.tok.tolist() == [a // 2 for a in order]
    assert [order.index(a) for a in range(10)] == plan.inv.tolist()
    # tiles of 2 rows: 1 + 1 + 3 + 1 of the bound ceil(10 / 2) + 4 = 9
    assert plan.tile_expert.tolist() == [0, 1, 2, 2, 2, 3, 4, 4, 4]
    assert plan.tile_row.tolist()[:6] == [0, 2, 3, 5, 7, 8]
    assert plan.keep is None and plan.br == 2 and plan.n_tiles == 9
    assert plan.tile_count.tolist() == [6] and plan.tile_count.dtype == torch.int32
    assert moe.tile_rows(10, 4) == 8 and moe.tile_rows(16384, 128) == 128
    assert moe.tile_rows(80, 8) == 16 and moe.tile_bound(64, 128, 8) == 136


def test_routed_plan_drops_what_jax_drops_by_hand():
    """Groups of 3 tokens, capacity 1: in group 0 (assignments 0-5) the
    second and third to expert 2 drop, in group 1 (6-9) the second to
    expert 2; the dropped sort after every kept row, weight 0."""
    plan = moe.moe_plan(torch.tensor(HAND_LOGITS, dtype=torch.float32), 2, (3, 1), br=2)
    assert plan.keep.tolist() == [1, 1, 0, 1, 1, 0, 1, 1, 0, 1]
    assert plan.offsets.tolist() == [0, 2, 3, 5, 7]
    order = [1, 6, 3, 0, 7, 4, 9, 2, 5, 8]
    assert [order.index(a) for a in range(10)] == plan.inv.tolist()
    assert plan.weights[~plan.keep].tolist() == [0.0, 0.0, 0.0]
    assert plan.tile_expert.tolist() == [0, 1, 2, 3, 4, 4, 4, 4, 4]
    assert plan.tile_row.tolist()[:4] == [0, 2, 3, 5]
    assert moe.routed_capacity(21, 2, 4, 8, 0.5) == (8, 2)
    assert moe.routed_capacity(5, 8, 128, 512, 1.25) == (5, 1)


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_grouped_product_equals_a_per_token_loop(int8):
    rng = np.random.default_rng(11)
    E, K, N, T, k = 4, 64, 128, 9, 2
    w = rng.standard_normal((E, K, N)).astype(np.float32) / 8
    ws = quant.quantize_weight_torch(torch.from_numpy(w)) if int8 else torch.from_numpy(w)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32))
    plan = moe.moe_plan(torch.from_numpy(rng.standard_normal((T, E)).astype(np.float32)), k)
    y = moe.moe_expert_matmul(x, plan.tok, plan, [ws])[0]
    experts = _experts_of(plan)
    for a in range(T * k):
        e, row = int(experts[a]), int(plan.inv[a])
        want = (x[a // k] @ ws["q"][e].float()) * ws["s"][e] if int8 else x[a // k] @ ws[e]
        torch.testing.assert_close(y[row], want, rtol=1e-6, atol=1e-6)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    plan = moe.moe_plan(torch.zeros((4, 4)), 2)
    w = torch.zeros((4, 64, 128))
    with pytest.raises(ValueError, match="no kernel"):
        moe.moe_expert_matmul(torch.zeros((4, 64), device="meta"), plan.tok, plan, [w])
    with pytest.raises(TypeError, match="float16"):
        moe._check_kernel_args(torch.zeros((4, 64), dtype=torch.float16), None, plan, [w])
    with pytest.raises(ValueError, match="K % 32"):
        moe._check_kernel_args(torch.zeros((4, 48)), None, plan, [w])
    with pytest.raises(ValueError, match="N % 64"):
        moe._check_kernel_args(torch.zeros((8, 64)), None, plan, [torch.zeros((4, 64, 96))])


def _tile_map_reference(counts, br: int, bound: int):
    """The tile map of per-expert row counts in numpy: each expert's rows
    cut into tiles of br from its first row, the real tiles first, the
    slots past them naming expert E."""
    E = len(counts)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    experts, rows = [], []
    for e, c in enumerate(counts):
        for j in range(-(-c // br)):
            experts.append(e)
            rows.append(offsets[e] + j * br)
    return experts + [E] * (bound - len(experts)), rows, len(experts)


def _skewed_logits(N: int, E: int, seed: int = 5) -> torch.Tensor:
    """Router logits where expert 0 wins in every token and experts 5 and
    6 in none."""
    logits = np.random.default_rng(seed).standard_normal((N, E)).astype(np.float32)
    logits[:, 0] += 10.0
    logits[:, 5:7] -= 10.0
    return torch.from_numpy(logits)


@pytest.mark.parametrize("br", [128, 256])
def test_plan_tile_map_at_prefill_heights_on_skewed_routing(br):
    """300 tokens, 2 of 8 experts each: expert 0 takes all 300 rows (past
    the tallest tile), experts 5 and 6 none. The tile map at 128 and 256
    rows a tile equals the numpy cut of the counts: expert 0's tiles from
    rows 0, br, 2br below 300, every other expert's from its first row,
    the real tiles counted on the device and first, the rest expert E."""
    N, E, k = 300, 8, 2
    plan = moe.moe_plan(_skewed_logits(N, E), k, br=br)
    counts = (plan.offsets[1:] - plan.offsets[:-1]).tolist()
    assert counts[0] == N and counts[5] == counts[6] == 0 and sum(counts) == N * k
    experts, rows, real = _tile_map_reference(counts, br, plan.n_tiles)
    assert plan.n_tiles == moe.tile_bound(N * k, E, br)
    assert plan.tile_expert.tolist() == experts
    assert plan.tile_row.tolist()[:real] == rows
    assert plan.tile_count.tolist() == [real]
    # by hand: expert 0's rows [0, 300) in tiles from 0, br (and 256 at 128)
    assert rows[:2] == [0, br] and (br == 256 or rows[2] == 256)
    assert experts[:3] == ([0, 0, 0] if br == 128 else [0, 0, 1])


@pytest.mark.parametrize("assignments,experts,dtype,want", [
    (64, 128, torch.bfloat16, 8),  # qwen3-30b-a3b, a B = 8 decode step
    (320, 128, torch.bfloat16, 8),  # its K = 4 verify step
    (80, 8, torch.bfloat16, 16),  # mixtral-8x7b's verify step
    (16384, 128, torch.bfloat16, 128),  # qwen3-30b-a3b, a 2,048-token chunk
    (4096, 8, torch.bfloat16, 256),  # mixtral-8x7b, a 2,048-token chunk
    (65536, 8, torch.bfloat16, 256),  # past the tallest tile
    (16384, 128, torch.float32, 64),  # the FFMA form's tallest
    (4096, 8, torch.float32, 64),
])
def test_tile_rows_at_the_prefill_heights(assignments, experts, dtype, want):
    """The smallest height of x's form that holds the mean rows an
    expert: bf16 x up to 256 rows (the wgmma form), f32 x up to 64."""
    assert moe.tile_rows(assignments, experts, dtype) == want
    logits = torch.zeros((assignments, experts))
    assert moe.moe_plan(logits, 1, dtype=dtype).br == want


@pytest.mark.parametrize("assignments,experts,K,N,want", [
    (16, 8, 14336, 4096, 4),  # mixtral-8x7b's w_down at decode
    (80, 8, 14336, 4096, 4),  # and at verify
    (16, 8, 4096, 2 * 14336, 1),  # its w_up|w_gate: a long grid
    (4096, 8, 14336, 4096, 1),  # a prefill chunk: tall tiles, no split
    (64, 128, 2048, 2 * 768, 1),  # qwen3-30b-a3b: K under SPLIT_MIN_K
    (64, 128, 768, 2048, 1),
    (8, 4, 8192, 64, 8),  # a one-group grid takes the most splits
    (8, 4, 4096, 64, 4),  # each split keeps SPLIT_MIN_INPUTS inputs
])
def test_k_splits_cover_k_and_follow_host_shapes(assignments, experts, K, N, want):
    """The K split of a launch is a function of (A, E, K, N) alone, a power
    of two that cuts K into whole 64-input stages, each split at least
    SPLIT_MIN_INPUTS inputs, and splits only decode-height tiles."""
    splits = moe.k_splits(assignments, experts, K, N)
    assert splits == want == moe.k_splits(assignments, experts, K, N)
    assert splits & (splits - 1) == 0 and K % (moe.INPUTS * splits) == 0
    assert splits == 1 or (K // splits >= moe.SPLIT_MIN_INPUTS
                           and moe.tile_rows(assignments, experts) <= 32)
    bounds = [s * (K // splits) for s in range(splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == K


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_split_partial_sums_in_order_then_one_rounding(int8):
    """A numpy model of the split-K route: each split's f32 partial sums
    over its K range, summed in split order, times the int8 scale, rounded
    to bf16 once, within 2^-6 of the largest |output| of the plain version
    (the product in bf16, then the scale, as JAX rounds it)."""
    rng = np.random.default_rng(13)
    R, K, N, splits = 16, 1024, 128, 4
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    x = bf(rng.standard_normal((R, K)).astype(np.float32))
    if int8:
        w = quant.quantize_weight_torch(torch.from_numpy(
            rng.standard_normal((1, K, N)).astype(np.float32) / np.sqrt(K)))
        wf, scale = w["q"][0].float().numpy(), w["s"][0].numpy()
    else:
        w = bf(rng.standard_normal((1, K, N)).astype(np.float32) / np.sqrt(K))
        wf, scale = w[0].float().numpy(), np.ones(N, np.float32)
    xf = x.float().numpy()
    acc = np.zeros((R, N), np.float32)
    for s in range(splits):
        ks = slice(s * K // splits, (s + 1) * K // splits)
        acc = acc + (xf[:, ks].astype(np.float64) @ wf[ks].astype(np.float64)).astype(np.float32)
    got = torch.from_numpy(acc * scale).to(torch.bfloat16).float()
    plan = moe.moe_plan(torch.zeros((R, 1)), 1)
    want = moe.moe_expert_matmul_ref(x, None, plan, [w])[0].float()
    assert (got - want).abs().max() <= 2.0 ** -6 * want.abs().max()


@pytest.mark.parametrize("case", ["bf16 K % 64", "f32 tall tile", "bf16 odd tile",
                                  "tile count"])
def test_kernel_wrapper_refuses_what_the_wgmma_form_does_not_take(case):
    """bf16 x: K a whole number of 64-input stages, tile heights of the
    wgmma form; f32 x: the FFMA form's heights (at most 64 rows); the
    plan's device tile count int32."""
    w16 = torch.zeros((4, 64, 128), dtype=torch.bfloat16)
    if case == "bf16 K % 64":
        plan = moe.moe_plan(torch.zeros((4, 4)), 2)
        with pytest.raises(ValueError, match="K % 64"):
            moe._check_kernel_args(torch.zeros((8, 96), dtype=torch.bfloat16), None, plan,
                                   [torch.zeros((4, 96, 128), dtype=torch.bfloat16)])
    elif case == "f32 tall tile":
        plan = moe.moe_plan(torch.zeros((4, 4)), 2, br=128)
        with pytest.raises(ValueError, match="tile height 128"):
            moe._check_kernel_args(torch.zeros((8, 64)), None, plan, [torch.zeros((4, 64, 128))])
    elif case == "bf16 odd tile":
        plan = moe.moe_plan(torch.zeros((4, 4)), 2, br=24)
        with pytest.raises(ValueError, match="tile height 24"):
            moe._check_kernel_args(torch.zeros((8, 64), dtype=torch.bfloat16), None, plan, [w16])
    else:
        plan = moe.moe_plan(torch.zeros((4, 4)), 2)
        plan.tile_count = plan.tile_count.long()
        with pytest.raises(ValueError, match="tile_count"):
            moe._check_kernel_args(torch.zeros((8, 64), dtype=torch.bfloat16), None, plan, [w16])


# ------------------------------------------------------------- engines


def _jax_engine_tokens(jcfg, pool: str, prompts=PROMPTS, **extra) -> tuple:
    eng = JaxEngine(jcfg, params=_tree(jcfg.name), engine_config=JaxEngineConfig(
        dtype="float32", cache_dtype=pool, **KW, **extra))
    try:
        return tuple(tuple(eng.generate(p, max_new_tokens=NEW, temperature=0.0).token_ids)
                     for p in prompts)
    finally:
        eng.close()


@functools.lru_cache(maxsize=None)
def _jax_tokens(name: str, impl: str, pool: str) -> tuple:
    jcfg, _ = _cfgs(name, impl, DROP_FACTOR if impl == "routed" else 1.25)
    return _jax_engine_tokens(jcfg, pool)


def _port_engine(cfg, pool: str, **extra) -> InferenceEngine:
    return InferenceEngine(cfg, params=params_from_numpy(_tree(cfg.name), cfg, "cpu"),
                           device="cpu", engine_config=EngineConfig(
                               dtype="float32", cache_dtype=pool, **KW, **extra))


@pytest.mark.parametrize("impl", ["dense", "routed"])
@pytest.mark.parametrize("pool", ["float32", "int8"])
def test_engine_greedy_tokens_equal_jax(impl, pool):
    """tiny-mixtral in f32 over an f32 and an int8 pool; the routed impl
    at a capacity factor that drops assignments (the same batch shapes in
    both engines, so the same groups)."""
    _, cfg = _cfgs("tiny-mixtral", impl, DROP_FACTOR if impl == "routed" else 1.25)
    eng = _port_engine(cfg, pool)
    try:
        got = tuple(tuple(eng.generate(p, max_new_tokens=NEW, temperature=0.0).token_ids)
                    for p in PROMPTS)
        assert got == _jax_tokens("tiny-mixtral", impl, pool)
    finally:
        eng.close()


def test_prefix_hit_over_qwen3moe_equals_jax():
    """A second turn that extends the first prompt hits the prefix cache in
    both engines and decodes JAX's tokens."""
    jcfg, cfg = _cfgs("tiny-qwen3moe")
    first = list(range(5, 45))
    prompts = (first, first + [7, 8, 9])
    extra = dict(prefix_cache_entries=2)
    eng = _port_engine(cfg, "float32", **extra)
    try:
        got = tuple(tuple(eng.generate(p, max_new_tokens=NEW, temperature=0.0).token_ids)
                    for p in prompts)
        assert eng.scheduler.stats.prefix_hits >= 1
    finally:
        eng.close()
    assert got == _jax_engine_tokens(jcfg, "float32", prompts, **extra)


def test_ngram_spec_over_mixtral_keeps_the_greedy_tokens():
    _, cfg = _cfgs("tiny-mixtral")
    eng = _port_engine(cfg, "float32", spec_tokens=4)
    try:
        got = tuple(tuple(eng.generate(p, max_new_tokens=NEW, temperature=0.0).token_ids)
                    for p in PROMPTS)
        assert got == _jax_tokens("tiny-mixtral", "dense", "float32")
        assert eng.scheduler.stats.spec_steps > 0
    finally:
        eng.close()


def test_attention_adapter_rows_over_mixtral_match_jax():
    """An adapter row beside a base row over tiny-mixtral (attention
    targets): the JAX adapter engine's tokens; MLP targets are refused by
    both packages."""
    name = "tiny-mixtral"
    jcfg, cfg = jconfig.get_config(name), config.get_config(name)
    targets = ("wq", "wk", "wv", "wo")
    lcfg = lora.LoraConfig(rank=4, alpha=16.0, targets=targets)
    jlcfg = jlora.LoraConfig(rank=4, alpha=16.0, targets=targets)
    for bad in (("w_up",), ("wq", "w_down")):
        with pytest.raises(ValueError):
            jlora.validate_targets(jcfg, jlora.LoraConfig(rank=4, targets=bad))
        with pytest.raises(ValueError):
            lora.validate_targets(cfg, lora.LoraConfig(rank=4, targets=bad))
    io = lora.adapter_target_io(cfg)
    assert io == jlora.adapter_target_io(jcfg)
    rng = np.random.default_rng(4)
    ad = {t: {"a": (rng.standard_normal((cfg.n_layers, io[t][0], 4)) * 0.2).astype(np.float32),
              "b": (rng.standard_normal((cfg.n_layers, 4, io[t][1])) * 0.05).astype(np.float32)}
          for t in targets}
    ecfg = dict(KW, dtype="float32", cache_dtype="float32", max_adapters=1)
    jeng = JaxEngine(name, params=_tree(name), engine_config=JaxEngineConfig(**ecfg))
    eng = InferenceEngine(name, params=params_from_numpy(_tree(name), cfg, "cpu"),
                          device="cpu", engine_config=EngineConfig(**ecfg))
    try:
        jeng.load_adapter("a1", ad, jlcfg)
        eng.load_adapter("a1", ad, lcfg)
        for prompt, adapter in zip(PROMPTS, ("a1", None)):
            want = jeng.generate(prompt, max_new_tokens=NEW, temperature=0.0,
                                 adapter=adapter).token_ids
            assert eng.generate(prompt, max_new_tokens=NEW, temperature=0.0,
                                adapter=adapter).token_ids == want
    finally:
        jeng.close()
        eng.close()


# ------------------------------------------------------------- init and card


def _cpu_peak(fn):
    """(fn's result, the peak of the CPU allocator's bytes while it ran,
    from torch.profiler's memory events: each op's own allocations and
    frees in time order)."""
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        out = fn()
    cur = peak = 0
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        cur += e.self_cpu_memory_usage
        peak = max(peak, cur)
    return out, peak


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("name", NAMES)
def test_int8_init_quantizes_as_it_draws(name):
    """``init_params(quantize=True)``: the values of quantizing the dense
    init (the same draws), and a CPU peak within 1.05 x (the int8 model +
    its largest dense tensor): no layer's dense weights are ever held
    together."""
    cfg = config.get_config(name)
    params, peak = _cpu_peak(lambda: init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                                 torch.float32, quantize=True))
    dense = quant.quantize_params_(init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                               torch.float32))
    got, want = _leaves(params), _leaves(dense)
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    assert set(params["layers"][0]["moe"]["w_up"]) == {"q", "s"}
    model = sum(t.numel() * t.element_size() for t in got)
    largest = max(t.numel() * t.element_size() for t in got if t.is_floating_point()
                  and t.dim() == 2)
    assert peak <= 1.05 * (model + largest)


def test_card_check_takes_the_moe_presets_and_refuses_odd_experts():
    for name in ("mixtral-8x7b", "qwen3-30b-a3b"):
        cfg = config.get_config(name)
        core.check_supported(cfg)
        for quantize in ("none", "int8"):
            check_card_supported(cfg, EngineConfig(quantize=quantize), "cuda")
    odd = dataclasses.replace(config.get_config("qwen3-30b-a3b"), d_ff=760)
    with pytest.raises(NotImplementedError, match="expert GEMM"):
        check_card_supported(odd, EngineConfig(), "cuda")
    for name in NAMES:
        core.check_supported(config.get_config(name))
