"""The gpt2 family and gpt-bigcode in the PyTorch port against the JAX
package, at tiny size: ``tiny-gpt2`` (learned positions, biased layernorms,
the non-gated tanh-gelu MLP, biases on q/k/v/o and on the MLP; 4 heads over
4) and ``tiny-bigcode`` (the same block over one kv head), on one numpy
tree from the JAX init with every bias drawn N(0, 0.25), every layernorm
scale 1 + N(0, 0.01) and every layernorm bias N(0, 0.1) (the JAX init's
zeros and ones would hide a dropped or swapped bias or norm).

- ``check_supported`` takes the family's presets and still refuses the
  other families by name; ``init_params`` has JAX's schema
  (``pos_embed``, the norm biases, ``bo``, ``b_up``, ``b_down``, no
  ``w_gate``); ``params_from_numpy`` / ``params_to_numpy`` carry the new
  keys; ``matmul_params_per_token`` agrees with JAX.
- ``_norm``'s layernorm form and both gelu forms equal JAX's functions.
- The paged forward (a prefill chunk under a write ceil, then two decode
  steps) gives JAX's logits, with JAX on its dense attention and on the
  ragged kernel in interpret mode, over an f32 pool (1e-4) and an int8
  pool (1e-3); with int8 weights (1e-4); the rectangular-cache forward
  (the drafter's) gives JAX ``forward``'s.
- Learned positions past the table: the port clamps them into [0, P - 1]
  where JAX's ``jnp.take`` returns NaN rows (and wraps -1); a dead row at
  offset -1, a prefix hit whose bucket runs past the table and decode
  windows past a row's budget run without an index error and emit JAX's
  tokens.
- Checkpoints: JAX ``export_hf`` of tiny-gpt2 (Conv1D) and tiny-bigcode
  (multi_query) and an HF per-head packed ``multi_query=False`` bigcode
  file load bit-equal in both packages; the port's state exporters write
  JAX's tensors (multi_query) or HF's per-head layout.
- Engines: greedy tokens equal the JAX engine's over f32, bf16 and int8
  pools; a mixed LoRA batch (no ``w_gate``) equals the JAX adapter-pool
  engine's tokens; the model drafter proposes JAX's drafts.
- The dispatch at starcoder-15b's G = 48 (hd 128) and gpt2's hd 64, G = 1;
  the card check, the CLI and the node's service take the family.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from bee2bee_tpu.engine import EngineConfig as JaxEngineConfig
from bee2bee_tpu.engine import InferenceEngine as JaxEngine
from bee2bee_tpu.engine import drafter as jdrafter
from bee2bee_tpu.models import config as jconfig
from bee2bee_tpu.models import core as jcore
from bee2bee_tpu.models import export as jexport
from bee2bee_tpu.models import loader as jloader
from bee2bee_tpu.models import quant as jquant
from bee2bee_tpu.ops.ragged import make_ragged_attn_fn
from bee2bee_tpu.train import lora as jlora
from bee2bee_tpu_torch.__main__ import cli
from bee2bee_tpu_torch.config import NodeConfig
from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine, drafter
from bee2bee_tpu_torch.engine.engine import check_card_supported
from bee2bee_tpu_torch.meshnet import runtime
from bee2bee_tpu_torch.models import config, core, export, loader, quant
from bee2bee_tpu_torch.models.params import init_params, params_from_numpy, params_to_numpy
from bee2bee_tpu_torch.ops import ragged
from bee2bee_tpu_torch.train import lora
# the qwen file's engine settings, prompts and tolerances, and its helpers:
# bit-exact tree comparison, the paged prefill (under a write ceil) then two
# decode steps held to JAX's logits, and an engine's greedy tokens
from test_torch_qwen import (INT8_LOGIT_ATOL, KW, LOGIT_ATOL, NEW, PROMPTS, _assert_flat_equal,
                             _port_tokens, _prefill_then_decode)

NAMES = ["tiny-gpt2", "tiny-bigcode"]
PRESETS = ["distilgpt2", "gpt2", "starcoder-15b"]
BIAS_STD = 0.5  # N(0, 0.25)
NORM_STD = 0.1  # scales 1 + N(0, 0.01)
NORM_BIAS_STD = math.sqrt(0.1)  # N(0, 0.1)


def _perturb(tree: dict, seed: int) -> dict:
    """The JAX tree with every bias drawn N(0, 0.25), every layernorm
    scale 1 + N(0, 0.01) and every layernorm bias N(0, 0.1), in place of
    JAX's zeros and ones."""
    rng = np.random.default_rng(seed)

    def draw(a, mean, std):
        return (mean + rng.standard_normal(np.shape(a)) * std).astype(np.float32)

    layers = tree["layers"]
    for norm in (layers["ln1"], layers["ln2"], tree["final_norm"]):
        norm["scale"] = draw(norm["scale"], 1.0, NORM_STD)
        norm["bias"] = draw(norm["bias"], 0.0, NORM_BIAS_STD)
    for group, keys in (("attn", ("bq", "bk", "bv", "bo")), ("mlp", ("b_up", "b_down"))):
        for key in keys:
            layers[group][key] = draw(layers[group][key], 0.0, BIAS_STD)
    return tree


@functools.lru_cache(maxsize=None)
def _tree(name: str, seed: int = 0, max_pos: int | None = None) -> tuple:
    """(JAX config, the perturbed numpy tree, layers stacked): read only.
    ``max_pos``: the config's position table cut to that many rows."""
    jcfg = jconfig.get_config(name)
    if max_pos is not None:
        jcfg = dataclasses.replace(jcfg, max_seq_len=max_pos, name=f"{name}-p{max_pos}")
    tree = jax.device_get(jcore.init_params(jcfg, jax.random.key(seed), dtype=jnp.float32))
    return jcfg, _perturb(tree, seed + 1)


def _cfg(jcfg) -> config.ModelConfig:
    """The port's config of a JAX one (same fields)."""
    return config.ModelConfig(**dataclasses.asdict(jcfg))


def _params(name, dtype=torch.float32, seed=0, max_pos=None):
    jcfg, tree = _tree(name, seed, max_pos)
    return params_from_numpy(tree, _cfg(jcfg), "cpu", dtype)


# ------------------------------------------------------------- config


@pytest.mark.parametrize("name", NAMES + PRESETS)
def test_check_supported_takes_the_gpt2_family(name):
    core.check_supported(config.get_config(name))


@pytest.mark.parametrize("name,switch", [
    ("tiny-bloom", "pos_embedding='alibi'"), ("tiny-gptj", "mlp_bias"),
    ("tiny-phi", "lm_head_bias"), ("tiny-falcon", "parallel_block"),
    ("tiny-neox", "partial/interleaved rotary"), ("tiny-olmo2", "qk_norm_full"), ("tiny-olmo2", "no_pre_norms"),
    ("tiny-bloom", "embedding_norm"), ("tiny-stablelm", "partial/interleaved rotary"),
])
def test_check_supported_still_refuses_the_others_by_name(name, switch):
    with pytest.raises(NotImplementedError, match=switch):
        core.check_supported(config.get_config(name))


@pytest.mark.parametrize("name", NAMES + PRESETS)
def test_matmul_params_per_token_matches_jax(name):
    assert core.matmul_params_per_token(config.get_config(name)) == \
        jcore.matmul_params_per_token(jconfig.get_config(name))


def test_starcoder_preset_is_one_kv_head_under_48():
    cfg = config.get_config("starcoder-15b")
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers) == (48, 1, 128, 40)
    assert cfg.activation == "gelu" and cfg.tie_embeddings


# ------------------------------------------------------------- params


@pytest.mark.parametrize("name", NAMES)
def test_init_params_schema_matches_jax(name):
    """The same tree and shapes as JAX ``init_params``: the position table,
    the norm biases, q/k/v/o and MLP biases, no ``w_gate``; biases at zero,
    norm scales at one."""
    jcfg = jconfig.get_config(name)
    want = jcore.unstack_layers(jax.device_get(
        jcore.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)))
    got = init_params(config.get_config(name), torch.Generator().manual_seed(0), "cpu",
                      torch.float32)
    assert sorted(got) == sorted(want)
    assert tuple(got["pos_embed"].shape) == np.shape(want["pos_embed"]) == (jcfg.max_seq_len,
                                                                            jcfg.d_model)
    assert jax.tree.map(np.shape, want["final_norm"]) == {
        k: tuple(v.shape) for k, v in got["final_norm"].items()}
    for lp, jlp in zip(got["layers"], want["layers"]):
        assert jax.tree.map(np.shape, jlp) == {
            g: {k: tuple(v.shape) for k, v in d.items()} for g, d in lp.items()}
        assert "w_gate" not in lp["mlp"]
        for group, key in (("ln1", "bias"), ("ln2", "bias"), ("attn", "bo"), ("mlp", "b_up")):
            assert torch.equal(lp[group][key], torch.zeros_like(lp[group][key]))
        assert torch.equal(lp["ln1"]["scale"], torch.ones_like(lp["ln1"]["scale"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_params_round_trip_keeps_positions_and_biases(name, dtype):
    _, tree = _tree(name)
    cfg = config.get_config(name)
    for form in (tree, jcore.unstack_layers(tree)):
        params = params_from_numpy(form, cfg, "cpu", dtype)
        np.testing.assert_array_equal(
            params["pos_embed"].float().numpy(),
            torch.tensor(tree["pos_embed"]).to(dtype).float().numpy())
        for group, key in (("ln2", "bias"), ("attn", "bo"), ("attn", "bk"),
                           ("mlp", "b_up"), ("mlp", "b_down")):
            np.testing.assert_array_equal(
                params["layers"][1][group][key].float().numpy(),
                torch.from_numpy(tree["layers"][group][key][1]).to(dtype).float().numpy())
        back = params_from_numpy(params_to_numpy(params), cfg, "cpu", dtype)
        _assert_flat_equal(loader._flatten(back), loader._flatten(params))
    # int8: the biases, norms and the position table stay in the
    # activations' type, unquantized; the MLP has no w_gate to quantize
    qp = quant.quantize_params_(params_from_numpy(tree, cfg, "cpu", dtype))
    assert set(qp["layers"][0]["mlp"]["w_up"]) == {"q", "s"}
    assert sorted(qp["layers"][0]["mlp"]) == ["b_down", "b_up", "w_down", "w_up"]
    assert qp["pos_embed"].dtype == qp["layers"][0]["attn"]["bo"].dtype == dtype


# ------------------------------------------------------------- the functions


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype, bias):
    """f32 mean and variance, cast to x's type, times the scale, plus the
    bias where the params carry one (mpt's weight-only norms: none)."""
    jcfg = dataclasses.replace(jconfig.get_config("tiny-gpt2"), norm_bias=bias)
    cfg = _cfg(jcfg)
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 3, 64)) * 3 + 1).astype(np.float32)
    p = {"scale": (1 + rng.standard_normal(64) * 0.1).astype(np.float32)}
    if bias:
        p["bias"] = (rng.standard_normal(64) * 0.3).astype(np.float32)
    jd = jnp.dtype(dtype)
    want = np.asarray(jcore._norm(jnp.asarray(x, jd), {k: jnp.asarray(v, jd)
                                                       for k, v in p.items()}, jcfg)
                      .astype(jnp.float32))
    td = getattr(torch, dtype)
    got = core._norm(torch.from_numpy(x).to(td), {k: torch.from_numpy(v).to(td)
                                                 for k, v in p.items()}, cfg)
    assert got.dtype == td
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    rms = core._norm(torch.from_numpy(x), {"scale": torch.from_numpy(p["scale"])},
                     config.get_config("tiny-llama"))
    assert (rms - got.float()).abs().max() > 1e-2


@pytest.mark.parametrize("activation", ["gelu", "gelu_exact"])
def test_gelu_forms_match_jax(activation):
    """The non-gated MLP's activation of ``up`` (no gate): tanh-approximated
    (gpt2, bigcode) or exact erf; f32 within rounding, the two forms
    differ."""
    jcfg = dataclasses.replace(jconfig.get_config("tiny-gpt2"), activation=activation)
    cfg = _cfg(jcfg)
    rng = np.random.default_rng(7)
    up = (rng.standard_normal((2, 3, 4, 128)) * 3).astype(np.float32)
    want = np.asarray(jcore._activate(jnp.asarray(up), None, jcfg))
    got = core._activate(torch.from_numpy(up), None, cfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    other = "gelu_exact" if activation == "gelu" else "gelu"
    assert np.abs(core._activate(torch.from_numpy(up), None,
                                 dataclasses.replace(cfg, activation=other)).numpy()
                  - got).max() > 1e-4


# ------------------------------------------------------------- forward


# JAX reads an int8 pool through its ragged kernel only
@pytest.mark.parametrize("jax_attention,pool", [
    ("dense", "float32"), ("ragged_interpret", "float32"), ("ragged_interpret", "int8")])
@pytest.mark.parametrize("name", NAMES)
def test_paged_forward_prefill_then_decode_matches_jax(name, jax_attention, pool):
    jcfg, tree = _tree(name)
    attn = make_ragged_attn_fn(interpret=True) if jax_attention != "dense" else None
    _prefill_then_decode(jcfg, config.get_config(name), tree, _params(name), attn,
                         torch.int8 if pool == "int8" else torch.float32,
                         INT8_LOGIT_ATOL if pool == "int8" else LOGIT_ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_biases_and_positions_change_the_function(name):
    """The perturbed biases, norm biases and the position table reach the
    logits: dropping any of them gives another function."""
    cfg = config.get_config(name)
    ids = torch.arange(3, 15).reshape(1, 12)
    tables = torch.tensor([[1, 2]], dtype=torch.int32)

    def logits(params):
        pool = core.init_paged_pool(cfg, 3, 8, torch.float32)
        return core.forward(params, cfg, ids, pool, 0, tables)[0]

    base = logits(_params(name))
    for drop in (("attn", "bo"), ("mlp", "b_up"), ("mlp", "b_down"), ("ln1", "bias")):
        params = _params(name)
        for lp in params["layers"]:
            lp[drop[0]].pop(drop[1])
        assert (logits(params) - base).abs().max() > 1e-2, drop
    params = _params(name)
    params["pos_embed"] = torch.zeros_like(params["pos_embed"])
    assert (logits(params) - base).abs().max() > 1e-3


@pytest.mark.parametrize("name", NAMES)
def test_int8_weights_forward_matches_jax(name):
    jcfg, tree = _tree(name)
    cfg = config.get_config(name)
    qtree = jquant.quantize_params(tree)
    params = params_from_numpy(qtree, cfg, "cpu", torch.float32)
    assert set(params["layers"][0]["mlp"]["w_up"]) == {"q", "s"}
    _prefill_then_decode(jcfg, cfg, qtree, params, None, torch.float32, LOGIT_ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_rectangular_cache_forward_matches_jax(name):
    """The drafter's forward: a prefill, then a 2-token chunk at per-row
    offsets, over [L, B, S, Hkv, hd] caches; logits and caches within
    1e-4."""
    jcfg, tree = _tree(name)
    cfg = config.get_config(name)
    params = _params(name)
    B, S = 3, 96
    jc = jcore.init_cache(jcfg, B, S, dtype=jnp.float32)
    tc = core.init_cache(cfg, B, S, dtype=torch.float32)
    rng = np.random.default_rng(12)
    for offs, width in (([0, 0, 0], 20), ([20, 9, 60], 2)):
        ids = rng.integers(3, 500, size=(B, width)).astype(np.int32)
        jl, jc = jcore.forward(tree, jcfg, jnp.asarray(ids), jc, jnp.asarray(offs, jnp.int32))
        tl, tc = core.forward(params, cfg, torch.from_numpy(ids).long(), tc,
                              torch.tensor(offs, dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=LOGIT_ATOL,
                                       rtol=0)


# ------------------------------------------------------------- learned positions


def test_positions_outside_the_table_are_clamped_where_jax_takes_nan():
    """JAX's ``jnp.take`` gives NaN rows past the table and wraps -1 to the
    last row; the port clamps into [0, P - 1] (an index error on the CPU,
    a device assert on the card otherwise). Inside the table the two are
    the same rows, bit for bit."""
    jcfg, tree = _tree("tiny-gpt2", max_pos=64)
    cfg = _cfg(jcfg)
    params = _params("tiny-gpt2", max_pos=64)
    ids = np.full((1, 5), 7, np.int32)
    pos = np.asarray([[-1, 0, 30, 63, 64]], np.int32)
    want = np.asarray(jcore.embed_tokens(tree, jcfg, jnp.asarray(ids), jnp.asarray(pos)))
    got = core.embed_tokens(params, cfg, torch.from_numpy(ids).long(),
                            torch.from_numpy(pos).long()).numpy()
    np.testing.assert_array_equal(got[0, 1:4], want[0, 1:4])
    assert np.isnan(want[0, 4]).all() and np.isfinite(got).all()
    tok = tree["tok_embed"][7]
    np.testing.assert_array_equal(want[0, 0], tok + tree["pos_embed"][63])  # wrapped
    np.testing.assert_array_equal(got[0, 0], got[0, 1])  # clamped to 0
    np.testing.assert_array_equal(got[0, 4], got[0, 3])  # clamped to 63
    with pytest.raises(IndexError):
        torch.nn.functional.embedding(torch.tensor([64]), params["pos_embed"])


@functools.lru_cache(maxsize=None)
def _edge_tokens(name: str) -> tuple:
    """The JAX engine's greedy tokens on the learned-position edge cases
    (``_edge_requests``) over a 64-row position table."""
    jcfg, tree = _tree(name, max_pos=64)
    eng = JaxEngine(jcfg, params=tree, engine_config=JaxEngineConfig(**_EDGE_KW))
    try:
        return tuple(tuple(eng.generate(p, max_new_tokens=n, temperature=0.0).token_ids)
                     for p, n in _edge_requests())
    finally:
        eng.close()


# the engine's max_seq_len is the model's 64-row table; a prefix cache
_EDGE_KW = dict(KW, dtype="float32", prefix_cache_entries=4)


def _edge_requests() -> list:
    """(prompt, new tokens): a 58-token prompt and 10 new tokens (the
    engine keeps its last 54 tokens; the third 4-step decode window runs to
    position 65, past the table); a 40-token prompt, then that prompt with
    17 more tokens and 4 new (a prefix hit at 40 whose 17-token remainder
    takes bucket 32: the window would reach position 71, so the capacity
    re-anchor runs it over 32-63 under the write floor)."""
    rng = np.random.default_rng(13)
    long = rng.integers(3, 500, size=58).tolist()
    first = rng.integers(3, 500, size=40).tolist()
    second = first + rng.integers(3, 500, size=17).tolist()
    return [(long, 10), (first, 4), (second, 4)]


@pytest.mark.parametrize("name", NAMES)
def test_learned_positions_past_the_table_emit_jax_tokens(name):
    """Three requests at once (bucket 4: a dead row at offset -1 beside
    them; the 58-token prompt's last decode window runs past position 63),
    then the prefix hit whose bucket would run past the table. No index
    error, and each row's emitted tokens are the JAX engine's."""
    jcfg, _ = _tree(name, max_pos=64)
    cfg = _cfg(jcfg)
    reqs = _edge_requests()
    eng = InferenceEngine(cfg, params=_params(name, max_pos=64), device="cpu",
                          engine_config=EngineConfig(**_EDGE_KW))
    try:
        assert eng.max_seq_len == 64
        got: dict = {}
        rows = [reqs[0], reqs[1], (reqs[1][0][:20], 4)]
        barrier = threading.Barrier(len(rows))

        def run(i):
            barrier.wait()
            got[i] = eng.generate(rows[i][0], max_new_tokens=rows[i][1],
                                  temperature=0.0).token_ids

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(rows))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        want = _edge_tokens(name)
        assert got[0] == list(want[0]) and got[1] == list(want[1])
        assert len(got[0]) == 10
        hits = eng.scheduler.stats.prefix_hits
        saved = eng.scheduler.stats.prefix_tokens_saved
        assert eng.generate(reqs[2][0], max_new_tokens=reqs[2][1],
                            temperature=0.0).token_ids == list(want[2])
        assert eng.scheduler.stats.prefix_hits == hits + 1
        assert eng.scheduler.stats.prefix_tokens_saved == saved + 40
    finally:
        eng.close()


# ------------------------------------------------------------- checkpoints


def _bigcode_per_head_state(tree, cfg) -> dict:
    """HF's ``multi_query=False`` gpt-bigcode layout of a JAX tree, written
    here from HF's convention (c_attn rows ``view(H, 3, hd)``): no exporter
    of either package in the loop."""
    H, hd, D = cfg.n_heads, cfg.head_dim, cfg.d_model
    layers = tree["layers"]
    state = {"transformer.wte.weight": tree["tok_embed"],
             "transformer.wpe.weight": tree["pos_embed"],
             "transformer.ln_f.weight": tree["final_norm"]["scale"],
             "transformer.ln_f.bias": tree["final_norm"]["bias"]}
    for i in range(cfg.n_layers):
        p = f"transformer.h.{i}."
        a, m = layers["attn"], layers["mlp"]
        w = np.stack([a[k][i].T.reshape(H, hd, D) for k in ("wq", "wk", "wv")], 1)
        b = np.stack([a[k][i].reshape(H, hd) for k in ("bq", "bk", "bv")], 1)
        state.update({
            p + "ln_1.weight": layers["ln1"]["scale"][i], p + "ln_1.bias": layers["ln1"]["bias"][i],
            p + "ln_2.weight": layers["ln2"]["scale"][i], p + "ln_2.bias": layers["ln2"]["bias"][i],
            p + "attn.c_attn.weight": w.reshape(3 * H * hd, D),
            p + "attn.c_attn.bias": b.reshape(3 * H * hd),
            p + "attn.c_proj.weight": a["wo"][i].T, p + "attn.c_proj.bias": a["bo"][i],
            p + "mlp.c_fc.weight": m["w_up"][i].T, p + "mlp.c_fc.bias": m["b_up"][i],
            p + "mlp.c_proj.weight": m["w_down"][i].T, p + "mlp.c_proj.bias": m["b_down"][i]})
    return {k: np.ascontiguousarray(v, np.float32) for k, v in state.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_jax_export_loads_bit_equal_in_both_packages(name, dtype, tmp_path):
    jcfg, tree = _tree(name, seed=1)
    jexport.export_hf(tree, jcfg, tmp_path, dtype=dtype)
    assert config.config_for_checkpoint(tmp_path).__dict__ == \
        jconfig.config_for_checkpoint(tmp_path).__dict__
    cfg = config.config_for_checkpoint(tmp_path)
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    got = loader._flatten(loader.load_checkpoint(tmp_path, cfg, tdtype, "cpu"))
    want = jloader._flatten(jloader.load_checkpoint(tmp_path, jcfg, jnp.dtype(dtype),
                                                    host=True))
    _assert_flat_equal(got, want)
    src = jloader._flatten(jax.tree.map(lambda a: np.asarray(a).astype(jnp.dtype(dtype)),
                                        tree))
    _assert_flat_equal(got, src)
    # the port's state exporter (the smoke writes its gpt2 and bigcode
    # checkpoints with it) writes JAX's tensors under JAX's names
    fn = export._export_gpt2_state if name == "tiny-gpt2" else export._export_bigcode_state
    jfn = jexport._export_gpt2_state if name == "tiny-gpt2" else jexport._export_bigcode_state
    state = fn(params_from_numpy(tree, cfg, "cpu"), cfg, tdtype)
    jstate = jfn(tree, jcfg, jnp.dtype(dtype))
    assert sorted(state) == sorted(jstate)
    for k, v in jstate.items():
        np.testing.assert_array_equal(params_to_numpy({"x": state[k], "layers": [{}]})["x"]
                                      .view(np.uint16 if dtype == "bfloat16" else np.float32),
                                      np.asarray(v).view(np.uint16 if dtype == "bfloat16"
                                                         else np.float32), err_msg=k)


def test_per_head_bigcode_checkpoint_loads_bit_equal_in_both_packages(tmp_path):
    """gpt-bigcode with ``multi_query=False`` (4 kv heads): c_attn packed
    per head. Both loaders give back the tree; a split into thirds would
    not. The port's exporter writes the same file."""
    jcfg = dataclasses.replace(jconfig.get_config("tiny-bigcode"), n_kv_heads=4,
                               name="tiny-bigcode-mha")
    tree = _perturb(jax.device_get(jcore.init_params(jcfg, jax.random.key(3),
                                                     dtype=jnp.float32)), 4)
    cfg = _cfg(jcfg)
    state = _bigcode_per_head_state(tree, cfg)
    export.write_safetensors(tmp_path / "model.safetensors", state)
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "gpt_bigcode", "_name_or_path": cfg.name, "vocab_size": cfg.vocab_size,
        "n_embd": cfg.d_model, "n_layer": cfg.n_layers, "n_head": cfg.n_heads,
        "n_inner": cfg.d_ff, "n_positions": cfg.max_seq_len, "multi_query": False,
        "activation_function": "gelu_pytorch_tanh", "layer_norm_epsilon": cfg.norm_eps}))
    assert config.config_for_checkpoint(tmp_path) == cfg
    got = loader._flatten(loader.load_checkpoint(tmp_path, cfg, torch.float32, "cpu"))
    want = jloader._flatten(jloader.load_checkpoint(tmp_path, jcfg, jnp.float32, host=True))
    _assert_flat_equal(got, want)
    _assert_flat_equal(got, jloader._flatten(tree))
    ours = export._export_bigcode_state(params_from_numpy(tree, cfg, "cpu"), cfg,
                                        torch.float32)
    assert sorted(ours) == sorted(set(state) | {"lm_head.weight"})
    for k, v in state.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_hf_checkpoint_serves_from_auto(name, tmp_path):
    """The port's state + the JAX package's config.json: ``InferenceEngine
    ("auto", checkpoint_path=...)`` serves the tokens of the engine over
    the same params."""
    jcfg, tree = _tree(name, seed=2)
    cfg = config.get_config(name)
    params = params_from_numpy(tree, cfg, "cpu")
    fn = export._export_gpt2_state if name == "tiny-gpt2" else export._export_bigcode_state
    export.write_safetensors(tmp_path / "model.safetensors", fn(params, cfg, torch.float32))
    (tmp_path / "config.json").write_text(json.dumps(
        dict(jexport.hf_config_dict(jcfg), _name_or_path=f"{name}-ckpt")))
    ecfg = EngineConfig(dtype="float32", **KW)
    eng = InferenceEngine("auto", checkpoint_path=str(tmp_path), device="cpu",
                          engine_config=ecfg)
    ref = InferenceEngine(cfg, params=params, device="cpu", engine_config=ecfg)
    try:
        assert eng.model_cfg == dataclasses.replace(cfg, name=f"{name}-ckpt")
        for p in PROMPTS:
            assert eng.generate(p, max_new_tokens=NEW, temperature=0.0).token_ids == \
                ref.generate(p, max_new_tokens=NEW, temperature=0.0).token_ids
    finally:
        eng.close()
        ref.close()


# ------------------------------------------------------------- engines


@functools.lru_cache(maxsize=None)
def _jax_tokens(name: str, dtype: str, cache_dtype: str | None = None) -> tuple:
    """The JAX engine's greedy tokens on PROMPTS over the perturbed tree."""
    _, tree = _tree(name)
    eng = JaxEngine(name, params=tree, engine_config=JaxEngineConfig(
        dtype=dtype, **dict(KW, cache_dtype=cache_dtype or dtype)))
    try:
        return tuple(tuple(eng.generate(p, max_new_tokens=NEW, temperature=0.0).token_ids)
                     for p in PROMPTS)
    finally:
        eng.close()


@pytest.mark.parametrize("dtype,pool", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                        ("float32", "int8")])
@pytest.mark.parametrize("name", NAMES)
def test_engine_greedy_tokens_equal_jax(name, dtype, pool):
    eng = InferenceEngine(name, params=_params(name), device="cpu",
                          engine_config=EngineConfig(dtype=dtype,
                                                     **dict(KW, cache_dtype=pool)))
    try:
        assert eng.kv_quantized == (pool == "int8")
        assert _port_tokens(eng) == _jax_tokens(name, dtype, pool)
    finally:
        eng.close()


def test_lora_batch_over_gpt2_matches_the_jax_pool_engine():
    """An adapter row and a base row in one batch over tiny-gpt2 (targets
    wq, wv, w_up, w_down; the MLP has no w_gate, which validation refuses
    in both packages): the JAX adapter-pool engine's tokens, row by row."""
    name = "tiny-gpt2"
    cfg, jcfg = config.get_config(name), jconfig.get_config(name)
    targets = ("wq", "wv", "w_up", "w_down")
    lcfg = lora.LoraConfig(rank=4, alpha=16.0, targets=targets)
    jlcfg = jlora.LoraConfig(rank=4, alpha=16.0, targets=targets)
    lora.validate_targets(cfg, lcfg)
    jlora.validate_targets(jcfg, jlcfg)
    with pytest.raises(ValueError, match="w_gate"):
        lora.validate_targets(cfg, lora.LoraConfig(targets=("w_gate",)))
    io = lora.adapter_target_io(cfg)
    assert io == jlora.adapter_target_io(jcfg)
    rng = np.random.default_rng(4)
    ad = {t: {"a": (rng.standard_normal((cfg.n_layers, io[t][0], 4)) * 0.2).astype(np.float32),
              "b": (rng.standard_normal((cfg.n_layers, 4, io[t][1])) * 0.05).astype(np.float32)}
          for t in targets}
    rows = ("a1", None)
    _, tree = _tree(name)
    ecfg = dict(KW, dtype="float32", max_adapters=1)
    jeng = JaxEngine(name, params=tree, engine_config=JaxEngineConfig(**ecfg))
    eng = InferenceEngine(name, params=_params(name), device="cpu",
                          engine_config=EngineConfig(**ecfg))
    try:
        jeng.load_adapter("a1", ad, jlcfg)
        eng.load_adapter("a1", ad, lcfg)
        want = [jeng.generate(p, max_new_tokens=NEW, temperature=0.0, adapter=a).token_ids
                for p, a in zip(PROMPTS, rows)]
        got: dict = {}
        barrier = threading.Barrier(len(rows))

        def run(i):
            barrier.wait()
            got[i] = eng.generate(PROMPTS[i], max_new_tokens=NEW, temperature=0.0,
                                  adapter=rows[i]).token_ids

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(rows))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert [got[i] for i in range(len(rows))] == want
        assert want[1] == list(_jax_tokens(name, "float32")[1])
        assert want[0] != list(_jax_tokens(name, "float32")[0])
    finally:
        jeng.close()
        eng.close()


def test_model_drafter_over_gpt2_proposes_jax_drafts():
    """distilgpt2 drafting for gpt2, at tiny size: the drafter's
    rectangular cache adds the learned positions; its drafts are JAX's."""
    name = "tiny-gpt2"
    _, tree = _tree(name)
    K = 4
    ours = drafter.DraftModel(name, spec_tokens=K, batch=2, target_max_seq_len=128,
                              params=_params(name), device="cpu")
    theirs = jdrafter.DraftModel(name, spec_tokens=K, batch=2, target_max_seq_len=128,
                                 params=tree)

    class _Req:
        def __init__(self, ids):
            self.ids, self.out_ids = [int(i) for i in ids], []

    rng = np.random.default_rng(5)
    reqs = [_Req(rng.integers(3, 500, size=n)) for n in (20, 7)]
    for _ in range(3):
        rows = list(enumerate(reqs))
        got, want = ours.propose_batch(rows), theirs.propose_batch(rows)
        assert got == want
        for b, r in rows:
            r.out_ids += got[b][:1] + [int(rng.integers(3, 500))]
            ours.observe(r, 1)
            theirs.observe(r, 1)


# ------------------------------------------------------------- the card


def test_dispatch_at_48_query_heads_a_kv_head_and_at_head_dim_64():
    """starcoder-15b's G = 48 at hd 128: ``decode_f32`` holds G·T <= 32
    rows, so every f32 chunk (T = 1 too) goes to the f32 tile form; bf16
    T = 1 to the decode kernel, T >= 2 to the tile kernel. gpt2's G = 1 at
    hd 64: ``decode_f32`` up to T = 8, the decode and tile forms in bf16."""
    sc = config.get_config("starcoder-15b")
    assert sc.n_heads // sc.n_kv_heads == 48 and sc.head_dim == 128
    g2 = config.get_config("gpt2")
    assert g2.n_heads // g2.n_kv_heads == 1 and g2.head_dim == 64
    for int8 in (False, True):
        for T in (1, 5):
            assert ragged.ragged_kernel(torch.float32, T, 128, int8, group=48) == "tile_f32"
            assert ragged.ragged_kernel(torch.float32, T, 64, int8, group=1) == "decode_f32"
        for hd, G in ((128, 48), (64, 1)):
            assert ragged.ragged_kernel(torch.bfloat16, 1, hd, int8, group=G) == "decode"
            assert ragged.ragged_kernel(torch.bfloat16, 5, hd, int8, group=G) == "tile"
        assert ragged.ragged_kernel(torch.float32, 300, 64, int8, group=1) == "tile_f32"


@pytest.mark.parametrize("name", PRESETS)
def test_card_check_takes_the_gpt2_presets(name):
    mcfg = config.get_config(name)
    for over in (dict(), dict(cache_dtype="int8", quantize="int8"),
                 dict(dtype="float32", cache_dtype="float32"),
                 dict(dtype="float32", cache_dtype="int8")):
        check_card_supported(mcfg, EngineConfig(**over), "cuda")
    with pytest.raises(NotImplementedError, match="head_dim 16"):
        check_card_supported(config.get_config("tiny-gpt2"), EngineConfig(), "cuda")


def test_serve_cuda_accepts_distilgpt2_with_its_drafter(monkeypatch):
    """``serve-cuda --model distilgpt2 --spec 4 --drafter distilgpt2``: the
    CLI passes the model and the model tier to the node, and the engine
    config it builds passes the core's and the card's checks."""
    from bee2bee_tpu_torch import __main__ as main

    seen = {}
    monkeypatch.setattr(main, "_serve", lambda backend, model, **kw: seen.update(
        main._apply_common_cfg(NodeConfig(), kw).to_dict(), backend=backend, model=model))
    out = CliRunner().invoke(cli, ["serve-cuda", "--model", "distilgpt2", "--spec", "4",
                                   "--drafter", "distilgpt2"])
    assert out.exit_code == 0, out.output
    assert (seen["backend"], seen["model"], seen["drafter"]) == ("cuda", "distilgpt2",
                                                                 "distilgpt2")
    ecfg = NodeConfig(**{k: v for k, v in seen.items()
                         if k not in ("backend", "model")}).engine_config()
    assert ecfg.spec_tokens == 4
    core.check_supported(config.get_config("distilgpt2"))
    check_card_supported(config.get_config("distilgpt2"), ecfg, "cuda")


def test_node_service_serves_tiny_gpt2(monkeypatch):
    """serve-cuda's path (``runtime.build_service``) with ``--model
    tiny-gpt2 --quantize int8 --kv-quant`` on the CPU: the service answers
    with the int8-weight engine over an int8 pool."""
    from bee2bee_tpu_torch.services import cuda

    monkeypatch.setattr(cuda, "resolve_device", lambda device=None: torch.device(
        device or "cpu"))
    cfg = NodeConfig(quantize="int8", kv_quant=True, max_seq_len=64, dtype="float32")
    svc = runtime.build_service("cuda", "tiny-gpt2", cfg).load_sync()
    try:
        eng = svc.engine
        assert eng.engine_cfg.quantize == "int8" and eng.kv_quantized
        assert set(eng.params["layers"][0]["mlp"]["w_up"]) == {"q", "s"}
        assert eng.params["pos_embed"].dtype == torch.float32
        assert svc.get_metadata()["models"] == ["tiny-gpt2"]
        assert len(eng.generate("gpt2", max_new_tokens=4, temperature=0.0).token_ids) == 4
    finally:
        eng.close()
