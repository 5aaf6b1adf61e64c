"""The gemma family in the PyTorch port against the JAX package, at tiny
size: ``tiny-gemma`` (gemma 1: geglu, the embedding scale, (1 + w) norms,
one kv head), ``tiny-gemma2`` (+ post-norms, attention and logit
softcaps, a score scale, a window on every second layer) and
``tiny-gemma3`` (+ head-wise q/k norms and the dual rope over a
2-local-1-global pattern), on one numpy tree from the JAX init with every
norm scale perturbed off 1 (the JAX init's ones would hide a swapped or
dropped norm).

- ``init_params`` has JAX's schema (``ln1_post``, ``ln2_post``), and
  ``params_from_numpy`` / ``params_to_numpy`` carry the new keys.
- The paged forward (a prefill chunk under a write ceil, then two decode
  steps) gives JAX's logits, with JAX on its dense attention and on the
  ragged kernel in interpret mode, over an f32 pool (1e-4) and an int8
  pool (1e-3, the tolerance of the llama int8-pool test); with int8
  weights (1e-4).
- The bf16 embedding-scale constant, geglu and the logit softcap, each
  against JAX's function; the dual rope layer by layer.
- JAX ``export_hf`` checkpoints load bit-equal in both packages (the
  (1 + w) fold; gemma-2's ``post_attention_layernorm`` lands in
  ``ln1_post``), the port's HF-named state holds JAX's tensors, and a
  gemma3_text directory serves through ``auto``.
- Engines: greedy tokens equal to the JAX engine's in f32 and bf16 and
  over an int8 pool; n-gram spec keeps the greedy tokens; a mixed LoRA
  batch equals the JAX adapter-pool engine's tokens; the model drafter
  proposes JAX's drafts; ``matmul_params_per_token`` agrees with JAX.
- The dispatch at G = 8 (gemma-2b's one kv head) and G = 1 (gemma-7b), and
  the card check and the node's service take the gemma presets.
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
from bee2bee_tpu_torch.config import NodeConfig
from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine, drafter
from bee2bee_tpu_torch.engine.engine import check_card_supported
from bee2bee_tpu_torch.meshnet import runtime
from bee2bee_tpu_torch.models import config, core, export, loader, quant
from bee2bee_tpu_torch.models.params import init_params, params_from_numpy, params_to_numpy
from bee2bee_tpu_torch.ops import ragged
from bee2bee_tpu_torch.train import lora
# the qwen file's engine settings, prompts (both longer than tiny-gemma2's
# and tiny-gemma3's 4-token windows) and tolerances, and its helpers:
# bit-exact tree comparison, the paged prefill (under a write ceil) then two
# decode steps held to JAX's logits, and an engine's greedy tokens
from test_torch_qwen import (INT8_LOGIT_ATOL, KW, LOGIT_ATOL, NEW, PROMPTS, _assert_flat_equal,
                             _bits, _port_tokens, _prefill_then_decode)

NAMES = ["tiny-gemma", "tiny-gemma2", "tiny-gemma3"]
PRESETS = ["gemma-2b", "gemma-7b", "gemma-2-9b", "gemma-3-4b"]
NORMS = ("ln1", "ln2", "ln1_post", "ln2_post")


def _perturb(tree: dict, seed: int) -> dict:
    """The JAX tree with every norm scale (block norms, q/k norms, the
    final norm) drawn 1 + N(0, 0.1) in place of JAX's ones."""
    rng = np.random.default_rng(seed)

    def draw(a):
        return (1.0 + rng.standard_normal(np.shape(a)) * 0.1).astype(np.float32)

    layers = tree["layers"]
    for key in NORMS:
        if key in layers:
            layers[key] = {"scale": draw(layers[key]["scale"])}
    for key in ("q_norm", "k_norm"):
        if key in layers["attn"]:
            layers["attn"][key] = draw(layers["attn"][key])
    tree["final_norm"] = {"scale": draw(tree["final_norm"]["scale"])}
    return tree


@functools.lru_cache(maxsize=None)
def _tree(name: str, seed: int = 0) -> dict:
    """(JAX config, the perturbed numpy tree, layers stacked): read only."""
    jcfg = jconfig.get_config(name)
    tree = jax.device_get(jcore.init_params(jcfg, jax.random.key(seed), dtype=jnp.float32))
    return jcfg, _perturb(tree, seed + 1)


def _params(name, dtype=torch.float32, seed=0):
    return params_from_numpy(_tree(name, seed)[1], config.get_config(name), "cpu", dtype)


# ------------------------------------------------------------- config


@pytest.mark.parametrize("name", NAMES + PRESETS)
def test_check_supported_takes_the_gemma_family(name):
    core.check_supported(config.get_config(name))


@pytest.mark.parametrize("name", NAMES + PRESETS)
def test_matmul_params_per_token_matches_jax(name):
    assert core.matmul_params_per_token(config.get_config(name)) == \
        jcore.matmul_params_per_token(jconfig.get_config(name))


# ------------------------------------------------------------- params


@pytest.mark.parametrize("name", NAMES)
def test_init_params_schema_matches_jax(name):
    """The same tree and shapes as JAX ``init_params``: ``ln1_post`` and
    ``ln2_post`` where gemma-2/3 set ``post_norms``, every norm at one."""
    jcfg = jconfig.get_config(name)
    want = jcore.unstack_layers(jax.device_get(
        jcore.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)))
    got = init_params(config.get_config(name), torch.Generator().manual_seed(0), "cpu",
                      torch.float32)
    for lp, jlp in zip(got["layers"], want["layers"]):
        assert jax.tree.map(np.shape, jlp) == {
            g: {k: tuple(v.shape) for k, v in d.items()} for g, d in lp.items()}
        for key in NORMS:
            if key in lp:
                assert torch.equal(lp[key]["scale"], torch.ones_like(lp[key]["scale"]))
    assert ("ln1_post" in got["layers"][0]) == (name != "tiny-gemma")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_params_round_trip_with_post_norms(name, dtype):
    _, tree = _tree(name)
    cfg = config.get_config(name)
    params = params_from_numpy(tree, cfg, "cpu", dtype)
    assert set(params["layers"][1]) == set(tree["layers"])
    for key in NORMS:
        if key in tree["layers"]:
            np.testing.assert_array_equal(
                params["layers"][1][key]["scale"].float().numpy(),
                torch.from_numpy(tree["layers"][key]["scale"][1]).to(dtype).float().numpy())
    back = params_from_numpy(params_to_numpy(params), cfg, "cpu", dtype)
    _assert_flat_equal(loader._flatten(back), loader._flatten(params))
    # int8: the norms stay in the activations' type, unquantized
    qp = quant.quantize_params_(params_from_numpy(tree, cfg, "cpu", dtype))
    assert set(qp["layers"][0]["attn"]["wq"]) == {"q", "s"}
    for key in NORMS:
        if key in qp["layers"][0]:
            assert qp["layers"][0][key]["scale"].dtype == dtype


# ------------------------------------------------------------- the functions


@pytest.mark.parametrize("d_model", [64, 2048, 2304, 3072, 3584])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_embedding_scale_is_rounded_to_the_dtype_as_in_jax(d_model, dtype):
    """sqrt(d_model) rounded to the embedding's dtype before the product
    (bf16 sqrt(3584) is 59.75): the port's embeddings equal JAX's bit for
    bit, and differ from a product with the unrounded constant."""
    jcfg = jconfig.get_config("tiny-gemma")
    cfg = config.get_config("tiny-gemma")
    jcfg = dataclasses.replace(jcfg, d_model=d_model)
    cfg = dataclasses.replace(cfg, d_model=d_model)
    rng = np.random.default_rng(d_model)
    table = (rng.standard_normal((32, d_model)) * 0.7).astype(np.float32)
    ids = rng.integers(0, 32, size=(2, 5)).astype(np.int32)
    jt = jnp.asarray(table, jnp.dtype(dtype))
    want = jcore.embed_tokens({"tok_embed": jt}, jcfg, jnp.asarray(ids), None)
    tdtype = getattr(torch, dtype)
    t = torch.from_numpy(table).to(tdtype)
    got = core.embed_tokens({"tok_embed": t}, cfg, torch.from_numpy(ids).long())
    assert got.dtype == tdtype
    np.testing.assert_array_equal(_bits(params_to_numpy({"x": got, "layers": [{}]})["x"]),
                                  _bits(want))
    if dtype == "bfloat16" and d_model == 3584:
        assert core._in_dtype(math.sqrt(d_model), tdtype) == 59.75
        unrounded = (t[torch.from_numpy(ids).long()].float() * math.sqrt(d_model)).to(tdtype)
        assert not torch.equal(got, unrounded)


def test_geglu_matches_jax():
    """gelu(gate, tanh approximation) * up. f32: JAX's function within
    f32 rounding. bf16 (one fused gelu in f32, then the product; JAX's CPU
    code rounds intermediates to bf16): within two bf16 ulps of the f32
    function of the same bf16 inputs, and no further from it than JAX's
    own bf16 result is."""
    jcfg, cfg = jconfig.get_config("tiny-gemma"), config.get_config("tiny-gemma")
    rng = np.random.default_rng(7)
    up, gate = ((rng.standard_normal((2, 3, 4, 128)) * 3).astype(np.float32))
    want = np.asarray(jcore._activate(jnp.asarray(up), jnp.asarray(gate), jcfg))
    got = core._activate(torch.from_numpy(up), torch.from_numpy(gate), cfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    silu = core._activate(torch.from_numpy(up), torch.from_numpy(gate),
                          config.get_config("tiny-llama")).numpy()
    assert np.abs(silu - got).max() > 1e-2
    bup, bgate = torch.from_numpy(up).bfloat16(), torch.from_numpy(gate).bfloat16()
    ref = np.asarray(jcore._activate(jnp.asarray(bup.float().numpy()),
                                     jnp.asarray(bgate.float().numpy()), jcfg))
    jax_bf16 = np.asarray(jcore._activate(jnp.asarray(bup.float().numpy(), jnp.bfloat16),
                                          jnp.asarray(bgate.float().numpy(), jnp.bfloat16),
                                          jcfg).astype(jnp.float32))
    ours = core._activate(bup, bgate, cfg).float().numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=2.0 ** -7)
    assert np.abs(ours - ref).max() <= np.abs(jax_bf16 - ref).max()


def test_logit_softcap_matches_jax():
    """tanh(logits / 30) * 30 in f32 after the cast: the port's
    ``final_logits`` equals JAX's, and the cap binds."""
    name = "tiny-gemma2"
    jcfg, tree = _tree(name)
    cfg = config.get_config(name)
    params = _params(name)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    # the tied head's rows scaled so that logits pass the cap
    sub = {"tok_embed": tree["tok_embed"] * 100.0, "final_norm": tree["final_norm"]}
    params = dict(params, tok_embed=params["tok_embed"] * 100.0)
    want = np.asarray(jcore.final_logits(sub, jcfg, jnp.asarray(x)))
    got = core.final_logits(params, cfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.abs(got).max() <= cfg.logits_softcap
    raw = core.final_logits(params, dataclasses.replace(cfg, logits_softcap=None),
                            torch.from_numpy(x)).numpy()
    assert np.abs(raw).max() > cfg.logits_softcap


def test_dual_rope_layer_by_layer_matches_jax():
    """tiny-gemma3 (3 layers, residues (0, 1) of 3): layers 0 and 1 rotate
    with the local theta unscaled, layer 2 with theta 1e6 and linear-8
    scaling, each equal to JAX's ``_rope`` for that layer's kind; the two
    kinds differ. The local frequencies are kept per device."""
    jcfg, cfg = jconfig.get_config("tiny-gemma3"), config.get_config("tiny-gemma3")
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, cfg.n_heads, cfg.head_dim)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4], [40, 41, 42, 43, 44]], np.int32)
    rope = core.make_layer_rope(cfg, torch.from_numpy(pos).long())
    kinds = []
    for i in range(cfg.n_layers):
        sliding = bool(jcore.is_sliding_layer(jcfg, i))
        assert core.is_sliding_layer(cfg, i) == sliding
        kinds.append(sliding)
        theta, scaling = ((jcfg.local_rope_theta, None) if sliding
                          else (jcfg.rope_theta, jcfg.rope_scaling))
        want = np.asarray(jcore._rope(jnp.asarray(x), jnp.asarray(pos), theta,
                                      jcfg.rotary_dim, jcfg.rope_style, scaling))
        got = core._rope(torch.from_numpy(x), rope(i)).numpy()
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    assert kinds == [True, True, False]
    assert not torch.equal(core._rope(torch.from_numpy(x), rope(0)),
                           core._rope(torch.from_numpy(x), rope(2)))
    assert core.rope_freqs(cfg, "cpu", local=True) is core.rope_freqs(cfg, "cpu", local=True)
    # gemma-3-4b: 5 local layers of every 6, the global one scaled
    g3 = config.get_config("gemma-3-4b")
    assert [core.is_sliding_layer(g3, i) for i in range(12)] == \
        [bool(jcore.is_sliding_layer(jconfig.get_config("gemma-3-4b"), i))
         for i in range(12)] == [True] * 5 + [False] + [True] * 5 + [False]


# ------------------------------------------------------------- forward


# JAX reads an int8 pool through its ragged kernel only
@pytest.mark.parametrize("jax_attention,pool", [
    ("dense", "float32"), ("ragged_interpret", "float32"), ("ragged_interpret", "int8")])
@pytest.mark.parametrize("name", NAMES)
def test_paged_forward_prefill_then_decode_matches_jax(name, jax_attention, pool):
    jcfg, tree = _tree(name)
    cfg = config.get_config(name)
    attn = make_ragged_attn_fn(interpret=True) if jax_attention != "dense" else None
    _prefill_then_decode(jcfg, cfg, tree, _params(name), attn,
                         torch.int8 if pool == "int8" else torch.float32,
                         INT8_LOGIT_ATOL if pool == "int8" else LOGIT_ATOL)


@pytest.mark.parametrize("name", ["tiny-gemma2", "tiny-gemma3"])
def test_post_norms_change_the_function(name):
    """The perturbed post-norms reach the logits: the same forward with
    ``ln1_post`` and ``ln2_post`` swapped is another function."""
    cfg = config.get_config(name)
    params = _params(name)
    swapped = _params(name)
    for lp in swapped["layers"]:
        lp["ln1_post"], lp["ln2_post"] = lp["ln2_post"], lp["ln1_post"]
    ids = torch.arange(3, 15).reshape(1, 12)
    tables = torch.tensor([[1, 2]], dtype=torch.int32)
    a = core.forward(params, cfg, ids, core.init_paged_pool(cfg, 3, 8, torch.float32), 0,
                     tables)[0]
    b = core.forward(swapped, cfg, ids, core.init_paged_pool(cfg, 3, 8, torch.float32), 0,
                     tables)[0]
    assert (a - b).abs().max() > 1e-3


@pytest.mark.parametrize("name", NAMES)
def test_int8_weights_forward_matches_jax(name):
    jcfg, tree = _tree(name)
    cfg = config.get_config(name)
    qtree = jquant.quantize_params(tree)
    params = params_from_numpy(qtree, cfg, "cpu", torch.float32)
    _prefill_then_decode(jcfg, cfg, qtree, params, None, torch.float32, LOGIT_ATOL)


# ------------------------------------------------------------- checkpoints


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
    st = loader._read_safetensors(tmp_path / "model.safetensors")
    # the (1 + w) fold: the file holds the scale less one, the loaded tree
    # the scale; gemma-2's post_attention_layernorm is the attention
    # OUTPUT's norm, ln1_post
    hf_ln = st["model.layers.1.post_attention_layernorm.weight"].float()
    ours = "layers/ln1_post/scale" if name != "tiny-gemma" else "layers/ln2/scale"
    np.testing.assert_array_equal(
        np.asarray(got[ours][1], np.float32) if dtype == "float32"
        else torch.from_numpy(_bits(got[ours][1]).view(np.int16)).view(torch.bfloat16)
        .float().numpy(), (hf_ln + 1.0).to(tdtype).float().numpy())
    if name != "tiny-gemma":
        assert "layers/ln2_post/scale" in got
        assert "model.layers.0.pre_feedforward_layernorm.weight" in st
    # the port's HF-named state of the same tree (the smoke writes its gemma
    # checkpoints from it) holds JAX's tensors under JAX's names
    state = export._export_llama_state(params_from_numpy(tree, cfg, "cpu"), cfg, tdtype)
    assert sorted(state) == sorted(st)
    assert all(torch.equal(state[k].view(torch.int16) if tdtype == torch.bfloat16
                           else state[k], st[k].view(torch.int16)
                           if tdtype == torch.bfloat16 else st[k]) for k in st)


def test_gemma3_text_checkpoint_serves_from_auto(tmp_path):
    """A gemma3_text HF directory (the port's state + a gemma3_text
    config.json with layer_types) serves through
    ``InferenceEngine("auto", checkpoint_path=...)`` with the tokens of the
    engine over the same params."""
    name = "tiny-gemma3"
    _, tree = _tree(name, seed=2)
    cfg = config.get_config(name)
    params = params_from_numpy(tree, cfg, "cpu")
    export.write_safetensors(tmp_path / "model.safetensors",
                             export._export_llama_state(params, cfg, torch.float32))
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "gemma3_text", "_name_or_path": "tiny-gemma3-ckpt",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.d_model,
        "num_hidden_layers": cfg.n_layers, "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads, "intermediate_size": cfg.d_ff,
        "max_position_embeddings": cfg.max_seq_len, "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta, "rope_local_base_freq": cfg.local_rope_theta,
        "rope_scaling": {"rope_type": "linear", "factor": 8.0},
        "query_pre_attn_scalar": cfg.attn_scale, "rms_norm_eps": cfg.norm_eps,
        "sliding_window": cfg.sliding_window, "hidden_activation": "gelu_pytorch_tanh",
        "layer_types": ["sliding_attention", "sliding_attention", "full_attention"]}))
    ecfg = EngineConfig(dtype="float32", **KW)
    eng = InferenceEngine("auto", checkpoint_path=str(tmp_path), device="cpu",
                          engine_config=ecfg)
    ref = InferenceEngine(cfg, params=params, device="cpu", engine_config=ecfg)
    try:
        assert eng.model_cfg == dataclasses.replace(cfg, name="tiny-gemma3-ckpt")
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_engine_greedy_tokens_equal_jax(name, dtype):
    eng = InferenceEngine(name, params=_params(name), device="cpu",
                          engine_config=EngineConfig(dtype=dtype,
                                                     **dict(KW, cache_dtype=dtype)))
    try:
        assert _port_tokens(eng) == _jax_tokens(name, dtype)
    finally:
        eng.close()


def test_int8_pool_engine_equals_the_jax_int8_pool_engine():
    """tiny-gemma (one kv head) over an int8 pool in f32: the JAX int8-pool
    engine's own greedy tokens."""
    name = "tiny-gemma"
    eng = InferenceEngine(name, params=_params(name), device="cpu",
                          engine_config=EngineConfig(dtype="float32",
                                                     **dict(KW, cache_dtype="int8")))
    try:
        assert eng.kv_quantized
        assert _port_tokens(eng) == _jax_tokens(name, "float32", "int8")
    finally:
        eng.close()


def test_ngram_spec_over_gemma2_keeps_the_greedy_tokens():
    eng = InferenceEngine("tiny-gemma2", params=_params("tiny-gemma2"), device="cpu",
                          engine_config=EngineConfig(dtype="float32", spec_tokens=4, **KW))
    try:
        assert _port_tokens(eng) == _jax_tokens("tiny-gemma2", "float32")
        assert eng.scheduler.stats.spec_steps > 0
    finally:
        eng.close()


def test_lora_batch_over_gemma3_matches_the_jax_pool_engine():
    """An adapter row and a base row in one batch over tiny-gemma3 (the
    adapter's wo delta before ``ln1_post``, its w_down delta before
    ``ln2_post``): the JAX adapter-pool engine's tokens, row by row."""
    name = "tiny-gemma3"
    cfg, jcfg = config.get_config(name), jconfig.get_config(name)
    lcfg = lora.LoraConfig(rank=4, alpha=16.0, targets=("wq", "wv", "wo", "w_gate",
                                                        "w_down"))
    jlcfg = jlora.LoraConfig(rank=4, alpha=16.0, targets=lcfg.targets)
    lora.validate_targets(cfg, lcfg)
    jlora.validate_targets(jcfg, jlcfg)
    io = lora.adapter_target_io(cfg)
    assert io == jlora.adapter_target_io(jcfg)
    rng = np.random.default_rng(4)
    adapters = {n: {t: {"a": (rng.standard_normal((cfg.n_layers, io[t][0], 4)) * 0.2)
                        .astype(np.float32),
                        "b": (rng.standard_normal((cfg.n_layers, 4, io[t][1])) * 0.05)
                        .astype(np.float32)} for t in lcfg.targets} for n in ("a1",)}
    rows = ("a1", None)
    _, tree = _tree(name)
    ecfg = dict(KW, dtype="float32", max_adapters=1)
    jeng = JaxEngine(name, params=tree, engine_config=JaxEngineConfig(**ecfg))
    eng = InferenceEngine(name, params=_params(name), device="cpu",
                          engine_config=EngineConfig(**ecfg))
    try:
        for n, ad in adapters.items():
            jeng.load_adapter(n, ad, jlcfg)
            eng.load_adapter(n, ad, lcfg)
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
        assert want[0] != want[1]
    finally:
        jeng.close()
        eng.close()


def test_model_drafter_over_gemma3_proposes_jax_drafts():
    """The drafter's rectangular cache runs the dual rope and the
    alternating window: its drafts are JAX's."""
    name = "tiny-gemma3"
    _, tree = _tree(name)
    K = 3
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


def test_dispatch_at_eight_and_one_query_heads_a_kv_head():
    """gemma-2b's G = 8 (one kv head): ``decode_f32`` holds 8 T <= 32 rows,
    so T <= 4, and the K = 4 verify chunk (T = 5) goes to the f32 tile form
    at head_dim 256; gemma-7b's G = 1: ``decode_f32`` up to T = 16 (the hd
    256 crossover). bf16 to the head_dim-256 decode and tile forms."""
    for name, G, last_decode_f32 in (("gemma-2b", 8, 4), ("gemma-7b", 1, 16)):
        cfg = config.get_config(name)
        assert cfg.n_heads // cfg.n_kv_heads == G and cfg.head_dim == 256
        for int8 in (False, True):
            assert ragged.ragged_kernel(torch.float32, last_decode_f32, 256, int8,
                                        group=G) == "decode_f32"
            assert ragged.ragged_kernel(torch.float32, last_decode_f32 + 1, 256, int8,
                                        group=G) == "tile_f32"
            assert ragged.ragged_kernel(torch.bfloat16, 1, 256, int8, group=G) == \
                "decode_hd256"
            assert ragged.ragged_kernel(torch.bfloat16, 5, 256, int8, group=G) == \
                "tile_hd256"
    assert ragged.ragged_kernel(torch.float32, 5, 256, group=8) == "tile_f32"


@pytest.mark.parametrize("name", PRESETS)
def test_card_check_takes_the_gemma_presets(name):
    mcfg = config.get_config(name)
    for over in (dict(), dict(cache_dtype="int8", quantize="int8"),
                 dict(dtype="float32", cache_dtype="int8"),
                 dict(dtype="float32", cache_dtype="float32", quantize="int8")):
        check_card_supported(mcfg, EngineConfig(**over), "cuda")
    # the tiny configs' head_dim 16 has no kernel
    with pytest.raises(NotImplementedError, match="head_dim 16"):
        check_card_supported(config.get_config("tiny-gemma"), EngineConfig(), "cuda")


def test_node_service_serves_a_gemma_preset(monkeypatch):
    """serve-cuda's path (``runtime.build_service``) with ``--model
    tiny-gemma2 --quantize int8 --kv-quant`` on the CPU: the service
    answers with the int8-weight engine over an int8 pool."""
    from bee2bee_tpu_torch.services import cuda

    monkeypatch.setattr(cuda, "resolve_device", lambda device=None: torch.device(
        device or "cpu"))
    cfg = NodeConfig(quantize="int8", kv_quant=True, max_seq_len=64, dtype="float32")
    svc = runtime.build_service("cuda", "tiny-gemma2", cfg).load_sync()
    try:
        eng = svc.engine
        assert eng.engine_cfg.quantize == "int8" and eng.kv_quantized
        assert set(eng.params["layers"][0]["attn"]["wq"]) == {"q", "s"}
        assert eng.params["layers"][0]["ln1_post"]["scale"].dtype == torch.float32
        assert svc.get_metadata()["models"] == ["tiny-gemma2"]
        assert len(eng.generate("gemma", max_new_tokens=4, temperature=0.0).token_ids) == 4
    finally:
        eng.close()
