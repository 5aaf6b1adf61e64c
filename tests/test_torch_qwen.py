"""The qwen2 and qwen3 families in the PyTorch port against the JAX package,
at tiny size (``tiny-qwen``: q/k/v biases; ``tiny-qwen3``: head-wise q/k
RMSNorm), on one numpy tree from the JAX init with the biases drawn
nonzero and the norm scales perturbed off 1 (the JAX init draws zeros and
ones, which would prove nothing about either switch).

- ``init_params`` has JAX's schema for both families (zeros, ones).
- The paged forward (a prefill chunk under a write ceil, then two decode
  steps) gives JAX's logits, with JAX on its dense attention and on the
  ragged kernel in interpret mode, over a pool in q's type (f32, 1e-4) and
  over an int8 pool (ragged interpret, 1e-3: the tolerance of the llama
  int8-pool test); with int8 weights (1e-4).
- Yarn: ``scale_rope_freqs`` within 1e-7 of JAX's at rot 16 and 128, and
  a yarn forward's logits within 1e-4 (the llama3 test's tolerance).
- ``params_from_numpy`` / ``params_to_numpy`` round-trip the new keys;
  JAX ``export_hf`` checkpoints load bit-equal in both packages (f32 and
  bf16), and so does the port's HF-named state (``_export_llama_state``).
- Engines: greedy tokens equal to the JAX engine's in f32 and in bf16, and
  with int8 weights beside f32 activations; a mixed LoRA batch equals the
  JAX adapter-pool engine's tokens; n-gram spec keeps the greedy tokens;
  the model drafter proposes JAX's drafts; LoRA validation and
  ``matmul_params_per_token`` agree with JAX.
- The dispatch at G = 7 (qwen2-7b's 28 query heads over 4 kv heads), and
  the card check and the node's service take the qwen presets and int8
  weights beside f32.
"""

from __future__ import annotations

import dataclasses
import functools
import json
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

NAMES = ["tiny-qwen", "tiny-qwen3"]
LOGIT_ATOL = 1e-4
INT8_LOGIT_ATOL = 1e-3
KW = dict(max_seq_len=128, cache_dtype="float32", kv_block_size=16, decode_chunk=4,
          prefill_buckets=(16, 32, 64), max_batch=4)
# two prompts of one prefill bucket: each engine compiles (JAX) one bucket
PROMPTS = ([5, 6, 7, 8, 9, 10, 11, 12], [400, 3, 77] * 5)
NEW = 12
# qwen3's published yarn scaling at tiny size: factor 4 over an original
# context of 64, beta 32 / 1, attention factor 0.1 ln 4 + 1
YARN = ("yarn", 4.0, 0.1 * np.log(4.0) + 1.0, 32.0, 1.0, 64, True)


def _perturb(tree: dict, seed: int) -> dict:
    """The JAX tree with q/k/v biases drawn N(0, 0.5) and q/k norm scales
    1 + N(0, 0.1), in place of JAX's zeros and ones."""
    rng = np.random.default_rng(seed)
    attn = tree["layers"]["attn"]
    for key in ("bq", "bk", "bv"):
        if key in attn:
            attn[key] = (rng.standard_normal(attn[key].shape) * 0.5).astype(np.float32)
    for key in ("q_norm", "k_norm"):
        if key in attn:
            attn[key] = (1.0 + rng.standard_normal(attn[key].shape) * 0.1).astype(np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def _tree(name: str, seed: int = 0) -> dict:
    """(JAX config, the perturbed numpy tree, layers stacked): read only."""
    jcfg = jconfig.get_config(name)
    tree = jax.device_get(jcore.init_params(jcfg, jax.random.key(seed), dtype=jnp.float32))
    return jcfg, _perturb(tree, seed + 1)


def _params(name, dtype=torch.float32, seed=0):
    return params_from_numpy(_tree(name, seed)[1], config.get_config(name), "cpu", dtype)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 and a.dtype.kind != "i" else a


def _assert_flat_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = _bits(got[k]), _bits(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


# ------------------------------------------------------------- params


@pytest.mark.parametrize("name", NAMES)
def test_init_params_schema_matches_jax(name):
    """The same tree and shapes as JAX ``init_params``, biases at zero and
    norm scales at one."""
    jcfg = jconfig.get_config(name)
    want = jcore.unstack_layers(jax.device_get(
        jcore.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)))
    got = init_params(config.get_config(name), torch.Generator().manual_seed(0), "cpu",
                      torch.float32)
    for lp, jlp in zip(got["layers"], want["layers"]):
        assert jax.tree.map(np.shape, jlp) == {
            g: {k: tuple(v.shape) for k, v in d.items()} for g, d in lp.items()}
        for key, fill in (("bq", 0.0), ("bk", 0.0), ("bv", 0.0), ("q_norm", 1.0),
                          ("k_norm", 1.0)):
            if key in jlp["attn"]:
                assert torch.equal(lp["attn"][key], torch.full_like(lp["attn"][key], fill))
    assert ("bq" in got["layers"][0]["attn"]) == (name == "tiny-qwen")
    assert ("q_norm" in got["layers"][0]["attn"]) == (name == "tiny-qwen3")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_params_round_trip_with_bias_and_norm_keys(name, dtype):
    jcfg, tree = _tree(name)
    cfg = config.get_config(name)
    params = params_from_numpy(tree, cfg, "cpu", dtype)
    keys = set(params["layers"][1]["attn"])
    assert keys == set(tree["layers"]["attn"])
    for key in keys - {"wq", "wk", "wv", "wo"}:
        np.testing.assert_array_equal(
            params["layers"][1]["attn"][key].float().numpy(),
            torch.from_numpy(tree["layers"]["attn"][key][1]).to(dtype).float().numpy())
    back = params_from_numpy(params_to_numpy(params), cfg, "cpu", dtype)
    _assert_flat_equal(loader._flatten(back), loader._flatten(params))
    # int8: the biases and norms stay in the activations' type, unquantized
    qp = quant.quantize_params_(params_from_numpy(tree, cfg, "cpu", dtype))
    attn = qp["layers"][0]["attn"]
    assert set(attn["wq"]) == {"q", "s"}
    for key in keys - {"wq", "wk", "wv", "wo"}:
        assert torch.is_tensor(attn[key]) and attn[key].dtype == dtype
    assert sorted(jquant.quantize_params({"layers": {"attn": dict(tree["layers"]["attn"])}})
                  ["layers"]["attn"]) == sorted(attn)


# ------------------------------------------------------------- forward


def _run_jax(jcfg, tree, ids, tables, offset, pool, attn, **kw):
    return jcore.forward(tree, jcfg, jnp.asarray(ids), pool, jnp.asarray(offset, jnp.int32),
                         attn_fn=attn, block_tables=jnp.asarray(tables), **kw)


def _prefill_then_decode(jcfg, cfg, tree, params, attn, pool_dtype, atol):
    """A [2, 16] prefill chunk under a write ceil of 11, then two decode
    steps fed from the JAX argmax: logits within ``atol`` each call."""
    BS, NB, B, Tb = 8, 12, 2, 16
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 500, size=(B, Tb)).astype(np.int32)
    tables = np.zeros((B, 4), np.int32)
    tables[0, :2] = [3, 7]
    tables[1, :3] = [1, 2, 5]
    jpool = jcore.init_paged_pool(jcfg, NB, BS, {torch.int8: jnp.int8}.get(
        pool_dtype, jnp.float32))
    pool = core.init_paged_pool(cfg, NB, BS, pool_dtype)
    jl, jpool = _run_jax(jcfg, tree, ids, tables, [0, 0], jpool, attn,
                         paged_write_ceil=jnp.int32(11))
    tl, pool = core.forward(params, cfg, torch.from_numpy(ids).long(), pool, 0,
                            torch.from_numpy(tables), paged_write_ceil=11)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol, rtol=0)
    offs = np.asarray([11, 11], np.int32)
    cur = np.asarray(jl)[:, 10].argmax(-1).astype(np.int32)
    for _ in range(2):
        jl, jpool = _run_jax(jcfg, tree, cur[:, None], tables, offs, jpool, attn)
        tl, pool = core.forward(params, cfg, torch.from_numpy(cur[:, None]).long(), pool,
                                torch.from_numpy(offs), torch.from_numpy(tables))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol, rtol=0)
        cur = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
        offs = offs + 1
    return tl


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


@pytest.mark.parametrize("name", NAMES)
def test_switches_change_the_function(name):
    """The perturbed biases / norms reach the logits: the same forward
    without them is another function."""
    _, tree = _tree(name)
    cfg = config.get_config(name)
    params = _params(name)
    bare = params_from_numpy(tree, cfg, "cpu")
    for lp in bare["layers"]:
        for key in ("bq", "bk", "bv", "q_norm", "k_norm"):
            lp["attn"].pop(key, None)
    ids = torch.arange(3, 15).reshape(1, 12)
    tables = torch.tensor([[1, 2]], dtype=torch.int32)
    a = core.forward(params, cfg, ids, core.init_paged_pool(cfg, 3, 8, torch.float32), 0,
                     tables)[0]
    b = core.forward(bare, cfg, ids, core.init_paged_pool(cfg, 3, 8, torch.float32), 0,
                     tables)[0]
    assert (a - b).abs().max() > 1e-2


@pytest.mark.parametrize("name", NAMES)
def test_int8_weights_forward_matches_jax(name):
    jcfg, tree = _tree(name)
    cfg = config.get_config(name)
    qtree = jquant.quantize_params(tree)
    params = params_from_numpy(qtree, cfg, "cpu", torch.float32)
    _prefill_then_decode(jcfg, cfg, qtree, params, None, torch.float32, LOGIT_ATOL)


# ------------------------------------------------------------- yarn


@pytest.mark.parametrize("scaling", [YARN, ("yarn", 8.0, 1.0, 32.0, 1.0, 8192, True),
                                     ("yarn", 4.0, 1.2, 16.0, 2.0, 32768, False)],
                         ids=["tiny", "8k", "no-truncate"])
@pytest.mark.parametrize("rot", [16, 128])
def test_scale_rope_freqs_yarn_matches_jax(scaling, rot):
    theta = 1000000.0
    f = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    want = np.asarray(jcore.scale_rope_freqs(jnp.asarray(f), scaling, theta=theta, rot=rot))
    got = core.scale_rope_freqs(torch.from_numpy(f), scaling, theta=theta, rot=rot).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert not np.array_equal(got, f)
    with pytest.raises(ValueError, match="theta and rot"):
        core.scale_rope_freqs(torch.from_numpy(f), scaling)


def test_yarn_forward_logits_match_jax():
    """tiny-qwen3 with yarn (factor 4 over 64 positions, attention factor
    1.139): prefill and decode within the llama3 test's 1e-4; the factor
    and the ramp are live."""
    jcfg, tree = _tree("tiny-qwen3")
    jcfg = dataclasses.replace(jcfg, rope_scaling=YARN)
    cfg = dataclasses.replace(config.get_config("tiny-qwen3"), rope_scaling=YARN)
    core.check_supported(cfg)
    params = _params("tiny-qwen3")
    got = _prefill_then_decode(jcfg, cfg, tree, params, None, torch.float32, LOGIT_ATOL)
    freqs = core.rope_freqs(cfg, "cpu")
    assert core.rope_freqs(cfg, "cpu") is freqs  # kept: the roots only read it
    plain = core.rope_freqs(config.get_config("tiny-qwen3"), "cpu")
    assert not torch.equal(freqs, plain)
    cos, sin, factor = core.rope_angles(torch.zeros((1, 1), dtype=torch.long), cfg)
    assert factor == YARN[2] and core.rope_angles(
        torch.zeros((1, 1), dtype=torch.long), config.get_config("tiny-qwen3"))[2] is None
    assert torch.isfinite(got).all()


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
    src = jloader._flatten(jax.tree.map(lambda a: np.asarray(a).astype(jnp.dtype(dtype)),
                                        tree))
    _assert_flat_equal(got, src)
    assert any(k.endswith(("/bq", "/q_norm")) for k in got)
    # the port's HF-named state of the same tree (the smoke writes its qwen
    # checkpoints from it) holds JAX's tensors under JAX's names
    state = export._export_llama_state(params_from_numpy(tree, cfg, "cpu"), cfg, tdtype)
    st = loader._read_safetensors(tmp_path / "model.safetensors")
    assert sorted(state) == sorted(st)
    assert all(torch.equal(state[k].view(torch.int16) if tdtype == torch.bfloat16
                           else state[k], st[k].view(torch.int16)
                           if tdtype == torch.bfloat16 else st[k]) for k in st)


def test_hf_checkpoint_with_config_json_serves_from_auto(tmp_path):
    """A qwen3 HF checkpoint (the port's state + a qwen3 config.json with
    yarn) serves through ``InferenceEngine("auto", checkpoint_path=...)``
    with the tokens of the engine over the same params."""
    _, tree = _tree("tiny-qwen3", seed=2)
    cfg = dataclasses.replace(config.get_config("tiny-qwen3"), rope_scaling=YARN,
                              name="tiny-qwen3-ckpt")
    params = params_from_numpy(tree, cfg, "cpu")
    export.write_safetensors(tmp_path / "model.safetensors",
                             export._export_llama_state(params, cfg, torch.float32))
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "qwen3", "_name_or_path": cfg.name, "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.d_ff, "max_position_embeddings": cfg.max_seq_len,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps, "head_dim": 16,
        "tie_word_embeddings": False,
        "rope_scaling": {"rope_type": "yarn", "factor": 4.0,
                         "original_max_position_embeddings": 64}}))
    ecfg = EngineConfig(dtype="float32", **KW)
    eng = InferenceEngine("auto", checkpoint_path=str(tmp_path), device="cpu",
                          engine_config=ecfg)
    ref = InferenceEngine(cfg, params=params, device="cpu", engine_config=ecfg)
    try:
        assert eng.model_cfg == cfg
        for p in PROMPTS:
            assert eng.generate(p, max_new_tokens=NEW, temperature=0.0).token_ids == \
                ref.generate(p, max_new_tokens=NEW, temperature=0.0).token_ids
    finally:
        eng.close()
        ref.close()


# ------------------------------------------------------------- engines


@functools.lru_cache(maxsize=None)
def _jax_tokens(name: str, dtype: str, quantize: str = "none") -> tuple:
    """The JAX engine's greedy tokens on PROMPTS over the perturbed tree."""
    _, tree = _tree(name)
    eng = JaxEngine(name, params=tree, engine_config=JaxEngineConfig(
        dtype=dtype, quantize=quantize, **dict(KW, cache_dtype=dtype)))
    try:
        return tuple(tuple(eng.generate(p, max_new_tokens=NEW, temperature=0.0).token_ids)
                     for p in PROMPTS)
    finally:
        eng.close()


def _port_tokens(eng) -> tuple:
    return tuple(tuple(eng.generate(p, max_new_tokens=NEW, temperature=0.0).token_ids)
                 for p in PROMPTS)


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


@pytest.mark.parametrize("name", NAMES)
def test_int8_weights_beside_f32_engine_equals_jax(name):
    """``quantize="int8"`` with f32 activations: the tokens of the JAX
    int8-weight engine; the biases and norms stay f32."""
    eng = InferenceEngine(name, params=_params(name), device="cpu",
                          engine_config=EngineConfig(dtype="float32", quantize="int8", **KW))
    try:
        assert _port_tokens(eng) == _jax_tokens(name, "float32", "int8")
        attn = eng.params["layers"][0]["attn"]
        assert set(attn["wq"]) == {"q", "s"}
        assert all(attn[k].dtype == torch.float32 for k in attn if k not in
                   ("wq", "wk", "wv", "wo"))
    finally:
        eng.close()


def test_ngram_spec_over_qwen3_keeps_the_greedy_tokens():
    eng = InferenceEngine("tiny-qwen3", params=_params("tiny-qwen3"), device="cpu",
                          engine_config=EngineConfig(dtype="float32", spec_tokens=4, **KW))
    try:
        assert _port_tokens(eng) == _jax_tokens("tiny-qwen3", "float32")
        assert eng.scheduler.stats.spec_steps > 0
    finally:
        eng.close()


def test_lora_batch_over_qwen3_matches_the_jax_pool_engine():
    """An adapter row and a base row in one batch over tiny-qwen3: the JAX
    adapter-pool engine's tokens, row by row; ``validate_targets`` and
    ``adapter_target_io`` agree with JAX."""
    name = "tiny-qwen3"
    cfg, jcfg = config.get_config(name), jconfig.get_config(name)
    lcfg = lora.LoraConfig(rank=4, alpha=16.0, targets=("wq", "wk", "wv", "wo", "w_up"))
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
    finally:
        jeng.close()
        eng.close()


def test_model_drafter_over_qwen2_proposes_jax_drafts():
    name = "tiny-qwen"
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


@pytest.mark.parametrize("name", ["qwen2-7b", "qwen3-8b", "tiny-qwen", "tiny-qwen3"])
def test_matmul_params_per_token_matches_jax(name):
    assert core.matmul_params_per_token(config.get_config(name)) == \
        jcore.matmul_params_per_token(jconfig.get_config(name))


# ------------------------------------------------------------- the card


def test_dispatch_at_seven_query_heads_a_kv_head():
    """qwen2-7b's G = 7: decode and short f32 chunks whose 7 T rows fit
    ``decode_f32`` go there; a verify chunk of T = 5 (35 rows) goes to the
    f32 tile form; bf16 to the decode and tile kernels."""
    cfg = config.get_config("qwen2-7b")
    G = cfg.n_heads // cfg.n_kv_heads
    assert G == 7 and cfg.head_dim == 128
    assert ragged.ragged_kernel(torch.float32, 1, 128, group=G) == "decode_f32"
    assert ragged.ragged_kernel(torch.float32, 4, 128, True, group=G) == "decode_f32"
    assert ragged.ragged_kernel(torch.float32, 5, 128, group=G) == "tile_f32"
    assert ragged.ragged_kernel(torch.bfloat16, 1, 128, True, group=G) == "decode"
    assert ragged.ragged_kernel(torch.bfloat16, 5, 128, True, group=G) == "tile"


@pytest.mark.parametrize("name", ["qwen2-7b", "qwen3-8b"])
def test_card_check_takes_qwen_and_int8_weights_beside_f32(name):
    mcfg = config.get_config(name)
    core.check_supported(mcfg)
    core.check_supported(dataclasses.replace(mcfg, rope_scaling=YARN))
    for over in (dict(), dict(cache_dtype="int8", quantize="int8"),
                 dict(dtype="float32", cache_dtype="int8", quantize="int8"),
                 dict(dtype="float32", cache_dtype="float32", quantize="int8")):
        check_card_supported(mcfg, EngineConfig(**over), "cuda")
    node = NodeConfig(dtype="float32", quantize="int8", kv_quant=True).engine_config()
    check_card_supported(mcfg, node, "cuda")


def test_node_service_serves_a_qwen_preset_with_int8_weights_in_f32(monkeypatch):
    """serve-cuda's path (``runtime.build_service``) with ``--model
    tiny-qwen3 --quantize int8`` in f32 (``BEE2BEE_DTYPE=float32``: the
    node config's dtype), on the CPU: the service answers with the
    int8-weight engine."""
    from bee2bee_tpu_torch.services import cuda

    monkeypatch.setattr(cuda, "resolve_device", lambda device=None: torch.device(
        device or "cpu"))
    cfg = NodeConfig(quantize="int8", max_seq_len=64, dtype="float32")
    svc = runtime.build_service("cuda", "tiny-qwen3", cfg).load_sync()
    try:
        eng = svc.engine
        assert eng.engine_cfg.quantize == "int8" and eng.engine_cfg.dtype == "float32"
        assert set(eng.params["layers"][0]["attn"]["wq"]) == {"q", "s"}
        assert svc.get_metadata()["models"] == ["tiny-qwen3"]
        assert len(eng.generate("qwen", max_new_tokens=4, temperature=0.0).token_ids) == 4
    finally:
        eng.close()
