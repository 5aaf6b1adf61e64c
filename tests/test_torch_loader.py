"""The port's checkpoint path against the JAX package, at tiny sizes:
``models/config.py`` (``config_from_hf``, ``config_for_checkpoint``),
``models/core.py`` (``scale_rope_freqs``), ``models/loader.py``,
``models/export.py``, ``engine/tokenizer.py`` and the engine, drafter and
service from a checkpoint.

- ``config_from_hf`` equals JAX's field for field on the config.json
  dicts JAX's ``hf_config_dict`` writes for every family it exports, and on
  phi-3 and yarn dicts; a family the port's core cannot run still parses
  and ``check_supported`` refuses it by item 11; qwen2, qwen3, yarn,
  the gemma family (gemma, gemma2, gemma3_text) and the gpt2 block (gpt2,
  gpt_bigcode) pass it.
- The linear and llama3 rope scalings equal JAX's within 1e-7, and a tiny
  llama-3.1 forward's f32 logits JAX's within 1e-4.
- Checkpoints written by JAX ``export_hf`` and by the port's (f32 and
  bf16, one file or shards; tiny-llama, tiny-mistral, a tiny llama-3.1 and
  a phi-3-shaped checkpoint with fused tensors) load bit-equal in both
  packages, and equal the tree they were written from; ``pytorch_model.bin``
  loads as the safetensors do.
- Native ``save_native`` dirs cross between the packages both ways, bit
  for bit (f32 and bf16).
- The engine from a checkpoint (``"auto"``) decodes JAX's engine's greedy
  tokens; with ``quantize="int8"`` its packed weights equal quantizing the
  loaded ones, and its tokens the in-memory int8 engine's.
- Other converters, export families and expert tensors raise by item
  number; yarn's kept frequencies equal JAX's.
- Tokenizer files without ``transformers`` raise; a path with none takes
  the byte tokenizer.
- The loader, pieces, weights and export modules import neither
  ml_dtypes, safetensors nor transformers at module level.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee2bee_tpu.engine import EngineConfig as JaxEngineConfig
from bee2bee_tpu.engine import InferenceEngine as JaxEngine
from bee2bee_tpu.models import config as jconfig
from bee2bee_tpu.models import core as jcore
from bee2bee_tpu.models import export as jexport
from bee2bee_tpu.models import loader as jloader
from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
from bee2bee_tpu_torch.engine import tokenizer
from bee2bee_tpu_torch.engine.drafter import DraftModel
from bee2bee_tpu_torch.models import config, core, export, loader
from bee2bee_tpu_torch.models.params import params_from_numpy, params_to_numpy
from bee2bee_tpu_torch.models.quant import quantize_params_
from bee2bee_tpu_torch.services.cuda import CUDAService

ROOT = Path(__file__).resolve().parent.parent
# llama-3.1's rope schedule at tiny size: original context 256 puts the
# eight frequencies of head_dim 16 in all three bands (kept, smoothed,
# divided)
LLAMA31 = dict(name="tiny-llama31", rope_theta=500000.0, tie_embeddings=False,
               rope_scaling=("llama3", 8.0, 1.0, 4.0, 256))
PHI3 = dict(name="tiny-phi3", n_kv_heads=4, tie_embeddings=False, sliding_window=16)
KW = dict(max_seq_len=128, dtype="float32", cache_dtype="float32", kv_block_size=16,
          decode_chunk=4, prefill_buckets=(16, 32, 64), max_batch=4)


def _cfgs(name):
    base = "tiny-llama" if name in ("tiny-llama31", "tiny-phi3") else name
    over = {"tiny-llama31": LLAMA31, "tiny-phi3": PHI3}.get(name, {})
    return (dataclasses.replace(jconfig.get_config(base), **over),
            dataclasses.replace(config.get_config(base), **over))


def _jax_tree(jcfg, seed=0):
    return jax.device_get(jcore.init_params(jcfg, jax.random.key(seed), dtype=jnp.float32))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 and a.dtype.kind != "i" else a


def _assert_flat_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = _bits(got[k]), _bits(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


# ------------------------------------------------------------- config


HF_NAMES = ["tiny-llama", "llama-3-8b", "llama-3.1-8b", "mistral-7b", "tiny-mistral",
            "qwen2-7b", "qwen3-8b", "gemma-7b", "gemma-2-9b", "mixtral-8x7b",
            "qwen3-30b-a3b", "gpt2", "starcoder-15b", "pythia-1.4b", "falcon-7b",
            "gpt-j-6b", "phi-2", "bloom-7b1", "mpt-7b", "olmo2-7b", "stablelm-2-1.6b"]
EXTRA_DICTS = {
    "phi3": {"model_type": "phi3", "vocab_size": 32064, "hidden_size": 3072,
             "num_hidden_layers": 32, "num_attention_heads": 32,
             "num_key_value_heads": 32, "intermediate_size": 8192,
             "max_position_embeddings": 4096, "sliding_window": 2047},
    "llama-yarn": {"model_type": "llama", "vocab_size": 512, "hidden_size": 64,
                   "num_hidden_layers": 2, "num_attention_heads": 4,
                   "intermediate_size": 128, "max_position_embeddings": 4096,
                   "rope_scaling": {"rope_type": "yarn", "factor": 4.0,
                                    "original_max_position_embeddings": 1024}},
    "gemma3-text": {"model_type": "gemma3_text", "vocab_size": 262208, "hidden_size": 2304,
                    "num_hidden_layers": 34, "num_attention_heads": 8,
                    "num_key_value_heads": 4, "head_dim": 256, "intermediate_size": 9216,
                    "max_position_embeddings": 131072, "query_pre_attn_scalar": 256,
                    "rope_theta": 1000000.0, "rope_local_base_freq": 10000.0,
                    "rope_scaling": {"rope_type": "linear", "factor": 8.0},
                    "sliding_window": 1024, "sliding_window_pattern": 6,
                    "rms_norm_eps": 1e-6, "hidden_activation": "gelu_pytorch_tanh"},
    "llama3-dict": {"model_type": "llama", "vocab_size": 128256, "hidden_size": 4096,
                    "num_hidden_layers": 2, "num_attention_heads": 32,
                    "num_key_value_heads": 8, "intermediate_size": 14336,
                    "max_position_embeddings": 131072, "rope_theta": 500000.0,
                    "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
                    "_name_or_path": "meta-llama/Llama-3.1-8B",
                    "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                                     "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                     "original_max_position_embeddings": 8192}},
}


def _hf_dict(key):
    if key in EXTRA_DICTS:
        return EXTRA_DICTS[key]
    return jexport.hf_config_dict(jconfig.get_config(key))


@pytest.mark.parametrize("key", HF_NAMES + list(EXTRA_DICTS))
def test_config_from_hf_matches_jax(key):
    d = _hf_dict(key)
    got = dataclasses.asdict(config.config_from_hf(d))
    assert got == dataclasses.asdict(jconfig.config_from_hf(d))
    if key == "llama3-dict":
        assert got["rope_scaling"] == ("llama3", 8.0, 1.0, 4.0, 8192)
        assert got["name"] == "meta-llama/Llama-3.1-8B"
        assert got == dataclasses.asdict(dataclasses.replace(
            config.get_config("llama-3.1-8b"), n_layers=2, name=got["name"]))


@pytest.mark.parametrize("key", ["gpt-j-6b", "olmo2-7b", "pythia-1.4b", "falcon-7b",
                                 "phi-2", "bloom-7b1"])
def test_family_the_core_cannot_run_parses_then_refuses_by_item_11(key):
    cfg = config.config_from_hf(_hf_dict(key))
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue A item 11\)"):
        core.check_supported(cfg)


@pytest.mark.parametrize("key", ["qwen2-7b", "qwen3-8b", "llama-yarn", "gemma-7b",
                                 "gemma-2-9b", "gemma3-text", "gpt2", "starcoder-15b",
                                 "mixtral-8x7b", "qwen3-30b-a3b"])
def test_family_the_core_runs_parses_then_passes_the_core(key):
    """qwen2 (q/k/v biases), qwen3 (head-wise q/k norms), yarn rope
    scaling, the gemma family (gemma, gemma2, gemma3_text), the gpt2
    block (gpt2, gpt_bigcode) and the MoE families (mixtral, qwen3_moe):
    parsed as JAX parses them, and the core runs them."""
    cfg = config.config_from_hf(_hf_dict(key))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jconfig.config_from_hf(_hf_dict(key)))
    core.check_supported(cfg)
    assert (cfg.qkv_bias, cfg.qk_norm) == {"qwen2-7b": (True, False), "qwen3-8b": (False, True),
                                           "gemma3-text": (False, True),
                                           "qwen3-30b-a3b": (False, True)}.get(key, (False, False))
    assert cfg.n_experts == {"mixtral-8x7b": 8, "qwen3-30b-a3b": 128}.get(key, 0)
    if key == "llama-yarn":
        assert cfg.rope_scaling[0] == "yarn"
    if key.startswith("gemma"):
        assert cfg.activation == "geglu" and cfg.embedding_scale and cfg.norm_plus_one
        assert cfg.post_norms == (key != "gemma-7b")
    if key == "gemma3-text":
        assert cfg.local_rope_theta == 10000.0 and cfg.rope_scaling == ("linear", 8.0)
        assert (cfg.sliding_window_every, cfg.sliding_window_residues) == (6, (0, 1, 2, 3, 4))


def test_llama31_and_phi3_pass_the_core():
    core.check_supported(config.get_config("llama-3.1-8b"))
    core.check_supported(config.config_from_hf(EXTRA_DICTS["phi3"]))


def test_config_for_checkpoint_and_resolve(tmp_path, caplog):
    jcfg, cfg = _cfgs("tiny-llama31")
    (tmp_path / "model_config.json").write_text(json.dumps(
        dict(cfg.__dict__, future_switch=True), default=str))
    with caplog.at_level("WARNING"):
        got = config.config_for_checkpoint(tmp_path)
    assert got == cfg and "future_switch" in caplog.text
    assert config.resolve_model_config("auto", str(tmp_path)) == cfg
    assert config.resolve_model_config("tiny-llama", str(tmp_path)).name == "tiny-llama"
    with pytest.raises(KeyError):
        config.resolve_model_config("auto")
    with pytest.raises(FileNotFoundError):
        config.config_for_checkpoint(tmp_path / "empty")


# ------------------------------------------------------------- rope


@pytest.mark.parametrize("scaling", [("linear", 8.0), ("llama3", 8.0, 1.0, 4.0, 256),
                                     ("llama3", 8.0, 1.0, 4.0, 8192)])
@pytest.mark.parametrize("rot", [16, 128])
def test_scale_rope_freqs_matches_jax(scaling, rot):
    f = 1.0 / (500000.0 ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    want = np.asarray(jcore.scale_rope_freqs(jnp.asarray(f), scaling))
    got = core.scale_rope_freqs(torch.from_numpy(f), scaling).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert not np.array_equal(got, f)


def test_rope_freqs_are_computed_once_per_config_and_device():
    _, cfg = _cfgs("tiny-llama31")
    freqs = core.rope_freqs(cfg, "cpu")
    assert core.rope_freqs(dataclasses.replace(cfg, name="other"), "cpu") is freqs
    assert core.rope_freqs(dataclasses.replace(cfg, rope_scaling=None), "cpu") is not freqs


# the name is historical: the test held the yarn refusal that yarn's port lifted
def test_rope_freqs_refuses_yarn():
    """Yarn runs since queue A item 11.1 was finished: the kept frequency
    vector of a yarn config equals JAX's (theta and the rotary dims passed
    through, as ``_rope`` passes them) within 1e-7, and only a yarn
    scaling without theta and rot is still refused."""
    cfg = config.config_from_hf(EXTRA_DICTS["llama-yarn"])
    jcfg = jconfig.config_from_hf(EXTRA_DICTS["llama-yarn"])
    rot = jcfg.rotary_dim
    f = 1.0 / (jcfg.rope_theta ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    want = np.asarray(jcore.scale_rope_freqs(jnp.asarray(f), jcfg.rope_scaling,
                                             theta=jcfg.rope_theta, rot=rot))
    got = core.rope_freqs(cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert not np.array_equal(got, f)
    with pytest.raises(ValueError, match="theta and rot"):
        core.scale_rope_freqs(torch.from_numpy(f), cfg.rope_scaling)


def test_llama31_forward_logits_match_jax():
    jcfg, cfg = _cfgs("tiny-llama31")
    tree = _jax_tree(jcfg, seed=4)
    params = params_from_numpy(tree, cfg, "cpu")
    rng = np.random.default_rng(7)
    B, T, BS, NB = 2, 40, 8, 16
    ids = rng.integers(3, 500, size=(B, T)).astype(np.int32)
    tables = np.zeros((B, 8), np.int32)
    tables[0, :5] = [1, 2, 3, 4, 5]
    tables[1, :5] = [6, 7, 8, 9, 10]
    jpool = jcore.init_paged_pool(jcfg, NB, BS, jnp.float32)
    want, _ = jcore.forward(tree, jcfg, jnp.asarray(ids), jpool, jnp.asarray([0, 0], jnp.int32),
                            block_tables=jnp.asarray(tables))
    pool = core.init_paged_pool(cfg, NB, BS, torch.float32)
    got, _ = core.forward(params, cfg, torch.from_numpy(ids).long(), pool, 0,
                          torch.from_numpy(tables))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    # the scaling is live: the unscaled forward is another function
    plain = dataclasses.replace(cfg, rope_scaling=None)
    other, _ = core.forward(params, plain, torch.from_numpy(ids).long(),
                            core.init_paged_pool(cfg, NB, BS, torch.float32), 0,
                            torch.from_numpy(tables))
    assert (other - got).abs().max() > 1e-3


# ------------------------------------------------------------- checkpoints


def _phi3_dir(path: Path, jcfg, tree):
    """A phi-3-shaped checkpoint: JAX's llama export with q/k/v and
    gate/up fused the way Phi-3 stores them."""
    jexport.export_hf(tree, jcfg, path)
    st = loader._read_safetensors(path / "model.safetensors")
    fused = {}
    for k, v in st.items():
        if ".self_attn.q_proj." in k:
            base = k.replace("q_proj", "{}")
            fused[base.format("qkv_proj")] = torch.cat(
                [st[base.format(n)] for n in ("q_proj", "k_proj", "v_proj")])
        elif ".mlp.gate_proj." in k:
            fused[k.replace("gate_proj", "gate_up_proj")] = torch.cat(
                [v, st[k.replace("gate_proj", "up_proj")]])
        elif not any(s in k for s in ("k_proj", "v_proj", "up_proj")):
            fused[k] = v
    (path / "model.safetensors").unlink()
    export.write_safetensors(path / "model.safetensors", fused)
    d = dict(EXTRA_DICTS["phi3"], vocab_size=jcfg.vocab_size, hidden_size=jcfg.d_model,
             num_hidden_layers=jcfg.n_layers, num_attention_heads=jcfg.n_heads,
             num_key_value_heads=jcfg.n_kv_heads, intermediate_size=jcfg.d_ff,
             max_position_embeddings=jcfg.max_seq_len, sliding_window=jcfg.sliding_window,
             rms_norm_eps=jcfg.norm_eps)
    (path / "config.json").write_text(json.dumps(d))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,writer", [
    (n, w) for n in ("tiny-llama", "tiny-mistral", "tiny-llama31")
    for w in ("jax", "port", "port-shards")] + [("tiny-phi3", "jax")])
def test_checkpoint_loads_bit_equal_in_both_packages(name, writer, dtype, tmp_path):
    jcfg, cfg = _cfgs(name)
    tree = _jax_tree(jcfg, seed=1)
    if name == "tiny-phi3":
        _phi3_dir(tmp_path, jcfg, tree)
    elif writer == "jax":
        jexport.export_hf(tree, jcfg, tmp_path, dtype=dtype)
    else:
        params = params_from_numpy(tree, cfg, "cpu")
        export.export_hf(params, cfg, tmp_path, dtype=dtype,
                         max_shard_bytes=40_000 if writer == "port-shards" else None)
        files = sorted(p.name for p in tmp_path.glob("*.safetensors"))
        if writer == "port-shards":
            index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
            assert len(files) > 1 and sorted(set(index["weight_map"].values())) == files
        else:
            assert files == ["model.safetensors"]
    assert config.config_for_checkpoint(tmp_path).__dict__ == \
        jconfig.config_for_checkpoint(tmp_path).__dict__
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    got = loader._flatten(loader.load_checkpoint(tmp_path, cfg, tdtype, "cpu"))
    want = jloader._flatten(jloader.load_checkpoint(tmp_path, jcfg, jnp.dtype(dtype), host=True))
    _assert_flat_equal(got, want)
    # and the tree it was written from
    src = jloader._flatten(jax.tree.map(lambda a: np.asarray(a).astype(jnp.dtype(dtype)), tree))
    _assert_flat_equal(got, src)


def test_pytorch_bin_loads_as_the_safetensors_do(tmp_path):
    jcfg, cfg = _cfgs("tiny-llama31")
    jexport.export_hf(_jax_tree(jcfg), jcfg, tmp_path, dtype="bfloat16")
    want = loader._flatten(loader.load_checkpoint(tmp_path, cfg, torch.bfloat16, "cpu"))
    state = loader._read_safetensors(tmp_path / "model.safetensors")
    (tmp_path / "model.safetensors").unlink()
    torch.save({k: v.clone() for k, v in state.items()}, tmp_path / "pytorch_model.bin")
    got = loader._flatten(loader.load_checkpoint(tmp_path, cfg, torch.bfloat16, "cpu"))
    _assert_flat_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_native_dirs_cross_both_ways(dtype, tmp_path):
    jcfg, cfg = _cfgs("tiny-llama31")
    tree = jax.tree.map(lambda a: np.asarray(a).astype(jnp.dtype(dtype)), _jax_tree(jcfg, 2))
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    params = params_from_numpy(tree, cfg, "cpu", tdtype)
    loader.save_native(params, cfg, tmp_path / "port")
    jloader.save_native(tree, jcfg, tmp_path / "jax")
    want = jloader._flatten(tree)
    for d in ("port", "jax"):
        _assert_flat_equal(loader._flatten(loader.load_native(tmp_path / d, device="cpu",
                                                              dtype=tdtype)), want)
        _assert_flat_equal(jloader._flatten(jloader.load_native(
            tmp_path / d, dtype=jnp.dtype(dtype), host=True)), want)
        assert config.config_for_checkpoint(tmp_path / d) == cfg
    with pytest.raises(NotImplementedError, match="item 14"):
        loader.save_native(params, cfg, tmp_path / "mesh", mesh_axes={"model": 2})


def test_other_converters_and_export_families_raise_by_item(tmp_path):
    jcfg = jconfig.get_config("tiny-phi")
    jexport.export_hf(_jax_tree(jcfg), jcfg, tmp_path)
    cfg = config.config_for_checkpoint(tmp_path)
    with pytest.raises(NotImplementedError, match=r"phi.*item 11\)"):
        loader.load_checkpoint(tmp_path, cfg, torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match=r"item 15\)"):
        export.hf_config_dict(config.get_config("tiny-qwen3"))
    # an expert's tensor under a config without experts is refused, not
    # dropped
    mcfg = jconfig.get_config("tiny-mixtral")
    jexport.export_hf(_jax_tree(mcfg), mcfg, tmp_path / "mixtral")
    with pytest.raises(ValueError, match=r"block_sparse_moe.*no experts"):
        loader.load_checkpoint(tmp_path / "mixtral", _cfgs("tiny-llama")[1], torch.float32,
                               "cpu")


def test_hf_config_dict_matches_jax_for_llama_families():
    for name in ("tiny-llama", "llama-3.1-8b", "mistral-7b", "tiny-mistral", "tiny-mixtral",
                 "mixtral-8x7b", "tiny-qwen3moe", "qwen3-30b-a3b"):
        assert export.hf_config_dict(config.get_config(name)) == \
            jexport.hf_config_dict(jconfig.get_config(name))


# ------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def llama31_dir(tmp_path_factory):
    jcfg, _ = _cfgs("tiny-llama31")
    path = tmp_path_factory.mktemp("llama31")
    jexport.export_hf(_jax_tree(jcfg, seed=3), jcfg, path)
    return path


PROMPTS = ["user: the checkpoint speaks\nassistant:", "0123 4567 89ab cdef"]


def test_engine_from_checkpoint_decodes_jax_engines_tokens(llama31_dir):
    jeng = JaxEngine("auto", engine_config=JaxEngineConfig(**KW),
                     checkpoint_path=str(llama31_dir))
    eng = InferenceEngine("auto", checkpoint_path=str(llama31_dir), device="cpu",
                          engine_config=EngineConfig(**KW))
    try:
        assert eng.model_cfg == config.config_for_checkpoint(llama31_dir)
        assert eng.model_cfg.rope_scaling == LLAMA31["rope_scaling"]
        for p in PROMPTS:
            want = jeng.generate(p, max_new_tokens=20, temperature=0.0).token_ids
            assert eng.generate(p, max_new_tokens=20, temperature=0.0).token_ids == want
        assert isinstance(eng.tokenizer, tokenizer.ByteTokenizer)
        # the service advertises the checkpoint's name for --model auto
        svc = CUDAService("auto", engine=eng, device="cpu").load_sync()
        assert svc.get_metadata()["models"] == [eng.model_cfg.name]
    finally:
        jeng.close()
        eng.close()


def test_int8_engine_from_checkpoint_quantizes_as_it_uploads(llama31_dir):
    ecfg = EngineConfig(**dict(KW, quantize="int8"))
    eng = InferenceEngine("auto", checkpoint_path=str(llama31_dir), device="cpu",
                          engine_config=ecfg)
    dense = loader.load_checkpoint(llama31_dir, eng.model_cfg, torch.float32, "cpu")
    ref = InferenceEngine(eng.model_cfg, params=dense, device="cpu", engine_config=ecfg)
    try:
        want = quantize_params_(loader.load_checkpoint(llama31_dir, eng.model_cfg,
                                                       torch.float32, "cpu"))
        for lp, wp in zip(eng.params["layers"], want["layers"]):
            for g in ("attn", "mlp"):
                for k, w in wp[g].items():
                    assert set(lp[g][k]) == set(w)
                    for part in w:
                        assert torch.equal(lp[g][k][part], w[part]), (g, k, part)
        assert eng.load_stats["bytes"] > 0
        for p in PROMPTS:
            assert eng.generate(p, max_new_tokens=12, temperature=0.0).token_ids == \
                ref.generate(p, max_new_tokens=12, temperature=0.0).token_ids
    finally:
        eng.close()
        ref.close()


def test_drafter_from_checkpoint_drafts_as_from_its_params(llama31_dir):
    cfg = config.config_for_checkpoint(llama31_dir)
    params = loader.load_checkpoint(llama31_dir, cfg, torch.float32, "cpu")
    a = DraftModel("auto", spec_tokens=3, batch=1, target_max_seq_len=64,
                   checkpoint_path=str(llama31_dir), device="cpu")
    b = DraftModel(cfg, spec_tokens=3, batch=1, target_max_seq_len=64, params=params,
                   device="cpu")
    assert a.cfg == cfg and isinstance(a.tokenizer, tokenizer.ByteTokenizer)
    _assert_flat_equal(loader._flatten(a.params), loader._flatten(b.params))


# ------------------------------------------------------------- tokenizer


def test_tokenizer_files_without_transformers_raise(tmp_path, monkeypatch):
    (tmp_path / "tokenizer_config.json").write_text("{}")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(tokenizer.TokenizerLoadError, match="transformers"):
        tokenizer.load_tokenizer(str(tmp_path), 512)
    # no tokenizer files: the byte tokenizer, as in JAX
    assert isinstance(tokenizer.load_tokenizer(str(tmp_path / "none"), 512),
                      tokenizer.ByteTokenizer)
    (tmp_path / "tokenizer_config.json").unlink()
    assert isinstance(tokenizer.load_tokenizer(str(tmp_path), 512), tokenizer.ByteTokenizer)


def test_broken_tokenizer_files_raise_rather_than_serve_bytes(tmp_path):
    (tmp_path / "tokenizer.json").write_text("not a tokenizer")
    with pytest.raises(tokenizer.TokenizerLoadError, match="did not load"):
        tokenizer.load_tokenizer(str(tmp_path), 512)


# ------------------------------------------------------------- imports


@pytest.mark.parametrize("module", ["models/loader.py", "models/export.py", "pieces.py",
                                    "meshnet/weights.py", "models/params.py"])
def test_module_level_imports_need_no_ml_dtypes_safetensors_or_transformers(module):
    tree = ast.parse((ROOT / "bee2bee_tpu_torch" / module).read_text())
    for node in tree.body:
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in ("ml_dtypes", "safetensors", "transformers",
                                              "jax", "bee2bee_tpu"), (module, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", ["tiny-mixtral", "tiny-qwen3moe"])
def test_moe_checkpoints_load_bit_equal_both_ways(name, writer, dtype, tmp_path):
    """mixtral's (block_sparse_moe.experts.N.w1/w3/w2) and qwen3_moe's
    (mlp.experts.N.gate/up/down_proj) names: a JAX export loads in the port
    and the port's export loads in JAX, bit-equal to the tree written, with
    equal configs."""
    jcfg, cfg = _cfgs(name)
    tree = _jax_tree(jcfg, seed=1)
    if writer == "jax":
        jexport.export_hf(tree, jcfg, tmp_path, dtype=dtype)
    else:
        export.export_hf(params_from_numpy(tree, cfg, "cpu"), cfg, tmp_path, dtype=dtype)
    assert config.config_for_checkpoint(tmp_path).__dict__ == \
        jconfig.config_for_checkpoint(tmp_path).__dict__
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    got = loader._flatten(loader.load_checkpoint(tmp_path, cfg, tdtype, "cpu"))
    want = jloader._flatten(jloader.load_checkpoint(tmp_path, jcfg, jnp.dtype(dtype), host=True))
    _assert_flat_equal(got, want)
    src = jloader._flatten(jax.tree.map(lambda a: np.asarray(a).astype(jnp.dtype(dtype)), tree))
    _assert_flat_equal(got, src)
    assert got["layers/moe/w_up"].shape == (2, 4, 64, cfg.d_ff)


def test_int8_experts_round_trip_and_split_to_the_frame_budget(tmp_path):
    """JAX's int8 moe tree ({"q": [L, E, in, out], "s": [L, E, out]})
    crosses both ways through params_from_numpy / params_to_numpy bit for
    bit, the port's quantizer gives JAX's q and s, and a native dir whose
    expert stack is split under the frame budget along a 3-D slab reads
    back bit-equal in both packages."""
    from bee2bee_tpu.models import quant as jquant
    from bee2bee_tpu_torch import pieces
    from bee2bee_tpu_torch.models.quant import quantize_weight_torch

    jcfg, cfg = _cfgs("tiny-mixtral")
    tree = _jax_tree(jcfg, seed=2)
    qtree = jquant.quantize_params(tree)
    params = params_from_numpy(qtree, cfg, "cpu")
    w = params["layers"][1]["moe"]["w_gate"]
    assert w["q"].dtype == torch.int8 and tuple(w["s"].shape) == (4, cfg.d_ff)
    _assert_flat_equal(loader._flatten(params_to_numpy(params)), jloader._flatten(qtree))
    mine = quantize_weight_torch(torch.from_numpy(np.array(tree["layers"]["moe"]["w_up"][0])))
    want = qtree["layers"]["moe"]["w_up"]
    assert np.array_equal(mine["q"].numpy(), want["q"][0])
    assert np.array_equal(mine["s"].numpy(), want["s"][0])
    # a wide expert stack (the frame budget is 4 MiB): one layer's [E, in,
    # out] slab splits on an inner axis
    big = dataclasses.replace(cfg, d_ff=8192, name="tiny-mixtral-wide")
    jbig = dataclasses.replace(jcfg, d_ff=8192, name="tiny-mixtral-wide")
    wide = _jax_tree(jbig, seed=3)
    params = params_from_numpy(wide, big, "cpu")
    manifest = loader.save_native(params, big, tmp_path / "wide")
    axes = {p.axis for p in manifest.pieces if p.param == "layers/moe/w_up"}
    assert axes == {1}  # [L, E, in, out]: split by expert, one layer's slab too wide
    assert max(len(d) for d in (pieces.load_piece(tmp_path / "wide" / "pieces", p.sha256)
                                for p in manifest.pieces)) <= pieces.DEFAULT_PIECE_SIZE
    want = jloader._flatten(wide)
    _assert_flat_equal(loader._flatten(loader.load_native(tmp_path / "wide", device="cpu",
                                                          dtype=torch.float32)), want)
    _assert_flat_equal(jloader._flatten(jloader.load_native(
        tmp_path / "wide", dtype=jnp.dtype("float32"), host=True)), want)


def test_params_to_numpy_inverts_params_from_numpy():
    jcfg, cfg = _cfgs("tiny-llama31")
    tree = _jax_tree(jcfg)
    for dtype in (torch.float32, torch.bfloat16):
        params = params_from_numpy(tree, cfg, "cpu", dtype)
        back = params_from_numpy(params_to_numpy(params), cfg, "cpu", dtype)
        _assert_flat_equal(loader._flatten(back), loader._flatten(params))
