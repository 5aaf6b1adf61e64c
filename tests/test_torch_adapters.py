"""Batched multi-LoRA serving in the PyTorch port (``adapters/``,
``train/lora.py``, the scheduler's adapter rows), against the JAX package
on the same numpy factors.

- The pool (``AdapterPool``): LRU slots with in-flight refcounts, rank
  zero-padding, typed errors for a larger rank, a new target or a bad
  shape (the JAX ``test_adapters.py`` checks), and in-place writes: the
  stacks and scales keep their storage across loads, refreshes and
  evictions, which run on the scheduler thread when an engine owns the
  pool.
- The ``.npz`` adapter format is byte-compatible: a file either package
  saves, the other loads; a tampered tensor is a typed error.
- One forward with per-row adapter ids gives JAX's logits (f32, 1e-4); a
  mixed batch of three adapters and two base rows decodes the JAX pool
  engine's greedy tokens over 16 steps; int8 weights with adapters too.
- A hot swap (evict a cold adapter, load another, refresh an idle one)
  while a streamed generation runs leaves its tokens unchanged; the live
  adapter refuses eviction and refresh.
- Adapter rows never match or pin the prefix cache; speculative decoding
  under an adapter keeps the merged engine's tokens.
- An adapter published by a port node is fetched by the JAX
  ``fetch_adapter``, and the reverse; ``--adapters`` preloads the pool.
- ``serve-cuda --quantize int8 --lora ... --adapters ... --max-adapters``
  reach the node's config; the service advertises ``<base>:<adapter>``.
"""

from __future__ import annotations

import asyncio
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
# websockets 15 binds its ``exceptions`` submodule on the package only once
# something imports it, and the JAX package's transport reads
# ``websockets.exceptions`` after a bare ``import websockets``: whether the
# JAX networking tests of a pytest-xdist worker passed depended on which test
# file that worker ran first. Every worker collects this module, so each
# starts with the submodule bound, as the port's own transport binds it
# (bee2bee_tpu_torch/transport.py); nothing else here needs it.
import websockets.exceptions  # noqa: F401
from click.testing import CliRunner

from bee2bee_tpu.adapters.distrib import fetch_adapter as jax_fetch_adapter
from bee2bee_tpu.adapters.distrib import publish_adapter as jax_publish_adapter
from bee2bee_tpu.engine import EngineConfig as JaxEngineConfig
from bee2bee_tpu.engine import InferenceEngine as JaxEngine
from bee2bee_tpu.meshnet.node import P2PNode as JaxNode
from bee2bee_tpu.models import core as jcore
from bee2bee_tpu.train import lora as jlora
from bee2bee_tpu.transport import LoopbackTransport as JaxLoopback
from bee2bee_tpu_torch.adapters import AdapterPoolBusy, UnknownAdapter
from bee2bee_tpu_torch.adapters.distrib import fetch_adapter, publish_adapter
from bee2bee_tpu_torch.adapters.pool import AdapterPool
from bee2bee_tpu_torch.config import NodeConfig
from bee2bee_tpu_torch.dht import DHTNode
from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
from bee2bee_tpu_torch.meshnet import runtime
from bee2bee_tpu_torch.meshnet.node import P2PNode
from bee2bee_tpu_torch.models import core
from bee2bee_tpu_torch.models.config import get_config
from bee2bee_tpu_torch.models.params import params_from_numpy
from bee2bee_tpu_torch.services.cuda import CUDAService
from bee2bee_tpu_torch.train.lora import (
    AdapterLoadError,
    LoraConfig,
    load_adapters,
    merge_lora,
    save_adapters,
)
from bee2bee_tpu_torch.transport import LoopbackTransport

CFG = get_config("tiny-llama")
KW = dict(max_seq_len=128, dtype="float32", cache_dtype="float32", decode_chunk=4,
          prefill_buckets=(16, 32, 64), max_batch=8)
LCFG = LoraConfig(rank=4, alpha=32.0, targets=("wq", "wk", "wv", "wo", "w_gate",
                                               "w_up", "w_down"))
ROWS = (None, "a1", "a2", "a3", None)
PROMPTS = [[5 + r, 9, 17, 33, 2 * r + 40, 61, 7] * (r + 1) for r in range(len(ROWS))]
NEW = 16


def _adapter(seed: int, lcfg: LoraConfig = LCFG) -> dict:
    """Random factors (numpy, f32), B non-zero so each adapter shows."""
    rng = np.random.default_rng(seed)
    io = jlora.adapter_target_io(CFG)
    return {t: {"a": (rng.standard_normal((CFG.n_layers, io[t][0], lcfg.rank)) * 0.2)
                .astype(np.float32),
                "b": (rng.standard_normal((CFG.n_layers, lcfg.rank, io[t][1])) * 0.05)
                .astype(np.float32)}
            for t in lcfg.targets}


ADAPTERS = {f"a{i}": _adapter(i) for i in (1, 2, 3)}


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jcore.init_params(CFG, jax.random.key(0), dtype=jnp.float32))


def _port_params(tree):
    return params_from_numpy(tree, CFG, "cpu", torch.float32)


def _port_engine(tree, **over):
    return InferenceEngine("tiny-llama", params=_port_params(tree), device="cpu",
                           engine_config=EngineConfig(**{**KW, **over}))


@pytest.fixture(scope="module")
def jax_pool_tokens(jax_params):
    """The JAX pool engine's greedy tokens for ROWS, one request at a
    time (per-row selection makes them batch-independent in f32)."""
    eng = JaxEngine("tiny-llama", params=jax_params, engine_config=JaxEngineConfig(
        max_adapters=4, kv_block_size=16, **KW))
    try:
        for name, ad in ADAPTERS.items():
            eng.load_adapter(name, ad, jlora.LoraConfig(rank=LCFG.rank, alpha=LCFG.alpha,
                                                         targets=LCFG.targets))
        yield [eng.generate(p, max_new_tokens=NEW, temperature=0.0, adapter=a).token_ids
               for p, a in zip(PROMPTS, ROWS)]
    finally:
        eng.close()


@pytest.fixture(scope="module")
def port_pool_engine(jax_params):
    eng = _port_engine(jax_params, max_adapters=4)
    for name, ad in ADAPTERS.items():
        eng.load_adapter(name, ad, LCFG)
    yield eng
    eng.close()


def _burst(eng, rows, prompts=PROMPTS, new=NEW):
    """Generate every row at once (one admission burst where the queue
    allows); returns the token ids per row."""
    out: dict = {}
    barrier = threading.Barrier(len(rows))

    def run(i, name):
        barrier.wait()
        out[i] = eng.generate(prompts[i], max_new_tokens=new, temperature=0.0,
                              adapter=name).token_ids

    threads = [threading.Thread(target=run, args=(i, n)) for i, n in enumerate(rows)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return [out[i] for i in range(len(rows))]


# ------------------------------------------------------------------ pool


def test_pool_load_lru_evict_and_refcount():
    pool = AdapterPool(CFG, slots=2)
    lcfg = LoraConfig(rank=4)
    pool.load("a", _adapter(1, lcfg), lcfg)
    pool.load("b", _adapter(2, lcfg), lcfg)
    assert pool.resident() == ["a", "b"]
    slot_a = pool.acquire("a")  # touching "a" makes "b" the LRU victim
    pool.release(slot_a)
    pool.load("c", _adapter(3, lcfg), lcfg)
    assert pool.resident() == ["a", "c"] and pool.evictions == 1
    s_a, s_c = pool.acquire("a"), pool.acquire("c")
    with pytest.raises(AdapterPoolBusy):
        pool.load("d", _adapter(4, lcfg), lcfg)
    with pytest.raises(AdapterPoolBusy):
        pool.evict("a")
    with pytest.raises(AdapterPoolBusy):  # a live adapter is not refreshed
        pool.load("a", _adapter(5, lcfg), lcfg)
    pool.release(s_a)
    pool.release(s_c)
    assert pool.evict("c") is True
    assert pool.resident() == ["a"]
    with pytest.raises(UnknownAdapter):
        pool.acquire("c")


def test_pool_rank_padding_and_target_subset():
    pool = AdapterPool(CFG, slots=2)
    big = LoraConfig(rank=8, targets=("wq", "wv"))
    pool.load("big", _adapter(1, big), big)
    small = LoraConfig(rank=2, targets=("wq",))
    small_ad = _adapter(2, small)
    slot = pool.load("small", small_ad, small)
    assert pool.rank == 8 and set(pool.targets) == {"wq", "wv"}
    stacks, scales = pool.device_args()
    # the smaller rank zero-pads, the missing target stays zero
    np.testing.assert_array_equal(stacks["wq"]["a"][:, slot, :, :2].numpy(),
                                  small_ad["wq"]["a"])
    assert not stacks["wq"]["a"][:, slot, :, 2:].any()
    assert not stacks["wv"]["b"][:, slot].any()
    assert scales[slot].item() == small.scaling and scales[0].item() == 0.0
    with pytest.raises(AdapterLoadError):
        too_big = LoraConfig(rank=16, targets=("wq",))
        pool.load("huge", _adapter(3, too_big), too_big)
    with pytest.raises(AdapterLoadError):
        other = LoraConfig(rank=4, targets=("wo",))
        pool.load("other", _adapter(4, other), other)


def test_pool_shape_mismatch_is_typed():
    pool = AdapterPool(CFG, slots=1)
    lcfg = LoraConfig(rank=4)
    bad = _adapter(1, lcfg)
    bad["wq"]["a"] = bad["wq"]["a"][:, :-1, :]  # wrong din
    with pytest.raises(AdapterLoadError, match="shape"):
        pool.load("bad", bad, lcfg)
    assert pool.rank is None  # the bad first adapter fixed no geometry


def test_pool_writes_in_place_on_the_scheduler_thread(jax_params):
    """The stacks and scales are allocated once and written in place (a
    captured graph holds their addresses); an engine's pool writes run on
    its scheduler thread."""
    eng = _port_engine(jax_params, max_adapters=2)
    seen = []
    run = eng.scheduler.run_on_device
    eng.scheduler.run_on_device = lambda fn: run(
        lambda: seen.append(threading.current_thread().name) or fn())
    try:
        eng.load_adapter("a1", ADAPTERS["a1"], LCFG)
        stacks, scales = eng.adapter_pool.device_args()
        ptrs = {t: (ab["a"].data_ptr(), ab["b"].data_ptr()) for t, ab in stacks.items()}
        eng.load_adapter("a2", ADAPTERS["a2"], LCFG)
        eng.load_adapter("a1", ADAPTERS["a3"], LCFG)  # refresh, in place
        eng.load_adapter("a3", ADAPTERS["a1"], LCFG)  # evicts a2 (LRU)
        assert eng.unload_adapter("a3") is True
        stacks2, scales2 = eng.adapter_pool.device_args()
        assert scales2 is scales and all(
            (ab["a"].data_ptr(), ab["b"].data_ptr()) == ptrs[t] for t, ab in stacks2.items())
        slot = eng.adapter_pool.slot_of("a1")
        np.testing.assert_array_equal(stacks2["wq"]["a"][:, slot].numpy(),
                                      ADAPTERS["a3"]["wq"]["a"])
        assert eng.resident_adapters() == ["a1"] and eng.adapter_pool.evictions == 2
        assert len(seen) == 5 and set(seen) == {"bee2bee-torch-batch-scheduler"}
        assert eng.info["adapters"]["slots"] == 2
        assert eng.introspect.ledger.snapshot()["components"]["adapter_pool"] > 0
    finally:
        eng.close()


# ------------------------------------------------------- the .npz format


def test_adapter_file_is_byte_compatible_both_ways(tmp_path):
    ad = ADAPTERS["a1"]
    port_file, jax_file = tmp_path / "port.npz", tmp_path / "jax.npz"
    save_adapters(port_file, ad, LCFG)
    jcfg = jlora.LoraConfig(rank=LCFG.rank, alpha=LCFG.alpha, targets=LCFG.targets)
    jlora.save_adapters(jax_file, ad, jcfg)
    for loaded, lcfg in (jlora.load_adapters(port_file, model_cfg=_jax_cfg()),
                         load_adapters(jax_file, model_cfg=CFG)):
        assert (lcfg.rank, lcfg.alpha, tuple(lcfg.targets)) == (4, 32.0, LCFG.targets)
        for t in LCFG.targets:
            np.testing.assert_array_equal(np.asarray(loaded[t]["a"]), ad[t]["a"])
    with np.load(port_file) as z:
        data = {n: z[n] for n in z.files}
    data["wq/a"] = data["wq/a"] + 1e-3
    np.savez(port_file, **data)
    with pytest.raises(AdapterLoadError, match="hash mismatch"):
        load_adapters(port_file)
    (tmp_path / "junk.npz").write_bytes(b"not a zip")
    with pytest.raises(AdapterLoadError):
        load_adapters(tmp_path / "junk.npz")


def _jax_cfg():
    from bee2bee_tpu.models import get_config as jax_get_config

    return jax_get_config("tiny-llama")


def test_merge_lora_matches_jax(jax_params):
    merged = merge_lora(_port_params(jax_params), ADAPTERS["a2"], LCFG)
    jcfg = jlora.LoraConfig(rank=LCFG.rank, alpha=LCFG.alpha, targets=LCFG.targets)
    want = jlora.merge_lora(jax_params, ADAPTERS["a2"], jcfg)
    for i, lp in enumerate(merged["layers"]):
        for grp, t in (("attn", "wq"), ("attn", "wo"), ("mlp", "w_down")):
            np.testing.assert_allclose(lp[grp][t].numpy(), want["layers"][grp][t][i],
                                       atol=1e-6, rtol=0)


# ------------------------------------------------- serving against JAX


def test_forward_with_adapter_rows_matches_jax_logits(jax_params):
    """One [5, 12] chunk, each row on its own slot (0 = base), over the
    paged pool: the port's logits within 1e-4 of JAX's (f32)."""
    ids = np.random.default_rng(3).integers(3, 500, (5, 12)).astype(np.int32)
    slots = np.asarray([0, 1, 2, 3, 0], np.int32)
    scales = np.asarray([0.0] + [LCFG.scaling] * 3, np.float32)
    stacks = {t: {k: np.stack([np.zeros_like(ADAPTERS["a1"][t][k])]
                              + [ADAPTERS[n][t][k] for n in ("a1", "a2", "a3")], axis=1)
                  for k in ("a", "b")} for t in LCFG.targets}
    tables = np.arange(1, 6, dtype=np.int32).reshape(5, 1)
    jpool = jcore.init_paged_pool(CFG, 6, 16, dtype=jnp.float32)
    want, _ = jcore.forward(jax.tree.map(jnp.asarray, jax_params), CFG, jnp.asarray(ids),
                            jpool, jnp.int32(0), block_tables=jnp.asarray(tables),
                            adapters=jax.tree.map(jnp.asarray, stacks),
                            adapter_ids=jnp.asarray(slots), adapter_scales=scales)
    pool = core.init_paged_pool(CFG, 6, 16, torch.float32, "cpu")
    got, _ = core.forward(_port_params(jax_params), CFG, torch.from_numpy(ids).long(), pool,
                          0, torch.from_numpy(tables),
                          adapters=jax.tree.map(torch.from_numpy, stacks),
                          adapter_ids=torch.from_numpy(slots).long(),
                          adapter_scales=torch.from_numpy(scales))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_mixed_batch_three_adapters_and_base_match_jax(port_pool_engine, jax_pool_tokens):
    """Three adapters and two base rows decode in one shared batch, 16
    greedy tokens each, as the JAX pool engine decodes them; the adapters
    change the tokens; the mixed batch captured no graph on the CPU."""
    got = _burst(port_pool_engine, ROWS)
    assert got == jax_pool_tokens
    assert port_pool_engine.scheduler.stats.peak_active == len(ROWS)
    assert len({tuple(t) for t in got[1:4]}) == 3


def test_int8_weights_with_adapters_match_jax(jax_params):
    """int8 weights and the adapter pool together: the port's tokens equal
    the JAX int8 pool engine's, row by row."""
    jeng = JaxEngine("tiny-llama", params=jax_params, engine_config=JaxEngineConfig(
        quantize="int8", max_adapters=2, kv_block_size=16, **KW))
    eng = _port_engine(jax_params, quantize="int8", max_adapters=2)
    jcfg = jlora.LoraConfig(rank=LCFG.rank, alpha=LCFG.alpha, targets=LCFG.targets)
    try:
        jeng.load_adapter("a1", ADAPTERS["a1"], jcfg)
        eng.load_adapter("a1", ADAPTERS["a1"], LCFG)
        rows = ("a1", None, "a1")
        want = [jeng.generate(p, max_new_tokens=NEW, temperature=0.0, adapter=a).token_ids
                for p, a in zip(PROMPTS, rows)]
        assert _burst(eng, rows) == want
        assert set(eng.params["layers"][0]["attn"]["wq"]) == {"q", "s"}
    finally:
        jeng.close()
        eng.close()


def test_hot_swap_mid_stream_leaves_the_live_row_unchanged(jax_params):
    """While a streamed generation decodes on a1: a1 refuses eviction and
    refresh; a2 is evicted for a3 and a3 refreshed. The live row's tokens
    equal an undisturbed run's."""
    eng = _port_engine(jax_params, max_adapters=2)
    try:
        eng.load_adapter("a1", ADAPTERS["a1"], LCFG)
        eng.load_adapter("a2", ADAPTERS["a2"], LCFG)
        want = eng.generate(PROMPTS[1], max_new_tokens=24, temperature=0.0,
                            adapter="a1").token_ids
        stream = eng.generate_stream(PROMPTS[1], max_new_tokens=24, temperature=0.0,
                                     adapter="a1")
        first = next(stream)
        with pytest.raises(AdapterPoolBusy):
            eng.unload_adapter("a1")
        with pytest.raises(AdapterPoolBusy):
            eng.load_adapter("a1", ADAPTERS["a3"], LCFG)
        assert eng.unload_adapter("a2") is True
        eng.load_adapter("a3", ADAPTERS["a3"], LCFG)
        eng.load_adapter("a3", ADAPTERS["a2"], LCFG)  # refresh an idle adapter
        toks = list(first.get("tokens") or [])
        for ev in stream:
            if ev.get("done"):
                break
            toks.extend(ev.get("tokens") or [])
        assert toks == want
        assert eng.resident_adapters() == ["a1", "a3"]
        assert eng.unload_adapter("a1") is True  # retired: evictable now
    finally:
        eng.close()


def test_unknown_adapter_is_typed(jax_params, port_pool_engine):
    with pytest.raises(UnknownAdapter):
        port_pool_engine.generate([5, 6], max_new_tokens=4, adapter="nope")
    eng = _port_engine(jax_params)
    try:
        with pytest.raises(UnknownAdapter, match="max_adapters=0"):
            eng.generate([5, 6], max_new_tokens=4, adapter="a1")
        with pytest.raises(RuntimeError, match="multi-adapter serving is off"):
            eng.load_adapter("a1", ADAPTERS["a1"], LCFG)
        assert eng.resident_adapters() == [] and not eng.has_adapter("a1")
    finally:
        eng.close()


def test_adapter_rows_skip_the_prefix_cache(jax_params):
    eng = _port_engine(jax_params, max_adapters=2, prefix_cache_entries=4)
    try:
        eng.load_adapter("a1", ADAPTERS["a1"], LCFG)
        prompt = PROMPTS[4]
        ga = eng.generate(prompt, max_new_tokens=6, temperature=0.0, adapter="a1")
        g0 = eng.generate(prompt, max_new_tokens=6, temperature=0.0)
        assert eng.scheduler.stats.prefix_hits == 0  # the adapter row seeded nothing
        gb = eng.generate(prompt, max_new_tokens=6, temperature=0.0)
        assert eng.scheduler.stats.prefix_hits == 1  # base rows still share
        ga2 = eng.generate(prompt, max_new_tokens=6, temperature=0.0, adapter="a1")
        assert eng.scheduler.stats.prefix_hits == 1  # an adapter row never hits
        assert ga.token_ids == ga2.token_ids and g0.token_ids == gb.token_ids
    finally:
        eng.close()


def test_spec_decode_composes_with_adapters(jax_params):
    """Greedy spec rows under an adapter keep the merged engine's tokens:
    the verify forward gathers the same per-row factors."""
    eng = _port_engine(jax_params, max_adapters=2, spec_tokens=4, spec_min_match=1)
    merged = InferenceEngine("tiny-llama", device="cpu", engine_config=EngineConfig(**KW),
                             params=merge_lora(_port_params(jax_params), ADAPTERS["a2"],
                                               LCFG))
    try:
        eng.load_adapter("a2", ADAPTERS["a2"], LCFG)
        prompt = list(b"ab ab ab ab ab ab ab ab")  # the n-gram tier drafts here
        got = eng.generate(prompt, max_new_tokens=16, temperature=0.0, adapter="a2")
        want = merged.generate(prompt, max_new_tokens=16, temperature=0.0)
        assert got.token_ids == want.token_ids
        assert eng.scheduler.stats.spec_steps > 0
    finally:
        eng.close()
        merged.close()


# ------------------------------------------------ the mesh and the node


async def _settle(cond, timeout=10.0):
    for _ in range(int(timeout / 0.05)):
        if cond():
            return True
        await asyncio.sleep(0.05)
    return False


@pytest.mark.async_timeout(60)
async def test_adapters_publish_and_fetch_across_packages():
    """A port node publishes an adapter; the JAX node's fetch_adapter gets
    it hash-verified and equal. Then the reverse."""
    dht = DHTNode()
    await dht.start()
    j = JaxNode(host="127.0.0.1", port=0, transport=JaxLoopback())
    t = P2PNode(host="127.0.0.1", port=0, transport=LoopbackTransport())
    jcfg = jlora.LoraConfig(rank=LCFG.rank, alpha=LCFG.alpha, targets=LCFG.targets)
    await j.start()
    await t.start()
    try:
        await publish_adapter(t, dht, CFG.name, "acme", ADAPTERS["a1"], LCFG)
        got, lcfg = await jax_fetch_adapter(j, dht, CFG.name, "acme", model_cfg=_jax_cfg())
        assert (lcfg.rank, lcfg.alpha, tuple(lcfg.targets)) == (4, 32.0, LCFG.targets)
        for tgt in LCFG.targets:
            np.testing.assert_array_equal(got[tgt]["b"], ADAPTERS["a1"][tgt]["b"])
        await jax_publish_adapter(j, dht, CFG.name, "other", ADAPTERS["a2"], jcfg)
        got, lcfg = await fetch_adapter(t, dht, CFG.name, "other", model_cfg=CFG)
        assert lcfg.targets == LCFG.targets
        for tgt in LCFG.targets:
            np.testing.assert_array_equal(got[tgt]["a"], ADAPTERS["a2"][tgt]["a"])
        assert await _settle(lambda: t.peers and j.peers)
    finally:
        await t.stop()
        await j.stop()
        await dht.stop()


@pytest.mark.async_timeout(60)
async def test_preloaded_adapters_serve_and_advertise(jax_params, tmp_path):
    """``--adapters name=path.npz``: the node loads each into the engine's
    pool, publishes it and advertises ``<base>:<name>``; a request for
    that model id decodes under the adapter."""
    path = tmp_path / "acme.npz"
    save_adapters(path, ADAPTERS["a1"], LCFG)
    eng = _port_engine(jax_params, max_adapters=2)
    svc = CUDAService("tiny-llama", engine=eng, device="cpu")
    node = P2PNode(host="127.0.0.1", port=0, transport=LoopbackTransport())
    dht = DHTNode()
    await dht.start()
    await node.start()
    try:
        node.add_service(svc)
        await runtime._preload_adapters(node, dht, svc, f"acme={path}")
        assert eng.resident_adapters() == ["acme"]
        meta = svc.get_metadata()
        assert meta["adapters"] == ["acme"] and "tiny-llama:acme" in meta["models"]
        assert await dht.get_manifest("adapter/tiny-llama/acme") is not None
        out = await asyncio.get_running_loop().run_in_executor(None, lambda: svc.execute(
            {"prompt": "user: hi", "max_new_tokens": 6, "temperature": 0.0,
             "adapter": "acme"}))
        base = await asyncio.get_running_loop().run_in_executor(None, lambda: svc.execute(
            {"prompt": "user: hi", "max_new_tokens": 6, "temperature": 0.0}))
        assert out["tokens"] == 6 and out["text"] != base["text"]
    finally:
        await node.stop()
        await dht.stop()
        eng.close()


@pytest.mark.parametrize("args,field,value", [
    (["--quantize", "int8"], "quantize", "int8"),
    (["--adapters", "a=a.npz"], "adapters", "a=a.npz"),
    (["--max-adapters", "4"], "max_adapters", 4),
])
def test_serve_cuda_passes_quant_and_adapter_options(args, field, value, monkeypatch):
    from bee2bee_tpu_torch import __main__ as main
    from bee2bee_tpu_torch.__main__ import cli

    seen = {}
    monkeypatch.setattr(main, "_serve", lambda backend, model, **kw: seen.update(
        main._apply_common_cfg(NodeConfig(), kw).to_dict(), backend=backend,
        lora=kw.get("lora")))
    out = CliRunner().invoke(cli, ["serve-cuda", "--model", "tiny-llama", *args,
                                   "--lora", "l.npz"])
    assert out.exit_code == 0, out.output
    assert seen["backend"] == "cuda" and seen[field] == value and seen["lora"] == "l.npz"
    cfg = NodeConfig(**{k: v for k, v in seen.items() if k not in ("backend", "lora")})
    ecfg = cfg.engine_config()
    if field == "quantize":
        assert ecfg.quantize == "int8"
    else:  # --adapters implies 8 slots; --max-adapters sets them
        assert ecfg.max_adapters == (4 if field == "max_adapters" else 8)


def test_build_service_carries_lora_path(monkeypatch):
    seen = {}

    class Probe:
        def __init__(self, model, **kw):
            seen.update(kw, model=model)

    monkeypatch.setattr("bee2bee_tpu_torch.services.cuda.CUDAService", Probe)
    runtime.build_service("cuda", "tiny-llama", NodeConfig(quantize="int8"),
                          lora_path="l.npz")
    assert seen["lora_path"] == "l.npz" and seen["engine_config"].quantize == "int8"
