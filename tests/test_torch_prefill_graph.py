"""The prefill and first-token roots of the PyTorch port's scheduler
(``bee2bee_tpu_torch/engine/scheduler.py``): the steps a CUDA graph
captures on the card, run eagerly here over the same static buffers.

- A prefill chunk staged into the root's static buffers and run by its
  step equals the JAX ``_prefill_fn`` on the same weights and pool: a
  miss (write floor 0, the padded tail past the write ceil) and a hit
  that writes from a CoW-copied partial block with a write floor at the
  match. Last logits within 1e-5 (f32), the pool's blocks within 1e-5.
- The sentinel declares the prefill root's key space (the engine's
  bucket widths by the pow2 table widths): captures of declared keys
  fire nothing, a key outside it is a storm, as in JAX. On a stand-in
  card (captures replaced by eager replays) every root's captures are
  booked per key, with the sentinel's traces equal to them.
- The first-token step samples like JAX ``sample_batched``: greedy and
  penalized-greedy tokens equal, sampled draws inside JAX's kept set.
- Every root's step (prefill, first token, decode, verify, the drafter's
  draft and prime) runs inside ``device_gate.device_pass()``, the draft
  server's draft too.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee2bee_tpu.engine import EngineConfig as JaxEngineConfig
from bee2bee_tpu.engine import InferenceEngine as JaxEngine
from bee2bee_tpu.engine import sampling as jsampling
from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
from bee2bee_tpu_torch.engine import scheduler as port_scheduler
from bee2bee_tpu_torch.engine.introspect import device_gate
from bee2bee_tpu_torch.engine.scheduler import Request, copy_block
from bee2bee_tpu_torch.models.config import get_config
from bee2bee_tpu_torch.models.params import params_from_numpy

KW = dict(max_seq_len=128, dtype="float32", cache_dtype="float32", decode_chunk=4,
          prefill_buckets=(16, 32, 64), max_batch=2, kv_block_size=16)
TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    jeng = JaxEngine("tiny-llama", engine_config=JaxEngineConfig(**KW))
    params = params_from_numpy(jax.device_get(jeng.params), get_config("tiny-llama"),
                               "cpu", torch.float32)
    port = InferenceEngine("tiny-llama", params=params, device="cpu",
                           engine_config=EngineConfig(**KW))
    yield jeng, port
    jeng.close()
    port.close()


def _jax_chunk(jeng, jpool, chunk, bucket, pos, table, floor, ceil):
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :len(chunk)] = chunk
    return jeng._prefill(jeng.params, jnp.asarray(tokens), jpool,
                         jnp.asarray([len(chunk)], jnp.int32), jnp.int32(pos),
                         jnp.asarray(table[None]), jnp.int32(floor), jnp.int32(ceil))


def test_prefill_step_matches_jax_prefill_fn_on_a_miss_and_a_hit(pair):
    jeng, port = pair
    sch = port.scheduler
    pool = sch._cache
    for t in pool.values():
        t.zero_()
    jpool = jeng.new_pool()
    prompt = list(np.random.default_rng(4).integers(3, 500, size=56))
    # miss: 40 tokens in bucket 64 over blocks 1-3 (the tail past 40 goes
    # to the null block); hit: the 40-token prefix shared, its partial
    # block 3 copied to 5, the 16 new tokens from 40 with the floor there
    cases = (("miss", prompt[:40], 64, 0, np.asarray([1, 2, 3, 0], np.int32), 0, 40),
             ("hit", prompt[40:], 16, 40, np.asarray([1, 2, 5, 6], np.int32), 40, 56))
    for name, chunk, bucket, pos, table, floor, ceil in cases:
        if name == "hit":
            copy_block(pool, 3, 5)
            jpool = {k: v.at[:, :, 5].set(v[:, :, 3]) for k, v in jpool.items()}
        key = sch._stage_prefill(chunk, bucket, pos, table, floor, ceil)
        assert key == (bucket, 4, False)  # no adapter row
        sch._prefill_step(sch._prefill_views(key))
        jpool, want = _jax_chunk(jeng, jpool, chunk, bucket, pos, table, floor, ceil)
        np.testing.assert_allclose(sch._p_logits.numpy(), np.asarray(want), atol=TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(pool[k][:, :, 1:].numpy(),
                                       np.asarray(jpool[k])[:, :, 1:], atol=TOL)


def test_sentinel_declares_prefill_keys_and_storms_outside(pair, monkeypatch):
    _, port = pair
    sch = port.scheduler
    sentinel = port.introspect.sentinel
    monkeypatch.setattr(sentinel, "_recorder", type("R", (), {
        "incident": lambda self, *a, **k: None})())
    monkeypatch.setattr(sch, "_capture_locked",
                        lambda key, root="decode": (port_scheduler.Graph(None, []), 0.0))
    widths = port.declared_prefill_widths
    assert widths == {16, 32, 64, 128} == jax_declared(port)
    before = sentinel.snapshot()["prefill"]
    for key in ((16, 1), (64, 4), (128, port.blocks_per_row)):
        sch._capture(key, "prefill")
    assert sentinel.snapshot()["prefill"] == {"traces": before["traces"] + 3,
                                              "storms": before["storms"]}
    sch._capture((100, 4), "prefill")  # not a bucket
    sch._capture((64, 3), "prefill")  # not a pow2 width
    assert sentinel.snapshot()["prefill"]["storms"] == before["storms"] + 2


def jax_declared(port) -> set:
    jeng = JaxEngine("tiny-llama", engine_config=JaxEngineConfig(**KW))
    try:
        return set(jeng._declared_prefill_widths)
    finally:
        jeng.close()


class _EagerGraph:
    """A stand-in for a captured graph: each replay runs the step."""

    def __init__(self, step, live):
        self.step, self.live = step, live

    def replay(self):
        self.step(self.live)


def test_captures_are_booked_per_root_and_key_on_a_stand_in_card():
    """With the scheduler believing it runs on a card and captures that
    replay eagerly, a greedy request spec-on replays the prefill, first
    token, decode and verify roots: each capture booked once per key in
    ``root_graphs`` and as a sentinel trace of its root, no storm."""
    eng = InferenceEngine("tiny-llama", device="cpu", engine_config=EngineConfig(
        **KW, spec_tokens=4))
    sch = eng.scheduler

    def capture_locked(key, root="decode"):
        step, live, _, _ = sch._root(root, key)
        graph = _EagerGraph(step, live)
        sch._graphs[(root, key)] = graph
        rg = sch._root_stats(root)
        rg["captures"] += 1
        rg["keys"][key] = (rg["keys"].get(key, (0, 0.0))[0] + 1, 0.0)
        return graph, 0.0

    sch._capture_locked = capture_locked
    with device_gate.transition():  # between passes: the loop is idle
        sch._on_card = True
    try:
        want = InferenceEngine("tiny-llama", params=eng.params, device="cpu",
                               engine_config=EngineConfig(**KW))
        ref = want.generate([5, 6, 7, 8, 9] * 3, max_new_tokens=12, temperature=0.0)
        want.close()
        got = eng.generate([5, 6, 7, 8, 9] * 3, max_new_tokens=12, temperature=0.0)
        assert got.token_ids == ref.token_ids
        snap = eng.introspect.sentinel.snapshot()
        roots = sch.stats.root_graphs
        assert {"prefill", "first_token", "decode"} <= set(roots)
        for root, g in roots.items():
            assert g["captures"] == len(g["keys"]) == snap[root]["traces"]
            assert snap[root]["storms"] == 0 and g["replays"] >= 1
        assert list(roots["prefill"]["keys"]) == [(16, 1, False)]
        assert list(roots["first_token"]["keys"]) == [(False, False, False, False)]
    finally:
        eng.close()


@pytest.mark.parametrize("knobs", [
    dict(temperature=0.0),
    dict(temperature=0.0, repetition_penalty=1.3, presence_penalty=0.4,
         frequency_penalty=0.2),
    dict(temperature=1.0, top_k=3),
    dict(temperature=0.8, top_p=0.7, min_p=0.05),
])
def test_first_token_step_samples_like_jax(pair, knobs):
    """The first-token root's step on a row's static buffers: greedy (and
    penalized greedy) tokens equal JAX ``sample_batched``'s; sampled draws
    stay inside the tokens JAX draws (four near-equal leaders, the rest
    far below)."""
    _, port = pair
    sch = port.scheduler
    V = port.model_cfg.vocab_size
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal(V) - 8.0).astype(np.float32)
    logits[[11, 29, 301, 417]] = [5.0, 4.9, 4.95, 4.85]
    ids = list(rng.integers(3, V, size=20)) + [29, 29, 301]
    req = Request(ids, 8, knobs.get("temperature", 0.0), knobs.get("top_k", 0),
                  knobs.get("top_p", 1.0), set(), None, port.tokenizer,
                  repetition_penalty=knobs.get("repetition_penalty", 1.0),
                  presence_penalty=knobs.get("presence_penalty", 0.0),
                  frequency_penalty=knobs.get("frequency_penalty", 0.0),
                  min_p=knobs.get("min_p", 0.0))
    counts = np.zeros((1, 2, V), np.int32)
    counts[0, 0] = np.bincount(ids, minlength=V)
    jargs = [jnp.asarray(logits[None]), None, jnp.asarray([req.temperature], jnp.float32),
             jnp.asarray([req.top_k], jnp.int32), jnp.asarray([req.top_p], jnp.float32),
             jnp.asarray([req.min_p], jnp.float32) if req.min_p > 0 else None]
    if req.penalized:
        jargs += [jnp.asarray(counts), jnp.asarray([req.repetition_penalty], jnp.float32),
                  jnp.asarray([req.presence_penalty], jnp.float32),
                  jnp.asarray([req.frequency_penalty], jnp.float32)]
    draws = 1 if req.temperature <= 0 else 256
    # compiled once, as the JAX engine's first-token root is
    sample = jax.jit(jsampling.sample_batched)
    got, want = set(), set()
    for i in range(draws):
        sch._p_logits.copy_(torch.from_numpy(logits[None]))
        got.add(int(sch._first_token(req, 0)))
        jargs[1] = jax.random.key(i)
        want.add(int(sample(*jargs)[0]))
    if req.temperature <= 0:
        assert got == want
    else:
        assert got <= want <= {11, 29, 301, 417} and len(got) >= 2
    if req.penalized:
        assert np.array_equal(sch._f_counts.numpy(), counts)


def test_every_root_runs_inside_a_device_pass():
    """Each root step, the drafter's included, records whether its thread
    was in a device pass: always. The draft server's draft too (its
    executor thread enters its own)."""
    from bee2bee_tpu_torch.meshnet.node import P2PNode

    eng = InferenceEngine("tiny-llama", device="cpu", engine_config=EngineConfig(
        **KW, spec_tokens=4, spec_probe_tokens=4, drafter="tiny-llama"))
    sch, dm = eng.scheduler, eng.drafter_model
    seen: dict = {}

    def watch(owner, name):
        step = getattr(owner, name)

        def wrapped(v):
            seen.setdefault(name, set()).add(device_gate.inside())
            return step(v)
        setattr(owner, name, wrapped)

    for name in ("_prefill_step", "_first_step", "_decode_step", "_verify_step"):
        watch(sch, name)
    for name in ("_draft_step", "_prime_step"):
        watch(dm, name)
    try:
        eng.generate([1 + (j * 97) % 499 for j in range(24)], max_new_tokens=40,
                     temperature=0.0)
        assert seen == {n: {True} for n in ("_prefill_step", "_first_step",
                                            "_decode_step", "_verify_step",
                                            "_draft_step", "_prime_step")}
    finally:
        eng.close()
    node = P2PNode(host="127.0.0.1", port=0)
    node.enable_draft_server("tiny-llama", spec_tokens=4, max_rows=1, device="cpu")
    srv = node.draft_server
    try:
        seen.clear()
        watch(srv.drafter, "_draft_step")

        class _Row:
            ids, out_ids = [5, 6, 7, 8], []

        import threading

        t = threading.Thread(target=srv._propose, args=(_Row(),))
        t.start()
        t.join(30)
        assert seen == {"_draft_step": {True}}
    finally:
        srv.close()
