"""Self-speculative decoding in the PyTorch port (``bee2bee_tpu_torch/engine/
spec.py``, the engine's ``_spec_verify`` and the scheduler's spec step)
against the JAX package's (``tests/test_spec_decode.py``'s cases):

- the n-gram drafter functions give JAX's answers on the same inputs;
- on tiny-llama with the JAX ``init_params`` weights (``params_from_numpy``),
  the port's spec engine gives the JAX spec engine's greedy tokens, token
  for token, over the paged pool, with the same draft and accept counts
  (the same tokens make the same n-gram drafts); also streamed, with a
  stop token inside an accepted draft, and for a prompt with no repeats;
- mixed batches: greedy rows speculate while sampled rows in the same
  batch advance one token a step and finish;
- near capacity: rows within K+1 of the end take plain windows, with
  parity to the cache-imposed cap; a K that never fits speculates never;
- an impossible acceptance floor stops drafting after the probe, as in
  JAX; blocks claimed for rejected draft slots free at retirement; the
  prefix cache's pins survive spec steps;
- the stats and ``info["spec"]`` carry JAX's keys and values.
"""

from __future__ import annotations

import threading

import jax
import numpy as np
import pytest
import torch

from bee2bee_tpu.engine import EngineConfig as JaxEngineConfig
from bee2bee_tpu.engine import InferenceEngine as JaxEngine
from bee2bee_tpu.engine import spec as jspec
from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
from bee2bee_tpu_torch.engine import spec
from bee2bee_tpu_torch.engine.paged import ceil_div
from bee2bee_tpu_torch.models.config import get_config
from bee2bee_tpu_torch.models.params import params_from_numpy

KW = dict(max_seq_len=128, dtype="float32", cache_dtype="float32", decode_chunk=4,
          prefill_buckets=(16, 32, 64), max_batch=4)
# periodic prompt: the drafter finds its tail n-gram earlier in the
# sequence from the first decode steps (the JAX test's)
REP_PROMPT = [5, 6, 7, 8, 9] * 3 + [5, 6, 7]
NONREP = [(i * 37) % 400 + 3 for i in range(24)]


@pytest.fixture(scope="module")
def weights():
    """The JAX tiny-llama weights (seed 0) as the port's params."""
    jeng = JaxEngine("tiny-llama", engine_config=JaxEngineConfig(**KW))
    params = params_from_numpy(jax.device_get(jeng.params), get_config("tiny-llama"),
                               "cpu", torch.float32)
    yield jeng, params
    jeng.close()


def _port(params, **over):
    return InferenceEngine("tiny-llama", params=params, device="cpu",
                           engine_config=EngineConfig(**dict(KW, **over)))


def _jax(**over):
    return JaxEngine("tiny-llama", engine_config=JaxEngineConfig(**dict(KW, **over)))


@pytest.fixture(scope="module")
def spec_pair(weights):
    """(JAX spec engine, port spec engine), K=6, on the same weights."""
    jeng = _jax(spec_tokens=6)
    port = _port(weights[1], spec_tokens=6)
    yield jeng, port
    jeng.close()
    port.close()


def _spec_counts(eng):
    st = eng.scheduler.stats
    return st.spec_steps, st.spec_drafted, st.spec_accepted


# ------------------------------------------------------------ n-gram drafter


@pytest.mark.parametrize("ctx,k,kw", [
    ([1, 2, 3, 4] * 6, 5, {}),
    ([7] * 30, 6, {}),
    ([1, 2, 3, 4, 98, 99], 4, {}),
    ([1, 2], 4, dict(min_match=2)),
    ([1, 2, 3], 0, {}),
    ([9, 1, 2, 3, 9, 4, 5, 6, 9], 4, dict(min_match=2)),
    ([9, 1, 2, 3, 9, 4, 5, 6, 9], 4, dict(min_match=1)),
    (REP_PROMPT + [8, 9, 5], 6, dict(min_match=2, max_match=8)),
])
def test_find_ngram_draft_matches_jax(ctx, k, kw):
    assert spec.find_ngram_draft(ctx, k, **kw) == jspec.find_ngram_draft(ctx, k, **kw)


@pytest.mark.parametrize("args", [(10, 1, 64, 0.25), (64, 2, 64, 0.25),
                                  (64, 32, 64, 0.25), (12, 0, 12, 1.1)])
def test_should_disable_matches_jax(args):
    assert spec.should_disable(*args) == jspec.should_disable(*args)


def test_ngram_drafter_validation_and_proposals_match_jax():
    for bad in (dict(spec_tokens=0), dict(spec_tokens=4, min_match=3, max_match=2)):
        with pytest.raises(ValueError):
            spec.NgramDrafter(**bad)
        with pytest.raises(ValueError):
            jspec.NgramDrafter(**bad)

    class _Req:
        def __init__(self, ids, out):
            self.ids, self.out_ids = ids, out

    rows = [(0, _Req(REP_PROMPT, [8, 9])), (2, _Req(NONREP, [])), (3, _Req([7] * 9, [7]))]
    assert (spec.NgramDrafter(6).propose_batch(rows)
            == jspec.NgramDrafter(6).propose_batch(rows))


# ------------------------------------------------------------ greedy parity


def test_greedy_parity_with_the_jax_spec_engine(spec_pair):
    """THE bar: the JAX spec engine's greedy tokens, token for token, and
    speculation engaged alike (the same steps, drafts and accepts)."""
    jeng, port = spec_pair
    j0, p0 = _spec_counts(jeng), _spec_counts(port)
    want = jeng.generate(REP_PROMPT, max_new_tokens=40, temperature=0.0)
    got = port.generate(REP_PROMPT, max_new_tokens=40, temperature=0.0)
    assert got.token_ids == want.token_ids
    dj = [a - b for a, b in zip(_spec_counts(jeng), j0)]
    dp = [a - b for a, b in zip(_spec_counts(port), p0)]
    assert dp == dj and dp[0] > 0 and dp[1] > 0
    assert got.timings["spec_acceptance"] == want.timings["spec_acceptance"]


def test_greedy_parity_non_repetitive_prompt(spec_pair):
    jeng, port = spec_pair
    want = jeng.generate(NONREP, max_new_tokens=24, temperature=0.0)
    got = port.generate(NONREP, max_new_tokens=24, temperature=0.0)
    assert got.token_ids == want.token_ids


def test_greedy_parity_streaming(spec_pair):
    """Streamed: the chunks join to the JAX spec engine's tokens, and
    speculation flushes several tokens in one event."""
    jeng, port = spec_pair
    want = jeng.generate(REP_PROMPT, max_new_tokens=40, temperature=0.0).token_ids
    events = list(port.generate_stream(REP_PROMPT, max_new_tokens=40, temperature=0.0))
    chunks = [ev["tokens"] for ev in events if "tokens" in ev]
    assert [t for c in chunks for t in c] == want
    assert events[-1]["result"].token_ids == want
    assert max(len(c) for c in chunks) > 1


def test_stop_token_inside_accepted_draft(spec_pair):
    """A stop token that lands inside an accepted draft ends the request
    there, as in plain decode (and in JAX)."""
    jeng, port = spec_pair
    free = jeng.generate(REP_PROMPT, max_new_tokens=40, temperature=0.0).token_ids
    stop_at = free[12]
    cut = free.index(stop_at)
    want = jeng.generate(REP_PROMPT, max_new_tokens=40, temperature=0.0,
                         stop_tokens=[stop_at])
    got = port.generate(REP_PROMPT, max_new_tokens=40, temperature=0.0,
                        stop_tokens=[stop_at])
    assert got.token_ids == want.token_ids == free[:cut]
    assert got.finish_reason == want.finish_reason == "stop"


def test_mixed_batch_greedy_spec_rows_plus_sampled_rows(spec_pair):
    """Concurrent greedy and sampled requests share the batch: the greedy
    rows keep JAX's tokens and speculate, the sampled rows finish."""
    jeng, port = spec_pair
    truth = [jeng.generate(p, max_new_tokens=30, temperature=0.0).token_ids
             for p in (REP_PROMPT, REP_PROMPT + [3])]
    drafted0 = port.scheduler.stats.spec_drafted
    results: dict = {}

    def run(tag, prompt, temp):
        results[tag] = port.generate(prompt, max_new_tokens=30, temperature=temp,
                                     top_k=20, stop_tokens=[])

    threads = [threading.Thread(target=run, args=a) for a in (
        ("g0", REP_PROMPT, 0.0), ("g1", REP_PROMPT + [3], 0.0),
        ("s0", REP_PROMPT, 0.9), ("s1", list(range(3, 27)), 1.2))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert results["g0"].token_ids == truth[0]
    assert results["g1"].token_ids == truth[1]
    for tag in ("s0", "s1"):
        assert results[tag].new_tokens == 30 and results[tag].finish_reason == "length"
    assert port.scheduler.stats.spec_drafted > drafted0


@pytest.mark.parametrize("over,new_tokens", [
    (dict(max_seq_len=64), 60),  # rows run into the K+1 veto near the cap
    (dict(spec_tokens=100), 40),  # K never fits: no spec step at all
])
def test_near_capacity_falls_back_cleanly(weights, over, new_tokens):
    """Rows within K+1 of capacity take plain windows: parity with the
    JAX spec engine up to the cache-imposed cap; a K that never fits
    runs no spec step and multi-chunk windows resume."""
    cfg = dict(dict(spec_tokens=6), **over)
    jeng, port = _jax(**cfg), _port(weights[1], **cfg)
    try:
        want = jeng.generate(REP_PROMPT, max_new_tokens=new_tokens, temperature=0.0)
        got = port.generate(REP_PROMPT, max_new_tokens=new_tokens, temperature=0.0)
        assert got.token_ids == want.token_ids
        if over.get("spec_tokens") == 100:
            st = port.scheduler.stats
            assert st.spec_steps == 0 and st.chunks > st.windows
    finally:
        jeng.close()
        port.close()


def test_adaptive_disable_stops_drafting(weights):
    """An impossible acceptance floor retires the n-gram tier after the
    probe budget: parity holds and the draft volume is JAX's, bounded by
    the probe."""
    cfg = dict(spec_tokens=6, spec_min_accept=1.1, spec_probe_tokens=12)
    jeng, port = _jax(**cfg), _port(weights[1], **cfg)
    try:
        want = jeng.generate(REP_PROMPT, max_new_tokens=40, temperature=0.0)
        got = port.generate(REP_PROMPT, max_new_tokens=40, temperature=0.0)
        assert got.token_ids == want.token_ids
        assert (port.scheduler.stats.spec_drafted
                == jeng.scheduler.stats.spec_drafted)
        assert 0 < port.scheduler.stats.spec_drafted <= 12
    finally:
        jeng.close()
        port.close()


# ------------------------------------------------------- paged accounting


def test_paged_pool_releases_draft_blocks_after_rejection_and_retire(weights):
    port = _port(weights[1], spec_tokens=6)
    try:
        sch = port.scheduler
        free0 = sch._alloc.free_count
        r1 = port.generate(REP_PROMPT, max_new_tokens=40, temperature=0.0)
        st = sch.stats
        # rejected slots were written and freed (JAX's bound on the counts)
        assert st.spec_steps > 0
        assert st.spec_accepted < st.spec_drafted + st.spec_steps * 2
        assert sch._alloc.free_count == free0
        r2 = port.generate(REP_PROMPT, max_new_tokens=40, temperature=0.0)
        assert sch._alloc.free_count == free0 and r2.token_ids == r1.token_ids
    finally:
        port.close()


def test_paged_spec_with_prefix_cache_pins_survive(weights):
    port = _port(weights[1], spec_tokens=6, prefix_cache_entries=2)
    try:
        sch = port.scheduler
        free0 = sch._alloc.free_count
        port.generate(REP_PROMPT, max_new_tokens=32, temperature=0.0)
        pinned = ceil_div(len(REP_PROMPT), port.engine_cfg.kv_block_size)
        assert sch._alloc.free_count == free0 - pinned
        port.generate(REP_PROMPT, max_new_tokens=32, temperature=0.0)
        assert sch.stats.prefix_hits >= 1 and sch.stats.spec_steps > 0
        assert sch._alloc.free_count == free0 - pinned
    finally:
        port.close()


# ------------------------------------------------------------ observability


def test_spec_counters_in_stats_and_info(spec_pair):
    jeng, port = spec_pair
    for eng in spec_pair:
        eng.generate(REP_PROMPT, max_new_tokens=24, temperature=0.0)
    st = port.scheduler.stats
    info = port.info["spec"]
    assert set(info) == set(jeng.info["spec"])
    assert info == {"spec_tokens": 6, "drafted": st.spec_drafted,
                    "accepted": st.spec_accepted,
                    "acceptance": round(st.spec_acceptance, 4)}
    assert st.spec_drafted > 0 and set(st.spec_tiers) == {"ngram"}
    assert st.spec_tiers["ngram"] == {"drafted": st.spec_drafted,
                                      "accepted": st.spec_accepted}


def test_info_spec_present_without_scheduler(weights):
    port = _port(weights[1])
    try:
        assert port.info["spec"] == weights[0].info["spec"] == {
            "spec_tokens": 0, "drafted": 0, "accepted": 0, "acceptance": 0.0}
        assert port._scheduler is None
    finally:
        port.close()


def test_verify_step_matches_the_jax_verify_fn(weights):
    """The engine's ``_spec_verify`` against JAX ``_spec_verify_fn`` on one
    [B, K+1] chunk over the same pool: next tokens, accepted counts and
    the fused penalty counts equal."""
    import jax.numpy as jnp

    jeng, params = weights
    port = _port(params)
    try:
        rng = np.random.default_rng(0)
        B, K, BS = 3, 4, 16
        pool = port.new_pool()
        jpool = jeng.new_pool()
        offs = np.asarray([20, 7, 33], np.int32)
        tables = np.asarray([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.int32)
        # fill the rows' first positions with a real prefill each
        for b in range(B):
            ids = rng.integers(3, 500, size=(1, int(offs[b]))).astype(np.int64)
            port.forward(torch.from_numpy(ids), pool, 0, torch.from_numpy(tables[b:b + 1]))
            jpool, _ = jeng._prefill(jeng.params, jnp.asarray(ids, jnp.int32), jpool,
                                     jnp.asarray([ids.shape[1]], jnp.int32), jnp.int32(0),
                                     jnp.asarray(tables[b:b + 1]))
        cur = rng.integers(3, 500, size=B)
        drafts = rng.integers(3, 500, size=(B, K))
        lens = np.asarray([0, 2, 4], np.int32)
        counts = rng.integers(0, 3, size=(B, 2, port.model_cfg.vocab_size)).astype(np.int32)
        knobs = (np.zeros(B, np.float32), np.zeros(B, np.int32), np.ones(B, np.float32))
        pen = np.asarray([1.3, 1.0, 1.1], np.float32), np.zeros(B, np.float32), \
            np.asarray([0.0, 0.5, 0.0], np.float32)
        want_nxt, _, want_acc, want_counts = jeng._spec_verify(
            jeng.params, jnp.asarray(cur, jnp.int32), jnp.asarray(drafts, jnp.int32),
            jnp.asarray(lens), jpool, jnp.asarray(offs), *knobs, None,
            jax.random.key(0), jnp.asarray(tables), counts=jnp.asarray(counts),
            reps=pen[0], press=pen[1], freqs=pen[2])
        t = torch.from_numpy
        tc = t(counts.copy())
        nxt, acc = port._spec_verify(
            t(cur), t(drafts), t(lens), pool, t(offs), t(tables), t(knobs[0]),
            t(knobs[1]), t(knobs[2]), counts=tc, repetition=t(pen[0]),
            presence=t(pen[1]), frequency=t(pen[2]))
        assert nxt.tolist() == np.asarray(want_nxt).tolist()
        assert acc.tolist() == np.asarray(want_acc).tolist()
        np.testing.assert_array_equal(tc.numpy(), np.asarray(want_counts))
    finally:
        port.close()
