"""The port's prompt prefix cache and copy-on-write block sharing against
the JAX package's (tests/test_prefix_cache.py, ported), on the CPU.

Both engines serve tiny-llama in f32 from the same numpy weights
(``params_from_numpy``), over an f32 pool and over an int8 pool, with
block size 8, a 2-entry prefix cache and a 14-block pool. One sequence
runs on both, step by step: a miss, an exact repeat (a CoW hit), a chat
turn that extends it (a CoW hit), a block-aligned miss and its hit (no
copy), a long prompt that pushes an entry out, two concurrent prompts
that cannot both fit (the second requeues on an exhausted pool, and
pressure eviction reclaims pins for each). After every step:

- greedy tokens equal the JAX engine's (tolerance 0);
- ``prefix_hits``, ``prefix_tokens_saved`` and ``paged_blocks_copied``
  equal JAX's, and so do the prefix entries (keys and block ids) and
  every block's refcount;
- over the int8 pool, every entry's prompt slots (bytes) and block scales
  equal JAX's. The owner of an entry decodes into its pinned partial
  block, which can grow the block's scale and requantize the prompt
  slots below: JAX does the same, and the entries compared hold such
  blocks. Scales agree within 1e-5 relative and bytes within one int8
  step: the two forwards compute K/V in f32 in another order (~1e-6), as
  in tests/test_torch_models.py;
- no write of the int8 pool (prefill or decode) touches a block that a
  live row borrowed from the cache or that two rows map
  (``_quantized_page_write``'s page window never holds a shared block).

Plus the five tests of tests/test_prefix_cache.py on the port (LRU and
matching and ``best_prefix_key`` against the JAX functions, repeat and
extension hits and entry isolation against a cache-off port engine and
the JAX tokens), the pool sizing with pin room, and the scheduler stats'
keys against the JAX scheduler's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax

from bee2bee_tpu.engine import EngineConfig as JaxEngineConfig
from bee2bee_tpu.engine import InferenceEngine as JaxEngine
from bee2bee_tpu.engine import paged as jpaged
from bee2bee_tpu.engine.scheduler import SchedulerStats as JaxSchedulerStats
from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine, paged
from bee2bee_tpu_torch.engine.scheduler import SchedulerStats
from bee2bee_tpu_torch.models import core
from bee2bee_tpu_torch.models.config import get_config
from bee2bee_tpu_torch.models.params import params_from_numpy

BS = 8
KW = dict(max_seq_len=128, dtype="float32", decode_chunk=4,
          prefill_buckets=(16, 32, 64), max_batch=2, kv_block_size=BS,
          prefix_cache_entries=2, kv_pool_blocks=14)
SCALE_RTOL = 1e-5
# the scheduler stats only the port keeps: its decode windows and CUDA
# graphs (the JAX engine compiles a scan instead)
PORT_ONLY_STATS = {"windows", "graph_captures", "graph_replays", "graph_capture_s",
                   "graph_warmup_s", "graph_setup_forwards", "graph_keys"}


def _prompts():
    rng = np.random.default_rng(5)
    return lambda n: list(map(int, rng.integers(3, 500, size=n)))


def _engines(pool: str, **over):
    jax_engine = JaxEngine("tiny-llama", engine_config=JaxEngineConfig(
        **dict(KW, cache_dtype=pool, **over)))
    params = params_from_numpy(jax.device_get(jax_engine.params),
                               get_config("tiny-llama"), "cpu", torch.float32)
    port = InferenceEngine("tiny-llama", params=params, device="cpu",
                           engine_config=EngineConfig(**dict(KW, cache_dtype=pool, **over)))
    return jax_engine, port


def _observe(engine) -> dict:
    sch = engine.scheduler
    st = sch.stats
    cache = sch._prefix_cache
    pool = {k: np.asarray(v) if not isinstance(v, torch.Tensor) else v.numpy().copy()
            for k, v in sch._cache.items()}
    return {
        "stats": (st.prefix_hits, st.prefix_tokens_saved, st.paged_blocks_copied),
        "entries": [(k, tuple(map(int, v))) for k, v in cache._entries.items()],
        "refs": sch._alloc._refs.tolist(),
        "pool": pool,
    }


def _concurrent(engine, jobs):
    """Submit every job under the scheduler's lock, so the loop sees them
    together, and wait for each (bounded)."""
    sch = engine.scheduler
    reqs = [engine._make_request(p, m, 0.0, 0, 1.0, None) for p, m in jobs]
    with sch._cond:
        for r in reqs:
            sch.submit(r)
    out = []
    for r in reqs:
        while True:
            ev = r.events.get(timeout=60)
            if ev.get("done"):
                assert ev.get("result") is not None, ev
                out.append(ev["result"].token_ids)
                break
    return out


class _WriteWatch:
    """Wraps the port's ``_quantized_page_write`` while a sequence runs:
    every page a write touches (blocks of non-redirected positions) must
    be mapped by one live row only and must not be one the writing rows
    borrowed from the prefix cache."""

    def __init__(self, engine, monkeypatch):
        self.sch = engine.scheduler
        self.admitting = None
        self.writes = self.shared_writes = 0
        self.checked_while_shared = 0
        write, prefill = core._quantized_page_write, self.sch._paged_prefill

        def watched_write(pool, scale, blk, slot, wslot, xT):
            self.check(set(blk.unique().tolist()) - {0})
            return write(pool, scale, blk, slot, wslot, xT)

        def watched_prefill(req, b, bucket, start, cached, seq=None):
            if cached is not None:
                req.borrowed = set(int(x) for x in cached[:start // BS])
            self.admitting = req
            try:
                return prefill(req, b, bucket, start, cached, seq)
            finally:
                self.admitting = None

        monkeypatch.setattr(core, "_quantized_page_write", watched_write)
        monkeypatch.setattr(self.sch, "_paged_prefill", watched_prefill)

    def check(self, written: set):
        sch = self.sch
        live = [r for r in sch._rows if r is not None]
        if self.admitting is not None:
            live.append(self.admitting)
        borrowed = set().union(*(getattr(r, "borrowed", set()) for r in live))
        self.writes += 1
        if borrowed:
            self.checked_while_shared += 1
        assert not written & borrowed, f"a write touched borrowed blocks {written & borrowed}"
        for blk in written:
            owners = sum(blk in rb for rb in sch._row_blocks)
            assert owners <= 1, f"block {blk} is written while {owners} rows map it"


def _sequence(jax_engine, port, watch=None):
    """The sequence of the module docstring on both engines; yields
    (step name, jax tokens, port tokens, jax observation, port
    observation) after each step."""
    P = _prompts()
    p1, p2, p3 = P(21), P(17), P(16)
    steps = []

    def gen(name, prompt, m):
        want = jax_engine.generate(prompt, max_new_tokens=m, temperature=0.0).token_ids
        got = port.generate(prompt, max_new_tokens=m, temperature=0.0).token_ids
        steps.append((name, want, got, _observe(jax_engine), _observe(port)))
        return got

    r1 = gen("miss", p1, 6)
    gen("exact repeat", p1, 6)
    gen("chat extension", p1 + r1 + P(10), 5)
    gen("aligned miss", p3, 4)
    gen("aligned hit", p3 + P(9), 4)
    gen("long prompt", P(60), 10)
    gen("another miss", p2, 4)
    jobs = [(P(70), 20), (P(50), 8)]
    want = _concurrent(jax_engine, jobs)
    got = _concurrent(port, jobs)
    steps.append(("concurrent, one requeued", want, got, _observe(jax_engine),
                  _observe(port)))
    waits = (jax_engine.scheduler.stats.paged_alloc_waits,
             port.scheduler.stats.paged_alloc_waits)
    return steps, waits


def _run(pool: str):
    jax_engine, port = _engines(pool)
    mp = pytest.MonkeyPatch()
    try:
        watch = _WriteWatch(port, mp) if pool == "int8" else None
        steps, waits = _sequence(jax_engine, port, watch)
        yield pool, steps, waits, watch, port
    finally:
        mp.undo()
        jax_engine.close()
        port.close()


@pytest.fixture(scope="module")
def float32_sequence():
    yield from _run("float32")


@pytest.fixture(scope="module")
def int8_sequence():
    yield from _run("int8")


@pytest.fixture(params=["float32", "int8"])
def sequence(request):
    """The sequence over each pool (each run once per module)."""
    return request.getfixturevalue(f"{request.param}_sequence")


# --------------------------------------------------------- the sequence


def test_sequence_greedy_tokens_equal_jax(sequence):
    _, steps, _, _, _ = sequence
    for name, want, got, _, _ in steps:
        assert got == want, name


def test_sequence_prefix_stats_entries_and_refcounts_equal_jax(sequence):
    _, steps, waits, _, _ = sequence
    for name, _, _, jobs, pobs in steps:
        assert pobs["stats"] == jobs["stats"], name
        assert pobs["entries"] == jobs["entries"], name
        assert pobs["refs"] == jobs["refs"], name
    final = steps[-1][4]["stats"]
    assert final == (3, 57, 2)  # 3 hits, 2 of them CoW copies
    # the long prompt evicted by capacity; the concurrent pair by pressure
    # (the last step ends with ONE entry where capacity allows two)
    assert [len(k) for k, _ in steps[5][4]["entries"]] == [25, 60]
    assert len(steps[-1][4]["entries"]) == 1
    assert waits[0] == waits[1] > 0  # the second of the pair requeued


def test_sequence_written_slots_equal_jax_over_the_int8_pool(int8_sequence):
    """Every entry's prompt slots and block scales, after every step: the
    entries include an owner's pinned partial block it decoded into."""
    _, steps, _, _, _ = int8_sequence
    partial = 0
    for name, _, _, jobs, pobs in steps:
        for (key, blocks), (_, jblocks) in zip(pobs["entries"], jobs["entries"]):
            n = len(key)
            partial += n % BS != 0
            pos = np.arange(n)
            for part in ("k", "v"):
                got = pobs["pool"][part][:, :, np.asarray(blocks)[pos // BS], pos % BS]
                want = jobs["pool"][part][:, :, np.asarray(jblocks)[pos // BS], pos % BS]
                diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1, (name, part, int(diff.max()))
                np.testing.assert_allclose(
                    pobs["pool"][f"{part}_scale"][:, :, list(blocks)],
                    jobs["pool"][f"{part}_scale"][:, :, list(jblocks)],
                    rtol=SCALE_RTOL, err_msg=f"{name} {part}_scale",
                )
    assert partial > 0


def test_no_shared_block_is_ever_written(int8_sequence):
    _, _, _, watch, _ = int8_sequence
    assert watch.writes > 0 and watch.checked_while_shared > 0


# ------------------------------------------- tests/test_prefix_cache.py


def test_prefix_cache_lru_and_matching():
    """The longest-usable-prefix contract, LRU capacity eviction and its
    pins, op for op against the JAX cache over the same allocator moves."""
    results = []
    for mod in (paged, jpaged):
        alloc = mod.BlockAllocator(16)
        a, b, c = alloc.alloc(1), alloc.alloc(1), alloc.alloc(1)
        pc = mod.PagedPrefixCache(2, alloc)
        pc.put([1, 2, 3], a)
        pc.put([1, 2], b)
        out = [pc.match([1, 2, 3, 4]), pc.match([1, 2, 3]), pc.match([1, 2]),
               pc.match([9, 9])]
        pc.put([7], c)
        out += [len(pc), pc.match([7, 8]), alloc._refs.tolist(), pc.has([7]),
                pc.evict_for_pressure(14), alloc.free_count, len(pc),
                pc.evict_for_pressure(16), alloc._refs.tolist(), alloc.free_count]
        results.append(out)
    assert results[0] == results[1]
    assert results[0][0] == (3, tuple(results[0][0][1]))


@pytest.mark.parametrize("keys,ids", [
    ([(1, 2, 3, 4), (1, 2, 9), (1, 2, 3)], [1, 2, 3, 4, 5]),
    ([(1, 2, 3, 4), (1, 2, 9), (1, 2, 3)], [1, 2, 3, 5]),
    ([(1, 2, 3, 4), (1, 2, 9), (1, 2, 3)], [7, 7, 7]),
    ([(1, 2), (1, 2, 9)], [1, 2, 3]),
    ([(5,)], [5]),
    ([], [1, 2]),
])
def test_best_prefix_key_element_wise_semantics(keys, ids):
    assert paged.best_prefix_key(keys, ids) == jpaged.best_prefix_key(keys, ids)


def _cache_off(port, prompt, m):
    """The same weights without the cache (the reference of a hit)."""
    eng = InferenceEngine("tiny-llama", params=port.params, device="cpu",
                          engine_config=EngineConfig(**dict(
                              KW, cache_dtype=port.engine_cfg.cache_dtype,
                              prefix_cache_entries=0, kv_pool_blocks=None)))
    try:
        return eng.generate(prompt, max_new_tokens=m, temperature=0.0).token_ids
    finally:
        eng.close()


def test_repeat_prompt_hits_prefix_cache(sequence):
    _, steps, _, _, port = sequence
    (_, want, first, _, o1), (_, _, second, _, o2) = steps[:2]
    assert o1["stats"] == (0, 0, 0)
    assert o2["stats"][:2] == (1, 20)  # the last token prefills again
    assert first == second == want == _cache_off(port, _prompts()(21), 6)


def test_chat_turn_extension_prefills_only_delta(sequence):
    """Turn 2 = turn 1's prompt, its reply and new text: only the delta
    prefills, and the tokens equal a cache-off engine's."""
    _, steps, _, _, port = sequence
    P = _prompts()
    p1, _, _ = P(21), P(17), P(16)  # the sequence's draws
    turn2 = p1 + steps[0][2] + P(10)
    _, want, got, _, obs = steps[2]
    assert obs["stats"][:2] == (2, 20 + len(p1))
    assert _cache_off(port, turn2, 5) == got == want


def test_prefix_cache_entries_are_isolated():
    """Decoding after a hit must not corrupt the stored entry: a prompt
    served three times (two hits) decodes the same tokens, equal to a
    cache-off engine's, over both pools."""
    prompt = _prompts()(24)
    for pool in ("float32", "int8"):
        eng = InferenceEngine("tiny-llama", device="cpu",
                              engine_config=EngineConfig(**dict(KW, cache_dtype=pool)))
        try:
            got = [eng.generate(prompt, max_new_tokens=10, temperature=0.0).token_ids
                   for _ in range(3)]
            assert eng.scheduler.stats.prefix_hits == 2
            assert got[0] == got[1] == got[2] == _cache_off(eng, prompt, 10)
        finally:
            eng.close()


# ------------------------------------------------------- config and stats


def test_prefix_cache_config_builds_and_sizes_the_pool_like_jax():
    """``prefix_cache_entries`` no longer raises; the pool gets room for
    the pins, block for block as the JAX engine sizes it."""
    over = dict(max_seq_len=256, kv_block_size=16, max_batch=8, prefix_cache_entries=8)
    eng = InferenceEngine("tiny-llama", device="cpu", engine_config=EngineConfig(**over))
    jeng = JaxEngine("tiny-llama", engine_config=JaxEngineConfig(**over))
    try:
        assert eng.pool_blocks == jeng.pool_blocks == 1 + 8 * 18 + 8 * 16
        assert eng.kv_info == jeng.kv_info
    finally:
        eng.close()
        jeng.close()


def test_scheduler_stats_match_jax_key_for_key():
    """The port's SchedulerStats carry every JAX key (the prefix and CoW
    counts among them); the only extra keys are the port's windows and
    graph counts."""
    ours = set(dataclasses.asdict(SchedulerStats()))
    theirs = set(dataclasses.asdict(JaxSchedulerStats()))
    assert ours - PORT_ONLY_STATS == theirs
    assert {"prefix_hits", "prefix_tokens_saved", "paged_blocks_copied"} <= ours
    assert SchedulerStats().spec_acceptance == JaxSchedulerStats().spec_acceptance


def test_concurrent_hits_share_blocks_and_release_them():
    """Two rows admitted together from one entry share its full blocks
    (refcount 4: the entry's pin, both rows, and the pin of the first
    row's own entry, put before the second row is admitted), copy their
    partial blocks apart,
    decode the cache-off engine's tokens, and every reference drops back
    to the pin at retirement."""
    P = _prompts()
    base = P(20)
    prompts = [base + P(5), base + P(7)]
    eng = InferenceEngine("tiny-llama", device="cpu",
                          engine_config=EngineConfig(**dict(KW, cache_dtype="int8",
                                                            kv_pool_blocks=None)))
    try:
        eng.generate(base, max_new_tokens=4, temperature=0.0)
        sch = eng.scheduler
        ((_, blocks),) = sch._prefix_cache._entries.items()
        refs: list = []
        write = core._quantized_page_write

        def watched(pool, scale, blk, slot, wslot, xT):
            refs.append(max(sch._alloc.refcount(b) for b in blocks[:2]))
            return write(pool, scale, blk, slot, wslot, xT)

        core._quantized_page_write = watched
        try:
            outs = _concurrent(eng, [(p, 6) for p in prompts])
        finally:
            core._quantized_page_write = write
        assert max(refs) == 4
        assert sch.stats.prefix_hits == 2 and sch.stats.paged_blocks_copied == 2
        assert outs == [_cache_off(eng, p, 6) for p in prompts]
        # the pins of base and of both extensions remain; no row holds any
        assert all(sch._alloc.refcount(b) >= 1 for b in blocks)
        pinned = [b for _, bl in sch._prefix_cache._entries.items() for b in bl]
        assert [sch._alloc.refcount(b) for b in set(pinned)] == [
            pinned.count(b) for b in set(pinned)]
    finally:
        eng.close()
