"""The port's decode hot loop against the JAX engine's (CPU, tiny-llama
f32, ``decode_chunk`` 4, 4 rows: the configuration of
tests/test_decode_hotloop.py, with the JAX engine's weights carried across
by ``params_from_numpy``).

- Greedy tokens equal the JAX engine's with overlap, the readback ring,
  the fused root and sticky widths on, on the JAX test sequences: mixed
  budgets with retirement and queued admission, and a mixed batch with a
  repetition-penalised row; a request admitted while windows are in
  flight decodes the JAX tokens too. The port has one decode root, which
  always carries the penalty counts (the JAX fused root).
- Overlap on and off give the same tokens.
- ``engine.host_syncs`` counts one per fetched window; with overlap on
  the uniform-budget batch stalls on fewer syncs than it makes, and with
  overlap off on every one.
- The sticky bucket holds its width through retirement and releases it
  after the idle window, also when the scheduler thread serves the next
  request; without it the bucket walks the JAX ladder.
- A row that retires while windows are in flight keeps its blocks out of
  the free list until the ring drains.
- The graph key's first five fields are the JAX ``_decode_key``'s for the
  same state.
- A decode graph's replay adds its capture's counts (a fake graph: the
  CPU captures nothing).
- A decode step that raises fails the batch through the error path,
  which rebuilds the pool, the static buffers and the ring.

On the CPU the decode root runs eagerly; chip_smoke.py holds the captured
graphs against the eager step on the card.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from bee2bee_tpu.engine import EngineConfig as JaxEngineConfig
from bee2bee_tpu.engine import InferenceEngine as JaxEngine
from bee2bee_tpu.engine.scheduler import BatchScheduler as JaxBatchScheduler
from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
from bee2bee_tpu_torch.engine import scheduler as port_scheduler
from bee2bee_tpu_torch.engine.introspect import device_gate
from bee2bee_tpu_torch.models.config import get_config
from bee2bee_tpu_torch.models.params import params_from_numpy
from bee2bee_tpu_torch.ops import flash, flash_attention, ragged, ragged_paged_attention

ROWS = 4
PROMPTS = [[1 + (i * 37 + j) % 500 for j in range(32)] for i in range(ROWS)]
BASE = dict(max_seq_len=256, max_batch=ROWS, prefill_buckets=(32,),
            dtype="float32", cache_dtype="float32", decode_chunk=4,
            spec_tokens=0, rng_seed=7)
ON = dict(decode_overlap=True, fused_root=True, batch_sticky=True, readback_depth=2)
OFF = dict(decode_overlap=False, fused_root=False, batch_sticky=False,
           readback_depth=1)
RETIRE_BUDGETS = [8, 12, 16, 20, 24, 28]  # 6 requests through 4 rows
MIXED_BUDGETS = [16] * ROWS  # the last row repetition-penalised
LONG = 56


def _run_batch(eng, budgets, penalize_last=False):
    """Concurrent greedy requests (prompt i % ROWS) through the scheduler;
    the token ids in submission order."""
    results: list = [None] * len(budgets)

    def run(i):
        kw = {"max_new_tokens": budgets[i], "temperature": 0.0}
        if penalize_last and i == len(budgets) - 1:
            kw["repetition_penalty"] = 1.3
        results[i] = eng.generate(PROMPTS[i % ROWS], **kw)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(budgets))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(r is not None for r in results)
    return [r.token_ids for r in results]


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX engine with every hot-loop mechanism on, its weights, and
    its tokens on the two JAX test sequences."""
    eng = JaxEngine("tiny-llama", engine_config=JaxEngineConfig(**BASE, **ON))
    try:
        yield SimpleNamespace(
            params=jax.device_get(eng.params),
            retire=_run_batch(eng, RETIRE_BUDGETS),
            mixed=_run_batch(eng, MIXED_BUDGETS, penalize_last=True),
            # long enough that windows are capped at max_inflight_chunks
            # and look-ahead windows run
            long=_run_batch(eng, [LONG] * ROWS),
        )
    finally:
        eng.close()


def _port(jax_ref, **knobs):
    params = params_from_numpy(jax_ref.params, get_config("tiny-llama"), "cpu",
                               torch.float32)
    return InferenceEngine("tiny-llama", params=params, device="cpu",
                           engine_config=EngineConfig(**{**BASE, **knobs}))


@pytest.fixture(scope="module")
def port_on(jax_ref):
    eng = _port(jax_ref, **ON)
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def port_off(jax_ref):
    eng = _port(jax_ref, **OFF)
    yield eng
    eng.close()


def _wait_idle(sch, timeout=10.0):
    deadline = time.monotonic() + timeout
    while (sch.active or sch._inflight) and time.monotonic() < deadline:
        time.sleep(0.005)
    assert not sch.active and not sch._inflight


# ------------------------------------------------------------ token parity


@pytest.mark.parametrize("mode", ["on", "off"])
def test_greedy_parity_with_jax_under_retirement_and_queueing(jax_ref, port_on,
                                                              port_off, mode):
    eng = port_on if mode == "on" else port_off
    assert _run_batch(eng, RETIRE_BUDGETS) == jax_ref.retire


@pytest.mark.parametrize("mode", ["on", "off"])
def test_fused_mixed_batch_parity_with_jax(jax_ref, port_on, port_off, mode):
    """The counts riding the one decode root give the JAX engine's tokens
    on a batch of 3 plain rows and 1 repetition-penalised row, with every
    hot-loop mechanism on (on) and with overlap and sticky widths off
    (off)."""
    eng = port_on if mode == "on" else port_off
    before = eng.scheduler.stats.counts_windows
    assert _run_batch(eng, MIXED_BUDGETS, penalize_last=True) == jax_ref.mixed
    assert eng.scheduler.stats.counts_windows > before


def test_overlap_off_changes_no_tokens(jax_ref, port_on):
    """Overlap alone off against the all-on engine."""
    want_retire = _run_batch(port_on, RETIRE_BUDGETS)
    want_mixed = _run_batch(port_on, MIXED_BUDGETS, penalize_last=True)
    eng = _port(jax_ref, **dict(ON, decode_overlap=False))
    try:
        assert _run_batch(eng, RETIRE_BUDGETS) == want_retire
        assert _run_batch(eng, MIXED_BUDGETS, penalize_last=True) == want_mixed
    finally:
        eng.close()


def test_admission_while_windows_are_in_flight(jax_ref, port_on):
    """Requests submitted while two windows are in flight (from the
    scheduler thread, right after a look-ahead dispatch) are admitted after
    the loop drains the ring, and every request decodes the JAX engine's
    tokens (prefixes of its LONG runs of the same prompts)."""
    sch = port_on.scheduler
    _wait_idle(sch)
    specs = [(p, LONG) for p in range(ROWS)] + [(0, 8), (1, 12)]
    reqs = [port_on._make_request(PROMPTS[p], b, 0.0, 0, 1.0, None) for p, b in specs]
    drains: list = []
    submitted: list = []
    drain, dispatch = sch._drain_inflight, sch._dispatch_window

    def counted_drain():
        drains.append((len(sch._inflight), len(sch._queue)))
        return drain()

    def dispatch_then_submit(pending=0):
        ok = dispatch(pending)
        if ok and len(sch._inflight) == 2 and not submitted:
            submitted.extend(sch.submit(r) for r in reqs[ROWS:])
        return ok

    sch._drain_inflight, sch._dispatch_window = counted_drain, dispatch_then_submit
    try:
        for r in reqs[:ROWS]:
            sch.submit(r)
        out = []
        for r in reqs:
            ev = r.events.get(timeout=60)
            while not ev.get("done"):
                ev = r.events.get(timeout=60)
            out.append(ev["result"].token_ids)
    finally:
        sch._drain_inflight, sch._dispatch_window = drain, dispatch
    assert submitted, "the ring never held two windows"
    for (p, b), toks in zip(specs, out):
        assert toks == jax_ref.long[p][:b], (p, b)
    assert any(inflight and queued for inflight, queued in drains), drains


# ------------------------------------------------------------ readback ring


def test_host_syncs_count_one_per_fetched_window(port_on):
    """Every dispatched window is fetched once, and each fetch is one
    host sync."""
    sch = port_on.scheduler
    _wait_idle(sch)
    dispatched = []
    dispatch = sch._dispatch_window

    def counted_dispatch(pending=0):
        ok = dispatch(pending)
        dispatched.append(ok)
        return ok

    s0, w0 = port_scheduler._C_HOST_SYNCS.value(), sch.stats.windows
    sch._dispatch_window = counted_dispatch
    try:
        _run_batch(port_on, [6, 20, 20, 20])
        _wait_idle(sch)
    finally:
        sch._dispatch_window = dispatch
    syncs = port_scheduler._C_HOST_SYNCS.value() - s0
    assert syncs > 0 and syncs == sum(dispatched) == sch.stats.windows - w0


@pytest.mark.parametrize("mode", ["on", "off"])
def test_overlap_removes_host_sync_stalls(port_on, port_off, mode):
    """Uniform budgets, no queue or stream: with the ring on some fetches
    find another window in flight; with it off every fetch stalls."""
    eng = port_on if mode == "on" else port_off
    budgets = [48] * ROWS
    _run_batch(eng, budgets)
    s0 = port_scheduler._C_HOST_SYNCS.value()
    t0 = port_scheduler._C_SYNC_STALLS.value()
    _run_batch(eng, budgets)
    syncs = port_scheduler._C_HOST_SYNCS.value() - s0
    stalls = port_scheduler._C_SYNC_STALLS.value() - t0
    assert syncs > 0
    if mode == "on":
        assert stalls < syncs, f"{stalls}/{syncs} stalled"
    else:
        assert stalls == syncs, f"{stalls}/{syncs} stalled"


def test_retired_rows_blocks_wait_for_the_ring_to_drain(jax_ref, port_on):
    """Uniform long budgets with overlap on, and a stop token that ends
    row 0 early: it retires while a look-ahead window is in flight. Its
    blocks are held back, nothing is derefed while the ring holds a
    window, and no block allocated then is one held back."""
    sch = port_on.scheduler
    _wait_idle(sch)
    alloc = sch._alloc
    seen = {"deferred": 0, "deref_in_flight": 0, "freed_early": 0, "reused": 0}
    deref, take, fetch = alloc.deref, alloc.alloc, sch._fetch_window

    def watched_deref(blocks):
        if sch._inflight:
            seen["deref_in_flight"] += 1
        return deref(blocks)

    def watched_alloc(n):
        fresh = take(n)
        if fresh and set(fresh) & set(sch._deferred_blocks):
            seen["reused"] += 1
        return fresh

    def watched_fetch(rec):
        held = set(sch._deferred_blocks)
        seen["deferred"] = max(seen["deferred"], len(held))
        if held & set(alloc._free):
            seen["freed_early"] += 1
        return fetch(rec)

    seq = jax_ref.long[0]
    stop = seq[12]
    # submitted together under the scheduler's lock, so one admission
    # burst places every row and look-ahead starts before row 0 stops
    # (requests trickling in from threads keep the queue non-empty, which
    # holds look-ahead back, for as long as the host schedules them late)
    reqs = [port_on._make_request(PROMPTS[i], LONG, 0.0, 0, 1.0,
                                  [stop] if i == 0 else None) for i in range(ROWS)]
    results: list = []
    alloc.deref, alloc.alloc = watched_deref, watched_alloc
    sch._fetch_window = watched_fetch
    try:
        with sch._cond:
            for r in reqs:
                sch.submit(r)
        for r in reqs:
            while True:
                ev = r.events.get(timeout=60)
                if ev.get("done"):
                    results.append(ev["result"])
                    break
        _wait_idle(sch)
    finally:
        alloc.deref, alloc.alloc = deref, take
        sch._fetch_window = fetch
    assert results[0].token_ids == seq[:seq.index(stop)]
    assert results[0].finish_reason == "stop"
    assert [r.token_ids for r in results[1:]] == jax_ref.long[1:]
    assert seen["deferred"] > 0, "no row retired with windows in flight"
    assert seen["deref_in_flight"] == seen["freed_early"] == seen["reused"] == 0, seen
    assert not sch._deferred_blocks and sch.stats.paged_blocks_in_use == 0


# ------------------------------------------------------------ sticky widths


def test_sticky_width_holds_bucket_and_releases_on_idle(port_on, monkeypatch):
    sch = port_on.scheduler
    _run_batch(port_on, [4, 8, 12, 16])
    _wait_idle(sch)
    assert sch._bsz == ROWS, f"sticky bucket shrank to {sch._bsz} after retirement"
    with sch._cond:
        sch._compact_and_shrink()  # inside the idle window: holds
        assert sch._bsz == ROWS
        monkeypatch.setattr(sch, "_sticky_idle_s", 0.0)
        sch._compact_and_shrink()
        assert sch._bsz == 1


@pytest.mark.parametrize("idle", [False, True], ids=["busy", "idle"])
def test_sticky_bucket_released_by_the_next_admission_after_idle(port_on, monkeypatch,
                                                                  idle):
    """Served through the scheduler thread: after a burst of ROWS requests
    a lone request that comes within the idle window decodes at the held
    bucket; one that comes after it finds the bucket released to 1."""
    sch = port_on.scheduler
    _run_batch(port_on, [4, 8, 12, 16])
    _wait_idle(sch)
    assert sch._bsz == ROWS
    if idle:
        monkeypatch.setattr(sch, "_sticky_idle_s", 0.05)
        time.sleep(0.1)
    port_on.generate(PROMPTS[0], max_new_tokens=8, temperature=0.0)
    _wait_idle(sch)
    assert sch._bsz == (1 if idle else ROWS)


def _ladder(sch, n_rows: int, sticky_idle_s: float) -> list[int]:
    """Fill n_rows rows of an idle scheduler with placeholders at bucket
    n_rows just after a dispatch, retire row 0 one at a time and record the
    bucket after each compaction; leaves the scheduler empty at bucket 1."""
    with sch._cond:
        sch._sticky_idle_s = sticky_idle_s
        sch._last_dispatch_t = time.perf_counter()
        sch._resize(n_rows)
        sch._rows = [SimpleNamespace(penalized=False) for _ in range(n_rows)]
        walk = []
        for _ in range(n_rows):
            sch._rows[0] = None  # a hole the compaction fills from the top
            sch._compact_and_shrink()
            walk.append(sch._bsz)
        sch._sticky_idle_s = 0.0
        sch._compact_and_shrink()
        sch._sticky_idle_s = 5.0
        return walk


@pytest.mark.parametrize("sticky", [True, False], ids=["sticky", "ladder"])
def test_bucket_walk_matches_jax(jax_ref, sticky):
    """The same retirements give the same bucket sizes as the JAX
    scheduler, sticky (held) and not (the quarter-occupancy ladder)."""
    knobs = dict(ON, batch_sticky=sticky)
    kw = dict(BASE, max_batch=8)
    port = InferenceEngine("tiny-llama", device="cpu",
                           engine_config=EngineConfig(**{**kw, **knobs}))
    jeng = JaxEngine("tiny-llama", engine_config=JaxEngineConfig(**kw, **knobs))
    try:
        walks = [_ladder(e.scheduler, 8, 60.0) for e in (port, jeng)]
        assert walks[0] == walks[1]
        assert walks[0] == ([8] * 8 if sticky else [8, 8, 8, 8, 8, 4, 2, 1])
        assert port.scheduler._bsz == jeng.scheduler._bsz == 1
    finally:
        port.close()
        jeng.close()


def test_nonsticky_width_walks_back_to_one(jax_ref):
    eng = _port(jax_ref, **dict(ON, batch_sticky=False))
    try:
        _run_batch(eng, [4, 8, 12, 16])
        sch = eng.scheduler
        _wait_idle(sch)
        assert sch._bsz == 1
    finally:
        eng.close()


# ------------------------------------------------------------ graph keys


def _knob_rows(min_p: bool, pen: bool, sampled: bool):
    return [
        SimpleNamespace(temperature=0.7 if (sampled and b == 1) else 0.0, top_k=0,
                        top_p=1.0,
                        min_p=0.1 if (min_p and b == 2) else 0.0,
                        repetition_penalty=1.3 if (pen and b == 3) else 1.0,
                        presence_penalty=0.0, frequency_penalty=0.0,
                        penalized=pen and b == 3)
        for b in range(ROWS)
    ]


@pytest.mark.parametrize("sampled", [True, False], ids=["sampled", "greedy"])
@pytest.mark.parametrize("pen", [False, True], ids=["plain", "penalized"])
@pytest.mark.parametrize("min_p", [False, True], ids=["no_min_p", "min_p"])
def test_graph_key_matches_the_jax_decode_key(jax_ref, port_on, sampled, pen, min_p):
    """The key's first five fields are the JAX ``_decode_key``'s; the
    sixth says whether any row samples (the all-greedy short-cut)."""
    sch = port_on.scheduler
    _wait_idle(sch)
    tw = 8
    rows = _knob_rows(min_p, pen, sampled)
    with sch._cond:
        saved = sch._bsz, sch._rows
        sch._bsz, sch._rows, sch._row_params_dirty = ROWS, rows, True
        try:
            key = sch._decode_key(tw, sch._stage_knobs(sch._slots[0]))
            knobs_f = sch._d_knobs_f[:, :ROWS].clone()
        finally:
            sch._bsz, sch._rows, sch._row_params_dirty = *saved, True
    np.testing.assert_array_equal(knobs_f[2].numpy() > 0, [r.min_p > 0 for r in rows])
    cur = np.zeros((ROWS,), np.int32)
    tables = np.zeros((ROWS, tw), np.int32)
    minps = np.asarray([r.min_p for r in rows], np.float32)
    counts = np.zeros((ROWS, 2, 512), np.int32)
    args = (None, cur, None, None, None, None, None, minps if min_p else None, None)
    want = JaxBatchScheduler._decode_key(*args, tables=tables,
                                         counts=counts if pen else None)
    assert key == (*want, sampled)


# ------------------------------------------------------------ launch accounting


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_adds_the_counts_its_capture_moved(port_on):
    counters = port_scheduler.launch_counters(port_on)
    names = {n for _, n in counters}
    assert {"decode_launches", "int8_decode_launches", "prefill_launches",
            "forward_calls"} <= names
    # the ops' exported names are every counter their wrappers carry
    for op, listed in ((ragged_paged_attention, ragged.LAUNCH_COUNTERS),
                       (flash_attention, flash.LAUNCH_COUNTERS)):
        assert set(listed) == {n for n in vars(op) if n.endswith("launches")}
        assert {(op, n) for n in listed} <= set(counters)
    before = {n: getattr(h, n) for h, n in counters}
    graph = _FakeGraph()
    dg = port_scheduler.Graph(graph, [
        (ragged_paged_attention, "decode_launches", 2),
        (ragged_paged_attention, "int8_decode_launches", 0),
        (port_on, "forward_calls", 1),
    ])
    try:
        for _ in range(5):
            dg.replay()
        assert graph.replays == 5
        assert ragged_paged_attention.decode_launches == before["decode_launches"] + 10
        assert port_on.forward_calls == before["forward_calls"] + 5
        assert (ragged_paged_attention.int8_decode_launches
                == before["int8_decode_launches"])
    finally:
        ragged_paged_attention.decode_launches = before["decode_launches"]
        port_on.forward_calls = before["forward_calls"]


def test_engine_config_hot_loop_knobs_resolve_like_jax(monkeypatch):
    """The four knobs: the JAX defaults, the JAX env names, the depth
    clamped to 1."""
    fields = ("decode_overlap", "readback_depth", "fused_root", "batch_sticky")
    for env in ({}, {"BEE2BEE_OVERLAP": "0", "BEE2BEE_READBACK_DEPTH": "-3",
                     "BEE2BEE_FUSED_ROOT": "off", "BEE2BEE_BATCH_STICKY": "no"},
                {"BEE2BEE_READBACK_DEPTH": "4", "BEE2BEE_OVERLAP": "yes"}):
        for name in ("BEE2BEE_OVERLAP", "BEE2BEE_READBACK_DEPTH",
                     "BEE2BEE_FUSED_ROOT", "BEE2BEE_BATCH_STICKY"):
            monkeypatch.delenv(name, raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        ours, theirs = EngineConfig(), JaxEngineConfig()
        assert ({f: getattr(ours, f) for f in fields}
                == {f: getattr(theirs, f) for f in fields}), env
    monkeypatch.delenv("BEE2BEE_READBACK_DEPTH", raising=False)
    assert EngineConfig(readback_depth=0).readback_depth == 1


def test_a_failed_decode_step_fails_the_batch_and_rebuilds_the_state(jax_ref, port_on):
    """A decode step that raises (on the card: a capture or a replay)
    fails the requests through the scheduler's error path, which drops
    the ring and rebuilds the pool, the static buffers and the slots; the
    next request decodes the JAX tokens."""
    sch = port_on.scheduler
    _wait_idle(sch)
    old_pool, depth = sch._cache["k"], len(sch._slots)

    def broken(v):
        raise RuntimeError("replay failed")

    sch._decode_step = broken
    try:
        with pytest.raises(RuntimeError, match="replay failed"):
            port_on.generate(PROMPTS[0], max_new_tokens=8, temperature=0.0)
    finally:
        del sch._decode_step
    # the error event comes before the rebuild, in the same scheduler pass:
    # a gate transition waits that pass out
    with device_gate.transition():
        pass
    assert sch._cache["k"] is not old_pool and len(sch._slots) == depth
    assert not sch._inflight and not sch._graphs and sch._bsz == 1
    assert port_on.generate(PROMPTS[0], max_new_tokens=8,
                            temperature=0.0).token_ids == jax_ref.retire[0]
