"""The port's engine economics plane (bee2bee_tpu_torch/engine/introspect.py)
against the JAX package's, on the CPU.

- ``FlopsModel``, ``GoodputMeter`` and ``PoolForecast`` give the JAX
  module's numbers on the same inputs (FLOPs and totals exactly; each
  meter's rates share its window, so fractions and the MFU-to-goodput
  ratio agree); ``peak_flops_per_device`` takes the env override and knows
  the H100's published dense bf16 peak, and keeps the JAX nominal values
  elsewhere.
- The capture sentinel, with captures booked as the scheduler books them
  (``note_compile``) and through the scheduler's own capture wrapper over
  a fake capture: warm-up is quiet; an undeclared key storms at once with
  the typed ``engine:retrace_storm`` incident; a repeated key storms only
  past the threshold; distinct keys do not; the declared batch ladder
  covers a non-pow2 shrink like the JAX engine's; ``engine.compiles
  {root="decode"}`` equals the scheduler's decode captures and its
  seconds their seconds; a capture waits for a device profile, also from
  inside a scheduler pass, whose gate the profile's stop needs.
- The HBM ledger: components sum, a storage counted once, unregister
  clears its gauge, device stats add the workspace residual, and the
  ``BEE2BEE_HBM_BYTES`` budget gives headroom on the CPU; an engine's
  ``weights`` and ``kv_pool`` equal its tensors' storage bytes.
- The profiler over ``torch.profiler`` on the CPU: capture and listing;
  a concurrent capture refused typed; it starts and stops only between
  the schedulers' passes (``device_gate``), and a served engine's
  requests finish beside a capture; the pause repair's choices (CPU and
  device activity without external correlation, 0.05 s windows 0.25 s
  apart stopped by the C++ disable, a readback wait outside the pass, a
  chunk's replays letting a transition in, one forked child writing the joined trace outside
  the capture lock) with the zip layout unchanged.
- The engine and the fleet: a generation rides the digest and
  ``engine.info``; close clears the gauges; the fleet view aggregates a
  CUDA peer's economics; the router penalizes a squeezed or storming
  peer from its real digest; the admission shed reads the forecast's
  gauge.
- The growth gate: under a ledger at 1% headroom a second request is
  refused a wider bucket, ``width_grow_denials`` counts it, and both
  requests still decode the tokens they decode alone.
"""

from __future__ import annotations

import io
import json
import threading
import time
import zipfile

import pytest
import torch

from bee2bee_tpu.engine import EngineConfig as JaxEngineConfig
from bee2bee_tpu.engine import InferenceEngine as JaxEngine
from bee2bee_tpu.engine import introspect as jintro
from bee2bee_tpu.models import config as jconfig
from bee2bee_tpu_torch import health
from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
from bee2bee_tpu_torch.engine import introspect as intro
from bee2bee_tpu_torch.engine import scheduler as port_scheduler
from bee2bee_tpu_torch.metrics import get_registry
from bee2bee_tpu_torch.models.config import get_config
from bee2bee_tpu_torch.router.admission import pool_exhaust_eta
from bee2bee_tpu_torch.router.policy import RouterPolicy, RouterWeights

ECFG = dict(max_seq_len=64, prefill_buckets=(16,), dtype="float32",
            cache_dtype="float32", decode_chunk=4)


def _engine(**over):
    return InferenceEngine("tiny-llama", device="cpu",
                           engine_config=EngineConfig(**{**ECFG, **over}))


class _Recorder:
    """Incident sink: the sentinel's typed incidents, in order."""

    def __init__(self):
        self.incidents = []

    def incident(self, kind, detail=None, node=None, extra=None):
        self.incidents.append({"kind": kind, "detail": detail, "extra": extra})


# ------------------------------------------------ the JAX module's numbers


@pytest.mark.parametrize("name", ["tiny-llama", "llama-3-8b", "mistral-7b"])
def test_flops_model_matches_jax(name):
    ours = intro.FlopsModel(get_config(name))
    theirs = jintro.FlopsModel(jconfig.get_config(name))
    for positions, ctx in ((1.0, 0.0), (8.0, 1024.0), (2048.0, 1024.0), (3.0, -5.0)):
        assert ours.flops(positions, ctx) == theirs.flops(positions, ctx)


def test_goodput_meter_matches_jax():
    cfg, jcfg = get_config("tiny-llama"), jconfig.get_config("tiny-llama")
    ours = intro.GoodputMeter(intro.FlopsModel(cfg), peak_flops=1e9)
    theirs = jintro.GoodputMeter(jintro.FlopsModel(jcfg), peak_flops=1e9)
    for meter in (ours, theirs):
        meter.record_dispatch(100.0, 10.0, scheduled=100)
        meter.note_useful(40)
        meter.record_dispatch(64.0, 500.0, scheduled=60)
        meter.note_useful(0)
        meter.note_useful(17)
    time.sleep(0.01)
    a, b = ours.refresh(), theirs.refresh()
    for key in ("scheduled_tokens_total", "useful_tokens_total", "model_flops_total"):
        assert a[key] == b[key]
    # each meter's rates share its own window, so the fraction is 57/160
    # on both (each rounded to 4 places from its own float ratio) and the
    # ratio of MFU to goodput agrees
    for snap in (a, b):
        assert snap["goodput_fraction"] == pytest.approx(57 / 160, abs=1e-4)
    assert a["mfu"] / a["goodput_tokens_per_s"] == pytest.approx(
        b["mfu"] / b["goodput_tokens_per_s"], rel=1e-3)


def test_goodput_meter_clears_when_idle():
    meter = intro.GoodputMeter(None, peak_flops=1.0, window_s=0.05)
    meter.record_dispatch(10.0, 0.0, scheduled=10)
    meter.refresh()
    reg = get_registry()
    assert reg.get("engine.mfu").series()
    time.sleep(0.15)
    snap = meter.refresh()
    assert "mfu" not in snap
    assert not reg.get("engine.mfu").series()
    assert not reg.get("engine.goodput_tokens_per_s").series()


@pytest.mark.parametrize("feeds,at", [
    ([(0, 100, 0.0), (50, 50, 5.0)], 5.0),       # 10 blocks/s growth
    ([(50, 50, 0.0), (10, 90, 5.0)], 5.0),       # shrinking: no trend
    ([(0, 100, 0.0), (90, 10, 0.5)], 0.5),       # a burst inside 2 s
    ([(0, 100, 0.0), (30, 70, 3.0), (99, 0, 9.0)], 9.0),  # dry
    ([(5, 95, 0.0)], 0.0),                        # one sample
])
def test_pool_forecast_matches_jax(feeds, at):
    ours, theirs = intro.PoolForecast(window_s=30.0), jintro.PoolForecast(window_s=30.0)
    t = 1000.0
    for used, free, dt in feeds:
        ours.feed(used, free, now=t + dt)
        theirs.feed(used, free, now=t + dt)
    assert ours.eta_s(now=t + at) == theirs.eta_s(now=t + at)


def test_peak_flops_env_override_and_gpu_table(monkeypatch):
    monkeypatch.delenv("BEE2BEE_PEAK_FLOPS", raising=False)
    assert intro.peak_flops_per_device("gpu", "NVIDIA H100 80GB HBM3") == 989e12
    assert intro.peak_flops_per_device("gpu", "Some Other Card") == (
        jintro.peak_flops_per_device("gpu", "Some Other Card"))
    assert intro.peak_flops_per_device("cpu") == jintro.peak_flops_per_device("cpu")
    monkeypatch.setenv("BEE2BEE_PEAK_FLOPS", "123e9")
    assert intro.peak_flops_per_device("gpu", "NVIDIA H100 80GB HBM3") == 123e9
    monkeypatch.setenv("BEE2BEE_PEAK_FLOPS", "not-a-number")
    assert intro.peak_flops_per_device("cpu") == 1e11


# --------------------------------------------------------- the sentinel


def test_sentinel_warmup_and_declared_growth_fire_nothing():
    rec = _Recorder()
    s = intro.RetraceSentinel(recorder=rec)
    s.register("unit_root", allowed=lambda key: key[0] in (4, 8))
    s.note_compile("unit_root", (4,), 0.1)   # boot warm-up
    s.note_compile("unit_root", (8,), 0.1)   # late declared growth
    assert s.snapshot()["unit_root"] == {"traces": 2, "storms": 0}
    assert not s.storming() and rec.incidents == []


def test_sentinel_undeclared_key_storms_immediately():
    rec = _Recorder()
    s = intro.RetraceSentinel(recorder=rec)
    s.register("unit_root", allowed=lambda key: key[0] == 4)
    s.note_compile("unit_root", (4,))
    s.note_compile("unit_root", (7,))        # UNDECLARED in steady state
    assert s.snapshot()["unit_root"]["storms"] == 1 and s.storming()
    assert [i["kind"] for i in rec.incidents] == ["engine:retrace_storm"]
    assert rec.incidents[0]["extra"]["root"] == "unit_root"
    assert "(7,)" in rec.incidents[0]["extra"]["key"]
    assert "UNDECLARED" in rec.incidents[0]["detail"]
    assert get_registry().get("engine.retrace_storms").value(root="unit_root") >= 1


def test_sentinel_repeat_key_storms_only_past_threshold():
    rec = _Recorder()
    s = intro.RetraceSentinel(recorder=rec, storm_window_s=60.0, storm_repeats=3)
    for _ in range(3):                       # first-seen, repeats 1 and 2
        s.note_compile("unit_root", ())
    assert s.snapshot()["unit_root"]["storms"] == 0
    s.note_compile("unit_root", ())          # repeat 3: storm
    assert s.snapshot()["unit_root"]["storms"] == 1
    assert [i["kind"] for i in rec.incidents] == ["engine:retrace_storm"]


def test_sentinel_distinct_key_repeats_do_not_storm():
    s = intro.RetraceSentinel(recorder=_Recorder(), storm_window_s=60.0, storm_repeats=3)
    for key in ("a", "b", "c", "a", "b", "c"):   # warm-up, then one re-warm each
        s.note_compile("unit_root", key)
    assert s.snapshot()["unit_root"]["storms"] == 0
    s.note_compile("unit_root", "a")
    s.note_compile("unit_root", "a")         # "a"'s third repeat: storm
    assert s.snapshot()["unit_root"]["storms"] == 1


def test_declared_batch_ladder_covers_non_pow2_shrink():
    jeng = JaxEngine("tiny-llama", engine_config=JaxEngineConfig(**ECFG, max_batch=6))
    try:
        assert intro.declared_batch_sizes(6) == jeng._declared_batch_sizes
        assert {1, 2, 3, 4, 6} <= intro.declared_batch_sizes(6)
    finally:
        jeng.close()


def test_decode_captures_book_as_compiles_of_the_decode_root(monkeypatch):
    """The scheduler's capture wrapper over a fake capture: each capture
    is one ``engine.compiles{root="decode"}`` with its seconds, equal to
    the decode root's captures; a key off the batch ladder or the pow2 widths
    storms at once; the eager roots stay at zero compiles."""
    eng = _engine(max_batch=4)
    sch = eng.scheduler
    rec = _Recorder()
    eng.introspect.sentinel._recorder = rec
    reg = get_registry()
    compiles, seconds = reg.get("engine.compiles"), reg.get("engine.compile_seconds")
    c0, s0 = compiles.value(root="decode"), seconds.value(root="decode")

    def fake_capture(key, root="decode"):
        rg = sch._root_stats(root)
        rg["captures"] += 1
        rg["capture_s"] += 0.25
        return port_scheduler.Graph(None, []), 0.25

    monkeypatch.setattr(sch, "_capture_locked", fake_capture)
    try:
        bpr = eng.blocks_per_row
        for key in ((1, 1, False, False, False, False), (2, 4, False, False, True, True),
                    (4, bpr, True, False, False, False)):
            sch._capture(key)
        snap = eng.introspect.sentinel.snapshot()
        decode = sch.stats.root_graphs["decode"]
        assert snap["decode"] == {"traces": decode["captures"], "storms": 0}
        assert compiles.value(root="decode") - c0 == decode["captures"] == 3
        assert seconds.value(root="decode") - s0 == pytest.approx(decode["capture_s"])
        assert snap["prefill"] == snap["cow_copy"] == {"traces": 0, "storms": 0}
        assert rec.incidents == []
        sch._capture((3, 4, False, False, False, False))  # bucket 3: not on the ladder
        sch._capture((2, 3, False, False, False, False))  # width 3: not pow2
        assert eng.introspect.sentinel.snapshot()["decode"]["storms"] == 2
        assert [i["kind"] for i in rec.incidents] == ["engine:retrace_storm"] * 2
    finally:
        eng.close()


def test_a_capture_waits_for_a_device_profile(tmp_path, monkeypatch):
    eng = _engine()
    sch = eng.scheduler
    ends: dict = {}

    def fake_capture(key, root="decode"):
        ends["capture"] = time.time()
        return port_scheduler.Graph(None, []), 0.0

    monkeypatch.setattr(sch, "_capture_locked", fake_capture)
    prof = intro.DeviceProfiler(tmp_path)
    started = threading.Event()

    def workload():
        started.set()
        time.sleep(0.01)

    spans = []
    real_stop = prof._stop

    def stop(p):
        # inside its window, which holds the capture lock (the spacing
        # between windows and the export do not)
        real_stop(p)
        spans.append((p.t0, time.time()))

    prof._stop = stop
    t = threading.Thread(target=prof.capture, args=(0.3, workload))
    t.start()
    try:
        assert started.wait(10.0)
        sch._capture((1, 1, False, False, False, False))
    finally:
        t.join(20.0)
        eng.close()
    assert not t.is_alive()
    # the capture waited for the window it met, and ran inside none
    assert ends["capture"] >= spans[0][1] - 0.05
    assert not any(a < ends["capture"] < b for a, b in spans)


def test_a_capture_inside_a_pass_waits_for_a_profile_without_deadlock(tmp_path,
                                                                     monkeypatch):
    eng = _engine()
    sch = eng.scheduler
    ends: dict = {}

    def fake_capture(key, root="decode"):
        ends["capture"] = time.time()
        return port_scheduler.Graph(None, []), 0.0

    monkeypatch.setattr(sch, "_capture_locked", fake_capture)
    prof = intro.DeviceProfiler(tmp_path)
    started = threading.Event()

    def workload():
        started.set()
        time.sleep(0.01)

    spans = []
    real_stop = prof._stop

    def stop(p):
        # inside its window, which holds the capture lock (the spacing
        # between windows and the export do not)
        real_stop(p)
        spans.append((p.t0, time.time()))

    prof._stop = stop
    t = threading.Thread(target=prof.capture, args=(0.3, workload))
    t.start()
    try:
        assert started.wait(10.0)
        # as the scheduler's loop captures: inside a pass, which the
        # profile's stop waits out
        with intro.device_gate.device_pass():
            sch._capture((1, 1, False, False, False, False))
    finally:
        t.join(20.0)
        eng.close()
    assert not t.is_alive()
    # the capture waited for the window it met, and ran inside none
    assert ends["capture"] >= spans[0][1] - 0.05
    assert not any(a < ends["capture"] < b for a, b in spans)


def test_profiler_starts_and_stops_between_passes(tmp_path):
    prof = intro.DeviceProfiler(tmp_path)
    times: dict = {}
    in_pass, release = threading.Event(), threading.Event()

    def one_pass():
        with intro.device_gate.device_pass():
            in_pass.set()
            release.wait(10.0)
            time.sleep(0.2)
            times["pass_end"] = time.monotonic()

    def workload():
        times.setdefault("window", time.monotonic())
        time.sleep(0.01)

    passer = threading.Thread(target=one_pass)
    passer.start()
    assert in_pass.wait(10.0)
    profiler = threading.Thread(target=prof.capture, args=(0.1, workload))
    profiler.start()
    release.set()
    passer.join(20.0)
    profiler.join(20.0)
    assert not passer.is_alive() and not profiler.is_alive()
    # the start waited for the pass in progress
    assert times["window"] >= times["pass_end"]
    # and a pass waits for a transition: a stop in progress holds it back
    order = []

    def later_pass():
        with intro.device_gate.device_pass():
            order.append("pass")

    with intro.device_gate.transition():
        t = threading.Thread(target=later_pass)
        t.start()
        time.sleep(0.1)
        order.append("transition")
    t.join(10.0)
    assert order == ["transition", "pass"]


def test_a_readback_wait_lets_a_transition_in(monkeypatch):
    """The scheduler waits for a decode window's readback outside its
    device pass: a profile's transition runs while the pass waits, and
    the pass resumes after it."""
    eng = _engine()
    sch = eng.scheduler
    order, waiting, done = [], threading.Event(), threading.Event()

    class Event:  # the window's readback event, still pending on the device
        def synchronize(self):
            order.append(("wait", intro.device_gate.inside()))
            waiting.set()
            assert done.wait(10.0)

    slot = sch._slots.popleft()  # as a dispatch takes it; the fetch returns it
    monkeypatch.setattr(slot, "event", Event())
    rec = {"slot": slot, "bsz": 1, "W": 1, "t0": time.perf_counter()}

    def fetch():
        with intro.device_gate.device_pass():
            sch._fetch_window(rec)
            order.append(("resumed", intro.device_gate.inside()))

    t = threading.Thread(target=fetch)
    try:
        t.start()
        assert waiting.wait(10.0)
        with intro.device_gate.transition():
            order.append(("transition", None))
            done.set()
            time.sleep(0.05)
        t.join(10.0)
    finally:
        done.set()
        eng.close()
    assert not t.is_alive()
    assert order == [("wait", False), ("transition", None), ("resumed", True)]


def test_a_chunk_lets_a_transition_in_between_replays(monkeypatch):
    """A root run of several steps (a decode chunk) steps out of its pass
    between two steps when a transition waits: the transition runs after
    the step in progress, before the next one."""
    eng = _engine()
    sch = eng.scheduler
    order, first, go_on = [], threading.Event(), threading.Event()

    def step(live):
        order.append("step")
        if len(order) == 1:
            first.set()
            assert go_on.wait(10.0)

    monkeypatch.setattr(sch, "_root", lambda root, key: (step, None, None, False))
    chunk = threading.Thread(target=sch._run_root,
                             args=("decode", (1, 1, False, False, False, False), 3))

    def transition():
        with intro.device_gate.transition():
            order.append("transition")

    other = threading.Thread(target=transition)
    try:
        chunk.start()
        assert first.wait(10.0)
        other.start()
        while not intro.device_gate._closed:  # the transition waits for the pass
            time.sleep(0.001)
        go_on.set()
        other.join(10.0)
        chunk.join(10.0)
    finally:
        go_on.set()
        eng.close()
    assert not chunk.is_alive() and not other.is_alive()
    assert order == ["step", "transition", "step", "step"]


def test_served_requests_finish_beside_profiles(tmp_path):
    eng = _engine()
    prof = intro.DeviceProfiler(tmp_path)
    try:
        alone = eng.generate("hello there", max_new_tokens=12, temperature=0.0)
        results, errors = [], []

        def serve():
            try:
                for _ in range(3):
                    results.append(eng.generate("hello there", max_new_tokens=12,
                                                temperature=0.0).token_ids)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        t = threading.Thread(target=serve)
        t.start()
        for _ in range(3):
            prof.capture(0.05)
        t.join(60.0)
        assert not t.is_alive() and not errors
        assert results == [alone.token_ids] * 3
        t = prof.last_timings
        assert set(t) == {"start_s", "stop_s", "stops_s", "export_s", "windows",
                          "window_stops_s", "window_recorded_s"}
        assert min(v for v in t.values() if not isinstance(v, list)) >= 0
        assert len(t["window_stops_s"]) == len(t["window_recorded_s"]) == t["windows"]
    finally:
        eng.close()


# ---------------------------------------------------------- the ledger


def test_hbm_ledger_components_sum_and_unregister_clears(monkeypatch):
    monkeypatch.delenv("BEE2BEE_HBM_BYTES", raising=False)
    ledger = intro.HbmLedger()
    w = torch.zeros(128, dtype=torch.float32)          # 512 B
    tied = {"embed": w, "lm_head": w.view(8, 16).t()}  # one storage, twice
    kv = {"k": torch.zeros(64, dtype=torch.int8), "scale": torch.zeros(4)}  # 64 + 16 B
    ledger.register("weights", lambda: tied)
    ledger.register("kv_pool", lambda: kv)
    snap = ledger.snapshot()
    assert snap["components"] == {"weights": 512, "kv_pool": 80}
    assert snap["accounted_bytes"] == 592
    assert "headroom_frac" not in snap
    g = get_registry().get("engine.hbm_bytes")
    assert g.value(component="weights") == 512

    monkeypatch.setenv("BEE2BEE_HBM_BYTES", "1024")
    snap = ledger.snapshot()
    assert snap["bytes_limit"] == 1024
    assert snap["headroom_frac"] == pytest.approx(1 - 592 / 1024, abs=1e-3)

    ledger.unregister("kv_pool")
    assert "kv_pool" not in ledger.snapshot()["components"]
    assert g.value(component="kv_pool") == 0


def test_hbm_ledger_device_stats_add_workspace_residual():
    ledger = intro.HbmLedger(mem_info=lambda: (3000, 4000))  # (free, total)
    ledger.register("weights", lambda: torch.zeros(100, dtype=torch.int8))
    snap = ledger.snapshot()
    assert snap["bytes_in_use"] == 1000 and snap["bytes_limit"] == 4000
    assert snap["components"]["workspace_other"] == 900
    assert snap["headroom_frac"] == pytest.approx(0.75)


@pytest.mark.parametrize("pool", ["float32", "int8"])
def test_engine_ledger_counts_the_weights_and_the_pool(pool):
    eng = _engine(cache_dtype=pool)
    try:
        eng.generate("ledger", max_new_tokens=2)
        comps = eng.introspect.ledger.snapshot()["components"]
        storages = {}
        stack = [eng.params]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node.values())
            elif isinstance(node, list):
                stack.extend(node)
            else:
                storages[node.untyped_storage().data_ptr()] = node.untyped_storage().nbytes()
        assert comps["weights"] == sum(storages.values())
        assert comps["kv_pool"] == sum(t.numel() * t.element_size()
                                       for t in eng.scheduler._cache.values())
    finally:
        eng.close()


# -------------------------------------------------------- the profiler


def test_device_profiler_capture_and_listing(tmp_path):
    prof = intro.DeviceProfiler(profile_dir=tmp_path)
    header = prof.capture(duration_s=0.05, workload=lambda: torch.ones(64) @ torch.ones(64))
    assert header["id"].startswith("prof-") and header["bytes"] > 0
    assert [p["id"] for p in prof.list_profiles()] == [header["id"]]
    zf = zipfile.ZipFile(io.BytesIO(prof.profile_path(header["id"]).read_bytes()))
    assert zf.namelist() == ["trace.json"]
    assert "traceEvents" in zf.read("trace.json").decode()
    assert prof.profile_path("prof-nope") is None and prof.active is None


def test_device_profiler_runs_the_repaired_capture(tmp_path, monkeypatch):
    """The pause repair's choices: CPU and device activity without
    external correlation, windows of 0.05 s 0.25 s apart, each stopped
    by the C++ disable alone, one forked child writing and zipping the
    trace after ``graph_capture_lock`` is released (captures run beside
    the export). A 0.65 s capture in 0.2 s windows records windows until
    0.65 s, joined into one ``trace.json`` whose events span them; the
    route's zip layout is unchanged, also where ``os.fork`` is missing."""
    import os

    assert (intro.DeviceProfiler.WINDOW_S, intro.DeviceProfiler.SPACING_S) == (0.05, 0.25)
    window = intro.DeviceProfiler._profiler()
    assert set(window.activities) == {torch.profiler.ProfilerActivity.CPU}
    assert not (window.record_shapes or window.profile_memory or window.with_stack)
    exp = torch._C._profiler._ExperimentalConfig
    assert (window.experimental_config.__getstate__()
            == exp(disable_external_correlation=True).__getstate__()
            != exp().__getstate__())
    forks = []
    fork = os.fork
    monkeypatch.setattr(
        os, "fork", lambda: forks.append(intro.graph_capture_lock.locked()) or fork())
    monkeypatch.setattr(intro.DeviceProfiler, "WINDOW_S", 0.2)
    prof = intro.DeviceProfiler(profile_dir=tmp_path)
    header = prof.capture(duration_s=0.65, workload=lambda: torch.ones(64) @ torch.ones(64))
    t = prof.last_timings
    recorded = t["window_recorded_s"]
    # windows of 0.2 s (a stop may start a little late) until 0.65 s
    # recorded; one fork, made with the capture lock free
    assert forks == [False] and t["windows"] == len(recorded) >= 3
    assert all(r >= 0.2 - 1e-3 for r in recorded[:-1])
    assert sum(recorded[:-1]) < 0.65 <= sum(recorded) + 1e-3
    assert header["duration_s"] == pytest.approx(sum(recorded), abs=0.01)
    zf = zipfile.ZipFile(io.BytesIO(prof.profile_path(header["id"]).read_bytes()))
    assert zf.namelist() == ["trace.json"]
    ts = sorted(ev["ts"] for ev in json.loads(zf.read("trace.json"))["traceEvents"]
                if ev.get("name", "").startswith("aten::matmul"))
    # matmuls from every window: they span the windows and the stops between
    assert ts and (ts[-1] - ts[0]) / 1e6 >= 0.6 - 0.2
    monkeypatch.delattr(os, "fork")
    header = prof.capture(duration_s=0.05)
    zf = zipfile.ZipFile(io.BytesIO(prof.profile_path(header["id"]).read_bytes()))
    assert zf.namelist() == ["trace.json"] and len(forks) == 1


def test_device_profiler_refuses_concurrent_capture(tmp_path):
    prof = intro.DeviceProfiler(profile_dir=tmp_path)
    started = threading.Event()

    def workload():
        started.set()
        time.sleep(0.01)

    t = threading.Thread(target=prof.capture,
                         kwargs={"duration_s": 0.3, "workload": workload})
    t.start()
    try:
        assert started.wait(10.0)
        with pytest.raises(intro.ProfileInProgress):
            prof.capture(duration_s=0.05)
    finally:
        t.join(20.0)
    assert not t.is_alive()
    prof.capture(duration_s=0.05)


# ---------------------------------------------------- engine and fleet


def test_engine_generation_rides_digest_and_info():
    eng = _engine()
    try:
        eng.generate("ride the digest", max_new_tokens=4)
        intro_digest = health.build_digest().get("introspect")
        assert intro_digest, "digest missing the introspect block"
        assert set(intro_digest["compiles"]) >= {"prefill", "decode", "cow_copy"}
        assert intro_digest.get("goodput_tokens_per_s", 0) > 0
        assert intro_digest.get("mfu") is not None and intro_digest["storming"] is False
        info = eng.info["introspect"]
        assert info["platform"] == "cpu" and info["peak_flops"] == 1e11
        assert 0.0 < info["goodput"]["goodput_fraction"] <= 1.0
        assert set(info["hbm"]["components"]) == {"weights", "kv_pool"}
    finally:
        eng.close()


def test_engine_close_clears_economics_gauges():
    eng = _engine()
    eng.generate("then close", max_new_tokens=4)
    eng.introspect.refresh()
    reg = get_registry()
    assert reg.get("engine.hbm_bytes").series()
    eng.close()
    for name in ("engine.mfu", "engine.goodput_tokens_per_s", "engine.hbm_bytes",
                 "engine.pool_exhaust_eta_s", "engine.overlap_inflight"):
        assert not reg.get(name).series(), name
    assert not eng.introspect.ledger._sources


def _cuda_peer_digest(headroom_free: float, storm: bool) -> dict:
    """A port engine's real digest block, its ledger reading a card with
    ``headroom_free`` of its memory free, after a decode-root capture of
    an undeclared key when ``storm``."""
    eng = _engine()
    try:
        total = 80 * 2**30
        eng.introspect.ledger._mem_info = lambda: (int(total * headroom_free), total)
        eng.generate("fleet economics", max_new_tokens=4)
        if storm:
            eng.introspect.sentinel._recorder = _Recorder()
            eng.introspect.sentinel.note_compile("decode", (3, 3, False, False, False, False))
        return health.build_digest()
    finally:
        eng.close()


def test_fleet_view_aggregates_a_cuda_peers_economics():
    store = health.HealthStore(ttl_s=60.0)
    fast, squeezed = _cuda_peer_digest(0.5, False), _cuda_peer_digest(0.01, True)
    store.update("peer-fast", fast)
    store.update("peer-squeezed", squeezed)
    agg = health.fleet_view("me", {}, store)["aggregate"]
    fi, si = fast["introspect"], squeezed["introspect"]
    assert agg["goodput_tokens_per_s_total"] == pytest.approx(
        fi["goodput_tokens_per_s"] + si["goodput_tokens_per_s"], rel=1e-3)
    assert agg["hbm_headroom_frac_min"] == pytest.approx(0.01, abs=1e-3)
    assert agg["hbm_headroom_min_peer"] == "peer-squeezed"
    assert agg["retrace_storming_peers"] == ["peer-squeezed"]
    prom = health.render_fleet_prom(health.fleet_view("me", {}, store))
    assert 'bee2bee_mesh_peer_retrace_storming{peer="peer-squeezed"} 1' in prom


def test_router_penalizes_squeezed_and_storming_cuda_peers():
    pol = RouterPolicy(RouterWeights())

    def score(digest):
        return pol.score({"local": True}, digest, rtt_ms=None, max_price=0.0,
                         prompt_hashes=[])

    s_ok, b_ok = score(_cuda_peer_digest(0.5, False))
    s_bad, b_bad = score(_cuda_peer_digest(0.01, True))
    assert b_bad["storming"] is True and b_ok["storming"] is False
    assert b_bad["hbm"] > b_ok["hbm"]
    assert s_bad > s_ok  # a penalty: lower wins


def test_admission_reads_the_forecast_gauge():
    f = intro.PoolForecast()
    f.feed(0, 100, now=time.time() - 5.0)
    f.feed(50, 50, now=time.time())
    assert pool_exhaust_eta() == pytest.approx(f.eta_s(), rel=1e-2)
    intro._G_POOL_ETA.clear()
    assert pool_exhaust_eta() is None


# ------------------------------------------------------- the growth gate


def test_growth_gate_denies_a_wider_bucket_at_one_percent_headroom():
    prompts = ["first row decodes", "second row waits for it"]
    eng = _engine(max_batch=2)
    try:
        alone = [eng.generate(p, max_new_tokens=12, temperature=0.0).token_ids
                 for p in prompts]
        sch = eng.scheduler
        sch._sticky_idle_s = 0.0  # the bucket drops back to 1 when idle
        total = 80 * 2**30
        eng.introspect.ledger._mem_info = lambda: (total // 100, total)
        assert not sch._growth_headroom()
        reqs = [eng._make_request(p, 12, 0.0, 0, 1.0, None) for p in prompts]
        with sch._cond:
            for r in reqs:
                sch.submit(r)
        got = []
        for r in reqs:
            while True:
                ev = r.events.get(timeout=60)
                if ev.get("done"):
                    got.append(ev["result"].token_ids)
                    break
        assert sch.stats.width_grow_denials >= 1
        assert sch.stats.peak_active == 1 and got == alone
        eng.introspect.ledger._mem_info = lambda: (total // 2, total)
        assert sch._growth_headroom()
    finally:
        eng.close()
