"""The PyTorch port's serving slice as a whole, against the JAX package.

- The port's InferenceEngine("tiny-llama", device="cpu", dtype float32),
  given the JAX engine's parameters, serves 4 concurrent prompts of
  different lengths (plus a greedy repetition-penalised one) with the
  same greedy token ids as the JAX engine on its dense attention —
  ``max_new_tokens`` crossing block boundaries, whole-prompt buckets and
  chunked prefill alike.
- The same over an int8 KV pool (``cache_dtype="int8"``) against the JAX
  engine's int8 pool: greedy tokens equal on every job, and a recycled
  block starts from a zeroed scale (a prompt repeated after pool churn
  decodes the same tokens).
- CUDAService(device="cpu") answers execute / execute_stream with the
  same keys as TPUService.
- Entry points default to the card and raise without one.
- The port's own copies (paged allocator, chunk walk, tokenizer, stop
  scrubbing, metric names) behave like the originals.
- Import hygiene: the package and chip_smoke.py never import jax or
  bee2bee_tpu.
- On a CUDA device the engine refuses by name what its kernels cannot run
  (float16, a pool type other than the query's or int8, a head_dim or
  block size no kernel is built for); the CPU runs it.
- The scheduler's WDRR tenant queue pops in the JAX queue's order on the
  same sequence (weights 4:1:1, mixed costs, a burst, a weight change, a
  requeue and a refund), takes its weights from the same tenant config,
  and stays FIFO with no tenants configured.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from bee2bee_tpu.engine import EngineConfig as JaxEngineConfig
from bee2bee_tpu.engine import InferenceEngine as JaxEngine
from bee2bee_tpu.engine import paged as jpaged
from bee2bee_tpu.engine import tokenizer as jtokenizer
from bee2bee_tpu.router import tenants as jtenants
from bee2bee_tpu.router.fairness import WdrrQueue as JaxWdrrQueue
from bee2bee_tpu.services import base as jbase
from bee2bee_tpu.services.tpu import TPUService
from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
from bee2bee_tpu_torch.engine import paged, scheduler, tokenizer
from bee2bee_tpu_torch.engine.engine import check_card_supported
from bee2bee_tpu_torch.models.config import get_config
from bee2bee_tpu_torch.models.params import params_from_numpy
from bee2bee_tpu_torch.services import base
from bee2bee_tpu_torch.router import tenants
from bee2bee_tpu_torch.router.fairness import WdrrQueue
from bee2bee_tpu_torch.services.cuda import CUDAService

ROOT = Path(__file__).resolve().parent.parent
KW = dict(max_seq_len=128, dtype="float32", cache_dtype="float32",
          decode_chunk=4, prefill_buckets=(16, 32, 64), max_batch=4)
_RNG = np.random.default_rng(11)
# prompt lengths across buckets; budgets cross 16-token block boundaries
JOBS = [
    (list(map(int, _RNG.integers(3, 500, size=n))), m, pen)
    for n, m, pen in ((5, 21, 1.0), (17, 13, 1.0), (30, 40, 1.0), (50, 9, 1.0),
                      (12, 19, 1.3))
]


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX engine (dense attention, f32) and its greedy token ids."""
    eng = JaxEngine("tiny-llama", engine_config=JaxEngineConfig(
        kv_block_size=16, **KW))
    want = [
        eng.generate(p, max_new_tokens=m, temperature=0.0,
                     repetition_penalty=pen).token_ids
        for p, m, pen in JOBS
    ]
    yield eng, want
    eng.close()


@pytest.fixture(scope="module")
def jax_int8_reference():
    """The JAX engine over an int8 KV pool and its greedy token ids."""
    eng = JaxEngine("tiny-llama", engine_config=JaxEngineConfig(
        kv_block_size=16, **dict(KW, cache_dtype="int8")))
    want = [
        eng.generate(p, max_new_tokens=m, temperature=0.0,
                     repetition_penalty=pen).token_ids
        for p, m, pen in JOBS
    ]
    yield eng, want
    eng.close()


def _port_engine(jax_engine, **extra):
    cfg = get_config("tiny-llama")
    params = params_from_numpy(
        jax.device_get(jax_engine.params), cfg, "cpu", torch.float32
    )
    return InferenceEngine(
        "tiny-llama", params=params, device="cpu",
        engine_config=EngineConfig(kv_block_size=16, **dict(KW, **extra)),
    )


@pytest.mark.parametrize("prefill_chunk", [None, 16], ids=["buckets", "chunked"])
def test_concurrent_greedy_parity_with_jax_engine(jax_reference, prefill_chunk):
    jax_engine, want = jax_reference
    eng = _port_engine(jax_engine, prefill_chunk=prefill_chunk)
    try:
        got: list = [None] * len(JOBS)

        def run(i):
            p, m, pen = JOBS[i]
            got[i] = eng.generate(p, max_new_tokens=m, temperature=0.0,
                                  repetition_penalty=pen)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(JOBS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for i, r in enumerate(got):
            assert r.token_ids == want[i], f"request {i} diverged"
        st = eng.scheduler.stats
        assert st.peak_active >= 2, "requests never shared a batch"
        assert st.retired == len(JOBS) and st.paged_blocks_in_use == 0
        assert eng.forward_calls > 0
    finally:
        eng.close()


def test_int8_pool_greedy_parity_with_jax_engine(jax_int8_reference):
    jax_engine, want = jax_int8_reference
    eng = _port_engine(jax_engine, cache_dtype="int8")
    try:
        assert eng.kv_quantized and eng.kv_info["cache_dtype"] == "int8"
        assert eng.kv_info == jax_engine.kv_info
        got: list = [None] * len(JOBS)

        def run(i):
            p, m, pen = JOBS[i]
            got[i] = eng.generate(p, max_new_tokens=m, temperature=0.0,
                                  repetition_penalty=pen)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(JOBS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for i, r in enumerate(got):
            assert r.token_ids == want[i], f"request {i} diverged"
        pool = eng.scheduler._cache
        assert pool["k"].dtype == torch.int8 and pool["k_scale"].dtype == torch.float32
    finally:
        eng.close()


def test_int8_pool_block_recycling_starts_from_a_zeroed_scale(jax_int8_reference):
    """Prompt A, then louder churn that reuses A's freed blocks, then A
    again: the same tokens, because every allocation zeroes the fresh
    blocks' scales (the quantize-on-write running max would otherwise
    inherit the churn's amax)."""
    eng = _port_engine(jax_int8_reference[0], cache_dtype="int8")
    try:
        prompt, churn = JOBS[2][0], JOBS[3][0]
        a = eng.generate(prompt, max_new_tokens=10, temperature=0.0).token_ids
        sch = eng.scheduler
        used = np.flatnonzero(sch._cache["k_scale"][0, 0].numpy())
        assert len(used) > 1  # A's blocks (and the null block) hold scales
        eng.generate(churn, max_new_tokens=20, temperature=0.0)
        b = eng.generate(prompt, max_new_tokens=10, temperature=0.0).token_ids
        assert a == b
        # the funnel itself: blocks handed out again carry no old scale
        held = sch._cache["k_scale"][0, 0].clone()
        fresh = sch._alloc_blocks(3)
        assert held[fresh].all()  # each block held an earlier tenant's scale
        for key in ("k_scale", "v_scale"):
            assert not sch._cache[key][:, :, fresh].any()
        sch._alloc.deref(fresh)
    finally:
        eng.close()


def test_sampled_and_streamed_requests_finish(jax_reference):
    """Sampled (temperature/top-p/min-p) and streamed requests run to their
    budget; the stream's token events add up to the result."""
    eng = _port_engine(jax_reference[0])
    try:
        r = eng.generate(JOBS[1][0], max_new_tokens=11, temperature=0.9,
                         top_p=0.8, min_p=0.05)
        assert r.new_tokens == 11 and r.finish_reason == "length"
        events = list(eng.generate_stream(JOBS[0][0], max_new_tokens=10))
        assert events[-1]["done"]
        streamed = [t for ev in events[:-1] for t in ev["tokens"]]
        assert streamed == events[-1]["result"].token_ids
    finally:
        eng.close()


def test_cuda_service_on_cpu_matches_tpu_service_keys(jax_reference):
    jax_engine, _ = jax_reference
    port = CUDAService("tiny-llama", max_new_tokens=8, engine=_port_engine(jax_engine),
                       device="cpu")
    ref = TPUService("tiny-llama", max_new_tokens=8, engine=jax_engine)
    try:
        params = {"prompt": "user: hi\nassistant: hello", "temperature": 0.0}
        got, want = port.execute(params), ref.execute(params)
        assert set(got) == set(want)
        assert set(got["timing"]) == set(want["timing"])
        stops = dict(params, stop=["zz"])
        assert set(port.execute(stops)) == set(ref.execute(stops))
        got_lines = [json.loads(s) for s in port.execute_stream(params)]
        want_lines = [json.loads(s) for s in ref.execute_stream(params)]
        assert set(got_lines[-1]) == set(want_lines[-1]) >= {"done", "tokens", "cost"}
        meta = port.get_metadata()
        assert meta["backend"] == "cuda" and meta["engine"]["platform"] == "cpu"
        assert set(meta) == set(ref.get_metadata()) - {"adapters"}
    finally:
        port.engine.close()


def test_entry_points_default_to_the_card():
    """device=None means CUDA: without a card both entry points raise
    instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        assert CUDAService("tiny-llama").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine("tiny-llama")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CUDAService("tiny-llama")


@pytest.mark.parametrize("field,value", [
    ("attention", "sp"), ("attention", "dense"),
])
def test_unported_engine_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        EngineConfig(**{field: value})


@pytest.mark.parametrize("drafter,tiers", [
    ("", ["ngram"]), ("tiny-llama", ["ngram", "model"]),
])
def test_spec_engine_fields_build_the_drafter_stack(drafter, tiers):
    """spec_tokens (and a model drafter) configure the engine: the
    scheduler's drafter stack has the tiers, a greedy request is offered
    to them and keeps the spec-off engine's tokens; once the n-gram tier
    fails its probe (8 tokens: two misses), the same-seed model drafter
    (weight-identical) has every draft accepted."""
    kw = dict(max_seq_len=64, dtype="float32", cache_dtype="float32", decode_chunk=4,
              prefill_buckets=(16, 32), max_batch=2)
    prompt = [5, 6, 7, 8, 9] * 3
    off = InferenceEngine("tiny-llama", device="cpu", engine_config=EngineConfig(**kw))
    eng = InferenceEngine("tiny-llama", device="cpu", engine_config=EngineConfig(
        **kw, spec_tokens=4, spec_probe_tokens=8, drafter=drafter))
    try:
        assert list(eng.scheduler._spec.tiers) == tiers
        assert (eng.drafter_model is not None) == bool(drafter)
        ngram = eng.scheduler._spec.tiers["ngram"]
        offered = []
        propose = ngram.propose_batch
        ngram.propose_batch = lambda rows: offered.append(len(rows)) or propose(rows)
        want = off.generate(prompt, max_new_tokens=24, temperature=0.0).token_ids
        got = eng.generate(prompt, max_new_tokens=24, temperature=0.0).token_ids
        assert got == want and offered
        if drafter:
            st = eng.scheduler.stats
            assert st.spec_steps > 0
            assert st.spec_tiers["model"]["accepted"] == st.spec_tiers["model"]["drafted"] > 0
    finally:
        off.close()
        eng.close()


@pytest.mark.parametrize("n,start,bucket,S", [
    (5, 0, 16, 128), (50, 0, 16, 128), (120, 0, 64, 128), (127, 3, 32, 128),
])
def test_prefill_chunk_positions_copy(n, start, bucket, S):
    assert paged.prefill_chunk_positions(n, start, bucket, S) == (
        jpaged.prefill_chunk_positions(n, start, bucket, S)
    )


def test_block_allocator_copy_behaves_like_the_original():
    ours, theirs = paged.BlockAllocator(9), jpaged.BlockAllocator(9)
    for op, arg in [("alloc", 3), ("alloc", 2), ("ref", [1]), ("deref", [1, 2]),
                    ("alloc", 4), ("alloc", 1), ("deref", [1, 4, 5])]:
        assert getattr(ours, op)(arg) == getattr(theirs, op)(arg)
        assert (ours.free_count, ours.used_count, ours.hwm) == (
            theirs.free_count, theirs.used_count, theirs.hwm)
    assert paged.pow2_at_least(5) == jpaged.pow2_at_least(5) == 8


def test_tokenizer_copy_round_trips_like_the_original():
    text = "héllo, wörld — 12"
    for vocab in (512, 128256):
        ours, theirs = tokenizer.ByteTokenizer(vocab), jtokenizer.ByteTokenizer(vocab)
        assert ours.encode(text) == theirs.encode(text)
        assert ours.decode(ours.encode(text)) == theirs.decode(theirs.encode(text))
    assert isinstance(tokenizer.load_tokenizer(None, 512), tokenizer.ByteTokenizer)


@pytest.mark.parametrize("text,stops", [
    ("answer\nuser: more", ()), ("abc STOP def", ("STOP",)), ("user: hi", ()),
    ("x" * 20 + "assistant: y", ("q",)),
])
def test_stop_scrubbing_copy(text, stops):
    assert base.scrub_stop_words(text, stops) == jbase.scrub_stop_words(text, stops)
    assert base.normalize_stops(list(stops)) == jbase.normalize_stops(list(stops))
    for cut in range(len(text) + 1):
        assert base.scrub_stream_delta(text[:cut], 0, stops) == (
            jbase.scrub_stream_delta(text[:cut], 0, stops)
        )
    assert base.parse_transcript(text) == jbase.parse_transcript(text)


def test_metric_names_match_the_jax_registry(jax_reference):
    """Every metric the port registers, in any of its modules, carries a
    name the JAX package registers: each port module is imported beside
    its JAX counterpart, where there is one."""
    import importlib
    import importlib.util

    from bee2bee_tpu.metrics import get_registry as jax_registry
    from bee2bee_tpu_torch.metrics import get_registry

    for path in sorted((ROOT / "bee2bee_tpu_torch").rglob("*.py")):
        name = ".".join(path.relative_to(ROOT).with_suffix("").parts)
        name = name.removesuffix(".__init__")
        importlib.import_module(name)
        counterpart = "bee2bee_tpu" + name.removeprefix("bee2bee_tpu_torch")
        if importlib.util.find_spec(counterpart) is not None:
            importlib.import_module(counterpart)

    ours = set(get_registry().snapshot())
    assert ours and ours <= set(jax_registry().snapshot())


def _port_sources():
    return sorted((ROOT / "bee2bee_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "decode_probe.py", ROOT / "decode_f32_probe.py",
        ROOT / "hotloop_probe.py", ROOT / "profile_probe.py", ROOT / "moe_probe.py"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "bee2bee_tpu"), (
                    f"{path.relative_to(ROOT)} imports {name}"
                )


def test_importing_the_package_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "bee2bee_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'bee2bee_tpu'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ------------------------------------------- what the card's kernels refuse


@pytest.mark.parametrize("model,over,names", [
    ("phi-2", {}, ["head_dim 80"]),
    ("tiny-llama", {}, ["head_dim 16"]),
    ("llama-3-8b", dict(dtype="float16", cache_dtype="float16"), ["dtype='float16'"]),
    ("llama-3-8b", dict(cache_dtype="float32"),
     ["cache_dtype='float32' beside dtype='bfloat16'"]),
    ("llama-3-8b", dict(kv_block_size=12), ["kv_block_size=12"]),
    ("tiny-llama", dict(dtype="float16", cache_dtype="bfloat16"),
     ["dtype='float16'", "cache_dtype='bfloat16'", "head_dim 16"]),
], ids=["phi2_hd80", "tiny_hd16", "float16", "cache_mismatch", "block_size", "all"])
def test_card_refuses_what_its_kernels_cannot_run(model, over, names):
    """On a CUDA device the check names every setting no kernel takes, at
    engine build rather than at the first forward; on the CPU, which runs
    the plain versions, it refuses nothing."""
    cfg, ecfg = get_config(model), EngineConfig(**over)
    with pytest.raises(NotImplementedError) as err:
        check_card_supported(cfg, ecfg, "cuda")
    for name in names:
        assert name in str(err.value)
    check_card_supported(cfg, ecfg, "cpu")
    check_card_supported(cfg, ecfg, torch.device("cpu"))


@pytest.mark.parametrize("model,over", [
    ("llama-3-8b", {}), ("llama-3-8b", dict(cache_dtype="int8")),
    ("llama-3-8b", dict(dtype="float32", cache_dtype="float32")),
    ("llama-3-8b", dict(dtype="float32", cache_dtype="int8", kv_block_size=32)),
    ("mistral-7b", dict(kv_block_size=8)),
    ("phi-3-mini", {}), ("phi-3-mini", dict(cache_dtype="int8")),
    ("phi-3-mini", dict(dtype="float32", cache_dtype="float32")),
], ids=["bf16", "int8_pool", "f32", "f32_int8_pool_bs32", "mistral_bs8", "phi3_bf16",
        "phi3_int8_pool", "phi3_f32"])
def test_card_accepts_what_its_kernels_run(model, over):
    check_card_supported(get_config(model), EngineConfig(**over), "cuda")


def test_float16_engine_still_runs_on_the_cpu():
    """A config the card refuses builds and serves on the CPU."""
    eng = InferenceEngine("tiny-llama", device="cpu", engine_config=EngineConfig(
        dtype="float16", cache_dtype="float16", max_seq_len=64, max_batch=2,
        decode_chunk=4, prefill_buckets=(16,)))
    try:
        r = eng.generate([5, 9, 11], max_new_tokens=3, temperature=0.0)
        assert len(r.token_ids) == 3
    finally:
        eng.close()


# ------------------------------------------------- the WDRR tenant queue


def _wdrr_order(queue):
    """Pop order of one scripted sequence: three tenants at weights 4:1:1
    with mixed costs, then a burst from one tenant, then a weight change,
    a front requeue (the retry refunds its charge) and a refund. Items are
    "tenant:submit number:cost"."""
    order, pushed = [], [0]

    def push(tenant, costs):
        for c in costs:
            queue.append(f"{tenant}:{pushed[0]}:{c}", tenant=tenant, cost=c)
            pushed[0] += 1

    def pop(n):
        for _ in range(min(n, len(queue))):
            order.append(queue.popleft())

    push("acme", [32, 128, 64, 16, 256, 64, 500])
    push("hobby", [64, 64, 300, 8])
    push("edu", [100, 20, 20, 200, 1])
    pop(6)
    push("hobby", [32] * 8)  # one tenant's burst
    pop(7)
    queue.set_weights({"acme": 1, "hobby": 1, "edu": 4})
    retry = queue.popleft()
    tenant, _, cost = retry.split(":")
    queue.appendleft(retry, tenant=tenant, cost=int(cost))
    queue.refund("edu", 50)
    pop(4)
    push("acme", [8, 8, 8])
    pop(len(queue))
    return order


def test_wdrr_queue_pops_like_the_jax_queue(monkeypatch):
    """The same sequence through the JAX WdrrQueue and the port's queue as
    the scheduler builds it (weights from the same BEE2BEE_TENANTS config)
    pops every item once, in the same order, and not in FIFO order."""
    monkeypatch.setenv("BEE2BEE_TENANTS", json.dumps({
        "acme": {"api_key": "k-acme", "weight": 4},
        "hobby": {"weight": 1}, "edu": {"weight": 1, "rate_tokens_per_min": 60},
    }))
    jweights = {n: s.weight for n, s in jtenants.load_tenant_config().items()}
    assert jweights == {"acme": 4.0, "hobby": 1.0, "edu": 1.0}
    want = _wdrr_order(JaxWdrrQueue(weights=jweights))
    queue = scheduler.tenant_queue()
    assert isinstance(queue, WdrrQueue) and queue.weight("acme") == 4.0
    got = _wdrr_order(queue)
    assert got == want
    assert sorted(got, key=lambda x: int(x.split(":")[1])) != got
    assert len(set(got)) == len(got) == 7 + 4 + 5 + 8 + 3
    # the comparison is not blind to the queue's parameters: another
    # quantum reorders the JAX queue's pops
    assert _wdrr_order(JaxWdrrQueue(weights=jweights, quantum=64)) != want


@pytest.mark.parametrize("config", [
    {"acme": {"weight": 4, "api_key": "k1"}, "hobby": {"adapter": "lora-x"}},
    {"bad": {"weight": 0}},
    {"bad": {"surprise": 1}},
    {"a": {"api_key": "k"}, "b": {"api_key": "k"}},
    {"bad": {"adapter": "a:b"}},
    [1, 2],
], ids=["valid", "zero_weight", "unknown_key", "reused_key", "bad_adapter", "not_object"])
def test_tenant_config_parses_like_the_jax_config(config):
    try:
        want = {k: dataclasses.asdict(v)
                for k, v in jtenants.parse_tenant_config(config).items()}
    except ValueError as err:
        with pytest.raises(ValueError, match=re.escape(str(err))):
            tenants.parse_tenant_config(config)
        return
    got = {k: dataclasses.asdict(v) for k, v in tenants.parse_tenant_config(config).items()}
    assert got == want


def _request(max_new_tokens, tenant="default"):
    return scheduler.Request([1, 2], max_new_tokens, 0.0, 0, 1.0, set(), None, None,
                             tenant=tenant)


def test_scheduler_queue_is_fifo_without_tenants(monkeypatch):
    """With no tenants configured the scheduler's submit path (cost: the
    token budget) keeps pure FIFO order whatever the budgets."""
    monkeypatch.delenv("BEE2BEE_TENANTS", raising=False)
    sched = type("Stub", (), {})()
    sched._cond, sched._shutdown = threading.Condition(), False
    sched._queue = scheduler.tenant_queue()
    reqs = [_request(m) for m in (500, 1, 64, 3000, 7, 64, 2)]
    for r in reqs:
        scheduler.BatchScheduler.submit(sched, r)
    assert [sched._queue.popleft() for _ in reqs] == reqs


def test_scheduler_set_tenant_weights_reorders_admission(monkeypatch):
    """Weights pushed through set_tenant_weights decide the submit queue's
    order: a 4:1 tenant pair drains about 4:1 in tokens."""
    monkeypatch.delenv("BEE2BEE_TENANTS", raising=False)
    sched = type("Stub", (), {})()
    sched._cond, sched._shutdown = threading.Condition(), False
    sched._queue = scheduler.tenant_queue()
    scheduler.BatchScheduler.set_tenant_weights(sched, {"acme": 4, "hobby": 1})
    for i in range(10):
        scheduler.BatchScheduler.submit(sched, _request(256, "hobby"))
        scheduler.BatchScheduler.submit(sched, _request(256, "acme"))
    first = [sched._queue.popleft().tenant for _ in range(10)]
    assert first.count("acme") == 8 and first.count("hobby") == 2
