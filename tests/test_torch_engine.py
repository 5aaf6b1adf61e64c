"""The PyTorch port's serving slice as a whole, against the JAX package.

- The port's InferenceEngine("tiny-llama", device="cpu", dtype float32),
  given the JAX engine's parameters, serves 4 concurrent prompts of
  different lengths (plus a greedy repetition-penalised one) with the
  same greedy token ids as the JAX engine on its dense attention —
  ``max_new_tokens`` crossing block boundaries, whole-prompt buckets and
  chunked prefill alike.
- CUDAService(device="cpu") answers execute / execute_stream with the
  same keys as TPUService.
- Entry points default to the card and raise without one.
- The port's own copies (paged allocator, chunk walk, tokenizer, stop
  scrubbing, metric names) behave like the originals.
- Import hygiene: the package and chip_smoke.py never import jax or
  bee2bee_tpu.
"""

from __future__ import annotations

import ast
import json
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
from bee2bee_tpu.services import base as jbase
from bee2bee_tpu.services.tpu import TPUService
from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
from bee2bee_tpu_torch.engine import paged, tokenizer
from bee2bee_tpu_torch.models.config import get_config
from bee2bee_tpu_torch.models.params import params_from_numpy
from bee2bee_tpu_torch.services import base
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


def _port_engine(jax_engine, **extra):
    cfg = get_config("tiny-llama")
    params = params_from_numpy(
        jax.device_get(jax_engine.params), cfg, "cpu", torch.float32
    )
    return InferenceEngine(
        "tiny-llama", params=params, device="cpu",
        engine_config=EngineConfig(kv_block_size=16, **KW, **extra),
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
    ("spec_tokens", 4), ("drafter", "tiny-llama"), ("max_adapters", 2),
    ("quantize", "int8"), ("cache_dtype", "int8"), ("prefix_cache_entries", 4),
    ("attention", "sp"), ("attention", "dense"),
])
def test_unported_engine_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        EngineConfig(**{field: value})


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
    """The port registers the serving metrics under the JAX names."""
    from bee2bee_tpu.metrics import get_registry as jax_registry
    from bee2bee_tpu_torch.metrics import get_registry

    ours = set(get_registry().snapshot())
    assert ours and ours <= set(jax_registry().snapshot())


def _port_sources():
    return sorted((ROOT / "bee2bee_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
