"""Live generation migration in the PyTorch port, against the JAX package.

The port's engine half of migration (``BatchScheduler.checkpoint``,
``InferenceEngine.migration_signature`` / ``import_generation``), its
node half (``meshnet/migrate.py``, ``meshnet/chaos.py``) and the wire
between the two packages, on the CPU at tiny-llama size, f32 compute,
every engine on the JAX engine's weights (``params_from_numpy``):

- Port counterparts of ``tests/test_migration.py``, each held to the JAX
  engine's unmigrated greedy rollout: the KV round trip with zero
  re-prefill, the re-prefill rung, a penalised row's rebuilt counts, a
  queued request's metadata-only snapshot, a finished request's None, the
  CoW prefix refcounts on both pools, the int8 round trip and its
  signature gate, a typed import on an exhausted pool, the validation
  refusals (the JAX engine's texts, case by case), the three-node drain,
  the chaos faults (corrupt page, corrupt scale, target pool exhausted,
  link killed mid-stream, every rung dead), the disagg handoff landing
  only on the decode peer, and pool exhaustion mid-decode migrating.
- Across the packages: a JAX engine's snapshot imported by the port
  engine and the reverse (through the two wire codecs) over bf16, f32 and
  int8 pools, token for token; equal signatures; equal chunk hashes from
  both exporters on the same blocks; JAX and port nodes on one loopback
  mesh draining live streams onto each other (bf16 and f32 pools); and
  the known design difference: a JAX f32 engine's bf16 pool reaches a
  port f32 engine's f32 pool by the re-prefill rung, refused typed at the
  KV rung.

Threaded and mesh tests wait on state, never on time.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import queue
import types

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
# websockets 15 binds its ``exceptions`` submodule on the package only once
# something imports it, and the JAX transport reads it after a bare import
import websockets.exceptions  # noqa: F401

from bee2bee_tpu import protocol as jprotocol
from bee2bee_tpu.engine import EngineConfig as JaxEngineConfig
from bee2bee_tpu.engine import InferenceEngine as JaxEngine
from bee2bee_tpu.meshnet.migrate import MigrationManager as JaxMigrationManager
from bee2bee_tpu.meshnet.node import P2PNode as JaxNode
from bee2bee_tpu.services.tpu import TPUService
from bee2bee_tpu.transport import LoopbackTransport as JaxLoopback
from bee2bee_tpu_torch import protocol
from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
from bee2bee_tpu_torch.engine.paged import ceil_div
from bee2bee_tpu_torch.health import get_recorder
from bee2bee_tpu_torch.meshnet.chaos import ChaosMigration
from bee2bee_tpu_torch.meshnet.migrate import MigrationManager
from bee2bee_tpu_torch.meshnet.node import P2PNode
from bee2bee_tpu_torch.models.config import get_config
from bee2bee_tpu_torch.models.params import params_from_numpy
from bee2bee_tpu_torch.services.cuda import CUDAService
from bee2bee_tpu_torch.transport import LoopbackTransport

# the JAX migration tests' config: f32 compute, 16-token blocks
CFG = dict(max_seq_len=128, prefill_buckets=(16, 32, 64), dtype="float32",
           cache_dtype="float32", decode_chunk=4, max_batch=4, kv_block_size=16)
PROMPT = "the quick brown fox jumps over the lazy dog"
POOLS = ("bfloat16", "float32", "int8")


class _Jax:
    """The JAX engines of this file by pool type, built on first use (one
    compile each) and shared; every one holds the same random-init weights
    (one rng_seed)."""

    def __init__(self):
        self.engines: dict = {}
        self.rollouts: dict = {}

    def engine(self, pool: str = "float32") -> JaxEngine:
        if pool not in self.engines:
            self.engines[pool] = JaxEngine("tiny-llama", engine_config=JaxEngineConfig(
                **{**CFG, "cache_dtype": pool}))
        return self.engines[pool]

    def rollout(self, pool: str = "float32", prompt: str = PROMPT, n: int = 24, **kw):
        """The JAX engine's unmigrated greedy tokens (and text)."""
        key = (pool, prompt, n, tuple(sorted(kw.items())))
        if key not in self.rollouts:
            r = self.engine(pool).generate(prompt, max_new_tokens=n, **kw)
            self.rollouts[key] = (r.token_ids, r.text)
        return self.rollouts[key]


@pytest.fixture(scope="module")
def ref():
    j = _Jax()
    j.params = params_from_numpy(jax.device_get(j.engine("float32").params),
                                 get_config("tiny-llama"), "cpu", torch.float32)
    yield j
    for eng in j.engines.values():
        eng.close()


def _port(ref, **over) -> InferenceEngine:
    return InferenceEngine("tiny-llama", params=ref.params, device="cpu",
                           engine_config=EngineConfig(**{**CFG, **over}))


@contextlib.contextmanager
def _ports(ref, *overs):
    engines = [_port(ref, **over) for over in overs]
    try:
        yield engines
    finally:
        for eng in engines:
            eng.close()


def _drain_events(req, base_out=()):  # -> (tokens, finish, done event)
    out = list(base_out)
    while True:
        ev = req.events.get(timeout=60)
        if ev.get("imported"):
            continue
        if ev.get("done"):
            if ev.get("result") is None:
                raise RuntimeError(ev.get("error"))
            return out, ev["result"]
        out.extend(ev.get("tokens") or [])


def _checkpoint_mid_decode(engine, prompt=PROMPT, max_new_tokens=24, min_tokens=5, **kw):
    """Start a streamed generation, stop consuming after ``min_tokens``,
    checkpoint it. Returns (snapshot, kv, request)."""
    gen = engine.generate_stream(prompt, max_new_tokens=max_new_tokens, **kw)
    seen = []
    for ev in gen:
        assert not ev.get("done"), "finished before the checkpoint"
        seen.extend(ev.get("tokens") or [])
        if len(seen) >= min_tokens:
            break
    (req,) = engine.scheduler.live_requests()
    snap = engine.scheduler.checkpoint(req)
    assert snap is not None
    return snap, snap.pop("_kv", None), req


def _over_the_wire(kv: dict, encode, decode) -> dict:
    """Block tensors through one package's frame encoder and the other's
    decoder (what a KV_BLOCKS frame carries)."""
    _, tensors = decode(encode({"type": "kv_blocks"}, kv))
    return tensors


# ------------------------------------------------ signatures and the wire


@pytest.mark.parametrize("pool", POOLS)
def test_signature_equals_jax(ref, pool):
    with _ports(ref, {"cache_dtype": pool}) as (eng,):
        assert eng.migration_signature() == ref.engine(pool).migration_signature()
        assert eng.migration_signature()["cache_dtype"] == pool


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_kv_import_across_packages(ref, pool, direction):
    """A live row's blocks move between the two packages' engines (the
    port's through the port's frame encoder and the JAX decoder, the JAX
    engine's numpy arrays, ml_dtypes bf16 included, straight in) and
    decode resumes the JAX engine's unmigrated rollout token for token,
    with no re-prefill."""
    base, _ = ref.rollout(pool)
    jeng = ref.engine(pool)
    with _ports(ref, {"cache_dtype": pool}) as (eng,):
        if direction == "jax_to_port":
            snap, kv, _ = _checkpoint_mid_decode(jeng)
            if pool == "bfloat16":
                assert kv["k"].dtype == ml_dtypes.bfloat16
            target, before = eng, 0
        else:
            snap, kv, _ = _checkpoint_mid_decode(eng)
            assert all(isinstance(t, torch.Tensor) for t in kv.values())
            kv = _over_the_wire(kv, protocol.encode_binary, jprotocol.decode_binary)
            target = jeng
            before = jeng.scheduler.stats.import_reprefills
        assert sorted(kv) == (["k", "k_scale", "v", "v_scale"] if pool == "int8"
                              else ["k", "v"])
        json.dumps(snap)
        req = target.import_generation(snap, kv)
        out, _result = _drain_events(req, snap["out"])
        assert out == base
        assert target.scheduler.stats.import_reprefills == before


@pytest.mark.parametrize("pool", POOLS)
def test_both_exporters_hash_the_same_bytes(ref, pool):
    """The bf16 repair: the port exporter hashes a torch tensor's bytes
    (bf16: its int16 view) exactly as the JAX exporter hashes the same
    blocks as numpy (ml_dtypes bf16); each side's frames verify and join
    on the other."""
    rng = np.random.default_rng(3)
    shape = (2, 2, 300, 16, 16)  # several frames at a small chunk budget
    f32 = {"k": rng.standard_normal(shape).astype(np.float32),
           "v": rng.standard_normal(shape).astype(np.float32)}
    if pool == "int8":
        kv_np = {n: (a * 40).astype(np.int8) for n, a in f32.items()}
        for n in ("k_scale", "v_scale"):
            kv_np[n] = rng.random(shape[:3]).astype(np.float32)
    else:
        kv_np = {n: a.astype(ml_dtypes.bfloat16 if pool == "bfloat16" else np.float32)
                 for n, a in f32.items()}
    kv_torch = {n: (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                    if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a))
                for n, a in kv_np.items()}
    import bee2bee_tpu.meshnet.migrate as jmigrate
    import bee2bee_tpu_torch.meshnet.migrate as migrate

    node = types.SimpleNamespace(clock=None)
    old = (migrate.MAX_CHUNK_BYTES, jmigrate.MAX_CHUNK_BYTES)
    migrate.MAX_CHUNK_BYTES = jmigrate.MAX_CHUNK_BYTES = 256 * 1024
    try:
        ours = MigrationManager(node)._encode_chunks("r", kv_torch)
        theirs = JaxMigrationManager(node)._encode_chunks("r", kv_np)
    finally:
        migrate.MAX_CHUNK_BYTES, jmigrate.MAX_CHUNK_BYTES = old
    assert len(ours) == len(theirs) > 1
    for a, b in zip(ours, theirs):
        assert a == b  # header (hashes) and payload, byte for byte
    # the port's receiver verifies and joins the frames (the JAX
    # exporter's, as they are byte-equal) back into the shipped blocks
    tensors = [protocol.decode_binary(f) for f in theirs]
    for msg, t in tensors:
        assert all(msg["hashes"][n] == migrate._piece_hash(t[n]) for n in t)
    for n, a in kv_torch.items():
        joined = migrate._join([t[n] for _, t in tensors])
        assert protocol.tensor_bytes(joined) == protocol.tensor_bytes(a)


# ------------------------------------------- scheduler- and engine-level


def test_kv_import_roundtrip_greedy_parity(ref):
    base, _ = ref.rollout()
    with _ports(ref, {}, {}) as (a, b):
        snap, kv, _req = _checkpoint_mid_decode(a)
        assert kv is not None and kv["k"].shape == kv["v"].shape
        json.dumps(snap)  # the wire half is pure JSON
        assert snap["offset"] == len(snap["ids"]) + len(snap["out"]) - 1
        assert snap["cur"] == snap["out"][-1]
        assert kv["k"].shape[2] == snap["kv_blocks"] == ceil_div(snap["offset"], 16)
        assert a.scheduler.stats.migrated_out == 1
        req2 = b.import_generation(snap, kv)
        out, result = _drain_events(req2, snap["out"])
        assert out == base
        assert result.finish_reason == "length"
        assert b.scheduler.stats.migrated_in == 1
        assert b.scheduler.stats.import_reprefills == 0
        # the source released every block of the row, its thread lives on
        assert a.scheduler._alloc.used_count == 0
        assert a.scheduler._thread.is_alive()


def test_scatter_is_in_place_and_bit_equal(ref):
    """The import writes the shipped blocks into the target's pool tensors
    in place (the captured graphs hold their addresses), bit for bit."""
    with _ports(ref, {"cache_dtype": "int8"}, {"cache_dtype": "int8"}) as (a, b):
        snap, kv, _ = _checkpoint_mid_decode(a)
        sch = b.scheduler
        ptrs = {n: t.data_ptr() for n, t in sch._cache.items()}
        seen = {}
        orig = sch._paged_import

        def watch(req, row, st):
            orig(req, row, st)
            blocks = sch._row_blocks[row][:snap["kv_blocks"]]
            seen.update({n: t[:, :, blocks].clone() for n, t in sch._cache.items()})

        sch._paged_import = watch
        req = b.import_generation(snap, kv)
        _drain_events(req, snap["out"])
        assert {n: t.data_ptr() for n, t in sch._cache.items()} == ptrs
        assert sorted(seen) == sorted(kv)
        for n in kv:
            assert torch.equal(seen[n], kv[n])


def test_reprefill_import_rung_parity(ref):
    base, _ = ref.rollout()
    with _ports(ref, {}, {}) as (a, b):
        snap, _kv, _req = _checkpoint_mid_decode(a)
        req2 = b.import_generation(dict(snap))  # kv withheld
        out, _result = _drain_events(req2, snap["out"])
        assert out == base
        assert b.scheduler.stats.import_reprefills == 1
        assert b.scheduler.stats.migrated_in == 1


def test_penalized_row_migrates_with_rebuilt_counts(ref):
    kw = dict(repetition_penalty=1.3)
    base, _ = ref.rollout(n=20, **kw)
    with _ports(ref, {}, {}) as (a, b):
        snap, kv, _req = _checkpoint_mid_decode(a, max_new_tokens=20, min_tokens=4, **kw)
        req2 = b.import_generation(snap, kv)
        out, _result = _drain_events(req2, snap["out"])
        assert out == base


def test_queued_request_checkpoints_meta_only(ref):
    base, _ = ref.rollout(n=12)
    with _ports(ref, {"max_batch": 1}, {"max_batch": 1}) as (eng, b):
        gen = eng.generate_stream("occupy the only row", max_new_tokens=64)
        next(gen)  # admitted
        queued = eng._make_request(PROMPT, 12, 0.0, 0, 1.0, None, stream=True)
        eng.scheduler.submit(queued)
        snap = eng.scheduler.checkpoint(queued)
        assert snap is not None and snap.get("_kv") is None
        assert snap["out"] == [] and snap["kv_blocks"] == 0
        req2 = b.import_generation(snap)
        out, _result = _drain_events(req2)
        assert out == base
        gen.close()


def test_checkpoint_of_finished_request_returns_none(ref):
    with _ports(ref, {}) as (eng,):
        req = eng._make_request(PROMPT, 4, 0.0, 0, 1.0, None)
        eng.scheduler.submit(req)
        while not req.events.get(timeout=60).get("done"):
            pass
        assert eng.scheduler.checkpoint(req) is None


def test_cow_shared_prefix_refcounts_across_migration(ref):
    base, _ = ref.rollout()
    with _ports(ref, {"prefix_cache_entries": 4}, {"prefix_cache_entries": 4}) as (a, b):
        assert a.generate(PROMPT, max_new_tokens=24).token_ids == base  # pins
        sch_a = a.scheduler
        pinned_a = sch_a._alloc.used_count
        assert len(sch_a._prefix_cache) >= 1
        snap, kv, _req = _checkpoint_mid_decode(a)  # a prefix hit on admit
        assert sch_a.stats.prefix_hits >= 1
        assert sch_a._alloc.used_count == pinned_a
        for blocks in sch_a._prefix_cache._entries.values():
            for blk in blocks:
                assert sch_a._alloc.refcount(blk) == 1
        req2 = b.import_generation(snap, kv)
        out, _result = _drain_events(req2, snap["out"])
        assert out == base
        sch_b = b.scheduler
        n_prompt_blocks = ceil_div(len(snap["ids"]), 16)
        assert len(sch_b._prefix_cache) == 1
        assert sch_b._alloc.used_count == n_prompt_blocks
        for blocks in sch_b._prefix_cache._entries.values():
            for blk in blocks:
                assert sch_b._alloc.refcount(blk) == 1
        for sch in (sch_a, sch_b):  # retiring the pins empties both pools
            while sch._prefix_cache._evict_one():
                pass
        assert sch_a._alloc.used_count == 0
        assert sch_b._alloc.used_count == 0


def test_int8_kv_import_roundtrip_greedy_parity(ref):
    base, _ = ref.rollout("int8")
    with _ports(ref, {"cache_dtype": "int8"}, {"cache_dtype": "int8"}) as (a, b):
        snap, kv, _req = _checkpoint_mid_decode(a)
        assert sorted(kv) == ["k", "k_scale", "v", "v_scale"]
        assert kv["k"].dtype == torch.int8 and kv["k_scale"].dtype == torch.float32
        assert kv["k_scale"].shape == kv["k"].shape[:3]
        page_bytes = sum(kv[n].numel() for n in ("k", "v"))
        scale_bytes = sum(kv[n].numel() * 4 for n in ("k_scale", "v_scale"))
        assert scale_bytes < page_bytes / 16
        json.dumps(snap)
        req2 = b.import_generation(snap, kv)
        out, result = _drain_events(req2, snap["out"])
        assert out == base
        assert b.scheduler.stats.migrated_in == 1
        assert b.scheduler.stats.import_reprefills == 0


def test_int8_import_validation_and_signature_gate(ref):
    with _ports(ref, {"cache_dtype": "int8"}, {}) as (a, b):
        snap, kv, _req = _checkpoint_mid_decode(a)
        no_scales = {name: kv[name] for name in ("k", "v")}
        with pytest.raises(ValueError, match="kv tensors"):
            a.import_generation(dict(snap), no_scales)
        with pytest.raises(ValueError, match="kv tensors"):
            b.import_generation(dict(snap), kv)
        assert a.migration_signature() != b.migration_signature()
        assert a.migration_signature()["cache_dtype"] == "int8"
        snap2, _kv2, _ = _checkpoint_mid_decode(a)
        req2 = b.import_generation(dict(snap2))
        out, _result = _drain_events(req2, snap2["out"])
        assert out[:len(snap2["out"])] == snap2["out"]
        assert b.scheduler.stats.import_reprefills == 1


def test_import_pool_exhausted_is_typed_and_immediate(ref):
    with _ports(ref, {}, {"kv_pool_blocks": 3}) as (a, tiny):
        snap, kv, _req = _checkpoint_mid_decode(a, min_tokens=16)
        assert snap["kv_blocks"] >= 3
        req2 = tiny.import_generation(snap, kv)
        ev = req2.events.get(timeout=60)
        assert ev.get("done") and ev.get("result") is None
        assert ev.get("error_kind") == "pool_exhausted"
        assert tiny.scheduler.stats.migrated_in == 0
        assert tiny.scheduler._alloc.used_count == 0
        assert tiny.scheduler._thread.is_alive()


BAD = {  # (snapshot, blocks) each engine must refuse, by case
    "empty_prompt": lambda s, kv: ({**s, "ids": []}, kv),
    "model": lambda s, kv: ({**s, "model": "tiny-gpt2"}, kv),
    "adapter": lambda s, kv: ({**s, "adapter": "absent"}, kv),
    "invariant": lambda s, kv: ({**s, "offset": s["offset"] + 1}, kv),
    "no_room": lambda s, kv: ({**s, "ids": [5] * 126, "out": [7, 7], "offset": 127}, kv),
    "kv_without_out": lambda s, kv: ({**s, "out": []}, kv),
    "block_size": lambda s, kv: ({**s, "block_size": 8}, kv),
    "tensor_set": lambda s, kv: (s, {"k": kv["k"]}),
    "shape": lambda s, kv: (s, dict(kv, v=kv["v"][:, :, :1])),
    "dtype": lambda s, kv: (s, dict(kv, k=kv["k"].astype(np.float64))),
    "reprefill_no_room": lambda s, kv: ({**s, "ids": [5] * 126, "out": [7, 7]}, None),
}


@pytest.mark.parametrize("case", list(BAD))
def test_import_validation_refusals_match_jax(ref, case):
    """Each refusal raises ValueError with the JAX engine's text, before
    anything reaches either scheduler."""
    jeng = ref.engine()
    if not hasattr(ref, "bad_source"):
        ref.bad_source = _checkpoint_mid_decode(jeng)[:2]
    bad_snap, bad_kv = BAD[case](*ref.bad_source)
    with _ports(ref, {}) as (eng,):
        with pytest.raises(ValueError) as theirs:
            jeng.import_generation(dict(bad_snap), bad_kv)
        with pytest.raises(ValueError) as ours:
            eng.import_generation(dict(bad_snap), bad_kv)
        assert str(ours.value) == str(theirs.value)
        assert eng.scheduler.stats.migrated_in == 0


def test_import_validation_rejects_bad_snapshots(ref):
    with _ports(ref, {}, {"kv_block_size": 8}) as (a, b):
        snap, kv, _req = _checkpoint_mid_decode(a)
        with pytest.raises(ValueError, match="block_size"):
            b.import_generation(snap, kv)
        with pytest.raises(ValueError, match="model"):
            a.import_generation({**snap, "model": "tiny-gpt2"}, kv)
        with pytest.raises(ValueError, match="invariant"):
            a.import_generation({**snap, "offset": snap["offset"] + 1}, kv)
        assert a.migration_signature() != b.migration_signature()


def test_pool_pressure_offers_the_row_before_the_typed_error(ref):
    """A row the pool cannot grow goes to the migration hook with a
    snapshot of its settled state (reason "pool_exhausted"); taken, it
    leaves; a hook that raises falls back to the typed error, and the
    scheduler lives on."""
    base, _ = ref.rollout(prompt="hi", n=40)
    with _ports(ref, {"kv_pool_blocks": 3, "max_batch": 1}, {}) as (a, b):
        offered: queue.Queue = queue.Queue()
        a.scheduler.migrate_cb = lambda *offer: offered.put(offer) or True
        req = a._make_request("hi", 40, 0.0, 0, 1.0, None, stream=True)
        a.scheduler.submit(req)
        mreq, snap, reason = offered.get(timeout=60)
        assert mreq is req and reason == "pool_exhausted"
        assert snap["offset"] == len(snap["ids"]) + len(snap["out"]) - 1 == len(req.ids) + len(req.out_ids) - 1
        assert a.scheduler.stats.migrated_out == 1
        kv = snap.pop("_kv")
        req2 = b.import_generation(snap, kv)
        out, _ = _drain_events(req2, snap["out"])
        assert out == base

        def broken(req, snap, reason):
            raise RuntimeError("hook bug")

        a.scheduler.migrate_cb = broken
        req = a._make_request("hi", 40, 0.0, 0, 1.0, None)
        a.scheduler.submit(req)
        while True:
            ev = req.events.get(timeout=60)
            if ev.get("done"):
                break
        assert ev["result"] is None and "exhausted" in ev["error"]
        assert a.scheduler._thread.is_alive()
        assert a.generate("hi", max_new_tokens=4).new_tokens == 4


def test_prefill_handoff_offers_every_fresh_row(ref):
    """handoff_after_prefill: each freshly prefilled row with 2+ tokens
    left is offered once, leaves before any decode window, and resumes on
    another engine; a 1-token request stays."""
    with _ports(ref, {}, {}) as (a, b):
        offers: queue.Queue = queue.Queue()
        a.scheduler.migrate_cb = lambda *offer: offers.put(offer) or True
        a.scheduler.handoff_after_prefill = True
        prompts = [PROMPT, "hello there", "0123 4567"]
        reqs = [a._make_request(p, 10, 0.0, 0, 1.0, None, stream=True) for p in prompts]
        for r in reqs:
            a.scheduler.submit(r)
        short = a._make_request("short", 1, 0.0, 0, 1.0, None)
        a.scheduler.submit(short)
        while not short.events.get(timeout=60).get("done"):
            pass
        offered = [offers.get(timeout=60) for _ in reqs]
        st = a.scheduler.stats
        assert st.prefill_handoffs == st.migrated_out == 3
        assert st.chunks == 0  # nothing decoded here
        assert {why for _, _, why in offered} == {"prefill_handoff"}
        for (req, snap, _), prompt in zip(sorted(offered, key=lambda o: reqs.index(o[0])),
                                          prompts):
            assert snap["out"] == req.out_ids and len(snap["out"]) == 1
            base, _ = ref.rollout(prompt=prompt, n=10)
            out, _ = _drain_events(b.import_generation(snap, snap.pop("_kv")), snap["out"])
            assert out == base


# -------------------------------------------------------------- the mesh


async def _settle(cond, timeout=20.0, interval=0.05):
    for _ in range(int(timeout / interval)):
        if cond():
            return True
        await asyncio.sleep(interval)
    return False


def _node(kind: str, role=None):
    if kind == "jax":
        return JaxNode(host="127.0.0.1", port=0, transport=JaxLoopback(), disagg_role=role)
    return P2PNode(host="127.0.0.1", port=0, transport=LoopbackTransport(),
                   disagg_role=role)


def _service(kind: str, engine):
    if kind == "jax":
        return TPUService("tiny-llama", engine=engine)
    return CUDAService("tiny-llama", engine=engine, device="cpu")


@contextlib.asynccontextmanager
async def _mesh(ref, kinds=("port", "port", "port"), roles=None, engine_over=None,
                jax_pools=None):
    """Loopback nodes (port or JAX), each serving tiny-llama on its own
    engine (a port engine, or this file's shared JAX engine of the pool
    ``jax_pools[i]``), bootstrapped off node 0, services announced and
    digests gossiped."""
    n = len(kinds)
    roles = roles or [None] * n
    over = engine_over or [{}] * n
    nodes, svcs, owned = [], [], []
    try:
        for i, kind in enumerate(kinds):
            node = _node(kind, roles[i])
            node.ping_interval_s = 0.1
            await node.start()
            if kind == "jax":
                eng = ref.engine((jax_pools or {}).get(i, "float32"))
            else:
                eng = _port(ref, **over[i])
                owned.append(eng)
            svc = _service(kind, eng)
            node.add_service(svc)
            nodes.append(node)
            svcs.append(svc)
        for node in nodes[1:]:
            assert await node.connect_bootstrap(nodes[0].addr)
        assert await _settle(lambda: all(len(x.peers) == n - 1 for x in nodes))
        for node, svc in zip(nodes, svcs):
            await node.announce_service(svc)
        for node in nodes:
            await node.gossip_telemetry()
        assert await _settle(lambda: all(len(x.health.fresh()) == n - 1 for x in nodes))
        yield nodes, svcs
    finally:
        for node in nodes:
            with contextlib.suppress(Exception):
                await node.stop()
        for svc, kind in zip(svcs, kinds):
            sch = svc.engine._scheduler
            if kind == "jax" and sch is not None:
                # a shared engine: unhook it from the stopped node
                sch.migrate_cb = None
                sch.handoff_after_prefill = False
        for eng in owned:
            eng.close()


async def _start_streamed(node, svc, prompt=PROMPT, max_new_tokens=96, min_tokens=2):
    """A streamed generation through the node's own serving path, until it
    has produced ``min_tokens``. Returns (task, chunks)."""
    chunks: list[str] = []
    task = asyncio.create_task(node.request_generation(
        node.peer_id, prompt, model="tiny-llama", max_new_tokens=max_new_tokens,
        temperature=0.0, stream=True, on_chunk=chunks.append,
    ))
    for _ in range(1200):
        await asyncio.sleep(0.05)
        reqs = svc.engine.scheduler.live_requests()
        if reqs and len(reqs[0].out_ids) >= min_tokens:
            return task, chunks
        if task.done():
            task.result()
    raise AssertionError("generation never reached the checkpoint window")


def _kinds(*recorded):
    rec = get_recorder()
    rec.flush()
    return {e["kind"] for e in rec.list_incidents()} >= set(recorded)


@pytest.mark.async_timeout(120)
async def test_three_node_drain_token_parity_zero_reprefill(ref):
    _, text = ref.rollout(n=96)
    async with _mesh(ref) as (nodes, svcs):
        a, b, c = nodes
        task, _chunks = await _start_streamed(a, svcs[0])
        summary = await a.begin_drain()
        assert summary["migrated"] == 1 and summary["failed"] == 0, summary
        result = await task
        assert result["text"] == text
        assert result["tokens"] == 96
        assert svcs[0].engine.scheduler.stats.migrated_out == 1
        assert sum(s.engine.scheduler.stats.migrated_in for s in svcs) == 1
        assert all(s.engine.scheduler.stats.import_reprefills == 0 for s in svcs)
        assert a.telemetry_digest().get("draining") is True
        sch_a = svcs[0].engine.scheduler
        assert sch_a._alloc.used_count == 0 and sch_a._thread.is_alive()


@pytest.mark.async_timeout(120)
async def test_chaos_corrupt_piece_falls_back_to_reprefill(ref):
    get_recorder().clear()
    _, text = ref.rollout(n=96)
    async with _mesh(ref, kinds=("port", "port")) as (nodes, svcs):
        a, _b = nodes
        chaos = ChaosMigration(a, action="corrupt_piece", at_chunk=0, piece="k")
        task, _chunks = await _start_streamed(a, svcs[0])
        summary = await a.begin_drain()
        chaos.restore()
        assert chaos.triggered.is_set()
        assert summary["reprefilled"] == 1 and summary["failed"] == 0, summary
        assert (await task)["text"] == text
        assert svcs[1].engine.scheduler.stats.import_reprefills == 1
        assert _kinds("migration:hash_mismatch")


@pytest.mark.async_timeout(120)
async def test_corrupt_scale_tensor_falls_back_to_reprefill(ref):
    get_recorder().clear()
    over = [{"cache_dtype": "int8"}, {"cache_dtype": "int8"}]
    async with _mesh(ref, kinds=("port", "port"), engine_over=over) as (nodes, svcs):
        a, _b = nodes
        chaos = ChaosMigration(a, action="corrupt_piece", at_chunk=0, piece="k_scale")
        task, _chunks = await _start_streamed(a, svcs[0])
        summary = await a.begin_drain()
        chaos.restore()
        assert chaos.triggered.is_set()
        assert summary["reprefilled"] == 1 and summary["failed"] == 0, summary
        assert (await task).get("tokens")
        assert svcs[1].engine.scheduler.stats.import_reprefills == 1
        assert _kinds("migration:hash_mismatch")


@pytest.mark.async_timeout(120)
async def test_int8_exporter_refused_by_fullprec_importer_then_reprefills(ref):
    get_recorder().clear()
    over = [{"cache_dtype": "int8"}, {}]
    async with _mesh(ref, kinds=("port", "port"), engine_over=over) as (nodes, svcs):
        a, _b = nodes
        task, _chunks = await _start_streamed(a, svcs[0])
        summary = await a.begin_drain()
        assert summary["reprefilled"] == 1 and summary["failed"] == 0, summary
        assert (await task).get("tokens")
        assert svcs[1].engine.scheduler.stats.import_reprefills == 1
        assert _kinds("migration:incompatible")


@pytest.mark.async_timeout(120)
async def test_chaos_target_pool_exhausted_falls_back(ref):
    get_recorder().clear()
    _, text = ref.rollout(n=96)
    async with _mesh(ref) as (nodes, svcs):
        a, b, c = nodes
        chaos_b = ChaosMigration(b, action="exhaust_target")
        chaos_c = ChaosMigration(c, action="exhaust_target")
        task, _chunks = await _start_streamed(a, svcs[0])
        orig = a.migration._migrate_once

        async def unchaos_then(*args, **kw):
            if args[3] is None:  # the re-prefill rung (kv=None)
                chaos_b.restore()
                chaos_c.restore()
            return await orig(*args, **kw)

        a.migration._migrate_once = unchaos_then
        summary = await a.begin_drain()
        a.migration._migrate_once = orig
        assert chaos_b.triggered.is_set() or chaos_c.triggered.is_set()
        assert summary["reprefilled"] == 1 and summary["failed"] == 0, summary
        assert (await task)["text"] == text
        assert _kinds("migration:pool_exhausted")


@pytest.mark.async_timeout(120)
async def test_chaos_kill_link_mid_stream_falls_back(ref):
    get_recorder().clear()
    _, text = ref.rollout(n=96)
    async with _mesh(ref) as (nodes, svcs):
        a, b, c = nodes
        chaos = ChaosMigration(a, action="kill_link", at_chunk=0)
        task, _chunks = await _start_streamed(a, svcs[0])
        summary = await a.begin_drain()
        chaos.restore()
        assert chaos.triggered.is_set()
        assert summary["failed"] == 0 and summary["reprefilled"] == 1, summary
        assert (await task)["text"] == text
        assert not b.migration._imports and not c.migration._imports
        assert _kinds("migration:export_failed")


@pytest.mark.async_timeout(120)
async def test_every_rung_dead_yields_typed_error_not_hang(ref):
    get_recorder().clear()
    async with _mesh(ref, kinds=("port", "port")) as (nodes, svcs):
        a, b = nodes
        task, _chunks = await _start_streamed(a, svcs[0])
        sch = svcs[0].engine.scheduler
        (req,) = sch.live_requests()
        snap = await asyncio.to_thread(sch.checkpoint, req)
        kv = snap.pop("_kv", None)
        b.draining = True
        await b.gossip_telemetry()
        assert await _settle(lambda: a.health.fresh()[b.peer_id].get("draining"))
        outcome = await a.migration._migrate_with_fallback(req, svcs[0], snap, kv, "drain")
        assert outcome == "failed"
        with pytest.raises(Exception, match="migration_failed"):
            await task
        assert _kinds("migration:no_target", "migration:unrecoverable")


@pytest.mark.async_timeout(120)
async def test_disagg_prefill_handoff_to_decode_peer(ref):
    _, text = ref.rollout(n=16)
    async with _mesh(ref, roles=["prefill", "decode", None]) as (nodes, svcs):
        a, _b, _c = nodes
        assert svcs[0].engine.scheduler.handoff_after_prefill
        chunks: list[str] = []
        result = await a.request_generation(
            a.peer_id, PROMPT, model="tiny-llama", max_new_tokens=16,
            temperature=0.0, stream=True, on_chunk=chunks.append,
        )
        assert result["text"] == text
        assert "".join(chunks) == text
        sch_a = svcs[0].engine.scheduler
        assert sch_a.stats.prefill_handoffs == sch_a.stats.migrated_out == 1
        assert sch_a.stats.chunks == 0
        assert svcs[1].engine.scheduler.stats.migrated_in == 1
        assert svcs[2].engine.scheduler.stats.migrated_in == 0


@pytest.mark.async_timeout(120)
async def test_pool_exhaustion_mid_decode_migrates_instead_of_erroring(ref):
    _, text = ref.rollout(prompt="hi", n=40)
    over = [{"kv_pool_blocks": 3, "max_batch": 1}, {}]
    async with _mesh(ref, kinds=("port", "port"), engine_over=over) as (nodes, svcs):
        a, _b = nodes
        result = await a.request_generation(
            a.peer_id, "hi", model="tiny-llama", max_new_tokens=40,
            temperature=0.0, stream=True, on_chunk=lambda _: None,
        )
        assert result["text"] == text
        assert svcs[0].engine.scheduler.stats.migrated_out == 1
        assert svcs[1].engine.scheduler.stats.migrated_in == 1


@pytest.mark.parametrize("pool", ["bfloat16", "float32"])
@pytest.mark.parametrize("source", ["jax", "port"])
@pytest.mark.async_timeout(180)
async def test_drain_across_packages(ref, source, pool):
    """A JAX node and a CUDA-service node on one loopback mesh: the live
    stream of one drains onto the other through the KV rung (bf16 blocks
    cross the wire both ways and verify), with no re-prefill on either
    side and the JAX engine's text: all of it over f32 pools; over bf16
    pools the first 24 tokens' (f32 compute rounded into a bf16 pool: the
    two packages' own unmigrated rollouts part at token 32 on this
    prompt, so the tokens past it depend on where the row moved)."""
    base, text = ref.rollout(pool, n=96)
    if pool == "bfloat16":
        text = ref.engine(pool).tokenizer.decode(base[:24]).rstrip("\ufffd")
    kinds = (source, "port" if source == "jax" else "jax")
    jax_at = kinds.index("jax")
    over = [{"cache_dtype": pool}] * 2
    async with _mesh(ref, kinds=kinds, engine_over=over,
                     jax_pools={jax_at: pool}) as (nodes, svcs):
        a, _b = nodes
        tgt = svcs[1].engine.scheduler
        before = (tgt.stats.migrated_in, tgt.stats.import_reprefills)
        task, _chunks = await _start_streamed(a, svcs[0])
        summary = await a.begin_drain()
        assert summary["migrated"] == 1 and summary["failed"] == 0, summary
        result = await task
        assert result["text"].startswith(text) and result["tokens"] == 96
        assert pool == "bfloat16" or result["text"] == text
        assert (tgt.stats.migrated_in, tgt.stats.import_reprefills) == (
            before[0] + 1, before[1])


@pytest.mark.async_timeout(180)
async def test_jax_f32_engine_bf16_pool_reaches_port_f32_pool_by_reprefill(ref):
    """The known design difference: the JAX node config gives an f32 engine
    a bf16 pool, the port's an f32 pool. The signatures differ, so the KV
    rung is refused typed (incompatible) and the re-prefill rung resumes
    the row on the port node: no corruption, the stream completes with its
    accepted prefix intact."""
    from bee2bee_tpu.config import NodeConfig as JaxNodeConfig
    from bee2bee_tpu_torch.config import NodeConfig

    assert JaxNodeConfig(dtype="float32").engine_config().cache_dtype == "bfloat16"
    assert NodeConfig(dtype="float32").engine_config().cache_dtype == "float32"
    get_recorder().clear()
    async with _mesh(ref, kinds=("jax", "port"), jax_pools={0: "bfloat16"}) as (nodes, svcs):
        a, _b = nodes
        tgt = svcs[1].engine.scheduler
        assert svcs[0].engine.migration_signature() != svcs[1].engine.migration_signature()
        task, _chunks = await _start_streamed(a, svcs[0])
        summary = await a.begin_drain()
        assert summary["reprefilled"] == 1 and summary["failed"] == 0, summary
        assert (await task)["tokens"] == 96
        assert tgt.stats.import_reprefills == 1 and tgt.stats.migrated_in == 1
        assert _kinds("migration:incompatible")


def test_replays_count_every_launch_across_threads():
    """Two engines in one process (a migration's source and target) replay
    graphs from their own threads: every replay's counts land, none lost
    to a read-modify-write race (the switch interval shortened so threads
    interleave between the read and the write)."""
    import sys
    import threading

    from bee2bee_tpu_torch.engine.graphs import Graph

    holder = types.SimpleNamespace(launches=0, forwards=0)

    class _Null:
        def replay(self):
            pass

    graph = Graph(_Null(), [(holder, "launches", 32), (holder, "forwards", 1)])
    n_threads, n_replays = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [graph.replay() for _ in range(n_replays)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert (holder.launches, holder.forwards) == (32 * n_threads * n_replays,
                                                  n_threads * n_replays)


@pytest.mark.async_timeout(60)
async def test_websockets_links_carry_tensor_frames_uncompressed():
    """The port's websockets transport negotiates no permessage-deflate on
    either end, also when a JAX node (which offers it) dials in; a KV
    frame crosses such a link byte for byte."""
    from bee2bee_tpu.transport import WebsocketsTransport as JaxWebsockets
    from bee2bee_tpu_torch.transport import WebsocketsTransport

    got: asyncio.Queue = asyncio.Queue()

    async def handler(ws):
        async for message in ws:
            await got.put((message, ws.protocol.extensions))

    ours = WebsocketsTransport()
    server = await ours.serve(handler, "127.0.0.1", 0)
    port = next(iter(server.sockets)).getsockname()[1]
    frame = protocol.encode_binary({"type": "kv_blocks"}, {
        "k": torch.randn(2, 2, 3, 16, 16).to(torch.bfloat16)})
    try:
        for dialer in (ours, JaxWebsockets()):
            ws = await dialer.dial(f"ws://127.0.0.1:{port}")
            try:
                assert ws.protocol.extensions == []
                await ws.send(frame)
                message, extensions = await asyncio.wait_for(got.get(), 10)
                assert message == frame and extensions == []
            finally:
                await ws.close()
    finally:
        server.close()
        await server.wait_closed()
