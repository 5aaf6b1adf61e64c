"""The tiered drafter stack of the PyTorch port (``engine/spec.py``'s
``DrafterStack`` and ``MeshDrafter``, ``engine/drafter.py``'s
``DraftModel``, the rectangular-cache forward it runs on, and the mesh
draft role) against the JAX package's (``tests/test_drafter.py``'s cases):

- the typed boot gate: an unknown drafter, a vocab or tokenizer mismatch
  is a ``DrafterLoadError`` at construction; a drafter without
  ``spec_tokens`` is a config error;
- tier policy: the port's ``DrafterStack`` walks the ladder as JAX's, and
  every ``MeshDrafter`` wire scenario (pending, salvage, outpaced,
  mispredicted, timeout, no peer, error frames, reprime, forget) gives
  the port and the JAX client the same transcript;
- ``core.forward`` over a rectangular cache (``init_cache``) gives JAX's
  logits within 1e-5 in f32 at T = 1, 2 and the prime width, and writes
  the same cache; an int8 rectangular cache is refused as in JAX;
- ``DraftModel`` proposes JAX's drafts for the same weights and
  contexts, across prime, draft and observe cycles with idle rows;
- model tier end to end on tiny-llama (JAX weights): the n-gram tier
  escalates, the same-weight drafter's drafts are all accepted, greedy
  tokens equal the JAX engine's spec-off ones (also with a stop token
  inside a draft, and with a drafter at another seed, which demotes);
  the per-tier counters and the acceptance gauge reach ``/metrics``;
- mesh tier against an in-process fake draft peer, then the peer's death
  degrading rows typed; and a port node drafting from a JAX draft peer
  over the mesh.
"""

from __future__ import annotations

import asyncio
import queue
import re
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee2bee_tpu.engine import EngineConfig as JaxEngineConfig
from bee2bee_tpu.engine import InferenceEngine as JaxEngine
from bee2bee_tpu.engine import drafter as jdrafter
from bee2bee_tpu.engine import spec as jspec
from bee2bee_tpu.meshnet.node import P2PNode as JaxNode
from bee2bee_tpu.metrics import get_registry as jax_registry
from bee2bee_tpu.models import config as jconfig
from bee2bee_tpu.models import core as jcore
from bee2bee_tpu.transport import LoopbackTransport as JaxLoopback
from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
from bee2bee_tpu_torch.engine import drafter, spec
from bee2bee_tpu_torch.meshnet.node import P2PNode
from bee2bee_tpu_torch.metrics import get_registry
from bee2bee_tpu_torch.models import core
from bee2bee_tpu_torch.models.config import get_config
from bee2bee_tpu_torch.models.params import params_from_numpy
from bee2bee_tpu_torch.services.cuda import CUDAService
from bee2bee_tpu_torch.transport import LoopbackTransport

KW = dict(max_seq_len=128, dtype="float32", cache_dtype="float32", decode_chunk=4,
          prefill_buckets=(16, 32, 64), max_batch=4)
# probe small enough that the n-gram tier fails (and escalates) within
# about two missed attempts
SPEC_KW = dict(KW, spec_tokens=6, spec_probe_tokens=12)
# period-499 walk: no recurring n-gram, so rows escalate off the n-gram tier
NONREP = [1 + (j * 97) % 499 for j in range(24)]
REP_PROMPT = [5, 6, 7, 8, 9] * 3 + [5, 6, 7]
TOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    """The JAX spec-off engine and its tiny-llama weights as the port's."""
    jeng = JaxEngine("tiny-llama", engine_config=JaxEngineConfig(**KW))
    params = params_from_numpy(jax.device_get(jeng.params), get_config("tiny-llama"),
                               "cpu", torch.float32)
    yield jeng, params
    jeng.close()


def _model_engine(params, **over):
    """The port engine on the JAX weights, its tiny-llama drafter given the
    same weights (weight-identical, as a same-seed drafter is in JAX)."""
    eng = InferenceEngine("tiny-llama", params=params, device="cpu",
                          engine_config=EngineConfig(**dict(SPEC_KW, drafter="tiny-llama",
                                                            **over)))
    eng.drafter_model.params = params
    return eng


@pytest.fixture(scope="module")
def model_engine(ref):
    eng = _model_engine(ref[1])
    yield eng
    eng.close()


def _tiers(eng):
    return dict(eng.scheduler.stats.spec_tiers)


# ------------------------------------------------------------- boot gate


class _Cfg:
    def __init__(self, vocab):
        self.vocab_size = vocab


class _TokA:
    vocab_size = 512


class _TokB:
    vocab_size = 512


def test_tokenizer_fingerprint_matches_jax():
    from bee2bee_tpu_torch.engine.tokenizer import load_tokenizer

    for tok in (_TokA(), _TokB(), load_tokenizer(None, 512)):
        assert drafter.tokenizer_fingerprint(tok) == jdrafter.tokenizer_fingerprint(tok)
    assert drafter.tokenizer_fingerprint(_TokA()) != drafter.tokenizer_fingerprint(_TokB())


def test_validate_drafter_compat_typed_errors():
    drafter.validate_drafter_compat(_Cfg(512), _TokA(), _Cfg(512), _TokA())
    with pytest.raises(drafter.DrafterLoadError, match="vocab_size"):
        drafter.validate_drafter_compat(_Cfg(512), _TokA(), _Cfg(50257), _TokA())
    with pytest.raises(drafter.DrafterLoadError, match="tokenizer"):
        drafter.validate_drafter_compat(_Cfg(512), _TokA(), _Cfg(512), _TokB())


def test_unknown_drafter_is_a_typed_boot_error():
    with pytest.raises(drafter.DrafterLoadError, match="no-such-model"):
        drafter.DraftModel("no-such-model", spec_tokens=4, batch=2,
                           target_max_seq_len=128, device="cpu")
    with pytest.raises(drafter.DrafterLoadError):
        InferenceEngine("tiny-llama", device="cpu", engine_config=EngineConfig(
            max_seq_len=32, dtype="float32", cache_dtype="float32", decode_chunk=4,
            prefill_buckets=(16,), max_batch=1, spec_tokens=4, drafter="no-such-model"))


def test_drafter_without_spec_tokens_is_a_config_error():
    with pytest.raises(ValueError, match="spec_tokens"):
        EngineConfig(**KW, drafter="tiny-llama")


# ------------------------------------------------------------ tier policy


class _Stub:
    def __init__(self):
        self.dead = False

    def forget(self, req):
        pass

    def close(self):
        pass


def _ladder(module) -> list:
    ng, md, ms = _Stub(), _Stub(), _Stub()
    stack = module.DrafterStack({"ngram": ng, "model": md, "mesh": ms}, 6)
    out = [stack.start_tier(), stack.next_tier("ngram", {"ngram"}),
           stack.next_tier("model", {"ngram", "model"}),
           stack.next_tier("mesh", {"ngram", "model", "mesh"}),
           stack.next_tier("mesh", {"mesh"})]
    ms.dead = True
    out.append(stack.next_tier("model", {"ngram", "model"}))
    ng.dead = True
    out.append(stack.start_tier())
    only = module.DrafterStack({"mesh": _Stub()}, 6)
    out += [only.start_tier(), only.next_tier("mesh", {"mesh"})]
    for bad in ({"warp": _Stub()}, {}):
        with pytest.raises(ValueError):
            module.DrafterStack(bad, 6)
    return out


def test_drafter_stack_tier_policy_matches_jax():
    assert _ladder(spec) == _ladder(jspec) == [
        "ngram", "model", "mesh", spec.TIER_OFF, "model", spec.TIER_OFF, "model",
        "mesh", spec.TIER_OFF]


# ------------------------------------------------- mesh client protocol


class _Req:
    def __init__(self, ids):
        self.ids = list(ids)
        self.out_ids = []


class _Wire:
    def __init__(self):
        self.sent = []
        self.ok = True

    def __call__(self, payload):
        self.sent.append(dict(payload))
        return self.ok


def _scenario(module, name) -> list:
    """One MeshDrafter wire scenario of the JAX tests, as a transcript of
    what the client proposed and sent (request ids dropped: they are
    random per process)."""
    out = []
    wire = _Wire()
    kw = {}
    if name == "timeout":
        kw = dict(timeout_s=0.0, max_failures=2)
    elif name == "errors":
        kw = dict(max_failures=2)
    md = module.MeshDrafter(2 if name == "outpaced" else 4, **kw)
    if name != "no_transport":
        md.attach_transport(wire)
    req = _Req([1, 2, 3])
    if name == "no_peer":
        wire.ok = False
    out.append(md.propose_batch([(0, req)]))
    rid = wire.sent[0]["rid"] if wire.sent else None

    def deliver(**msg):
        md.deliver(dict(msg, rid=rid))

    if name == "pending":
        out.append(md.propose_batch([(0, req)]))
        deliver(pos=3, draft=[7, 8, 9, 10])
        out.append(md.propose_batch([(0, req)]))
        req.out_ids = [7, 8]
        md.observe(req, 2)
    elif name == "salvage":
        deliver(pos=3, draft=[7, 8, 9, 10])
        req.out_ids = [7, 8]
        out.append(md.propose_batch([(0, req)]))
    elif name == "outpaced":
        deliver(pos=3, draft=[7, 8])
        req.out_ids = [7, 8, 9]
        out.append(md.propose_batch([(0, req)]))
    elif name == "mispredicted":
        deliver(pos=3, draft=[7, 8, 9, 10])
        req.out_ids = [7, 99]
        out.append(md.propose_batch([(0, req)]))
    elif name == "timeout":
        for _ in range(2):
            time.sleep(0.005)
            out.append(md.propose_batch([(0, req)]))
        out.append(md.propose_batch([(0, req)]))
    elif name == "no_peer" or name == "no_transport":
        out.append(md.propose_batch([(0, req)]))
    elif name == "errors":
        deliver(error="draft_failed")
        out.append(md.dead)
        md.propose_batch([(0, req)])
        deliver(error="draft_failed")
    elif name == "reprime":
        deliver(pos=99, draft=[5, 5, 5])
        out.append(md.propose_batch([(0, req)]))
        deliver(reprime=True)
        md.propose_batch([(0, req)])
        md.deliver({"rid": "bogus", "pos": 3, "draft": [1]})
    elif name == "forget":
        md.forget(req)
        deliver(pos=3, draft=[1])
        out.append(md.propose_batch([(0, req)]))
    out.append((md.dead, md.dead_reason))
    out.append([{k: v for k, v in p.items() if k != "rid"} for p in wire.sent])
    return out


@pytest.mark.parametrize("name,want", [
    ("pending", [{0: None}, {0: None}, {0: [7, 8, 9, 10]}]),
    ("salvage", [{0: None}, {0: [9, 10]}]),
    ("outpaced", [{0: None}, {0: None}]),
    ("mispredicted", [{0: None}, {0: []}]),
    ("timeout", [{0: None}, {0: []}, {0: []}, {0: []}]),
    ("no_peer", [{0: None}, {0: []}]),
    ("no_transport", [{0: None}, {0: []}]),
    ("errors", [{0: None}, False]),
    ("reprime", [{0: None}, {0: None}]),
    ("forget", [{0: None}, {0: None}]),
])
def test_mesh_drafter_scenario_matches_jax(name, want):
    ours, theirs = _scenario(spec, name), _scenario(jspec, name)
    assert ours == theirs
    assert ours[:len(want)] == want
    if name in ("timeout", "no_peer", "errors"):
        assert ours[-2] == (True, {"timeout": "timeout", "no_peer": "no_peer",
                                   "errors": "peer_lost"}[name])


def test_meshdrafter_validates_spec_tokens():
    with pytest.raises(ValueError):
        spec.MeshDrafter(0)


# ------------------------------------------------ rectangular-cache forward


@pytest.fixture(scope="module")
def tiny():
    jcfg = jconfig.get_config("tiny-llama")
    tree = jax.device_get(jcore.init_params(jcfg, jax.random.key(0), dtype=jnp.float32))
    cfg = get_config("tiny-llama")
    return jcfg, tree, cfg, params_from_numpy(tree, cfg, "cpu", torch.float32)


@pytest.mark.parametrize("T", [1, 2, drafter.DraftModel.PRIME_WIDTH])
def test_rectangular_cache_forward_matches_jax(tiny, T):
    """A prefill, then a T-token chunk at per-row offsets (one clamped so
    the chunk fits, one parked far up), over [L, B, S, Hkv, hd] caches."""
    jcfg, tree, cfg, params = tiny
    B, S = 3, 160
    jc = jcore.init_cache(jcfg, B, S, dtype=jnp.float32)
    tc = core.init_cache(cfg, B, S, dtype=torch.float32)
    rng = np.random.default_rng(T)
    for offs, width in (([0, 0, 0], 20), ([20, 9, S - T + 3], T)):
        ids = rng.integers(3, 500, size=(B, width)).astype(np.int32)
        jl, jc = jcore.forward(tree, jcfg, jnp.asarray(ids), jc,
                               jnp.asarray(offs, jnp.int32))
        tl, tc = core.forward(params, cfg, torch.from_numpy(ids).long(), tc,
                              torch.tensor(offs, dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=TOL)


def test_int8_rectangular_cache_is_refused_as_in_jax(tiny):
    _, _, cfg, params = tiny
    cache = core.init_cache(cfg, 1, 32, dtype=torch.int8)
    with pytest.raises(ValueError, match="rectangular cache has no quantized path"):
        core.forward(params, cfg, torch.ones((1, 2), dtype=torch.long), cache, 0)


def test_draft_model_proposes_jax_drafts(tiny):
    """The same weights and contexts through both DraftModels, over
    propose/observe cycles: a fresh row (prime chunks), steady drafting
    (accepted 0..K), a re-prime after zero-accept streaks, an idle row."""
    jcfg, tree, cfg, params = tiny
    K = 4
    ours = drafter.DraftModel("tiny-llama", spec_tokens=K, batch=3, target_max_seq_len=128,
                              params=params, device="cpu")
    theirs = jdrafter.DraftModel("tiny-llama", spec_tokens=K, batch=3,
                                 target_max_seq_len=128, params=tree)
    rng = np.random.default_rng(11)
    reqs = [_Req(rng.integers(3, 500, size=n)) for n in (90, 5, 17)]
    for step in range(8):
        rows = [(b, r) for b, r in enumerate(reqs) if not (b == 2 and step % 3 == 1)]
        got, want = ours.propose_batch(rows), theirs.propose_batch(rows)
        assert got == want and all(len(d) == K for d in got.values())
        for b, r in rows:
            accepted = 0 if step in (2, 3, 4, 5) and b == 0 else int(rng.integers(0, K + 1))
            r.out_ids += got[b][:accepted] + [int(rng.integers(3, 500))]
            ours.observe(r, accepted)
            theirs.observe(r, accepted)
    assert [s.consumed for s in ours._slots.values()] == [
        s.consumed for s in theirs._slots.values()]


# --------------------------------------------- model tier: greedy parity


def test_model_tier_parity_and_escalation(ref, model_engine):
    """On a prompt the n-gram tier cannot draft, rows escalate to the
    resident drafter; the tokens equal the JAX spec-off engine's, and the
    weight-identical drafter's drafts are all accepted."""
    jeng, _ = ref
    want = jeng.generate(NONREP, max_new_tokens=32, temperature=0.0).token_ids
    got = model_engine.generate(NONREP, max_new_tokens=32, temperature=0.0).token_ids
    assert got == want
    mt = _tiers(model_engine).get("model", {"drafted": 0, "accepted": 0})
    assert mt["drafted"] > 0 and mt["accepted"] == mt["drafted"]
    assert model_engine.drafter_model.runs["draft"] > 0


def test_model_tier_stop_token_inside_draft(ref, model_engine):
    jeng, _ = ref
    free = jeng.generate(NONREP, max_new_tokens=24, temperature=0.0).token_ids
    stop_at = free[10]
    cut = free.index(stop_at)
    r = model_engine.generate(NONREP, max_new_tokens=24, temperature=0.0,
                              stop_tokens=[stop_at])
    assert r.token_ids == free[:cut] and r.finish_reason == "stop"


def test_bad_drafter_demotes_to_off_with_parity(ref):
    """A drafter at another seed proposes garbage: the verify rejects it,
    its probe fails and the row lands on "off", with parity."""
    jeng, params = ref
    eng = InferenceEngine("tiny-llama", params=params, device="cpu",
                          engine_config=EngineConfig(**dict(SPEC_KW, drafter="tiny-llama",
                                                            drafter_seed=1234)))
    try:
        want = jeng.generate(NONREP, max_new_tokens=24, temperature=0.0).token_ids
        assert eng.generate(NONREP, max_new_tokens=24, temperature=0.0).token_ids == want
        mt = _tiers(eng).get("model", {"drafted": 0, "accepted": 0})
        assert mt["drafted"] > 0 and mt["accepted"] < mt["drafted"]
    finally:
        eng.close()


def test_per_tier_counters_on_metrics(model_engine):
    model_engine.generate(NONREP, max_new_tokens=24, temperature=0.0)
    reg = get_registry()
    assert reg.counter("engine.spec_drafted").value(tier="model") > 0
    assert reg.counter("engine.spec_accepted").value(tier="model") > 0
    tiers = (model_engine.introspect.meter.refresh() or {}).get("spec_tiers", {})
    assert tiers["model"]["drafted"] > 0 and tiers["model"]["acceptance"] == 1.0
    text = reg.render()
    assert 'bee2bee_engine_spec_drafted_total{tier="model"}' in text
    assert re.search(r'^bee2bee_engine_spec_acceptance\{tier="model"\} 1(\.0)?$', text, re.M)
    assert model_engine.info["spec"]["tiers"]["model"]["drafted"] > 0
    assert model_engine.introspect.ledger.snapshot()["components"]["drafter"] > 0


def test_ngram_tier_still_first_on_repetitive_prompts(ref, model_engine):
    jeng, _ = ref
    before = _tiers(model_engine).get("ngram", {}).get("drafted", 0)
    want = jeng.generate(REP_PROMPT, max_new_tokens=30, temperature=0.0).token_ids
    assert model_engine.generate(REP_PROMPT, max_new_tokens=30,
                                 temperature=0.0).token_ids == want
    assert _tiers(model_engine)["ngram"]["drafted"] > before


# ------------------------------------------------- mesh tier, end to end


class _FakePeer:
    """In-process draft peer (the JAX test's): serves draft requests off a
    known greedy continuation on its own thread; ``stop_after`` kills it
    after that many served drafts."""

    def __init__(self, truth, k, stop_after=None):
        self.truth, self.k, self.stop_after = list(truth), k, stop_after
        self.served = 0
        self.md = None
        self._ctx: dict = {}
        self._q: queue.Queue = queue.Queue()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def send(self, payload):
        self._q.put(dict(payload))
        return True

    def close(self):
        self._q.put(None)
        self._t.join(timeout=5)

    def _run(self):
        while True:
            p = self._q.get()
            if p is None:
                return
            rid = p["rid"]
            if p.get("done"):
                self._ctx.pop(rid, None)
                continue
            base = int(p.get("base") or 0)
            ctx = self._ctx.setdefault(rid, [])
            if base == 0:
                ctx[:] = list(p["tokens"])
            elif base == len(ctx):
                ctx.extend(p["tokens"])
            else:
                self.md.deliver({"rid": rid, "reprime": True})
                continue
            if self.stop_after is not None and self.served >= self.stop_after:
                self.md.peer_lost()
                continue
            pos = len(ctx)
            self.served += 1
            self.md.deliver({"rid": rid, "pos": pos, "draft": self.truth[pos:pos + self.k]})


def test_mesh_tier_parity_then_peer_death_degrades_typed(ref):
    jeng, params = ref
    reg = get_registry()
    degraded0 = reg.counter("engine.spec_mesh_degraded").value(reason="peer_lost")
    want = jeng.generate(NONREP, max_new_tokens=40, temperature=0.0).token_ids
    eng = InferenceEngine("tiny-llama", params=params, device="cpu",
                          engine_config=EngineConfig(**dict(SPEC_KW, drafter="mesh")))
    md = eng.scheduler.mesh_drafter
    md.timeout_s = 30.0
    peer = _FakePeer(list(NONREP) + list(want), eng.engine_cfg.spec_tokens)
    peer.md = md
    md.attach_transport(peer.send)
    try:
        assert eng.generate(NONREP, max_new_tokens=40, temperature=0.0).token_ids == want
        mt = _tiers(eng).get("mesh", {"drafted": 0, "accepted": 0})
        assert mt["drafted"] > 0 and mt["accepted"] == mt["drafted"]
        peer.stop_after = peer.served
        r = eng.generate(NONREP, max_new_tokens=40, temperature=0.0)
        assert r.token_ids == want and len(r.token_ids) == 40
        assert md.dead and md.dead_reason == "peer_lost"
        assert reg.counter("engine.spec_mesh_degraded").value(reason="peer_lost") > degraded0
    finally:
        eng.close()
        peer.close()


@pytest.mark.async_timeout(120)
async def test_port_node_drafts_from_a_jax_draft_peer(ref):
    """A mixed mesh: a JAX node in the draft role hosts the JAX drafter
    (tiny-llama, seed 0: the target's weights); a port node serves the
    same weights with ``drafter="mesh"``. Its rows escalate to the mesh
    tier, drafts cross the packages, every draft is accepted and the
    greedy tokens equal the JAX engine's spec-off ones."""
    jeng, params = ref
    want = jeng.generate(NONREP, max_new_tokens=40, temperature=0.0).token_ids
    draft = JaxNode(host="127.0.0.1", port=0, disagg_role="draft", transport=JaxLoopback())
    serve = P2PNode(host="127.0.0.1", port=0, transport=LoopbackTransport())
    await draft.start()
    await serve.start()
    eng = None
    try:
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, lambda: draft.enable_draft_server(
            "tiny-llama", spec_tokens=6, dtype="float32", max_rows=2))
        served0 = jax_registry().counter("mesh.draft_served").total()
        eng = InferenceEngine("tiny-llama", params=params, device="cpu",
                              engine_config=EngineConfig(**dict(SPEC_KW, drafter="mesh")))
        serve.add_service(CUDAService("tiny-llama", engine=eng, device="cpu"))
        assert serve.draft_client is not None
        eng.scheduler.mesh_drafter.timeout_s = 30.0
        assert await draft.connect_bootstrap(serve.addr)
        for _ in range(200):
            if serve.peers and draft.peers:
                break
            await asyncio.sleep(0.05)
        await draft.gossip_telemetry()
        for _ in range(200):
            fresh = serve.health.fresh().get(draft.peer_id)
            if fresh and fresh.get("disagg_role") == "draft":
                break
            await asyncio.sleep(0.05)
        got = await asyncio.to_thread(eng.generate, NONREP, max_new_tokens=40,
                                      temperature=0.0)
        assert got.token_ids == want
        mt = _tiers(eng).get("mesh", {"drafted": 0, "accepted": 0})
        assert mt["drafted"] > 0 and mt["accepted"] == mt["drafted"]
        assert jax_registry().counter("mesh.draft_served").total() > served0
    finally:
        if eng is not None:
            eng.close()
        await serve.stop()
        await draft.stop()
