"""The port's mesh node (``bee2bee_tpu_torch/meshnet/``) in a mixed mesh with
the JAX package's node, on localhost.

Each package's node runs on its own ``LoopbackTransport`` (the wscompat
shim); the two copies frame alike, so JAX and CUDA nodes talk to each other
and nothing depends on the installed websockets.

- Mixed mesh: the hello handshake fills both peer tables; a join link made
  by one package parses alike in the other and bootstraps the link; each
  node lists the other's ``FakeService`` announce as a provider, and a
  generation crosses each way.
- Serving parity through the node: the same tiny-llama weights (the JAX
  ``init_params``, carried by ``params_from_numpy``) serve greedily behind
  a port node (``CUDAService(device="cpu")``) and a JAX node
  (``TPUService``). A client node requests the same prompts from each over
  the mesh: equal texts and token counts, streamed ``gen_chunk``s joined
  equal to the non-stream text, and the result dicts match key for key.
- A drain with no live generation completes on a node serving the port's
  engine.
"""

from __future__ import annotations

import asyncio
from contextlib import asynccontextmanager

import jax
import pytest
import torch

from bee2bee_tpu.engine import EngineConfig as JaxEngineConfig
from bee2bee_tpu.engine import InferenceEngine as JaxEngine
from bee2bee_tpu.joinlink import parse_join_link as jax_parse_join_link
from bee2bee_tpu.meshnet.node import P2PNode as JaxNode
from bee2bee_tpu.services.fake import FakeService as JaxFakeService
from bee2bee_tpu.services.tpu import TPUService
from bee2bee_tpu.transport import LoopbackTransport as JaxLoopback
from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
from bee2bee_tpu_torch.joinlink import parse_join_link
from bee2bee_tpu_torch.meshnet.node import P2PNode
from bee2bee_tpu_torch.models.config import get_config
from bee2bee_tpu_torch.models.params import params_from_numpy
from bee2bee_tpu_torch.services.cuda import CUDAService
from bee2bee_tpu_torch.services.fake import FakeService
from bee2bee_tpu_torch.transport import LoopbackTransport

KW = dict(max_seq_len=128, dtype="float32", cache_dtype="float32", kv_block_size=16,
          decode_chunk=4, prefill_buckets=(16, 32, 64), max_batch=4)
PROMPTS = ["user: hello there\nassistant:", "the quick brown fox jumps", "0123 4567 89ab"]
NEW_TOKENS = 12


def _jax_node():
    return JaxNode(host="127.0.0.1", port=0, transport=JaxLoopback())


def _port_node():
    return P2PNode(host="127.0.0.1", port=0, transport=LoopbackTransport())


@asynccontextmanager
async def running(*nodes):
    for node in nodes:
        await node.start()
    try:
        yield nodes
    finally:
        for node in nodes:
            await node.stop()


async def _settle(cond, timeout=10.0, interval=0.05):
    for _ in range(int(timeout / interval)):
        if cond():
            return True
        await asyncio.sleep(interval)
    return False


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's engine (CPU) on the same weights."""
    jax_engine = JaxEngine("tiny-llama", engine_config=JaxEngineConfig(**KW))
    params = params_from_numpy(jax.device_get(jax_engine.params), get_config("tiny-llama"),
                               "cpu", torch.float32)
    port_engine = InferenceEngine("tiny-llama", params=params, device="cpu",
                                  engine_config=EngineConfig(**KW))
    yield jax_engine, port_engine
    jax_engine.close()
    port_engine.close()


@pytest.mark.async_timeout(60)
async def test_mixed_mesh_handshake_join_link_and_announce():
    async with running(_jax_node(), _port_node()) as (j, t):
        for link in (j.join_link(), t.join_link()):
            assert parse_join_link(link) == jax_parse_join_link(link)
        # the port node bootstraps through the JAX node's join link
        assert await t.connect_bootstrap(j.join_link())
        assert await _settle(lambda: j.peers and t.peers)
        assert list(j.peers) == [t.peer_id] and list(t.peers) == [j.peer_id]
        assert j.peers[t.peer_id]["addr"] == t.addr
        assert t.peers[j.peer_id]["addr"] == j.addr

        j.add_service(JaxFakeService("jax-model", reply="from jax"))
        t.add_service(FakeService("port-model", reply="from the port"))
        await j.announce_service(j.local_services["fake"])
        await t.announce_service(t.local_services["fake"])
        assert await _settle(lambda: t.list_providers("jax-model")
                             and j.list_providers("port-model"))
        assert [p["provider_id"] for p in t.list_providers("jax-model")] == [j.peer_id]
        assert [p["provider_id"] for p in j.list_providers("port-model")] == [t.peer_id]
        a = await t.request_generation(j.peer_id, "ping", model="jax-model")
        b = await j.request_generation(t.peer_id, "ping", model="port-model")
        assert (a["text"], b["text"]) == ("from jax", "from the port")
        assert set(a) == set(b)


@pytest.mark.async_timeout(120)
async def test_greedy_text_equal_through_the_mesh(engines):
    jax_engine, port_engine = engines
    j, t, client = _jax_node(), _port_node(), _port_node()
    j.add_service(TPUService("tiny-llama", max_new_tokens=NEW_TOKENS, engine=jax_engine))
    t.add_service(CUDAService("tiny-llama", max_new_tokens=NEW_TOKENS, engine=port_engine,
                              device="cpu"))
    async with running(j, t, client):
        assert await client.connect_bootstrap(j.addr)
        assert await client.connect_bootstrap(t.join_link())
        await j.announce_service(j.local_services["tpu"])
        await t.announce_service(t.local_services["cuda"])
        assert await _settle(lambda: len(client.list_providers("tiny-llama")) == 2)
        backends = {p["provider_id"]: p.get("backend") for p in
                    client.list_providers("tiny-llama")}
        assert backends == {j.peer_id: "tpu", t.peer_id: "cuda"}
        for prompt in PROMPTS:
            ask = dict(model="tiny-llama", max_new_tokens=NEW_TOKENS, temperature=0.0)
            ours = await client.request_generation(t.peer_id, prompt, **ask)
            theirs = await client.request_generation(j.peer_id, prompt, **ask)
            assert ours["text"] == theirs["text"], prompt
            assert ours["tokens"] == theirs["tokens"] == NEW_TOKENS
            assert set(ours) == set(theirs)
            assert set(ours["timing"]) == set(theirs["timing"])
            chunks: dict[str, list] = {t.peer_id: [], j.peer_id: []}
            streamed = {
                pid: await client.request_generation(pid, prompt, on_chunk=chunks[pid].append,
                                                     **ask)
                for pid in chunks
            }
            for pid, parts in chunks.items():
                assert "".join(parts) == ours["text"], (prompt, pid)
            assert set(streamed[t.peer_id]) == set(streamed[j.peer_id])


@pytest.mark.async_timeout(60)
async def test_drain_with_no_live_generation_completes(engines):
    _, port_engine = engines
    t = _port_node()
    t.add_service(CUDAService("tiny-llama", max_new_tokens=4, engine=port_engine,
                              device="cpu"))
    async with running(t):
        summary = await t.migration.drain(wait=True)
        assert summary["draining"] and t.draining
        assert summary["migrated"] == summary["failed"] == 0
