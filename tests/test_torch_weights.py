"""The port's weight pieces and mesh join (``bee2bee_tpu_torch/pieces.py``,
``bee2bee_tpu_torch/meshnet/weights.py``) against the JAX package, tiny
sizes, both packages' nodes on loopback links in one mesh.

- A manifest the port builds for a parameter tree equals JAX's piece for
  piece (path, shape, dtype string, bytes, sha256) for tensors under the
  frame budget, in f32 and bf16.
- Above the budget (a small test budget here) a tensor becomes shards
  along one axis, every piece within the budget; JAX's ``load_native``
  and JAX's ``fetch_model_from_mesh`` reassemble the port's split
  manifest bit for bit.
- A port node joins from a JAX node's published tiny-llama, and a JAX
  node from a port node's split manifest: the joined weights equal the
  publisher's, and the greedy text the JAX engine's on those weights.
- A coordinate fetch of a split tensor raises by item 14; a piece no
  provider serves fails the join, typed.
- bf16 pieces build and decode with ml_dtypes blocked from import.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from contextlib import asynccontextmanager
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee2bee_tpu import pieces as jpieces
from bee2bee_tpu.engine import EngineConfig as JaxEngineConfig
from bee2bee_tpu.engine import InferenceEngine as JaxEngine
from bee2bee_tpu.meshnet import weights as jweights
from bee2bee_tpu.meshnet.node import P2PNode as JaxNode
from bee2bee_tpu.models import config as jconfig
from bee2bee_tpu.models import core as jcore
from bee2bee_tpu.models import loader as jloader
from bee2bee_tpu.transport import LoopbackTransport as JaxLoopback
from bee2bee_tpu_torch import pieces
from bee2bee_tpu_torch.dht import DHTNode
from bee2bee_tpu_torch.engine import EngineConfig
from bee2bee_tpu_torch.meshnet import weights
from bee2bee_tpu_torch.meshnet.node import P2PNode
from bee2bee_tpu_torch.models import config, loader
from bee2bee_tpu_torch.models.params import params_from_numpy
from bee2bee_tpu_torch.transport import LoopbackTransport

ROOT = Path(__file__).resolve().parent.parent
NAME = "tiny-llama"
KW = dict(max_seq_len=128, dtype="float32", cache_dtype="float32", kv_block_size=16,
          decode_chunk=4, prefill_buckets=(16, 32, 64), max_batch=4)
PROMPT = "mesh-born model"
BUDGET = 4096  # bytes: splits tok_embed, every weight and none of the norms


def _tree(dtype="float32"):
    tree = jax.device_get(jcore.init_params(jconfig.get_config(NAME), jax.random.key(0),
                                            dtype=jnp.float32))
    return jax.tree.map(lambda a: np.asarray(a).astype(jnp.dtype(dtype)), tree)


def _params(dtype="float32"):
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return params_from_numpy(_tree(dtype), config.get_config(NAME), "cpu", tdtype)


def _assert_flat_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if w.dtype.itemsize == 2:
            g, w = g.view(np.uint16), w.view(np.uint16)
        assert g.shape == w.shape and np.array_equal(g, w), k


@pytest.fixture(scope="module")
def want_text():
    """The JAX engine's greedy text on the published weights."""
    eng = JaxEngine(NAME, _tree(), engine_config=JaxEngineConfig(**KW))
    yield eng.generate(PROMPT, max_new_tokens=8, temperature=0.0).text
    eng.close()


@pytest.fixture
def small_budget(monkeypatch):
    monkeypatch.setattr(pieces, "DEFAULT_PIECE_SIZE", BUDGET)


@asynccontextmanager
async def nodes(*kinds):
    made = [JaxNode(host="127.0.0.1", port=0, transport=JaxLoopback()) if k == "jax"
            else P2PNode(host="127.0.0.1", port=0, transport=LoopbackTransport())
            for k in kinds]
    dht = DHTNode()
    await dht.start()
    for n in made:
        await n.start()
    try:
        yield dht, made
    finally:
        for n in made:
            await n.stop()
        await dht.stop()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_manifest_equals_jax_piece_for_piece_under_the_budget(dtype):
    jflat = jloader._flatten(_tree(dtype))
    jm, jblobs = jpieces.build_shard_manifest(NAME, jflat, {k: () for k in jflat}, {})
    flat = loader._flatten(_params(dtype))
    m, blobs = pieces.build_shard_manifest(NAME, flat, {k: () for k in flat}, {})
    assert [dataclasses.asdict(p) for p in m.pieces] == \
        [dataclasses.asdict(p) for p in jm.pieces]
    assert blobs == jblobs and m.to_json() == jm.to_json()
    assert all(p.shard_count == 1 for p in m.pieces)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_manifest_fits_the_budget_and_jax_load_native_reassembles(
        dtype, small_budget, tmp_path):
    cfg = config.get_config(NAME)
    manifest = loader.save_native(_params(dtype), cfg, tmp_path)
    split = [p for p in manifest.pieces if p.shard_count > 1]
    assert split and all(p.nbytes <= BUDGET for p in manifest.pieces)
    assert all(p.mesh_axis is None and p.axis is not None for p in split)
    assert {p.param for p in split} >= {"tok_embed", "layers/attn/wq", "layers/mlp/w_up"}
    want = jloader._flatten(_tree(dtype))
    _assert_flat_equal(jloader._flatten(jloader.load_native(
        tmp_path, dtype=jnp.dtype(dtype), host=True)), want)
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    _assert_flat_equal(loader._flatten(loader.load_native(tmp_path, device="cpu",
                                                          dtype=tdtype)), want)


async def test_jax_node_joins_from_a_port_publishers_split_manifest(small_budget, want_text):
    async with nodes("port", "jax") as (dht, (p, j)):
        manifest = await weights.publish_model_weights(p, dht, config.get_config(NAME),
                                                       _params())
        assert any(x.shard_count > 1 for x in manifest.pieces)
        _, flat = await jweights.fetch_model_from_mesh(j, dht, NAME)
        _assert_flat_equal(flat, jloader._flatten(_tree()))
        svc = await jweights.serve_model_from_mesh(
            j, dht, NAME, engine_config=JaxEngineConfig(**KW))
        try:
            out = svc.execute({"prompt": PROMPT, "max_new_tokens": 8, "temperature": 0.0})
            assert out["text"] == want_text
        finally:
            svc.engine.close()


async def test_port_node_joins_from_a_jax_publisher(want_text):
    async with nodes("jax", "port") as (dht, (j, p)):
        await jweights.publish_model_weights(j, dht, jconfig.get_config(NAME), _tree(),
                                             mesh_axes={})
        assert not p.peers and not p.piece_store
        stats = {}
        svc = await weights.serve_model_from_mesh(
            p, dht, NAME, engine_config=EngineConfig(**KW), device="cpu", stats=stats)
        try:
            assert any(i["addr"] == j.addr for i in p.peers.values())
            assert stats["pieces"] > 0 and stats["bytes"] > 0
            assert NAME in p.local_services["cuda"].get_metadata()["models"]
            _assert_flat_equal(loader._flatten(svc.engine.params), jloader._flatten(_tree()))
            out = svc.execute({"prompt": PROMPT, "max_new_tokens": 8, "temperature": 0.0})
            assert out["text"] == want_text
        finally:
            svc.engine.close()


async def test_coordinate_fetches_of_split_tensors_raise_by_item_14(small_budget):
    async with nodes("port", "port") as (dht, (a, c)):
        manifest = await weights.publish_model_weights(a, dht, config.get_config(NAME),
                                                       _params())
        with pytest.raises(NotImplementedError, match=r"item 14\)"):
            await weights.fetch_model_from_mesh(c, dht, NAME, coords={"model": 0})
        with pytest.raises(NotImplementedError, match=r"split into .* item 14\)"):
            pieces.assemble_params_from_pieces(manifest, a.piece_store, {"model": 0})
        with pytest.raises(NotImplementedError, match=r"item 14\)"):
            await weights.publish_model_weights(a, dht, config.get_config(NAME),
                                                _params(), mesh_axes={"model": 2})


async def test_a_piece_no_provider_serves_fails_the_join():
    async with nodes("port", "port") as (dht, (a, c)):
        manifest = await weights.publish_model_weights(a, dht, config.get_config(NAME),
                                                       _params())
        a.piece_store[manifest.pieces[0].sha256] = b"corrupt" * 10
        with pytest.raises(RuntimeError, match="no provider served piece"):
            await weights.serve_model_from_mesh(c, dht, NAME, device="cpu",
                                                engine_config=EngineConfig(**KW))
        assert "cuda" not in c.local_services
        with pytest.raises(RuntimeError, match="no manifest"):
            await weights.fetch_model_from_mesh(c, dht, "tiny-mistral")


def test_bf16_pieces_build_and_decode_without_ml_dtypes():
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import numpy as np, torch\n"
        "from bee2bee_tpu_torch import pieces\n"
        "from bee2bee_tpu_torch.models import loader\n"
        "from bee2bee_tpu_torch.models.config import get_config\n"
        "from bee2bee_tpu_torch.models.params import init_params\n"
        "pieces.DEFAULT_PIECE_SIZE = 4096\n"
        "cfg = get_config('tiny-llama')\n"
        "g = torch.Generator(); g.manual_seed(0)\n"
        "p = init_params(cfg, g, 'cpu', torch.bfloat16)\n"
        "flat = loader._flatten(p)\n"
        "m, blobs = pieces.build_shard_manifest(cfg.name, flat, {k: () for k in flat}, {})\n"
        "assert {x.dtype for x in m.pieces} == {'bfloat16'}\n"
        "back = loader._unflatten(pieces.reassemble(m, blobs))\n"
        "from bee2bee_tpu_torch.models.params import params_from_numpy\n"
        "q = params_from_numpy(back, cfg, 'cpu', torch.bfloat16)\n"
        "assert all(torch.equal(a, b) for a, b in zip(\n"
        "    (q['tok_embed'], q['layers'][1]['mlp']['w_up']),\n"
        "    (p['tok_embed'], p['layers'][1]['mlp']['w_up'])))\n"
        "assert 'ml_dtypes' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
