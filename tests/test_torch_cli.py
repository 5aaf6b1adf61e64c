"""The port's node entry points: ``serve-cuda``, ``build_service`` and
``run_p2p_node`` (``bee2bee_tpu_torch/__main__.py``,
``bee2bee_tpu_torch/meshnet/runtime.py``).

- ``build_service("cuda", ...)`` builds ``CUDAService`` on the card and,
  without one, raises the port's no-device error: no CPU fallback.
  ``build_service("tpu", ...)`` raises and names ``serve-cuda``.
- Every branch of the boot path that reaches a module the port does not
  have yet raises ``NotImplementedError`` naming its ROADMAP.md item, one
  case each: weights publish and mesh join, a checkpoint, LoRA, adapters,
  a mesh shape, the pipeline stage runner, the draft role, and KV
  migration export and import.
- ``NodeConfig().engine_config()`` is the port's ``EngineConfig`` with the
  ragged kernel's ``attention="auto"``.
- ``serve-cuda --help`` lists the options, and each option the port does
  not run fails with a ``click.UsageError`` naming its ROADMAP item.
- Without aiohttp, ``run_p2p_node(serve_api=True)`` raises and names it.
- Importing the node runtime and the gateway loads neither jax nor the
  JAX package, and ``get_accelerator_info`` reports the CPU without a card.
"""

from __future__ import annotations

import asyncio
import subprocess
import sys
from pathlib import Path

import pytest
from click.testing import CliRunner

from bee2bee_tpu_torch import adapters, transport
from bee2bee_tpu_torch.__main__ import cli
from bee2bee_tpu_torch.config import NodeConfig
from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
from bee2bee_tpu_torch.meshnet import runtime
from bee2bee_tpu_torch.meshnet.node import P2PNode
from bee2bee_tpu_torch.services.cuda import CUDAService
from bee2bee_tpu_torch.utils import get_accelerator_info

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(max_seq_len=64, dtype="float32", cache_dtype="float32",
            prefill_buckets=(16, 32, 64), max_batch=2)


def _cfg(**kw) -> NodeConfig:
    return NodeConfig(host="127.0.0.1", port=0, api_port=0, bootstrap_url="", **kw)


@pytest.fixture
def loopback(monkeypatch):
    """Nodes the runtime builds use the wscompat shim."""
    monkeypatch.setattr(transport, "_DEFAULT", transport.LoopbackTransport())


@pytest.fixture(scope="module")
def tiny_engine():
    eng = InferenceEngine("tiny-llama", device="cpu", engine_config=EngineConfig(**TINY))
    yield eng
    eng.close()


def test_build_service_cuda_needs_the_card():
    import torch

    if torch.cuda.is_available():
        svc = runtime.build_service("cuda", "tiny-llama", _cfg())
        assert type(svc) is CUDAService and svc.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.build_service("cuda", "tiny-llama", _cfg())


def test_build_service_tpu_names_serve_cuda():
    with pytest.raises(ValueError, match="serve-cuda"):
        runtime.build_service("tpu", "llama-3-8b", _cfg())


def test_node_config_builds_the_ports_engine_config():
    got = NodeConfig().engine_config()
    assert type(got) is EngineConfig and got.attention == "auto"
    assert got.cache_dtype == "bfloat16" and got.kv_pool_blocks is None
    assert NodeConfig(kv_quant=True).engine_config().cache_dtype == "int8"


def _run(**kw):
    return asyncio.run(runtime.run_p2p_node(
        registry_sync=False, serve_api=False, **kw))


def _boot(tiny_engine, monkeypatch, **kw):
    monkeypatch.setattr(runtime, "build_service", lambda backend, model, cfg, **_: CUDAService(
        model, engine=tiny_engine, device="cpu"))
    return _run(backend="cuda", model="tiny-llama", cfg=_cfg(), **kw)


def _part_load(tiny_engine):
    async def go():
        node = P2PNode(host="127.0.0.1", port=0, transport=transport.LoopbackTransport())
        await node._task_part_load(None, {"model": "tiny-llama", "task_id": "t1"})

    asyncio.run(go())


def _draft_role(tiny_engine):
    P2PNode(host="127.0.0.1", port=0).enable_draft_server("tiny-llama")


UNPORTED = {
    "publish_weights": (10, lambda e, mp: _boot(e, mp, publish_weights=True)),
    "from_mesh": (10, lambda e, mp: _run(backend="cuda", model="tiny-llama", cfg=_cfg(),
                                         from_mesh=True)),
    "checkpoint": (10, lambda e, mp: runtime.build_service(
        "cuda", "tiny-llama", _cfg(), checkpoint_path="/nonexistent")),
    "lora": (8, lambda e, mp: runtime.build_service(
        "cuda", "tiny-llama", _cfg(), lora_path="adapters.npz")),
    "adapters": (8, lambda e, mp: _run(backend="cuda", model="tiny-llama",
                                       cfg=_cfg(adapters="a=a.npz"))),
    "adapter_pool": (8, lambda e, mp: adapters.AdapterPool),
    "mesh_shape": (14, lambda e, mp: _run(backend="cuda", model="tiny-llama",
                                          cfg=_cfg(mesh_shape="data:1,model:8"))),
    "stage_runner": (13, lambda e, mp: _part_load(e)),
    "draft_role": (13, lambda e, mp: _draft_role(e)),
    "kv_migration_export": (9, lambda e, mp: e.scheduler.checkpoint(None)),
    "kv_migration_signature": (9, lambda e, mp: e.migration_signature()),
    "kv_migration_import": (9, lambda e, mp: e.import_generation({"prompt_ids": [1]})),
}


@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_branch_raises_by_name(case, tiny_engine, loopback, monkeypatch):
    item, call = UNPORTED[case]
    with pytest.raises(NotImplementedError, match=rf"ROADMAP\.md queue A item {item}\)"):
        call(tiny_engine, monkeypatch)


def test_serve_cuda_help_lists_the_options():
    out = CliRunner().invoke(cli, ["serve-cuda", "--help"])
    assert out.exit_code == 0, out.output
    for opt in ("--model", "--kv-quant", "--attention", "--port", "--api-port",
                "--bootstrap", "--price", "--tunnel"):
        assert opt in out.output
    assert "serve-fake" in CliRunner().invoke(cli, ["--help"]).output


@pytest.mark.parametrize("args,item", [
    (["--checkpoint", "ckpt"], 10), (["--lora", "a.npz"], 8),
    (["--quantize", "int8"], 5), (["--spec", "4"], 7), (["--drafter", "tiny-llama"], 7),
    (["--adapters", "a=a.npz"], 8), (["--max-adapters", "4"], 8),
    (["--mesh-shape", "model:8"], 14), (["--publish-weights"], 10), (["--from-mesh"], 10),
    (["--attention", "dense"], 12), (["--attention", "sp"], 14),
])
def test_serve_cuda_refuses_unported_options(args, item):
    out = CliRunner().invoke(cli, ["serve-cuda", "--model", "llama-3-8b", *args])
    assert out.exit_code == 2, out.output
    assert f"ROADMAP.md queue A item {item})" in out.output


def test_gateway_without_aiohttp_raises_and_names_it():
    code = (
        "import asyncio, sys\n"
        "sys.modules['aiohttp'] = None\n"
        "from bee2bee_tpu_torch import transport\n"
        "from bee2bee_tpu_torch.config import NodeConfig\n"
        "from bee2bee_tpu_torch.meshnet.runtime import run_p2p_node\n"
        "transport._DEFAULT = transport.LoopbackTransport()\n"
        "cfg = NodeConfig(host='127.0.0.1', port=0, api_port=0, bootstrap_url='')\n"
        "try:\n"
        "    asyncio.run(run_p2p_node(backend='fake', model='demo', cfg=cfg,\n"
        "                             registry_sync=False))\n"
        "except ImportError as e:\n"
        "    print(type(e).__name__, e)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "aiohttp" in out.stdout and "Error" in out.stdout


def test_node_runtime_and_gateway_load_no_jax():
    code = (
        "import sys\n"
        "import bee2bee_tpu_torch.meshnet.runtime, bee2bee_tpu_torch.api\n"
        "import bee2bee_tpu_torch.__main__\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'bee2bee_tpu', 'ml_dtypes')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_accelerator_info_without_a_card_is_the_cpu():
    import torch

    info = get_accelerator_info()
    if torch.cuda.is_available():
        assert info["platform"] == "gpu" and info["device_count"] >= 1
    else:
        assert info == {"platform": "cpu", "device_count": 0, "device_kinds": {},
                        "memory": None}
