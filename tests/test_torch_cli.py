"""The port's node entry points: ``serve-cuda``, ``build_service`` and
``run_p2p_node`` (``bee2bee_tpu_torch/__main__.py``,
``bee2bee_tpu_torch/meshnet/runtime.py``).

- ``build_service("cuda", ...)`` builds ``CUDAService`` on the card and,
  without one, raises the port's no-device error: no CPU fallback.
  ``build_service("tpu", ...)`` raises and names ``serve-cuda``.
- Every branch of the boot path that reaches a module the port does not
  have yet raises ``NotImplementedError`` naming its ROADMAP.md item, one
  case each: weights publish and mesh join, a checkpoint, LoRA, adapters,
  a mesh shape, the pipeline stage runner, and KV migration export and
  import. The draft role runs: a port node hosts the drafter and serves a
  draft.
- ``NodeConfig().engine_config()`` is the port's ``EngineConfig`` with the
  ragged kernel's ``attention="auto"``.
- ``serve-cuda --help`` lists the options, and each option the port does
  not run fails with a ``click.UsageError`` naming its ROADMAP item;
  ``--spec`` and ``--drafter`` reach the node's config.
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


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32_pool", "int8_pool"])
def test_f32_node_config_passes_the_card_check(kv_quant):
    """BEE2BEE_DTYPE=float32 (``NodeConfig.dtype``) serves f32 on the card:
    the pool follows the engine's type (or is int8 with --kv-quant), which
    the card's kernels take; a bf16 pool beside f32 queries is refused."""
    from bee2bee_tpu_torch.engine.engine import check_card_supported
    from bee2bee_tpu_torch.models.config import get_config

    ecfg = NodeConfig(dtype="float32", kv_quant=kv_quant).engine_config()
    assert ecfg.dtype == "float32"
    assert ecfg.cache_dtype == ("int8" if kv_quant else "float32")
    check_card_supported(get_config("llama-3-8b"), ecfg, "cuda")
    with pytest.raises(NotImplementedError, match="cache_dtype='bfloat16'"):
        check_card_supported(get_config("llama-3-8b"),
                             EngineConfig(dtype="float32", cache_dtype="bfloat16"), "cuda")


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


def test_draft_role_hosts_the_drafter_and_drafts():
    """The draft disagg role: the node hosts a DraftModel (warmed at
    boot), which drafts K greedy tokens for a context."""
    node = P2PNode(host="127.0.0.1", port=0)
    node.enable_draft_server("tiny-llama", spec_tokens=4, max_rows=2, device="cpu")
    srv = node.draft_server
    try:
        assert srv.drafter.cfg.name == "tiny-llama" and srv.drafter.runs["draft"] == 1

        class _Row:
            ids, out_ids = [5, 6, 7, 8, 9, 10], []

        out = srv._propose(_Row())
        assert len(out[0]) == 4 and all(0 <= t < srv.drafter.cfg.vocab_size
                                        for t in out[0])
    finally:
        srv.close()


@pytest.mark.parametrize("args,field,value", [
    (["--spec", "4"], "spec_tokens", 4),
    (["--spec", "4", "--drafter", "tiny-llama"], "drafter", "tiny-llama"),
])
def test_serve_cuda_passes_spec_options_to_the_node(args, field, value, monkeypatch):
    from bee2bee_tpu_torch import __main__ as main

    seen = {}
    monkeypatch.setattr(main, "_serve", lambda backend, model, **kw: seen.update(
        main._apply_common_cfg(NodeConfig(), kw).to_dict(), backend=backend))
    out = CliRunner().invoke(cli, ["serve-cuda", "--model", "tiny-llama", *args])
    assert out.exit_code == 0, out.output
    assert seen["backend"] == "cuda" and seen[field] == value
    # the config the node's engine is built from takes them
    ecfg = NodeConfig(**{k: v for k, v in seen.items() if k != "backend"}).engine_config()
    assert getattr(ecfg, field) == value


# each case keeps the id it had while --spec and --drafter (args3, args4)
# were refused too
@pytest.mark.parametrize("args,item", [
    (["--checkpoint", "ckpt"], 10), (["--lora", "a.npz"], 8),
    (["--quantize", "int8"], 5),
    (["--adapters", "a=a.npz"], 8), (["--max-adapters", "4"], 8),
    (["--mesh-shape", "model:8"], 14), (["--publish-weights"], 10), (["--from-mesh"], 10),
    (["--attention", "dense"], 12), (["--attention", "sp"], 14),
], ids=[f"args{i}-{item}" for i, item in zip((0, 1, 2, 5, 6, 7, 8, 9, 10, 11),
                                              (10, 8, 5, 8, 8, 14, 10, 10, 12, 14))])
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
