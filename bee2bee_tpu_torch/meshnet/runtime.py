"""run_p2p_node: the node orchestrator (reference p2p_runtime.py:843-954).

Boot order mirrors the reference's serve() stack (SURVEY §3.1): start the WS
node → start the HTTP gateway → connect bootstrap → load the service in an
executor (announce when ready) → sync with the registry → run forever.

PyTorch port: a copy of ``bee2bee_tpu/meshnet/runtime.py`` with the import
root rewritten to ``bee2bee_tpu_torch``. ``build_service`` builds
``CUDAService`` for the ``"cuda"`` backend and refuses ``"tpu"``; the engine-
backed branches are gated on ``"cuda"``, and those reaching unported modules
(mesh weights, adapters, LoRA, a checkpoint) raise by name.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging

from ..clock import get_clock
from ..config import NodeConfig, load_config
from ..unported import unported
from ..utils import TaskTracker
from .node import P2PNode

logger = logging.getLogger("bee2bee_tpu_torch.runtime")


def build_service(backend: str, model: str, cfg: NodeConfig, **kw):
    """Service factory for the CLI/runtime (reference run_p2p_node's backend
    switch, p2p_runtime.py:891-902). The port's engine backend is "cuda":
    CUDAService on the card (``device=None``; it raises without one)."""
    if backend == "tpu":
        raise ValueError(
            "backend 'tpu' is the JAX package's (python -m bee2bee_tpu "
            "serve-tpu); the PyTorch port serves on the card with backend "
            "'cuda' (python -m bee2bee_tpu_torch serve-cuda)"
        )
    if backend == "cuda":
        from ..services.cuda import CUDAService

        if kw.get("checkpoint_path"):
            raise unported("serving a local checkpoint (--checkpoint)", 10)
        if kw.get("lora_path"):
            raise unported("merging LoRA adapters over the base (--lora)", 8)
        # the mesh shape (the parallel package) is refused by name inside
        # engine_config()
        return CUDAService(
            model,
            price_per_token=cfg.price_per_token,
            max_new_tokens=cfg.max_new_tokens,
            engine_config=cfg.engine_config(),
        )
    if backend == "ollama":
        from ..services.ollama import OllamaService

        return OllamaService(
            model,
            price_per_token=cfg.price_per_token,
            host=kw.get("ollama_host") or "http://127.0.0.1:11434",
            max_new_tokens=cfg.max_new_tokens,
        )
    if backend in ("hf_remote", "remote"):
        from ..services.remote import RemoteService

        return RemoteService(
            model, price_per_token=cfg.price_per_token, max_new_tokens=cfg.max_new_tokens
        )
    if backend == "fake":
        from ..services.fake import FakeService

        return FakeService(model, price_per_token=cfg.price_per_token)
    raise ValueError(f"unknown backend {backend!r} (cuda | ollama | hf_remote | fake)")


def parse_adapter_spec(spec: str) -> list[tuple[str, str]]:
    """Parse ``BEE2BEE_ADAPTERS`` / ``--adapters``: a comma-separated
    list of ``name=path.npz`` entries → [(name, path)]. Loud on junk —
    a silently-dropped adapter would serve the wrong tenant the base."""
    out: list[tuple[str, str]] = []
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, path = entry.partition("=")
        if not sep or not name.strip() or not path.strip():
            raise ValueError(
                f"bad adapter entry {entry!r}: expected name=path.npz"
            )
        out.append((name.strip(), path.strip()))
    return out


async def _preload_adapters(node, dht, svc, spec: str):
    """Load the configured adapters into the engine's pool, publish each
    as a pieces manifest on the DHT (peers page them in on demand), and
    announce residency. Failures are LOUD — the operator configured
    these adapters by name; serving without them is wrong output."""
    engine = getattr(svc, "engine", None)
    if engine is None or engine.adapter_pool is None:
        raise ValueError(
            "--adapters requires the cuda backend with max_adapters > 0"
        )
    # adapters/distrib.py and train/lora.py are not ported: raises by name
    from ..adapters import load_adapters, publish_adapter

    loop = asyncio.get_running_loop()
    for name, path in parse_adapter_spec(spec):
        adapters, lcfg = await loop.run_in_executor(
            None, lambda p=path: load_adapters(p, model_cfg=engine.model_cfg)
        )
        await loop.run_in_executor(
            None, lambda n=name, a=adapters, c=lcfg: engine.load_adapter(n, a, c)
        )
        if dht is not None:
            await publish_adapter(
                node, dht, engine.model_cfg.name, name, adapters, lcfg
            )
        logger.info("adapter %s loaded from %s", name, path)
    await node.announce_adapters(svc)


def _parse_dht_bootstrap(spec: str) -> list[tuple[str, int]]:
    """"host:port,[v6::addr]:port,barehost" → [(host, port), ...].

    Bare hosts (including bare IPv6 literals, which contain colons) get
    the default kademlia port 8468; a malformed port raises rather than
    silently mis-resolving far from the misconfiguration."""
    out: list[tuple[str, int]] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if entry.startswith("["):  # [v6]:port or [v6]
            host, _, rest = entry[1:].partition("]")
            port_s = rest.lstrip(":")
        elif entry.count(":") == 1:
            host, _, port_s = entry.partition(":")
        else:  # zero colons = bare hostname; 2+ = bare IPv6 literal
            host, port_s = entry, ""
        if not port_s:
            out.append((host, 8468))
        elif port_s.isdigit():
            out.append((host, int(port_s)))
        else:
            raise ValueError(f"bad dht bootstrap entry {entry!r}: invalid port")
    return out


async def run_p2p_node(
    backend: str | None = "cuda",
    model: str = "distilgpt2",
    cfg: NodeConfig | None = None,
    bootstrap: str | None = None,
    serve_api: bool = True,
    registry_sync: bool = True,
    checkpoint_path: str | None = None,
    lora_path: str | None = None,  # LoRA adapters .npz (train/lora.py)
    ollama_host: str | None = None,
    ready_event: asyncio.Event | None = None,
    shutdown_event: asyncio.Event | None = None,
    stage_runner=None,  # host a preloaded pipeline stage (backend=None)
    dht=None,  # DHTNode for weight distribution (created on demand)
    publish_weights: bool = False,  # announce this node's params as pieces
    from_mesh: bool = False,  # cuda backend: fetch weights from the mesh DHT
    post_start=None,  # async callback(node) after services are set up —
    # the serve-pipeline coordinator wires its stage workers here
    tunnel: str | None = None,  # bore|ngrok|cloudflared|stub|auto: expose the
    # WS port through a public tunnel and announce ITS address (cloud-node
    # onboarding — tunnel.py; supersedes NAT auto-forward when set)
):
    """Boot a full serving node; runs until shutdown_event (or forever)."""
    cfg = cfg or load_config()
    node = P2PNode(
        host=cfg.host,
        port=cfg.port,
        announce_host=cfg.announce_host,
        announce_port=cfg.announce_port,
        api_port=cfg.api_port if serve_api else None,
    )
    await node.start()

    # everything after start() runs under the teardown guard: a failed
    # service build/load must not leak the listening node/gateway/monitor
    api_runner = None
    registry_tasks = None
    forwarder = None
    tun = None
    own_dht = dht is None  # stop a DHT we created ourselves
    try:
        if tunnel:
            from .. import tunnel as tunnel_mod

            tun = await tunnel_mod.open_tunnel_async(node.port, provider=tunnel)
            link = tunnel_mod.apply_to_node(node, tun)
            logger.info(
                "tunnel (%s) up: %s — join link: %s", tun.provider, tun.ws_url, link
            )

        # Announce-address resolution (reference p2p_runtime.py:195-274): when
        # no explicit announce host was configured, try NAT auto-forward →
        # STUN/echo public IP in an executor so router round-trips never block
        # the loop.
        if tun is None and not cfg.announce_host and cfg.auto_nat:
            from .. import nat

            loop = asyncio.get_running_loop()
            forwarder = nat.PortForwarder()
            with contextlib.suppress(Exception):
                mapping = await asyncio.wait_for(  # meshlint: ignore[ML-C001] -- real NAT/STUN round trip in an executor thread
                    loop.run_in_executor(None, forwarder.auto_forward, node.port), 15.0
                )
                if mapping.ok and mapping.public_ip:
                    node.announce_host = mapping.public_ip
                    # "stun" is observe-only: its external_port is the NAT
                    # mapping of a throwaway UDP socket, not our listener —
                    # only real mappings may override the announce port
                    if mapping.external_port and mapping.method != "stun":
                        node.announce_port = mapping.external_port
                    logger.info(
                        "NAT %s: announcing %s:%s", mapping.method,
                        node.announce_host, node.announce_port,
                    )

        if serve_api:
            from ..api import start_api_server

            api_runner = await start_api_server(node, cfg.host, cfg.api_port, api_key=cfg.api_key)

        if bootstrap or cfg.bootstrap_url:
            with contextlib.suppress(Exception):
                await node.connect_bootstrap(bootstrap or cfg.bootstrap_url)

        if stage_runner is not None:
            node.add_stage_runner(stage_runner)
            logger.info(
                "hosting stage %s/%s of %s (layers %s); join link: %s",
                stage_runner.spec.stage + 1, stage_runner.spec.n_stages,
                model, stage_runner.info["layers"], node.join_link(),
            )
        # adapter paging (adapters/) rides the same DHT leg as weight
        # distribution: a node with an adapter pool needs one to fetch
        # non-resident adapters on demand, and one to publish its own
        wants_adapters = backend == "cuda" and (
            cfg.adapters or cfg.max_adapters > 0
        )
        if (publish_weights or from_mesh or wants_adapters) and dht is None:
            from ..dht import DHTNode

            dht = DHTNode(port=cfg.dht_port)
            await dht.start(_parse_dht_bootstrap(cfg.dht_bootstrap) or None)
        if dht is not None:
            node.dht = dht  # ensure_adapter's fetch path reads this

        if backend == "cuda" and node.disagg_role == "draft":
            # the draft disagg role hosts ONLY the drafter program
            # (meshnet/draft.py): no target engine, no gen_request
            # service — serving peers stream draft_request frames here.
            # Loaded in an executor (weights init/load is sync compute);
            # a bad drafter spec fails the boot typed (DrafterLoadError).
            drafter_model = (
                cfg.drafter if cfg.drafter and cfg.drafter != "mesh"
                else model
            )
            k = cfg.spec_tokens or 6
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(
                None,
                lambda: node.enable_draft_server(
                    "auto" if checkpoint_path else drafter_model,
                    spec_tokens=k, dtype=cfg.dtype,
                    checkpoint_path=checkpoint_path,
                ),
            )
            backend = None  # skip the target-service build below
            logger.info(
                "hosting draft role (%s, K=%s); join link: %s",
                drafter_model, k, node.join_link(),
            )

        if backend == "cuda" and from_mesh:
            if lora_path:
                # silently serving the base while the operator believes the
                # adapters are applied would be wrong outputs with no signal
                raise ValueError(
                    "--lora is not supported with --from-mesh (mesh-fetched "
                    "weights + local adapters): serve from a local "
                    "--checkpoint, or publish the merged weights"
                )
            # the zero-local-checkpoint join: manifest + pieces come from
            # mesh providers via the DHT (meshnet/weights.py)
            raise unported("joining with weights from the mesh (--from-mesh, meshnet/weights.py)", 10)
        elif backend is not None:
            svc = build_service(
                backend, model, cfg,
                checkpoint_path=checkpoint_path, lora_path=lora_path,
                ollama_host=ollama_host,
            )
            loop = asyncio.get_running_loop()
            if hasattr(svc, "load_sync"):
                await loop.run_in_executor(None, svc.load_sync)
            await node.announce_service(svc)
            logger.info("serving %s via %s; join link: %s", model, backend, node.join_link())
        elif stage_runner is None and node.draft_server is None:
            logger.info(
                "stage worker awaiting part_load for %s; join link: %s",
                model, node.join_link(),
            )

        if backend == "cuda" and cfg.adapters:
            # preload + publish the configured adapters (BEE2BEE_ADAPTERS
            # / serve-tpu --adapters): this node serves them immediately
            # and seeds the mesh so peers can page them in
            await _preload_adapters(node, dht, svc, cfg.adapters)

        if publish_weights and backend == "cuda":
            # publishes after a --from-mesh join too: a joined peer reseeds
            # the swarm as a new piece provider
            raise unported("publishing weights as pieces (--publish-weights, meshnet/weights.py)", 10)

        if registry_sync:
            from ..registry import RegistryClient

            client = RegistryClient()
            if client.enabled:
                registry_tasks = TaskTracker("runtime")
                registry_tasks.spawn(client.sync_loop(node))

        if post_start is not None:
            await post_start(node)
        if ready_event is not None:
            ready_event.set()
        if shutdown_event is not None:
            await shutdown_event.wait()
        else:
            while True:
                await get_clock().sleep(3600)
    finally:
        if tun is not None:
            with contextlib.suppress(Exception):
                tun.close()
        if own_dht and dht is not None:
            with contextlib.suppress(Exception):
                await dht.stop()
        if registry_tasks is not None:
            await registry_tasks.cancel_all()
        if api_runner is not None:
            await api_runner.cleanup()
        if forwarder is not None and forwarder.mappings:
            loop = asyncio.get_running_loop()
            with contextlib.suppress(Exception):
                await asyncio.wait_for(  # meshlint: ignore[ML-C001] -- real NAT teardown in an executor thread
                    loop.run_in_executor(None, forwarder.cleanup), 10.0
                )
        await node.stop()
    return node
