"""CLI: `python -m bee2bee_tpu_torch <command>` — the port's click group:
`serve-cuda` boots a full mesh node (WebSocket mesh + aiohttp gateway)
whose service is the PyTorch engine on the CUDA card, and `serve-fake`
boots one over the deterministic fake backend.

PyTorch port of ``bee2bee_tpu/__main__.py``: `_setup_logging`,
`_apply_common_cfg`, `_serve` and `_common_opts` are copies with the
import root rewritten to ``bee2bee_tpu_torch``; `serve-cuda` takes
`serve-tpu`'s options, and each one the port does not run yet fails with
a `click.UsageError` naming its ROADMAP.md item. The JAX CLI's other
commands (stages, pipeline, web, train, export, registry, nat) are not
ported (ROADMAP.md queue A items 13, 15 and 16)."""

from __future__ import annotations

import asyncio
import logging
import os

import click

from . import __version__
from .config import load_config, save_config


def _setup_logging():
    fmt = "%(asctime)s %(name)s %(levelname)s %(message)s"
    logging.basicConfig(level=os.environ.get("LOG_LEVEL", "INFO"), format=fmt)
    # rotating file sink alongside stderr (the reference's loguru setup:
    # reference __main__.py:13-16). BEE2BEE_LOG_FILE overrides the path;
    # set it empty to disable. The default is per-PROCESS (pid suffix):
    # two processes rotating one shared file clobber each other's backups
    # — an explicit BEE2BEE_LOG_FILE opts into sharing deliberately.
    log_file = os.environ.get("BEE2BEE_LOG_FILE")
    if log_file is None:
        import contextlib
        import time as _time

        from .utils import bee2bee_home

        home = bee2bee_home()
        # reap per-pid logs of DEAD processes (>7 days) — a quiet but
        # live daemon's open log must never be unlinked out from under
        # its handler
        cutoff = _time.time() - 7 * 86400
        for old in home.glob("bee2bee-*.log*"):
            with contextlib.suppress(OSError, ValueError):
                pid = int(old.name.split("-", 1)[1].split(".", 1)[0])
                if pid == os.getpid():
                    continue
                try:
                    os.kill(pid, 0)  # raises if the pid is gone
                    continue  # still alive: keep its logs
                except ProcessLookupError:
                    pass
                except PermissionError:
                    continue  # alive under another uid
                if old.stat().st_mtime < cutoff:
                    old.unlink()
        log_file = str(home / f"bee2bee-{os.getpid()}.log")
    if log_file:
        from logging.handlers import RotatingFileHandler

        try:
            handler = RotatingFileHandler(
                log_file, maxBytes=5 * 1024 * 1024, backupCount=3
            )
            handler.setFormatter(logging.Formatter(fmt))
            logging.getLogger().addHandler(handler)
        except OSError:  # read-only fs etc. — stderr logging still works
            pass
    # orbax/absl emit per-save INFO floods; keep them at WARNING unless asked
    if os.environ.get("LOG_LEVEL", "INFO").upper() != "DEBUG":
        logging.getLogger("absl").setLevel(logging.WARNING)


def _apply_common_cfg(cfg, kw):
    """Fold _common_opts (and mesh shape) into the node config."""
    if kw.get("port") is not None:
        cfg.port = kw["port"]
    if kw.get("api_port") is not None:
        cfg.api_port = kw["api_port"]
    if kw.get("price") is not None:
        cfg.price_per_token = kw["price"]
    if kw.get("mesh_shape"):
        cfg.mesh_shape = kw["mesh_shape"]
    if kw.get("attention"):
        cfg.attention = kw["attention"]
    if kw.get("quantize"):
        cfg.quantize = kw["quantize"]
    if kw.get("kv_quant"):
        cfg.kv_quant = True
    if kw.get("paged"):
        cfg.paged = True
    if kw.get("spec_tokens") is not None:
        cfg.spec_tokens = kw["spec_tokens"]
    if kw.get("drafter") is not None:
        cfg.drafter = kw["drafter"]
    if kw.get("adapters"):
        cfg.adapters = kw["adapters"]
    if kw.get("max_adapters") is not None:
        cfg.max_adapters = kw["max_adapters"]
    return cfg


def _serve(backend: str, model: str, **kw):
    from .meshnet.runtime import run_p2p_node

    _setup_logging()
    cfg = _apply_common_cfg(load_config(), kw)
    try:
        asyncio.run(
            run_p2p_node(
                backend=backend,
                model=model,
                cfg=cfg,
                bootstrap=kw.get("bootstrap"),
                checkpoint_path=kw.get("checkpoint"),
                lora_path=kw.get("lora"),
                ollama_host=kw.get("ollama_host"),
                publish_weights=kw.get("publish_weights", False),
                from_mesh=kw.get("from_mesh", False),
                tunnel=kw.get("tunnel"),
            )
        )
    except KeyboardInterrupt:
        click.echo("shutting down")


def _microbatches_arg(ctx, param, value):
    """'auto' or an int >= 1 — validated at CLI parse, not minutes later
    inside the async serve body after the stages compiled."""
    if value == "auto":
        return value
    try:
        iv = int(value)
    except (TypeError, ValueError):
        raise click.BadParameter("must be 'auto' or a positive integer")
    if iv < 1:
        raise click.BadParameter("must be >= 1")
    return iv


def _common_opts(f):
    f = click.option("--port", type=int, default=None, help="WS mesh port")(f)
    f = click.option("--api-port", type=int, default=None, help="HTTP gateway port")(f)
    f = click.option("--bootstrap", default=None, help="bootstrap ws:// addr or join link")(f)
    f = click.option("--price", type=float, default=None, help="price per token")(f)
    f = click.option(
        "--tunnel",
        type=click.Choice(["auto", "bore", "ngrok", "cloudflared", "stub"]),
        default=None,
        help="expose this node through a public tunnel and announce its "
             "address (cloud/Colab onboarding — docs/CLOUD_NODE.md)",
    )(f)
    return f


@click.group()
@click.version_option(__version__)
def cli():
    """bee2bee-tpu-torch: the bee2bee mesh node on PyTorch and a CUDA card."""


# serve-tpu options the port does not run yet: option -> (flag, ROADMAP.md
# queue A item). Refused when set to anything but their off value.
_UNPORTED_OPTS = {
    "checkpoint": ("--checkpoint", 10),
    "lora": ("--lora", 8),
    "mesh_shape": ("--mesh-shape", 14),
    "adapters": ("--adapters", 8),
    "max_adapters": ("--max-adapters", 8),
    "publish_weights": ("--publish-weights", 10),
    "from_mesh": ("--from-mesh", 10),
}
# values of the choice options the port does not run yet
_UNPORTED_CHOICES = {
    ("quantize", "int8"): 5,
    ("attention", "dense"): 12,  # the dense no-cache forward
    ("attention", "sp"): 14,  # sequence-parallel serving over a mesh
}


def _refuse_unported(opts: dict) -> None:
    for name, (flag, item) in _UNPORTED_OPTS.items():
        if opts.get(name):
            raise click.UsageError(
                f"{flag} is not ported to PyTorch yet (ROADMAP.md queue A item {item})"
            )
    for (name, value), item in _UNPORTED_CHOICES.items():
        if opts.get(name) == value:
            raise click.UsageError(
                f"--{name} {value} is not ported to PyTorch yet "
                f"(ROADMAP.md queue A item {item})"
            )


@cli.command("serve-cuda")
@click.option("--model", default="llama-3-8b",
              help="registry model name (random weights from seed 0); the "
                   "port serves the llama architecture")
@click.option("--checkpoint", default=None, help="local checkpoint dir (not ported)")
@click.option("--lora", default=None, help="LoRA adapters .npz (not ported)")
@click.option("--mesh-shape", default=None, help="device mesh (not ported)")
@click.option("--attention", type=click.Choice(["auto", "dense", "flash", "sp"]), default=None,
              help="auto | flash: the ragged paged CUDA attention kernels "
                   "(dense and sp are not ported)")
@click.option("--quantize", type=click.Choice(["none", "int8"]), default=None,
              help="weight-only quantization (int8 is not ported)")
@click.option("--kv-quant", "kv_quant", is_flag=True, default=False,
              help="int8 KV pool: pages stored int8 with per-page-per-head "
                   "scales, dequantized inside the attention kernels "
                   "(BEE2BEE_KV_QUANT; bf16 pool default)")
@click.option("--paged", is_flag=True, default=False,
              help="DEPRECATED no-op: the paged KV block pool is the only "
                   "cache layout")
@click.option("--spec", "spec_tokens", type=int, default=None,
              help="self-speculative decoding: draft up to this many tokens "
                   "per step and verify them in one [B, K+1] forward "
                   "(BEE2BEE_SPEC; 0 = off)")
@click.option("--drafter", default=None,
              help="model-tier drafter: a registry name loaded beside the "
                   "target (random init), or 'mesh' for a draft-role peer "
                   "(BEE2BEE_DRAFTER; needs --spec)")
@click.option("--adapters", default=None, help="multi-LoRA adapters (not ported)")
@click.option("--max-adapters", "max_adapters", type=int, default=None,
              help="adapter pool slots (not ported)")
@click.option("--publish-weights", is_flag=True,
              help="announce this node's params as DHT pieces (not ported)")
@click.option("--from-mesh", is_flag=True,
              help="fetch weights from mesh providers (not ported)")
@_common_opts
def serve_cuda(model, checkpoint, lora, mesh_shape, attention, quantize,
               kv_quant, paged, spec_tokens, drafter, adapters, max_adapters,
               publish_weights, from_mesh, **kw):
    """Serve a model on the CUDA card through the PyTorch engine."""
    _refuse_unported(dict(
        checkpoint=checkpoint, lora=lora, mesh_shape=mesh_shape,
        attention=attention, quantize=quantize, adapters=adapters,
        max_adapters=max_adapters, publish_weights=publish_weights,
        from_mesh=from_mesh,
    ))
    _serve(
        "cuda", model, attention=attention, kv_quant=kv_quant, paged=paged,
        spec_tokens=spec_tokens, drafter=drafter, **kw
    )


@cli.command("serve-fake")
@click.option("--model", default="fake-model")
@_common_opts
def serve_fake(model, **kw):
    """Serve a deterministic fake backend (testing/demo)."""
    _serve("fake", model, **kw)


if __name__ == "__main__":
    cli()
