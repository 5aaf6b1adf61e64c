"""Batched multi-LoRA serving: one resident base model, N hot-swappable
adapters (ROADMAP item 1).

- ``pool`` — AdapterPool: stacked per-target A/B factors on device, per-
  row slot gather inside the jitted step (models/core.lora_matmul),
  LRU slot recycling guarded by in-flight refcounts.
- ``distrib`` — adapters as sha256-verified pieces manifests on the DHT
  (the weights publish→DHT→fetch leg, at adapter scale): publish once,
  any node pages the factors in without restarting its engine.

Naming: a served adapter model is ``<base>:<adapter>`` (``/v1`` model
ids, mesh hello/announce, router placement) — ``split_model_adapter``
is the ONE parser every surface shares.

PyTorch port: a copy of ``bee2bee_tpu/adapters/__init__.py`` with the import
root rewritten to ``bee2bee_tpu_torch``. The pool, distrib and LoRA names
raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

class UnknownAdapter(KeyError):
    """The requested adapter is not resident (and could not be resolved).
    Typed so the serving surfaces answer a clean 404 / unknown_adapter
    instead of a generic failure. Lives HERE (not pool.py) so api.py and
    meshnet can catch it without importing the jax-heavy pool."""

    def __str__(self):  # KeyError quotes its arg; keep the message usable
        return self.args[0] if self.args else "unknown adapter"


class AdapterPoolBusy(RuntimeError):
    """Every slot's adapter has in-flight rows — nothing can be evicted.
    Backpressure, not corruption: the caller retries or routes elsewhere."""


# the pool (adapters/pool.py), its DHT leg (adapters/distrib.py) and
# the train.lora machinery behind them are not ported: this package root
# keeps only the naming helpers meshnet/node.py and api.py pull on every
# boot, and the heavy names raise by name
_LAZY = {
    "AdapterPool": "the multi-LoRA adapter pool (adapters/pool.py)",
    "AdapterLoadError": "LoRA adapter loading (train/lora.py)",
    "load_adapters": "LoRA adapter loading (train/lora.py)",
    "UnknownAdapterManifest": "paging adapters over the mesh (adapters/distrib.py)",
    "fetch_adapter": "paging adapters over the mesh (adapters/distrib.py)",
    "publish_adapter": "publishing adapters on the DHT (adapters/distrib.py)",
}


def __getattr__(name: str):
    if name in _LAZY:
        from ..unported import unported

        raise unported(_LAZY[name], 8)
    raise AttributeError(name)

# wire-safety clamp for the gen_request `adapter` key: names key metric
# labels and DHT keys, so an unbounded or exotic wire string must reduce
# to None (→ typed unknown_adapter) rather than flow onward
MAX_ADAPTER_NAME = 64


def clamp_adapter_name(name) -> str | None:
    """A wire-supplied adapter claim → a sane name or None. ':' is the
    model separator and '/' the DHT key separator — a name containing
    either could alias another adapter's key."""
    if not isinstance(name, str) or not name:
        return None
    if len(name) > MAX_ADAPTER_NAME or ":" in name or "/" in name:
        return None
    return name


def split_model_adapter(model) -> tuple[str | None, str | None]:
    """``"<base>:<adapter>"`` → (base, adapter); a plain model name (or
    None) passes through with adapter None. Only the FIRST colon splits.
    The adapter half is returned RAW — callers clamp it and must treat a
    clamp failure as a typed unknown_adapter, never as "no adapter":
    collapsing a malformed name to None here would silently serve the
    plain base model to a tenant that asked for an adapter."""
    if not isinstance(model, str) or ":" not in model:
        return model, None
    base, _, name = model.partition(":")
    return base or None, name


def adapter_model_name(base: str, adapter: str) -> str:
    return f"{base}:{adapter}"
