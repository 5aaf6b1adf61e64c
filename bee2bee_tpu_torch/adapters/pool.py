"""AdapterPool: N hot-swappable LoRA adapters resident over ONE base model.

The pool keeps every adapter's low-rank A/B factors stacked on the device —

    {target: {"a": [L, N+1, din, r], "b": [L, N+1, r, dout]}}  (f32)

— and the serving step gathers each batch ROW's slot
(models/core.lora_matmul), so a mixed batch serves N tenants in one
forward. Slot 0 is the reserved NULL adapter (all-zero factors, scaling
0): adapter-less rows in a mixed batch gather zeros and stay exact, and a
batch with no adapter rows skips the lora arguments entirely (the
scheduler's batch-level flag).

Geometry is fixed by the FIRST adapter loaded: layer layout from the model
config, rank = that adapter's rank, targets = its target set. Later
adapters may use a smaller rank (factors zero-pad to the pool rank — the
delta is unchanged) and any subset of the pool's targets (missing targets
stay zero); a larger rank or a new target is a typed AdapterLoadError.

Slots recycle LRU among adapters with no in-flight rows: the scheduler
acquire()s a slot at admission and release()s it at retirement, so a
hot-swap can never take the factors from under a live generation; a
refresh of an adapter with rows in flight is refused (AdapterPoolBusy).

The port of ``bee2bee_tpu/adapters/pool.py``. What differs: the JAX pool
swaps fresh arrays in on every load, and an in-flight step keeps the
arrays it was dispatched with. The port's serving roots are CUDA graphs
that hold the ADDRESSES of the stacks and the scales, so here

- the stacks and the [N+1] scales are allocated once, at the first load,
  and keep their storage for the pool's life;
- every later load, refresh or eviction writes them IN PLACE, through
  ``run``: the engine hands its scheduler's ``run_on_device``, so the
  slot decision, the device writes and the publish run on the scheduler
  thread between two of its passes, inside its device pass, in stream
  order after every step already dispatched (none of which reads the
  slot: a slot is written only with no row on it) and before the next;
  and an admission (acquire, on the same thread) can never interleave
  with a write.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..engine.introspect import device_gate
from ..metrics import get_registry
from ..train.lora import (
    ATTN_TARGETS,
    MLP_TARGETS,
    AdapterLoadError,
    LoraConfig,
    adapter_target_io,
    validate_adapter_shapes,
)
from . import AdapterPoolBusy, UnknownAdapter

# pool observability: residency gauge, load/evict counters, and per-adapter
# request counts (the JAX metric names). The `adapter` label is bounded by
# what the pool ever admitted: the scheduler counts only RESOLVED slots
_G_RESIDENT = get_registry().gauge(
    "adapter.pool_resident", "LoRA adapters resident in the pool"
)
_C_LOADS = get_registry().counter(
    "adapter.pool_loads", "adapters loaded (fresh or refreshed) into the pool"
)
_C_EVICTED = get_registry().counter(
    "adapter.pool_evicted", "adapters evicted from the pool"
)
_C_REQUESTS = get_registry().counter(
    "adapter.requests", "generations admitted per adapter"
)


def _run_here(fn):
    """The default ``run``: the caller's own thread, inside a device pass
    (a pool with no scheduler beside it, as in the tests)."""
    with device_gate.device_pass():
        return fn()


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


class AdapterPool:
    """See the module docstring. Thread-safety: ``_lock`` guards the host
    maps (slots, names, refcounts); ``_io_lock`` serialises writers over
    their host prep and device write."""

    def __init__(self, model_cfg, slots: int, device=None):
        if slots < 1:
            raise ValueError(f"adapter pool needs >= 1 slot, got {slots}")
        self.model_cfg = model_cfg
        self.slots = int(slots)
        self.device = torch.device(device or "cpu")
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        # geometry (rank/targets) binds on the first load
        self.rank: int | None = None
        self.targets: tuple | None = None
        self._device: dict | None = None  # {t: {"a","b"}} stacked, fixed storage
        self._scales: torch.Tensor | None = None  # [slots+1] f32 (slot 0 -> 0.0)
        self._by_name: dict[str, int] = {}  # name -> slot (1-based)
        self._by_slot: dict[int, str] = {}
        self._refs: dict[int, int] = {}  # slot -> in-flight rows
        self._tick = 0  # LRU clock
        self._last_used: dict[int, int] = {}
        self.loads = 0
        self.evictions = 0

    # ------------------------------------------------------------ geometry

    def _ensure_geometry(self, lcfg: LoraConfig):
        """Allocate the stacks at the first load (device work: call inside
        ``run``)."""
        if self.rank is not None:
            return
        for t in lcfg.targets:
            if t not in ATTN_TARGETS + MLP_TARGETS:
                raise AdapterLoadError(f"unknown adapter target {t!r}")
        io = adapter_target_io(self.model_cfg)
        L = self.model_cfg.n_layers
        N = self.slots + 1  # + the null slot 0
        rank = int(lcfg.rank)
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                           device=self.device)
        self._device = {
            t: {"a": zeros(L, N, io[t][0], rank), "b": zeros(L, N, rank, io[t][1])}
            for t in lcfg.targets
        }
        self._scales = zeros(N)
        self.rank, self.targets = rank, tuple(lcfg.targets)

    # ------------------------------------------------------------ load/evict

    def _pick_slot(self) -> int:
        free = [s for s in range(1, self.slots + 1) if s not in self._by_slot]
        if free:
            return free[0]
        idle = [s for s in range(1, self.slots + 1) if self._refs.get(s, 0) == 0]
        if not idle:
            raise AdapterPoolBusy(
                f"all {self.slots} adapter slots have in-flight rows"
            )
        victim = min(idle, key=lambda s: self._last_used.get(s, 0))
        name = self._by_slot.pop(victim)
        self._by_name.pop(name, None)
        self.evictions += 1
        _C_EVICTED.inc()
        return victim

    def _write_slot(self, host: dict, slot: int) -> None:
        """Write ``slot``'s factors in place from the host-prepped
        ``host`` map (None entry = zero the target), queued on the current
        stream (pinned sources on the card)."""
        for t in self.targets:
            stack = self._device[t]
            pair = host.get(t)
            for key, idx in (("a", 0), ("b", 1)):
                dst = stack[key][:, slot]
                if pair is None:
                    dst.zero_()
                    continue
                src = torch.from_numpy(np.ascontiguousarray(pair[idx]))
                if dst.is_cuda:
                    src = src.pin_memory()
                dst.copy_(src, non_blocking=dst.is_cuda)

    def _publish_locked(self, name: str, slot: int, lcfg: LoraConfig) -> int:
        self._scales[slot].fill_(float(lcfg.scaling))
        self._by_name[name] = slot
        self._by_slot[slot] = name
        self._tick += 1
        self._last_used[slot] = self._tick
        self.loads += 1
        _C_LOADS.inc()
        _G_RESIDENT.set(len(self._by_name))
        return slot

    def load(self, name: str, adapters: dict, lcfg: LoraConfig, run=None) -> int:
        """Pin `name`'s factors into a slot (fresh, refreshed in place, or
        LRU-evicting a cold adapter). Validates shapes against the pool
        geometry FIRST — a rank/target mismatch is a typed
        AdapterLoadError with the pool untouched. Returns the slot.
        ``run(fn)`` runs the device part (see the module docstring);
        default: this thread, inside a device pass."""
        if not name or not isinstance(name, str):
            raise AdapterLoadError(f"adapter name must be a string, got {name!r}")
        run = run or _run_here
        with self._io_lock:
            with self._lock:
                rank, targets = self.rank, self.targets
            validate_adapter_shapes(self.model_cfg, adapters, lcfg, max_rank=rank)
            if targets is not None:
                extra = set(lcfg.targets) - set(targets)
                if extra:
                    raise AdapterLoadError(
                        f"adapter {name!r} targets {sorted(extra)} not in pool "
                        f"targets {sorted(targets)} (fixed by the first "
                        "adapter loaded)"
                    )
            # host-side prep (rank padding) with no lock a reader takes
            pool_rank = rank if rank is not None else int(lcfg.rank)
            pool_targets = targets if targets is not None else tuple(lcfg.targets)
            host: dict = {}
            for t in pool_targets:
                ab = adapters.get(t)
                if ab is None:
                    host[t] = None
                    continue
                a, b = _host_f32(ab["a"]), _host_f32(ab["b"])
                if lcfg.rank < pool_rank:
                    # zero-pad the rank dim: delta unchanged, one stacked
                    # shape for the whole pool
                    a = np.pad(a, ((0, 0), (0, 0), (0, pool_rank - lcfg.rank)))
                    b = np.pad(b, ((0, 0), (0, pool_rank - lcfg.rank), (0, 0)))
                host[t] = (a, b)

            def device_part():
                with self._lock:
                    self._ensure_geometry(lcfg)
                    slot = self._by_name.get(name)
                    if slot is not None and self._refs.get(slot, 0) > 0:
                        # an in-place refresh would hand a LIVE generation
                        # new factors at its next step: mixed-weights
                        # output. The same typed backpressure as eviction
                        raise AdapterPoolBusy(
                            f"adapter {name!r} has in-flight rows; cannot refresh"
                        )
                    if slot is None:
                        slot = self._pick_slot()
                    self._write_slot(host, slot)
                    return self._publish_locked(name, slot, lcfg)

            return run(device_part)

    def evict(self, name: str, run=None) -> bool:
        """Explicitly drop a resident adapter. Refuses — AdapterPoolBusy —
        while rows are in flight."""
        def device_part():
            with self._lock:
                slot = self._by_name.get(name)
                if slot is None:
                    return False
                if self._refs.get(slot, 0) > 0:
                    raise AdapterPoolBusy(
                        f"adapter {name!r} has in-flight rows; cannot evict"
                    )
                self._by_name.pop(name)
                self._by_slot.pop(slot, None)
                # zero the scaling so a stale id (never handed out past
                # this point) gathers a zero delta
                self._scales[slot].fill_(0.0)
                self.evictions += 1
                _C_EVICTED.inc()
                _G_RESIDENT.set(len(self._by_name))
                return True

        return (run or _run_here)(device_part)

    # ------------------------------------------------------------ row leases

    def acquire(self, name: str) -> int:
        """Slot for `name`, with its in-flight refcount bumped (the
        scheduler calls this at admission; release() at retirement)."""
        with self._lock:
            slot = self._by_name.get(name)
            if slot is None:
                raise UnknownAdapter(f"adapter {name!r} is not resident")
            self._refs[slot] = self._refs.get(slot, 0) + 1
            self._tick += 1
            self._last_used[slot] = self._tick
            _C_REQUESTS.inc(adapter=name)
            return slot

    def release(self, slot: int) -> None:
        with self._lock:
            left = self._refs.get(slot, 0) - 1
            if left <= 0:
                self._refs.pop(slot, None)
            else:
                self._refs[slot] = left

    # ------------------------------------------------------------ queries

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._by_name

    def resident(self) -> list[str]:
        with self._lock:
            return sorted(self._by_name)

    def slot_of(self, name: str) -> int | None:
        with self._lock:
            return self._by_name.get(name)

    def device_args(self):
        """(stacked factors, [N+1] scales) for the serving step, or (None,
        None) before the first load. Fixed storage: a graph captured over
        them reads every later write."""
        with self._lock:
            return self._device, self._scales

    @property
    def info(self) -> dict:
        with self._lock:
            return {
                "slots": self.slots,
                "rank": self.rank,
                "targets": list(self.targets or ()),
                "resident": sorted(self._by_name),
                "loads": self.loads,
                "evictions": self.evictions,
            }
