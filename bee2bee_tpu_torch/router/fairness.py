"""Weighted deficit round robin over per-tenant FIFO queues.

A copy of ``bee2bee_tpu/router/fairness.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_engine.py`` drives both queues
through the same sequence and holds their pop orders equal. Here it is
the engine scheduler's submit queue (engine/scheduler.py, its own
thread); the admission controller that shares it in the JAX package is
not ported yet. ``WdrrQueue`` is deliberately synchronization-free — the
scheduler already serializes access under its condition variable, and a
lock here would just be a second one.

DRR semantics (Shreedhar & Varghese): each tenant queue holds a deficit
counter; a full rotation over non-empty queues tops every deficit up by
``quantum * weight``, and a queue may dequeue its head once the deficit
covers the head's cost. Cost here is the request's token budget
(``max_new_tokens``), so fairness is in TOKENS, not request count — a
tenant asking for 10x longer generations gets proportionally fewer slots.
Long-run service ratio converges to the weight ratio whenever both
tenants keep their queues non-empty (the saturation regime the
``router_fairness`` bench rung drives).

A deficit resets when its queue drains: an idle tenant must not bank
credit and then burst past its weight when it returns.
"""

from __future__ import annotations

from collections import OrderedDict, deque

DEFAULT_QUANTUM = 256.0


class WdrrQueue:
    """Deque-compatible facade (append/appendleft/popleft/len/iter/clear)
    over per-tenant FIFOs with weighted-deficit dequeue order."""

    def __init__(self, weights: dict[str, float] | None = None,
                 quantum: float = DEFAULT_QUANTUM):
        self.quantum = float(quantum)
        self._weights = {str(k): float(v) for k, v in (weights or {}).items()}
        self._queues: OrderedDict[str, deque] = OrderedDict()
        self._deficit: dict[str, float] = {}

    def set_weights(self, weights: dict[str, float]) -> None:
        self._weights = {str(k): float(v) for k, v in (weights or {}).items()}

    def weight(self, tenant: str) -> float:
        return max(float(self._weights.get(tenant, 1.0)), 1e-6)

    # ------------------------------------------------------------- enqueue

    def _queue_for(self, tenant: str) -> deque:
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
            self._deficit.setdefault(tenant, 0.0)
        return q

    def append(self, item, tenant: str = "default", cost: float = 1.0) -> None:
        self._queue_for(tenant).append((item, max(float(cost), 0.0)))

    def appendleft(self, item, tenant: str = "default", cost: float = 1.0) -> None:
        """Front requeue (admission backpressure retry): the cost was
        already charged when the item was first popped — refund it, so the
        retry doesn't pay twice and stays immediately affordable."""
        cost = max(float(cost), 0.0)
        self._queue_for(tenant).appendleft((item, cost))
        self._deficit[tenant] = self._deficit.get(tenant, 0.0) + cost

    # ------------------------------------------------------------- dequeue

    def popleft(self):
        """Next item under WDRR order. Raises IndexError when empty (the
        deque contract)."""
        if not self:
            raise IndexError("pop from an empty WdrrQueue")
        while True:
            for tenant in list(self._queues):
                q = self._queues[tenant]
                if not q:
                    continue
                item, cost = q[0]
                if self._deficit[tenant] >= cost:
                    q.popleft()
                    if q:
                        self._deficit[tenant] -= cost
                    else:
                        # drained: no banked credit survives idleness
                        self._deficit[tenant] = 0.0
                    return item
            # nobody could afford their head: top every non-empty tenant
            # up by quantum*weight — guarantees progress (quantum > 0)
            for tenant, q in self._queues.items():
                if q:
                    self._deficit[tenant] += self.quantum * self.weight(tenant)

    def remove(self, item) -> bool:
        """Remove one queued item by identity (a drain pulls un-admitted
        requests out of the submit queue to forward them whole). Deficit
        is untouched — append never charged any."""
        for q in self._queues.values():
            for entry in q:
                if entry[0] is item:
                    q.remove(entry)
                    return True
        return False

    def refund(self, tenant: str, cost: float) -> None:
        """Return deficit charged for a popped item that never ran (a
        timed-out admission waiter, a cancelled request): without this,
        timeouts concentrated on one tenant push its realized share below
        its weight. Credited only while the tenant still has queued work —
        an idle tenant banking credit would violate the reset-on-drain
        rule."""
        q = self._queues.get(tenant)
        if q:
            self._deficit[tenant] = (
                self._deficit.get(tenant, 0.0) + max(float(cost), 0.0)
            )

    # ------------------------------------------------------------- protocol

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def __bool__(self) -> bool:
        return any(self._queues.values())

    def __iter__(self):
        for q in self._queues.values():
            for item, _cost in q:
                yield item

    def clear(self) -> None:
        self._queues.clear()
        self._deficit.clear()

    def depth(self, tenant: str) -> int:
        q = self._queues.get(tenant)
        return len(q) if q else 0
