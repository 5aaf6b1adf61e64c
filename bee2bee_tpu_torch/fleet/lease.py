"""The controller lease: TTL'd, gossiped, deterministically ordered.

There is no consensus protocol here on purpose — the mesh is AP by
design (peers come and go, partitions happen), so the lease gives
*liveness with deterministic conflict resolution* rather than mutual
exclusion: during a partition both sides may elect a leader, and that is
acceptable because every replica ACTION is epoch-gated at the target
(meshnet/node.py refuses ``fleet_action`` frames from anything but the
best lease it has seen) and the healed mesh converges on exactly one
leader by ordering alone.

Ordering is total and clock-free:

- a **higher epoch always wins** (every claim bumps the highest epoch
  the claimant has observed, so a new claim supersedes a lapsed reign);
- at **equal epoch** (split-brain: two nodes claimed the same lapsed
  lease concurrently) the lexicographically **smaller holder id wins** —
  both sides compute the same winner from the two frames alone, and the
  loser steps down the moment it sees the rival frame.

Expiry never compares cross-node clocks: a lease frame carries a
*relative* ``ttl_s`` and the receiver stamps its own arrival time, the
same discipline as the health store's staleness TTL.

Takeover is staggered to avoid a thundering claim: controller-eligible
nodes (they advertise ``fleet_controller`` in their telemetry digest)
rank themselves by peer id, and rank *i* waits ``i * stagger`` past the
lapse before claiming — so the deterministic first claimant is the
smallest live peer id, and collisions (rank-0 died too) resolve by the
ordering above anyway. A keeper that has never observed ANY lease
additionally waits one full TTL of boot grace before the void counts
as a lapse, so a freshly joined node cannot usurp a live incumbent it
simply hasn't heard yet.

PyTorch port: a copy of ``bee2bee_tpu/fleet/lease.py`` with the import root rewritten to
``bee2bee_tpu_torch``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..clock import Clock, get_clock, resolve_clock


def lease_beats(epoch_a: int, holder_a: str, epoch_b: int, holder_b: str) -> bool:
    """True when lease (epoch_a, holder_a) wins over (epoch_b, holder_b).
    Total order: higher epoch first, then smaller holder id."""
    if epoch_a != epoch_b:
        return epoch_a > epoch_b
    return str(holder_a) < str(holder_b)


@dataclass
class LeaseView:
    """One observed (or self-issued) lease, stamped with LOCAL time."""

    holder: str
    epoch: int
    ttl_s: float
    scope: str = "default"
    action: dict | None = None  # the leader's in-flight replica action
    released: bool = False
    received_at: float = field(default_factory=lambda: get_clock().time())

    def fresh(self, now: float | None = None) -> bool:
        now = get_clock().time() if now is None else now
        return not self.released and now - self.received_at <= self.ttl_s

    def age_s(self, now: float | None = None) -> float:
        now = get_clock().time() if now is None else now
        return now - self.received_at

    def describe(self, now: float | None = None) -> dict:
        now = get_clock().time() if now is None else now
        return {
            "holder": self.holder,
            "epoch": self.epoch,
            "ttl_s": self.ttl_s,
            "scope": self.scope,
            "action": self.action,
            "released": self.released,
            "age_s": round(self.age_s(now), 3),
            "fresh": self.fresh(now),
        }


class LeaseKeeper:
    """Per-node lease bookkeeping: the best lease observed so far, the
    highest epoch ever seen (the claim floor), and the authorization
    check ``fleet_action`` targets gate on.

    Lives on EVERY node — followers and non-controllers too: any node
    may be the target of a replica action and must be able to tell the
    rightful leader from a stale or split-brain-losing one."""

    def __init__(self, ttl_s: float = 45.0, scope: str = "default",
                 clock: Clock | None = None):
        self.ttl_s = ttl_s
        self.scope = scope
        self._clock = resolve_clock(clock)
        self._view: LeaseView | None = None
        self.highest_epoch = 0
        # when the CURRENT view lapsed (or the keeper booted with none):
        # the takeover stagger counts from here. While NO lease has ever
        # been observed, lapsed_for adds one full TTL of boot grace on
        # top (see there) so a fresh node cannot claim before the
        # incumbent's gossip has had a chance to arrive.
        self._lapse_started: float = self._clock.time()
        # first-election deferral bound: set by the first
        # reset_boot_grace (node start) — see there
        self._grace_cap: float | None = None

    def reset_boot_grace(self, now: float | None = None) -> None:
        """Re-anchor the boot grace at the moment the node actually
        joins the mesh — called from P2PNode.start AND from every first
        contact with a new peer: construction→start can take longer
        than a TTL (first jit compile), and a bootstrap dial that
        stalls past one TTL after start() would otherwise silently
        consume the grace too — either way re-opening the
        fresh-joiner-usurps-live-incumbent window. No-op once any lease
        has been observed. The total deferral is CAPPED at three TTLs
        past the first anchor (node start): a rolling bootstrap — or a
        crash-looping peer minting a fresh random id per restart —
        keeps re-anchoring, and an unbounded grace would leave the
        fleet leaderless forever."""
        if self._view is not None:
            return
        now = self._clock.time() if now is None else now
        if self._grace_cap is None:
            # grace END = _lapse_started + ttl, so capping the anchor
            # at start + 2*ttl bounds the first claim to start + 3*ttl
            self._grace_cap = now + 2.0 * self.ttl_s
        self._lapse_started = min(now, self._grace_cap)

    # ------------------------------------------------------------ observe

    def observe(self, frame: dict, now: float | None = None) -> LeaseView | None:
        """Fold one FLEET_LEASE frame in; returns the resulting current
        view. A frame only replaces the held view when it wins the
        deterministic ordering, refreshes the same holder's reign, or
        the held view has lapsed (any live claim beats a dead reign)."""
        now = self._clock.time() if now is None else now
        holder = frame.get("holder")
        try:
            epoch = int(frame.get("epoch") or 0)
            ttl_s = float(frame.get("ttl_s") or self.ttl_s)
        except (TypeError, ValueError):
            return self._view
        if not holder or epoch <= 0 or ttl_s <= 0:
            return self._view
        self.highest_epoch = max(self.highest_epoch, epoch)
        action = frame.get("action")
        view = LeaseView(
            holder=str(holder), epoch=epoch, ttl_s=ttl_s,
            scope=str(frame.get("scope") or self.scope),
            action=action if isinstance(action, dict) else None,
            released=bool(frame.get("released")), received_at=now,
        )
        cur = self._view
        if (
            cur is None
            or not cur.fresh(now)
            or view.holder == cur.holder
            or lease_beats(view.epoch, view.holder, cur.epoch, cur.holder)
        ):
            self._set_view(view, now)
        return self._view

    def _set_view(self, view: LeaseView, now: float) -> None:
        self._view = view
        if view.released:
            self._lapse_started = now

    # ------------------------------------------------------------- queries

    def current(self, now: float | None = None) -> LeaseView | None:
        """The held lease when FRESH, else None (marking the lapse start
        the first time it is observed lapsed)."""
        now = self._clock.time() if now is None else now
        v = self._view
        if v is None:
            return None
        if v.fresh(now):
            return v
        # lapse start = the instant the TTL ran out, not the instant we
        # happened to look — rank-based stagger must not depend on poll
        # timing (idempotent across polls: lapse_at is a pure function
        # of the lapsed view)
        self._lapse_started = v.received_at + (0.0 if v.released else v.ttl_s)
        return None

    def lapsed_for(self, now: float | None = None) -> float | None:
        """Seconds since the lease lapsed; None while one is fresh —
        or while the BOOT GRACE runs: a keeper that has never observed
        any lease waits out one full TTL of silence before the void
        counts as a lapse. Without it a freshly booted claimant ranks
        itself on an empty view and can usurp a live incumbent (same
        epoch, smaller peer id) whose gossip simply hasn't arrived yet."""
        now = self._clock.time() if now is None else now
        if self.current(now) is not None:
            return None
        start = self._lapse_started
        if self._view is None:
            start += self.ttl_s
        return now - start if now >= start else None

    def authorizes(self, holder: str, epoch: int, now: float | None = None) -> bool:
        """May (holder, epoch) command this node right now?

        With a FRESH lease held: the recognized holder is authorized
        outright, and a rival only if it beats that reign. The all-time
        epoch floor deliberately does NOT apply here — a higher epoch
        observed once from a now-dead claimant must not permanently
        refuse the leader whose renewals we are actively accepting
        (observe() re-installs a live lower-epoch reign once the higher
        one lapses; authorization must follow the same rule).

        With NO fresh lease: the floor gates claimants — anything below
        the highest epoch ever seen is a stale controller. A node that
        has seen nothing trusts the first claimant (bootstrap: refusing
        would deadlock an empty mesh)."""
        try:
            epoch = int(epoch)
        except (TypeError, ValueError):
            return False
        if not holder or epoch <= 0:
            return False
        cur = self.current(now)
        if cur is not None:
            if cur.holder == holder:
                return True
            return lease_beats(epoch, holder, cur.epoch, cur.holder)
        return epoch >= self.highest_epoch

    def describe(self, now: float | None = None) -> dict | None:
        return self._view.describe(now) if self._view is not None else None
