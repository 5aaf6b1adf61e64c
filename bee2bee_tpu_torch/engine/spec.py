"""Speculative decoding drafters: a tiered stack behind one interface.

Single-stream decode pays one full forward pass per token — the latency
floor interactive clients feel. Speculative decoding breaks it: draft up
to K tokens cheaply, then verify all K in ONE [B, K+1] forward
(engine.InferenceEngine._spec_verify_fn) and accept the longest exact
prefix. On a weight-bound chip that forward costs about the same as a
single decode step, so every accepted draft token is a free step.

Three draft TIERS share the ``Drafter`` interface, selected PER ROW by
the scheduler with the same gating discipline spec decode always used
(``DrafterStack`` picks the tier; ``should_disable`` — unchanged math —
decides when a row's current tier has failed its probe):

- ``ngram``: zero-cost host-side prompt lookup (``find_ngram_draft``) —
  matches the sequence's own tail against its earlier content. Free, but
  acceptance collapses to ~0 on non-repetitive chat traffic.
- ``model``: a real small model resident beside the target
  (engine/drafter.py ``DraftModel``) drafting K tokens per eligible row
  in one batched autoregressive pass with its own tiny KV state.
- ``mesh``: the same model drafter hosted on a CHEAP PEER
  (``BEE2BEE_DISAGG=draft``; meshnet/draft.py). Drafts stream over
  draft_request/draft_result frames, pipelined one step ahead so the
  draft RTT hides under the target's decode step. ``MeshDrafter`` here
  is the transport-agnostic scheduler side: a not-yet-arrived draft is
  PENDING (the row simply doesn't draft this step — never a stall), a
  timed-out one is a miss, and a dead peer flips ``dead`` so the
  scheduler demotes every mesh row to the local tier, typed.

Rows move between tiers instead of dying: when a tier fails its probe
budget the row DEMOTES down the ladder (mesh → model → ngram → off) —
or ESCALATES from ngram to a model-class tier when one is configured,
so a row whose content stops repeating still profits from the model.

Why rollback is free: the verify chunk writes K/V for positions
[offset, offset+K+1), but the row's offset only advances by accepted+1.
Rejected positions are >= the new offset, and the engine's causal
invariant — any cache position >= the write offset is either masked at
read time or overwritten before attention sees it — already guarantees
stale K/V there is never observed (the same invariant that makes the
paged cache's CoW prefix sharing sound; see engine/paged.py).

Everything in this module is host-side python/numpy owned by the
scheduler thread (MeshDrafter additionally takes results from the
transport thread under a lock); nothing here touches the device. The
model drafter's captured roots live in engine/drafter.py, the verify
step in engine/engine.py and its captured root in engine/scheduler.py,
with the per-row gating (greedy non-penalized rows speculate;
sampled/penalized rows ride the existing decode windows).

The PyTorch port's own copy of ``bee2bee_tpu/engine/spec.py``: the same
code, which imports nothing of either package.
"""

from __future__ import annotations

import threading
import time

import numpy as np

# Tier vocabulary, cost-descending. Demotion walks RIGHT (cheaper);
# escalation from ngram picks the best model-class tier present. "off"
# is the terminal state when every configured tier has failed its probe
# — it is a row state, not a drafter.
TIER_LADDER = ("mesh", "model", "ngram")
TIER_OFF = "off"


def find_ngram_draft(
    context,
    k: int,
    min_match: int = 2,
    max_match: int = 8,
) -> list[int]:
    """Draft up to `k` tokens by longest-suffix n-gram lookup.

    Tries suffix lengths from min(max_match, len-1) down to min_match:
    the first (longest) n-gram whose most recent earlier occurrence is
    found wins, and the draft is the tokens that followed that
    occurrence. Returns [] when no suffix of length >= min_match repeats
    — the caller falls back to plain decode for this row/step.

    Matching the LONGEST suffix first maximizes draft quality (a longer
    shared context predicts the continuation better). Among occurrences
    of that suffix, the most recent one with a FULL k tokens of
    continuation wins — recency biases toward the sequence's current
    phase, but a naively-latest occurrence of a short-period repetition
    overlaps the tail and leaves almost nothing to draft (an all-same-
    token run would draft length 1 forever); only when no occurrence has
    full room does the earliest — longest partial continuation — serve.
    """
    n_ctx = len(context)
    if k < 1 or n_ctx < min_match + 1:
        return []
    arr = np.asarray(context, dtype=np.int64)
    for n in range(min(max_match, n_ctx - 1), min_match - 1, -1):
        pattern = arr[n_ctx - n:]
        # candidate starts [0, n_ctx - n): every one has >= 1 token
        # following its window; position n_ctx - n is the suffix itself
        windows = np.lib.stride_tricks.sliding_window_view(arr, n)[:n_ctx - n]
        hits = np.flatnonzero((windows == pattern).all(axis=1))
        if hits.size:
            roomy = hits[hits + n + k <= n_ctx]
            start = int(roomy[-1] if roomy.size else hits[0]) + n
            return arr[start:start + k].tolist()
    return []


def should_disable(
    drafted: int, accepted: int, probe_tokens: int, min_rate: float
) -> bool:
    """Per-row probe verdict: True once the row has drafted at least
    `probe_tokens` tokens ON ITS CURRENT TIER with acceptance below
    `min_rate`. The row's tier has proven useless for this content — the
    scheduler moves it to the next tier on the ladder (or off when none
    remain). Counters reset per tier, so each tier gets its own probe
    budget; a failed tier is never retried for that row (requests are
    short-lived; there is no re-enable)."""
    return drafted >= probe_tokens and accepted < min_rate * drafted


class Drafter:
    """One draft tier. The scheduler talks to every tier through this
    interface and keys per-row tier choice off ``tier``.

    propose_batch() maps row slot -> draft for all rows currently
    assigned to this tier:

    - a token list  = a draft to verify (may be shorter than K),
    - []            = a miss this step (counts against the probe budget),
    - None          = PENDING (mesh tier only): the draft hasn't arrived
                      yet; the row skips drafting this step with NO
                      accounting — pending is not failure.

    observe()/forget() let stateful tiers (model KV, mesh pipeline) roll
    forward on accept and release per-request state at retirement; the
    stateless n-gram tier inherits the no-ops.
    """

    tier = "?"
    spec_tokens = 0

    def propose_batch(self, rows):
        raise NotImplementedError

    def observe(self, req, accepted: int) -> None:  # noqa: ARG002
        """Verify verdict for a row this tier drafted: `accepted` of the
        proposed tokens were kept (plus the bonus token)."""

    def forget(self, req) -> None:  # noqa: ARG002
        """Release any per-request state (row retired or left the tier)."""

    def close(self) -> None:
        """Release tier-wide resources (weights, transport)."""


class NgramDrafter(Drafter):
    """Tier "ngram": drafting policy object the scheduler holds —
    configuration plus the propose() entry point. Stateless across
    rows/steps — per-row acceptance bookkeeping lives on the Request
    (spec_tier / spec_tier_drafted / spec_tier_accepted)."""

    tier = "ngram"

    def __init__(
        self,
        spec_tokens: int,
        min_match: int = 2,
        max_match: int = 8,
    ):
        if spec_tokens < 1:
            raise ValueError(f"spec_tokens must be >= 1, got {spec_tokens}")
        if not (1 <= min_match <= max_match):
            raise ValueError(
                f"need 1 <= min_match <= max_match, got "
                f"{min_match}..{max_match}"
            )
        self.spec_tokens = spec_tokens
        self.min_match = min_match
        self.max_match = max_match

    def propose(self, prompt_ids, out_ids) -> list[int]:
        """Draft for one row from its OWN prompt + generated ids."""
        return find_ngram_draft(
            list(prompt_ids) + list(out_ids),
            self.spec_tokens,
            self.min_match,
            self.max_match,
        )

    def propose_batch(self, rows):
        return {b: self.propose(req.ids, req.out_ids) for b, req in rows}


class _MeshRow:
    """Per-request pipeline state for the mesh tier (client side)."""

    __slots__ = ("rid", "ctx_sent", "inflight_pos", "deadline",
                 "ready_pos", "ready_draft", "failures")

    def __init__(self, rid: str):
        self.rid = rid
        self.ctx_sent = 0          # ctx tokens the peer has appended
        self.inflight_pos = -1     # ctx length the outstanding request drafts at
        self.deadline = 0.0
        self.ready_pos = -1        # ctx length the received draft was computed at
        self.ready_draft = None
        self.failures = 0          # consecutive timeouts/errors


class MeshDrafter(Drafter):
    """Tier "mesh": client side of the remote draft peer, transport-
    agnostic. meshnet/draft.py attaches a ``send(payload) -> bool``
    callable and forwards draft_result frames into deliver(); this class
    owns the pipelining, timeout, and degradation policy so the
    scheduler never blocks on the network:

    - PIPELINED ONE AHEAD: observe() (the verify verdict) immediately
      ships the accepted delta and requests the NEXT draft, so the RTT
      runs concurrently with the target's own next decode/verify step.
      propose_batch() only CONSUMES results that already arrived.
    - PENDING != MISS: a result not yet arrived returns None (row skips
      drafting this step, zero accounting). Only a passed deadline is a
      miss — it counts against the probe budget and triggers a full
      re-send (base=0), so a dropped frame self-heals.
    - TYPED DEATH: `max_failures` consecutive timeouts/errors, a send
      into a void, or an explicit peer-lost notice flip ``dead`` with a
      reason in {"timeout", "peer_lost", "no_peer"}; the scheduler
      demotes every mesh row to the local tier and never comes back.

    The wire protocol (draft_request/draft_result, declared in
    analysis/schema.py) is documented on meshnet/draft.py.
    """

    tier = "mesh"

    def __init__(
        self,
        spec_tokens: int,
        model: str = "",
        timeout_s: float = 2.0,
        max_failures: int = 3,
    ):
        if spec_tokens < 1:
            raise ValueError(f"spec_tokens must be >= 1, got {spec_tokens}")
        self.spec_tokens = spec_tokens
        self.model = model
        self.timeout_s = timeout_s
        self.max_failures = max_failures
        self.dead = False
        self.dead_reason = None
        self._send = None          # callable(payload: dict) -> bool
        self._lock = threading.Lock()
        self._rows: dict[int, _MeshRow] = {}   # id(req) -> state
        self._by_rid: dict[str, _MeshRow] = {}
        self._next_rid = 0

    # -- transport attachment (called by meshnet/draft.py) ---------------
    def attach_transport(self, send_fn) -> None:
        with self._lock:
            self._send = send_fn

    def peer_lost(self) -> None:
        """Transport tells us the draft peer died/disconnected."""
        self._mark_dead("peer_lost")

    def _mark_dead(self, reason: str) -> None:
        with self._lock:
            if not self.dead:
                self.dead = True
                self.dead_reason = reason

    # -- wire helpers (lock held) ----------------------------------------
    def _submit(self, st: _MeshRow, ctx, full: bool) -> bool:
        if self._send is None:
            self.dead, self.dead_reason = True, "no_peer"
            return False
        base = 0 if full else st.ctx_sent
        payload = {
            "rid": st.rid,
            "base": base,
            "tokens": [int(t) for t in ctx[base:]],
            "k": self.spec_tokens,
            "model": self.model,
        }
        ok = False
        try:
            ok = bool(self._send(payload))
        except Exception:
            ok = False
        if not ok:
            self.dead, self.dead_reason = True, "no_peer"
            return False
        st.ctx_sent = len(ctx)
        st.inflight_pos = len(ctx)
        st.deadline = time.monotonic() + self.timeout_s
        return True

    def _row(self, req) -> _MeshRow:
        st = self._rows.get(id(req))
        if st is None:
            rid = f"d{self._next_rid}"
            self._next_rid += 1
            st = _MeshRow(rid)
            self._rows[id(req)] = st
            self._by_rid[rid] = st
        return st

    # -- Drafter interface (scheduler thread) ----------------------------
    def propose_batch(self, rows):
        out = {}
        now = time.monotonic()
        with self._lock:
            for b, req in rows:
                if self.dead:
                    out[b] = []
                    continue
                st = self._row(req)
                ctx = list(req.ids) + list(req.out_ids)
                ctx_len = len(ctx)
                miss = False
                if st.ready_pos >= 0 and st.ready_pos != ctx_len:
                    # CATCH-UP: the row advanced (a plain decode window
                    # ran while the draft was in flight — pending rows
                    # never stall). The draft predicted the tokens from
                    # its own position; if its prefix matches what the
                    # row actually produced since, the TAIL is still a
                    # valid draft for the current position. A mismatched
                    # prefix means the drafter mispredicted those tokens
                    # — a real miss that must feed the tier's probe, or
                    # a bad mesh drafter could ride pending/stale cycles
                    # forever without ever failing its audition.
                    delta = ctx_len - st.ready_pos
                    draft = st.ready_draft or []
                    if 0 < delta < len(draft) and (
                        draft[:delta] == ctx[st.ready_pos:]
                    ):
                        st.ready_pos = ctx_len
                        st.ready_draft = draft[delta:]
                    else:
                        # a fully-outpaced draft whose tokens all matched
                        # what the row produced is NOT a miss — the
                        # drafter was right, just slower than the plain
                        # decode windows; penalizing it would fail the
                        # probe on latency, not accuracy
                        correct = delta > 0 and (
                            draft
                            == ctx[st.ready_pos:st.ready_pos + len(draft)]
                        )
                        st.ready_pos, st.ready_draft = -1, None
                        miss = delta > 0 and not correct
                if st.ready_pos == ctx_len:
                    out[b] = st.ready_draft or []
                    st.ready_pos, st.ready_draft = -1, None
                    continue
                if st.inflight_pos < 0:
                    # first contact for this row (or a consumed/dropped
                    # result with no observe since): prime the pipeline
                    self._submit(st, ctx, full=st.ctx_sent == 0)
                    out[b] = [] if miss else None
                elif now > st.deadline:
                    st.failures += 1
                    if st.failures >= self.max_failures:
                        self.dead, self.dead_reason = True, "timeout"
                        out[b] = []
                    else:
                        self._submit(st, ctx, full=True)
                        out[b] = []          # a timeout is a real miss
                else:
                    out[b] = [] if miss else None  # in flight: only the
                    # mispredicted-prefix drop above counts against the
                    # probe; a merely-pending draft is free
        return out

    def observe(self, req, accepted: int) -> None:
        # the verify verdict grew the context: pipeline the next draft
        # now so it overlaps the target's next step
        with self._lock:
            if self.dead:
                return
            st = self._rows.get(id(req))
            if st is None:
                return
            ctx = list(req.ids) + list(req.out_ids)
            self._submit(st, ctx, full=st.ctx_sent > len(ctx))

    def deliver(self, msg: dict) -> None:
        """draft_result frame from the transport thread."""
        with self._lock:
            st = self._by_rid.get(str(msg.get("rid", "")))
            if st is None:
                return
            if msg.get("error"):
                st.failures += 1
                st.inflight_pos = -1
                if st.failures >= self.max_failures:
                    self.dead, self.dead_reason = True, "peer_lost"
                return
            if msg.get("reprime"):
                # peer lost our delta baseline (restart/eviction): the
                # next submit re-sends the full context
                st.ctx_sent = 0
                st.inflight_pos = -1
                return
            pos = int(msg.get("pos", -1))
            if pos != st.inflight_pos:
                return                        # stale result: drop
            st.failures = 0
            st.inflight_pos = -1
            st.ready_pos = pos
            st.ready_draft = [int(t) for t in (msg.get("draft") or [])]

    def forget(self, req) -> None:
        with self._lock:
            st = self._rows.pop(id(req), None)
            if st is None:
                return
            self._by_rid.pop(st.rid, None)
            if self._send is not None and not self.dead:
                try:
                    self._send({"rid": st.rid, "done": True})
                except Exception:
                    pass

    def close(self) -> None:
        with self._lock:
            self._rows.clear()
            self._by_rid.clear()
            self._send = None


class DrafterStack:
    """The scheduler's one handle on all configured tiers.

    Holds a tier-name -> Drafter map (any subset of TIER_LADDER) and the
    tier-transition policy. Per-row tier state lives on the Request
    (spec_tier + spec_tiers_failed); this object is shared and
    stateless across rows.
    """

    def __init__(self, tiers: dict, spec_tokens: int):
        if not tiers:
            raise ValueError("DrafterStack needs at least one tier")
        for name in tiers:
            if name not in TIER_LADDER:
                raise ValueError(f"unknown draft tier {name!r}")
        self.tiers = tiers
        self.spec_tokens = spec_tokens

    def start_tier(self) -> str:
        """New rows start on the CHEAPEST configured tier (n-gram when
        present): it costs nothing to probe, and escalation to the model
        tiers is exactly the failure path the ladder encodes."""
        for name in reversed(TIER_LADDER):
            if name in self.tiers and self._alive(name):
                return name
        return TIER_OFF

    def _alive(self, name: str) -> bool:
        return not getattr(self.tiers[name], "dead", False)

    def next_tier(self, current: str, failed) -> str:
        """Where a row goes when `current` fails its probe (or dies).

        Demotion prefers tiers BELOW current on the ladder (cheaper);
        when none remain, escalate to an untried tier ABOVE (this is the
        n-gram -> model escalation: ngram is the ladder's floor, so its
        only exits are up or off). Tiers in `failed` are never retried.
        """
        try:
            i = TIER_LADDER.index(current)
        except ValueError:
            i = -1
        below = TIER_LADDER[i + 1:]
        above = TIER_LADDER[:max(i, 0)]
        for name in tuple(below) + tuple(reversed(above)):
            if name in self.tiers and name not in failed and self._alive(name):
                return name
        return TIER_OFF

    def forget(self, req) -> None:
        for d in self.tiers.values():
            d.forget(req)

    def close(self) -> None:
        for d in self.tiers.values():
            d.close()
