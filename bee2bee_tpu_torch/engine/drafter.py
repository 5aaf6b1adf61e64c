"""The model-tier drafter: a real model resident beside the target.

The port of ``bee2bee_tpu/engine/drafter.py``. ``DraftModel`` implements
spec.Drafter tier "model": it holds its own weights and a RECTANGULAR KV
cache ([L, B, S, Hkv, hd], models/core.py ``init_cache``; drafter
contexts are short-lived, so the paged pool machinery would be pure
overhead) and drafts K tokens per eligible row in ONE batched
autoregressive pass: a [B, 2] chunk forward that catches the cache up to
the row's context tail and yields draft token 0, then K-1 [B, 1] decode
steps, all rows together.

KV state algebra (the whole file hangs on this): ``consumed[slot]`` is
the number of context positions with VALID cache content — every token
ctx[0..consumed) has been fed at its position. Feeds are always
CONTIGUOUS from ``consumed``, which buys a universal safety invariant:
any cache position >= a row's frontier is rewritten by the chunk that
first covers it BEFORE any query at or beyond it runs (the forward writes
K/V before attention; causal masking hides higher positions until then).
So rejected-draft K/V, padded prime chunks, and idle-row parking writes
are all garbage-above-frontier — never observed. The per-step
bookkeeping:

- propose: feed ctx[consumed:] (1 or 2 tokens in steady state), draft K,
  set consumed = len(ctx). The steps also wrote K/V for drafts[0..K-2].
- observe(accepted=a): the target kept drafts[:a] + a bonus token, so
  consumed += min(a, K-1) — accepted drafts' K/V is already valid; the
  bonus (and a full-accept's draft K-1) gets fed next propose. The gap
  len(ctx) - consumed stays in {1, 2} while the row drafts every step.
- a row that skipped drafting for some steps (eligibility flapped) or a
  fresh/re-primed row catches up through batched [B, W] prime chunks.
- rejection-heavy rows (consecutive zero-accept streak) re-prime from
  scratch — the typed escape hatch for any host/device state drift.

Idle rows in a batched call park at ``_idle_off`` — a fixed offset past
every reachable real frontier — so one fixed-shape root serves any
active subset without touching inactive rows' live state.

The JAX package's two jit roots are captured roots here
(engine/graphs.py): ``draft`` (the [B, 2] chunk plus the K-1 steps, one
key) and ``draft_prime`` (the [B, W] chunk, one key), registered with the
sentinel under JAX's names and declared shapes. Their inputs are static
device buffers filled by copies queued before each replay; on the CPU
the same steps run eagerly. Every run is inside a device pass
(``device_gate``): the scheduler's, or its own on the draft server's
executor thread. Weights are a random init from ``seed``
(models/params.py), so a same-name drafter at the engine's seed is
weight-identical to the target; a drafter from a checkpoint waits for
checkpoint loading (ROADMAP.md queue A item 10).

Loaded beside the target in engine/engine.py (BEE2BEE_DRAFTER /
--drafter), which runs the tokenizer compatibility gate below first: a
drafter whose token ids mean different strings than the target's would
be a silent garbage-draft loop (acceptance ~0, all verify FLOPs wasted),
so vocab-size or tokenizer-fingerprint mismatch is a typed
``DrafterLoadError`` at boot.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..device import resolve_device
from ..models import core
from ..models.config import resolve_model_config
from ..models.params import init_params
from ..unported import unported
from . import graphs
from .introspect import device_gate
from .spec import Drafter

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


class DrafterLoadError(RuntimeError):
    """Drafter/target incompatibility detected at boot (never at serve
    time): vocab-size mismatch, tokenizer-fingerprint mismatch, or a
    drafter spec that cannot resolve to a model."""


def tokenizer_fingerprint(tok) -> str:
    """Stable identity hash for a tokenizer: two tokenizers with the same
    fingerprint map ids to the same strings. HF tokenizers hash their
    full vocab table; the byte fallback is fully determined by its type
    and vocab size."""
    inner = getattr(tok, "_tok", None)
    if inner is not None and hasattr(inner, "get_vocab"):
        blob = json.dumps(sorted(inner.get_vocab().items()), ensure_ascii=True)
        return "vocab:" + hashlib.sha256(blob.encode()).hexdigest()
    return f"{type(tok).__name__}:{getattr(tok, 'vocab_size', 0)}"


def validate_drafter_compat(target_cfg, target_tok, draft_cfg, draft_tok):
    """The boot-time gate: draft token ids must BE target token ids."""
    if draft_cfg.vocab_size != target_cfg.vocab_size:
        raise DrafterLoadError(
            f"drafter vocab_size {draft_cfg.vocab_size} != target "
            f"vocab_size {target_cfg.vocab_size}: draft ids would be "
            f"garbage to the verify path"
        )
    tf, df = tokenizer_fingerprint(target_tok), tokenizer_fingerprint(draft_tok)
    if tf != df:
        raise DrafterLoadError(
            f"drafter tokenizer {df} != target tokenizer {tf}: same vocab "
            f"size but different id->string maps"
        )


class _Slot:
    __slots__ = ("idx", "consumed", "zero_streak")

    def __init__(self, idx: int):
        self.idx = idx
        self.consumed = 0
        self.zero_streak = 0


@dataclass
class _Views:
    """One root's static buffers (or their scratch twins)."""

    tokens: torch.Tensor  # [B, 2] (draft) / [B, W] (prime) int64
    off: torch.Tensor  # [B] int32: where tokens[:, 0] is written
    tlen: torch.Tensor | None = None  # [B] int64: draft chunk lengths
    drafts: torch.Tensor | None = None  # [B, K] int64: the draft's output


class DraftModel(Drafter):
    """Tier "model": batched K-token drafting with a resident model.

    One instance per engine, sized to the engine's max_batch; per-request
    cache rows are slot-assigned on first propose and released by
    forget() at retirement. Device work runs on the scheduler thread
    (inside its pass), or on the draft server's executor thread inside
    a pass of its own."""

    tier = "model"

    # consecutive all-rejected verify verdicts before a full re-prime —
    # the drift escape hatch; cheap because re-priming is W tokens/step
    REPRIME_AFTER = 4
    PRIME_WIDTH = 64

    def __init__(
        self,
        model,
        spec_tokens: int,
        batch: int,
        target_max_seq_len: int,
        dtype="float32",
        seed: int = 0,
        checkpoint_path: str | None = None,
        params=None,
        sentinel=None,
        device=None,
    ):
        if spec_tokens < 1:
            raise ValueError(f"spec_tokens must be >= 1, got {spec_tokens}")
        if checkpoint_path:
            raise unported(f"a drafter from a checkpoint ({checkpoint_path!r})", 10)
        try:
            self.cfg = resolve_model_config(model)
        except KeyError as e:
            raise DrafterLoadError(f"unknown drafter model {model!r}") from e
        core.check_supported(self.cfg)
        self.device = resolve_device(device)
        self._on_card = self.device.type == "cuda"
        self.spec_tokens = K = spec_tokens
        self.batch = batch
        self.dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
        # the longest context we draft at: the drafter's own positional
        # capacity caps it; rows beyond this miss
        self.cap = min(target_max_seq_len, self.cfg.max_seq_len - K - 1)
        self.prime_width = W = min(self.PRIME_WIDTH, max(self.cap, 8))
        # idle rows park past every reachable real frontier (a real row's
        # writes reach at most cap + K - 2), so a batched call never
        # clobbers an inactive row's valid prefix
        self._idle_off = self.cap + K - 1
        S = self._idle_off + max(W, K) + 1
        self.seq_len = S

        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
            params = init_params(self.cfg, gen, self.device, self.dtype)
        self.params = params
        self.cache = core.init_cache(self.cfg, batch, S, dtype=self.dtype,
                                     device=self.device)
        self.tokenizer = None

        self._slots: dict[int, _Slot] = {}      # id(req) -> slot state
        self._free = list(range(batch))

        # the roots' static buffers: what a captured graph reads and
        # writes, at fixed addresses
        dev = self.device
        self._draft_v = _Views(
            tokens=torch.zeros((batch, 2), dtype=torch.int64, device=dev),
            off=torch.zeros((batch,), dtype=torch.int32, device=dev),
            tlen=torch.ones((batch,), dtype=torch.int64, device=dev),
            drafts=torch.zeros((batch, K), dtype=torch.int64, device=dev),
        )
        self._prime_v = _Views(
            tokens=torch.zeros((batch, W), dtype=torch.int64, device=dev),
            off=torch.zeros((batch,), dtype=torch.int32, device=dev),
        )
        self._graphs: dict[str, graphs.Graph] = {}
        # replays (eager runs on the CPU) and captures of each root
        self.runs = {"draft": 0, "draft_prime": 0}
        self.captures = {"draft": (0, 0.0), "draft_prime": (0, 0.0)}
        if self._on_card:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(dev)
        self._sentinel = sentinel
        if sentinel is not None:
            # one declared shape each ([B,2] / [B,W]): any other capture
            # through these roots is a genuine storm
            sentinel.register("draft", allowed=lambda key: key == (batch, 2))
            sentinel.register("draft_prime", allowed=lambda key: key == (batch, W))

    # ------------------------------------------------------ the roots
    def _prime_step(self, v: _Views):
        """Catch-up chunk: write K/V for tokens at [offset, offset+W) per
        row; logits discarded. Padded tails and idle rows write garbage
        above their frontiers — safe by the contiguity invariant."""
        core.forward(self.params, self.cfg, v.tokens, self.cache, v.off)

    def _draft_step(self, v: _Views):
        """The draft root: one [B, 2] chunk + K-1 [B, 1] decode steps = K
        greedy draft tokens per row, into ``v.drafts``.

        tokens[b] = ctx[consumed:] right-padded to 2; tlen[b] in {1, 2};
        offsets[b] = consumed (where tokens[b, 0] is written). Draft 0 is
        the argmax at chunk index tlen-1 (the context's last token);
        drafts 1..K-1 come from feeding each draft back at position
        offset + tlen + j. The pad slot of a tlen=1 row is overwritten by
        draft 0's own feed one step later."""
        B = v.tokens.shape[0]
        rows = torch.arange(B, device=v.tokens.device)
        logits, _ = core.forward(self.params, self.cfg, v.tokens, self.cache, v.off)
        cur = torch.argmax(logits[rows, v.tlen - 1], dim=-1)
        v.drafts[:, 0] = cur
        base = v.off + v.tlen
        for j in range(self.spec_tokens - 1):
            lg, _ = core.forward(self.params, self.cfg, cur[:, None], self.cache,
                                 base + j)
            cur = torch.argmax(lg[:, 0], dim=-1)
            v.drafts[:, j + 1] = cur

    def _run(self, root: str):
        """Run ``root`` once over its static buffers, inside a device pass:
        a replay of its graph on the card (captured on first use), the
        step itself on the CPU."""
        step, live = ((self._draft_step, self._draft_v) if root == "draft"
                      else (self._prime_step, self._prime_v))
        with device_gate.device_pass():
            if not self._on_card:
                step(live)
            else:
                graph = self._graphs.get(root) or self._capture(root, step, live)
                graph.replay()
        self.runs[root] += 1

    def _capture(self, root: str, step, live: _Views) -> graphs.Graph:
        """Capture ``root``: the warm-up parks every row at ``_idle_off``
        (garbage above every frontier) with scratch outputs."""
        t0 = time.perf_counter()
        scratch = replace(
            live, tokens=torch.zeros_like(live.tokens),
            off=torch.full_like(live.off, self._idle_off),
            tlen=None if live.tlen is None else torch.ones_like(live.tlen),
            drafts=None if live.drafts is None else torch.zeros_like(live.drafts),
        )
        with graphs.capture_lock():
            graph, _, _ = graphs.capture(
                step, live, scratch, stream=self._capture_stream,
                pool=self._graph_pool, counters=graphs.launch_counters(),
            )
        seconds = time.perf_counter() - t0
        self._graphs[root] = graph
        n, total = self.captures[root]
        self.captures[root] = (n + 1, total + seconds)
        if self._sentinel is not None:
            self._sentinel.note_compile(root, tuple(live.tokens.shape), seconds)
        return graph

    # --------------------------------------------------- Drafter interface
    def _slot(self, req) -> _Slot | None:
        st = self._slots.get(id(req))
        if st is None:
            if not self._free:
                return None
            st = _Slot(self._free.pop())
            self._slots[id(req)] = st
        return st

    def propose_batch(self, rows):
        out = {}
        active = []  # (b, req, st, ctx)
        for b, req in rows:
            ctx = list(req.ids) + list(req.out_ids)
            if len(ctx) > self.cap:
                out[b] = []              # past drafter capacity: a miss
                continue
            st = self._slot(req)
            if st is None:
                out[b] = []              # no cache row free (shouldn't
                continue                 # happen: batch == max_batch)
            if st.consumed > len(ctx) - 1 or st.consumed < 0:
                # context moved under us (stop-string truncation, slot
                # reuse): recompute from scratch — rewriting from 0 is
                # always sound, it re-establishes the contiguous frontier
                st.consumed = 0
            active.append((b, req, st, ctx))
        if not active:
            return out

        # -- catch-up: prime rows whose frontier trails the context tail.
        # Target frontier is len(ctx) - 1 (the last token feeds in the
        # draft chunk itself so its logits yield draft 0).
        while any(len(ctx) - 1 - st.consumed > 1 for _, _, st, ctx in active):
            tokens = np.zeros((self.batch, self.prime_width), np.int64)
            offsets = np.full((self.batch,), self._idle_off, np.int32)
            for _, _, st, ctx in active:
                n = min(self.prime_width, len(ctx) - 1 - st.consumed)
                if n <= 1:
                    continue
                chunk = ctx[st.consumed:st.consumed + self.prime_width]
                tokens[st.idx, :len(chunk)] = chunk
                offsets[st.idx] = st.consumed
                st.consumed += n
            graphs.h2d(self._prime_v.tokens, tokens)
            graphs.h2d(self._prime_v.off, offsets)
            self._run("draft_prime")

        # -- the draft step proper: one [B, 2] root call for all rows
        tokens = np.zeros((self.batch, 2), np.int64)
        tlen = np.ones((self.batch,), np.int64)
        offsets = np.full((self.batch,), self._idle_off, np.int32)
        for _, _, st, ctx in active:
            tail = ctx[st.consumed:]
            tokens[st.idx, :len(tail)] = tail
            tlen[st.idx] = len(tail)
            offsets[st.idx] = st.consumed
            st.consumed = len(ctx)
        v = self._draft_v
        graphs.h2d(v.tokens, tokens)
        graphs.h2d(v.tlen, tlen)
        graphs.h2d(v.off, offsets)
        self._run("draft")
        # the drafts feed the verify step of this same scheduler step: the
        # readback IS the product
        drafts = v.drafts.cpu().numpy()
        for b, _, st, _ in active:
            out[b] = [int(t) for t in drafts[st.idx]]
        return out

    def observe(self, req, accepted: int) -> None:
        st = self._slots.get(id(req))
        if st is None:
            return
        # drafts[0..accepted-1] were fed during the steps, so their K/V is
        # already valid context; a full accept's last draft (K-1) and the
        # bonus token were never fed — they arrive in the next chunk
        st.consumed += min(int(accepted), self.spec_tokens - 1)
        if accepted == 0:
            st.zero_streak += 1
            if st.zero_streak >= self.REPRIME_AFTER:
                st.consumed = 0          # full re-prime from prompt+accepted
                st.zero_streak = 0
        else:
            st.zero_streak = 0

    def forget(self, req) -> None:
        st = self._slots.pop(id(req), None)
        if st is not None:
            self._free.append(st.idx)

    def close(self) -> None:
        self._slots.clear()
        self._free = list(range(self.batch))
        self._graphs.clear()
        self.params = None
        self.cache = None

    def hbm_source(self):
        """HBM ledger hook: the drafter's resident footprint."""
        return {"params": self.params, "cache": self.cache}
