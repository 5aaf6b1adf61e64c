"""Prompt-prefix locality hints for prefix-aware placement.

CoW prefix sharing makes a repeated prompt prefix nearly free —
but only on the node that already holds it. To let the ROUTER exploit
that across the mesh, every node advertises a compact digest of the
prompt prefixes it recently served, and the router hashes an incoming
prompt's leading blocks and prefers the peer whose advertised digest
matches.

Hashing is over the prompt TEXT in fixed-size character blocks, not over
token ids: the gateway routing a request has no tokenizer (the target
node's service owns tokenization), and text-prefix equality implies
token-prefix equality for any deterministic tokenizer fed the identical
leading string. Hashes are CHAINED — block i's hash covers blocks
0..i — so a single set-membership test per depth answers "does this peer
hold at least the first i+1 blocks of this prompt", and matching depth is
monotone by construction.

The advertised set is bounded (the digest is a wire payload repeated on
the ping cadence): an LRU of recent chains, trimmed to the newest few
dozen hashes. False positives are only a mild mis-weighting — routing is
a preference, never a correctness contract.

PyTorch port: a copy of ``bee2bee_tpu/router/prefixmap.py`` with the import root rewritten to
``bee2bee_tpu_torch``; comments that cited the JAX package's change history or the
reference checkout's path are trimmed.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

# block geometry: 256 chars ≈ 64-90 tokens for typical BPE English — a
# couple of KV blocks' worth, deep enough that a match predicts a real
# prefill saving. 4 blocks bound the hash work per request at ~1 KiB.
PREFIX_BLOCK_CHARS = 256
MAX_PREFIX_BLOCKS = 4


def prompt_prefix_hashes(prompt: str | None,
                         block_chars: int = PREFIX_BLOCK_CHARS,
                         max_blocks: int = MAX_PREFIX_BLOCKS) -> list[str]:
    """Chained hashes of the prompt's leading FULL blocks (shorter prompts
    produce fewer entries; below one block, none — there is nothing worth
    routing on). hashes[i] covers prompt[: (i+1) * block_chars]."""
    if not prompt or not isinstance(prompt, str):
        return []
    n = min(len(prompt) // block_chars, max_blocks)
    out: list[str] = []
    h = hashlib.sha256()
    for i in range(n):
        h.update(prompt[i * block_chars:(i + 1) * block_chars].encode("utf-8"))
        out.append(h.hexdigest()[:16])
    return out


class PrefixTracker:
    """Bounded LRU of prefix-chain hashes this node recently served.

    ``note()`` sits on the node's single serving funnel
    (meshnet/node._execute_local), so the advertisement tracks what the
    engine's prefix cache plausibly holds without coupling to any one
    backend. All access happens on the node's event loop — no locking."""

    def __init__(self, capacity: int = 256, advertise: int = 64):
        self.capacity = capacity
        self.advertise = advertise
        self._hashes: OrderedDict[str, bool] = OrderedDict()

    def note(self, prompt: str | None) -> None:
        for h in prompt_prefix_hashes(prompt):
            self._hashes.pop(h, None)  # LRU touch
            self._hashes[h] = True
        while len(self._hashes) > self.capacity:
            self._hashes.pop(next(iter(self._hashes)))

    def advertised(self) -> list[str]:
        """Newest-first hash list for the telemetry digest (bounded)."""
        return list(self._hashes)[-self.advertise:][::-1]

    def __len__(self) -> int:
        return len(self._hashes)


def match_depth(prompt_hashes: list[str], advertised) -> int:
    """Deepest block count the advertised set covers: chaining makes depth
    monotone, so the deepest matching hash alone tells the story."""
    if not prompt_hashes or not advertised:
        return 0
    adv = set(advertised)
    for i in range(len(prompt_hashes) - 1, -1, -1):
        if prompt_hashes[i] in adv:
            return i + 1
    return 0
