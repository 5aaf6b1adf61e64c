"""The service contract every backend implements.

The PyTorch port's own copy of ``bee2bee_tpu/services/base.py``, so a
CUDA backend returns exactly the result dicts and stream lines a TPU
backend does. The async thread bridges the mesh gateway uses come with
the node slice of the port.

Wire-compatible with the reference (`services.py:13-25`): `get_metadata()`
feeds hello/service_announce messages; `execute(params) -> result dict` with
keys text/tokens/latency_ms/price_per_token/cost (reference services.py:
101-113); `execute_stream(params)` yields JSON-lines `{"text": chunk}` then
`{"done": true}` (reference services.py:74-80).
"""

from __future__ import annotations

import json
import time
from typing import Any, Iterator

from ..metrics import get_registry

# every backend's execute() funnels through result_dict, so this one
# histogram covers service execute latency (streaming paths report their
# own done-line accounting)
_H_EXECUTE = get_registry().histogram(
    "service.execute_ms", "service execute() latency per request (ms)"
)


class ServiceError(Exception):
    pass


class BaseService:
    """A hostable inference backend."""

    def __init__(self, name: str):
        self.name = name

    def get_metadata(self) -> dict[str, Any]:
        return {}

    def execute(self, params: dict[str, Any]) -> dict[str, Any]:
        raise NotImplementedError

    def execute_stream(self, params: dict[str, Any]) -> Iterator[str]:
        raise NotImplementedError

    # -- shared helpers -------------------------------------------------------

    @staticmethod
    def _require_prompt(params: dict) -> str:
        prompt = params.get("prompt")
        if not prompt:
            raise ServiceError("Missing prompt")
        return prompt

    @staticmethod
    def result_dict(text: str, new_tokens: int, t0: float, price_per_token: float) -> dict:
        """The reference's result schema (services.py:101-113)."""
        latency_ms = int((time.time() - t0) * 1000.0)
        _H_EXECUTE.observe(latency_ms)
        return {
            "text": text,
            "tokens": int(new_tokens),
            "latency_ms": latency_ms,
            "price_per_token": price_per_token,
            "cost": price_per_token * int(new_tokens),
        }

    @staticmethod
    def stream_line(obj: dict) -> str:
        return json.dumps(obj) + "\n"


def parse_transcript(prompt: str) -> tuple[list[dict], bool]:
    """Parse a `user:`/`assistant:` transcript into chat messages (the
    reference does this inside generation, hf.py:54-81; we keep it at the
    service boundary). Returns (messages, was_transcript)."""
    lines = prompt.splitlines()
    roles = ("user:", "assistant:", "system:")
    if not any(ln.strip().lower().startswith(roles) for ln in lines):
        return [{"role": "user", "content": prompt}], False
    messages: list[dict] = []
    cur_role, cur = None, []
    for ln in lines:
        low = ln.strip().lower()
        matched = next((r for r in roles if low.startswith(r)), None)
        if matched:
            if cur_role is not None:
                messages.append({"role": cur_role, "content": "\n".join(cur).strip()})
            cur_role = matched[:-1]
            cur = [ln.strip()[len(matched):].lstrip()]
        elif cur_role is not None:
            cur.append(ln)
    if cur_role is not None:
        messages.append({"role": cur_role, "content": "\n".join(cur).strip()})
    return messages, True


STOP_MARKERS = ("\nuser:", "\nassistant:", "\nsystem:", "user:", "assistant:")
# streaming must hold back this many chars: a marker may still complete
STOP_HOLDBACK = max(len(m) for m in STOP_MARKERS) - 1


def normalize_stops(stop) -> tuple:
    """A request's `stop` param (OpenAI: string or list of strings) →
    tuple of non-empty strings, capped at 4 like OpenAI. Malformed values
    (ints, dicts, ...) normalize to () — a bad param must not crash the
    request after the compute is spent."""
    if not stop:
        return ()
    if isinstance(stop, str):
        stop = [stop]
    if not isinstance(stop, (list, tuple)):
        return ()
    return tuple(s for s in stop if isinstance(s, str) and s)[:4]


def role_cut(text: str) -> int:
    """Cut position for hallucinated role markers (idx > 0 rule: a reply
    that IS a role line isn't deleted whole — reference hf.py:111-136)."""
    cut = len(text)
    for marker in STOP_MARKERS:
        idx = text.find(marker)
        if idx > 0:
            cut = min(cut, idx)
    return cut


def stop_cut(text: str, stops: tuple) -> int | None:
    """Earliest caller-stop position (OpenAI semantics: ANY position,
    including 0), or None when no stop matches."""
    best = None
    for stop in stops:
        idx = text.find(stop)
        if idx >= 0 and (best is None or idx < best):
            best = idx
    return best


def scrub_stop_words(text: str, stops: tuple = ()) -> str:
    """Cut generation at a role-marker or caller stop string, whichever
    comes first (role_cut / stop_cut hold the two rules)."""
    cut = role_cut(text)
    sc = stop_cut(text, stops)
    if sc is not None:
        cut = min(cut, sc)
    return text[:cut]


def stop_holdback(stops: tuple = ()) -> int:
    return max([STOP_HOLDBACK] + [len(s) - 1 for s in stops])


def scrub_stream_delta(
    acc_text: str, emitted: int, stops: tuple = ()
) -> tuple[str, int, bool]:
    """Streaming stop-scrub step over CUMULATIVE text: returns
    (delta_to_emit, new_emitted, marker_hit). Holds back enough chars
    that a marker or stop string split across chunk boundaries never
    leaks its prefix — the streamed bytes must equal what execute()'s
    full-text scrub produces. Shared by every streaming backend
    (cuda)."""
    scrubbed = scrub_stop_words(acc_text, stops)
    if len(scrubbed) < len(acc_text):  # a marker completed: flush & stop
        return scrubbed[emitted:], len(scrubbed), True
    safe = max(emitted, len(scrubbed) - stop_holdback(stops))
    return scrubbed[emitted:safe], safe, False
