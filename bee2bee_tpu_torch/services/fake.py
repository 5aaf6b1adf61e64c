"""FakeService: deterministic in-memory backend for tests.

SURVEY §4: "no fake model backend (tests simply skip model paths)" is a
reference gap we close — the whole mesh/gateway stack is testable without
loading a model.

PyTorch port: a copy of ``bee2bee_tpu/services/fake.py`` with the import root rewritten to
``bee2bee_tpu_torch``.
"""

from __future__ import annotations

import time
from typing import Any, Iterator

from .base import BaseService


class FakeService(BaseService):
    def __init__(
        self,
        model_name: str = "fake-model",
        price_per_token: float = 0.0,
        reply: str | None = None,
        chunk_size: int = 4,
        fail_with: str | None = None,
        delay_s: float = 0.0,  # per-chunk stream delay (chaos/latency tests)
        exec_delay_s: float = 0.0,  # whole-execute() delay: makes a node
        # saturable for admission/fairness tests and the bench rung
    ):
        super().__init__("fake")
        self.model_name = model_name
        self.price_per_token = price_per_token
        self.reply = reply
        self.chunk_size = chunk_size
        self.fail_with = fail_with
        self.delay_s = delay_s
        self.exec_delay_s = exec_delay_s
        self.calls: list[dict] = []

    def get_metadata(self) -> dict[str, Any]:
        return {
            "models": [self.model_name],
            "price_per_token": self.price_per_token,
            "max_new_tokens": 2048,
        }

    def _reply_for(self, params: dict) -> str:
        if self.reply is not None:
            return self.reply
        return f"echo({self._require_prompt(params)})"

    def _timing(self, t0: float, n_tokens: int) -> dict:
        """Engine-shaped per-request breakdown (engine.py _build_result):
        the mesh/gateway timing plumbing is testable without a model."""
        e2e_ms = (time.time() - t0) * 1000.0
        return {
            "queue_wait_ms": 0.0,
            "prefill_ms": round(e2e_ms, 3),
            "ttft_ms": round(e2e_ms, 3),
            "decode_tokens": n_tokens,
            "tokens_per_s": (
                round(n_tokens / (e2e_ms / 1000.0), 2) if e2e_ms > 0 else 0.0
            ),
            "spec_acceptance": None,
        }

    def execute(self, params: dict[str, Any]) -> dict[str, Any]:
        self.calls.append(dict(params))
        if self.fail_with:
            from .base import ServiceError

            raise ServiceError(self.fail_with)
        t0 = time.time()
        if self.exec_delay_s:
            time.sleep(self.exec_delay_s)  # runs in the node's executor
        text = self._reply_for(params)
        n = len(text.split())
        out = self.result_dict(text, n, t0, self.price_per_token)
        out["timing"] = self._timing(t0, n)
        return out

    def execute_stream(self, params: dict[str, Any]) -> Iterator[str]:
        self.calls.append(dict(params))
        if self.fail_with:
            yield self.stream_line({"status": "error", "message": self.fail_with})
            return
        t0 = time.time()
        text = self._reply_for(params)
        for i in range(0, len(text), self.chunk_size):
            if self.delay_s:
                time.sleep(self.delay_s)
            yield self.stream_line({"text": text[i : i + self.chunk_size]})
        n = len(text.split())  # same accounting as execute()
        yield self.stream_line(
            {"done": True, "tokens": n, "cost": self.price_per_token * n,
             "timing": self._timing(t0, n)}
        )
