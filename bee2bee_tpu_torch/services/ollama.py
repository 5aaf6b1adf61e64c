"""OllamaService: proxy a local Ollama daemon behind the service contract
(reference services.py:118-245 — model-tag fuzzy matching, /api/generate
non-stream + stream).

PyTorch port: a copy of ``bee2bee_tpu/services/ollama.py`` with the import root rewritten to
``bee2bee_tpu_torch``.
"""

from __future__ import annotations

import json
import time
from typing import Any, Iterator

from .base import BaseService, ServiceError


class OllamaService(BaseService):
    def __init__(
        self,
        model_name: str,
        price_per_token: float = 0.0,
        host: str = "http://127.0.0.1:11434",
        max_new_tokens: int = 2048,
        timeout_s: float = 300.0,
    ):
        super().__init__("ollama")
        self.model_name = model_name
        self.price_per_token = price_per_token
        self.host = host.rstrip("/")
        self.max_new_tokens = max_new_tokens
        self.timeout_s = timeout_s
        self._resolved: str | None = None

    def get_metadata(self) -> dict[str, Any]:
        return {
            "models": [self.model_name],
            "price_per_token": self.price_per_token,
            "max_new_tokens": self.max_new_tokens,
            "backend": "ollama",
        }

    def _resolve_tag(self) -> str:
        """Fuzzy-match the configured model against installed tags (the
        reference's both-ways `in` match, services.py:136-151)."""
        if self._resolved:
            return self._resolved
        import requests

        try:
            r = requests.get(f"{self.host}/api/tags", timeout=5)
            r.raise_for_status()
            tags = [m.get("name", "") for m in r.json().get("models", [])]
        except Exception as e:
            raise ServiceError(f"ollama unreachable at {self.host}: {e}")
        want = self.model_name.lower()
        for tag in tags:
            if tag.lower() == want:
                self._resolved = tag
                return tag
        for tag in tags:
            t = tag.lower()
            if want in t or t.split(":")[0] in want:
                self._resolved = tag
                return tag
        raise ServiceError(f"model {self.model_name!r} not found in ollama (have: {tags})")

    def _payload(self, params: dict, stream: bool) -> dict:
        return {
            "model": self._resolve_tag(),
            "prompt": self._require_prompt(params),
            "stream": stream,
            "options": {
                "num_predict": int(params.get("max_new_tokens", self.max_new_tokens)),
                "temperature": float(params.get("temperature", 0.7)),
            },
        }

    def execute(self, params: dict[str, Any]) -> dict[str, Any]:
        import requests

        t0 = time.time()
        try:
            r = requests.post(
                f"{self.host}/api/generate",
                json=self._payload(params, stream=False),
                timeout=self.timeout_s,
            )
            r.raise_for_status()
            body = r.json()
        except ServiceError:
            raise
        except Exception as e:
            raise ServiceError(f"ollama generate failed: {e}")
        text = body.get("response", "")
        new_tokens = int(body.get("eval_count") or max(1, len(text) // 4))
        out = self.result_dict(text, new_tokens, t0, self.price_per_token)
        if body.get("total_duration"):
            out["latency_ms"] = int(body["total_duration"] / 1e6)  # ns → ms
        return out

    # Loop-native variants: every OllamaService call blocks on a local-HTTP
    # round trip (tag resolution + /api/generate), so serving it under the
    # async gateway must offload to a worker thread — these wrappers are
    # what meshnet/node._execute_local picks up; sync callers are unchanged
    # (meshlint ML-A001 bug class: one blocking call stalls every in-flight
    # generation on the node's loop).
    execute_async = BaseService._execute_via_thread
    execute_stream_async = BaseService._stream_via_thread

    def execute_stream(self, params: dict[str, Any]) -> Iterator[str]:
        import requests

        try:
            r = requests.post(
                f"{self.host}/api/generate",
                json=self._payload(params, stream=True),
                stream=True,
                timeout=self.timeout_s,
            )
            r.raise_for_status()
            for line in r.iter_lines():
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if obj.get("response"):
                    yield self.stream_line({"text": obj["response"]})
                if obj.get("done"):
                    break
            yield self.stream_line({"done": True})
        except Exception as e:
            yield self.stream_line({"status": "error", "message": f"Stream error: {e}"})
