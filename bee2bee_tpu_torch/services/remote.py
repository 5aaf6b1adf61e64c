"""RemoteService: proxy the HF serverless Inference API (reference
services.py:247-308 — InferenceClient text_generation with char/4 token
estimates). Requires network + HUGGING_FACE_HUB_TOKEN; raises ServiceError
cleanly when offline.

PyTorch port: a copy of ``bee2bee_tpu/services/remote.py`` with the import root rewritten to
``bee2bee_tpu_torch``.
"""

from __future__ import annotations

import os
import time
from typing import Any, Iterator

from .base import BaseService, ServiceError


class RemoteService(BaseService):
    def __init__(
        self,
        model_name: str,
        price_per_token: float = 0.0,
        max_new_tokens: int = 2048,
        token: str | None = None,
    ):
        super().__init__("hf_remote")
        self.model_name = model_name
        self.price_per_token = price_per_token
        self.max_new_tokens = max_new_tokens
        self.token = token or os.environ.get("HUGGING_FACE_HUB_TOKEN")
        self._client = None

    def _client_or_raise(self):
        if self._client is None:
            try:
                from huggingface_hub import InferenceClient

                self._client = InferenceClient(model=self.model_name, token=self.token)
            except Exception as e:
                raise ServiceError(f"huggingface_hub unavailable: {e}")
        return self._client

    def get_metadata(self) -> dict[str, Any]:
        return {
            "models": [self.model_name],
            "price_per_token": self.price_per_token,
            "max_new_tokens": self.max_new_tokens,
            "backend": "hf_remote",
        }

    def execute(self, params: dict[str, Any]) -> dict[str, Any]:
        prompt = self._require_prompt(params)
        t0 = time.time()
        try:
            text = self._client_or_raise().text_generation(
                prompt,
                max_new_tokens=int(params.get("max_new_tokens", self.max_new_tokens)),
                temperature=max(float(params.get("temperature", 0.7)), 1e-3),
            )
        except ServiceError:
            raise
        except Exception as e:
            raise ServiceError(f"remote inference failed: {e}")
        # reference's char/4 estimate (services.py:296) — the API doesn't
        # return token counts
        return self.result_dict(text, max(1, len(text) // 4), t0, self.price_per_token)

    def execute_stream(self, params: dict[str, Any]) -> Iterator[str]:
        prompt = self._require_prompt(params)
        try:
            stream = self._client_or_raise().text_generation(
                prompt,
                max_new_tokens=int(params.get("max_new_tokens", self.max_new_tokens)),
                temperature=max(float(params.get("temperature", 0.7)), 1e-3),
                stream=True,
            )
            for chunk in stream:
                piece = getattr(getattr(chunk, "token", None), "text", None) or (
                    chunk if isinstance(chunk, str) else ""
                )
                if piece:
                    yield self.stream_line({"text": piece})
            yield self.stream_line({"done": True})
        except Exception as e:
            yield self.stream_line({"status": "error", "message": f"Stream error: {e}"})
