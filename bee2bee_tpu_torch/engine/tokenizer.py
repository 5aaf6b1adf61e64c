"""Tokenizers: HF tokenizer when a local checkpoint provides one, byte-level
fallback otherwise (nothing may download).

The PyTorch port's own copy of ``bee2bee_tpu/engine/tokenizer.py``: the
same ids for the same text, so a prompt tokenizes identically on a TPU
node and a CUDA node. One difference: a path that holds tokenizer files
(``TOKENIZER_FILES``) never falls back to bytes. When ``transformers``
cannot be imported (the card's machine has none) or the files do not
load, ``load_tokenizer`` raises ``TokenizerLoadError``: a real checkpoint
served with byte ids would be silently wrong. A path with no tokenizer
files takes the byte tokenizer, as in JAX.

The reference requires `transformers` tokenizers unconditionally (reference
hf.py:23-32); here the fallback keeps every code path (engine, services,
mesh, bench) runnable offline, and the interface is the small subset the
engine needs.
"""

from __future__ import annotations

from pathlib import Path


class ByteTokenizer:
    """Reversible byte-level tokenizer: token = byte + 3 specials.

    ids 0..2 are pad/bos/eos; byte b maps to b+3. Works with any vocab_size
    >= 259; with tiny test vocabs (<259) bytes wrap modulo the space above
    the specials (lossy but still exercises every engine path).
    """

    pad_id = 0
    bos_id = 1
    eos_id = 2
    _OFFSET = 3

    def __init__(self, vocab_size: int = 50257):
        self.vocab_size = vocab_size
        self._span = max(vocab_size - self._OFFSET, 1)

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = [self._OFFSET + (b % self._span) for b in text.encode("utf-8")]
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids) -> str:
        data = bytes(
            (int(i) - self._OFFSET) % 256
            for i in ids
            if int(i) >= self._OFFSET
        )
        return data.decode("utf-8", errors="replace")

    @property
    def eos_token_id(self) -> int:
        return self.eos_id


class HFTokenizer:
    """Thin adapter over a transformers tokenizer loaded from a LOCAL path."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = len(self._tok)

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        # honor add_bos=False (continuation chunks must not get a BOS
        # injected mid-sequence) — mirrors ByteTokenizer's behavior
        return self._tok.encode(text, add_special_tokens=add_bos)

    def decode(self, ids) -> str:
        return self._tok.decode([int(i) for i in ids], skip_special_tokens=True)

    @property
    def eos_token_id(self) -> int:
        return self._tok.eos_token_id if self._tok.eos_token_id is not None else -1


TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model", "tokenizer_config.json")


class TokenizerLoadError(RuntimeError):
    """A checkpoint's tokenizer files could not be loaded."""


def load_tokenizer(model_name_or_path: str | None, vocab_size: int):
    """The local HF tokenizer of a path that holds tokenizer files (or
    TokenizerLoadError), else the byte tokenizer."""
    path = Path(model_name_or_path) if model_name_or_path else None
    if path is None or not path.exists():
        return ByteTokenizer(vocab_size)
    files = [f for f in TOKENIZER_FILES if (path / f).exists()]
    if not files:
        return ByteTokenizer(vocab_size)
    try:
        return HFTokenizer(str(path))
    except ImportError as e:
        raise TokenizerLoadError(
            f"{path} holds tokenizer files {files}, and transformers cannot be "
            f"imported to read them ({e}); serving byte ids instead would be "
            f"silently wrong"
        ) from e
    except Exception as e:  # noqa: BLE001 — name the files that failed
        raise TokenizerLoadError(f"{path}: tokenizer files {files} did not load: {e}") from e
