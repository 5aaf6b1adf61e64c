"""The one error for a branch of the JAX package that the port does not
run yet: ``NotImplementedError`` naming the ROADMAP.md item (queue A)
that will lift it, so nothing falls back silently to another path."""

from __future__ import annotations


def unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md queue A item {item})"
    )
