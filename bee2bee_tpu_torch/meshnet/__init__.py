"""The P2P mesh runtime: WebSocket nodes with peer discovery, service
announcement, health monitoring, request routing with swarm relay, streaming
generation, and hash-verified piece transfer (reference p2p_runtime.py:33-980
reimagined; wire-compatible message set, known defects fixed — see node.py).

PyTorch port: a copy of ``bee2bee_tpu/meshnet/__init__.py`` with the import root rewritten to
``bee2bee_tpu_torch``.
"""

from .node import P2PNode  # noqa: F401
from .pipeline import (  # noqa: F401 — the pipeline failure taxonomy
    StageDead,
    StageError,
    StageTimeout,
)
from .runtime import run_p2p_node  # noqa: F401
