"""Content-addressed pieces: chunk/hash/verify blobs, and map pieces to
parameter shards on a device mesh.

Capability parity with reference pieces (bee2bee/pieces.py:7-32:
split, per-piece sha256, verify+reassemble, persist). The TPU-native extension
is the *shard manifest*: a piece is not an arbitrary byte range but one
parameter's shard for specific mesh coordinates, so a peer joining a
tensor-parallel serving group can fetch exactly the hash-verified pieces its
mesh position needs (SURVEY §7 hard part 4) and `jax.device_put` them onto
its addressable devices.

PyTorch port: a copy of ``bee2bee_tpu/pieces.py`` with the import root
rewritten to ``bee2bee_tpu_torch``; comments that cited the JAX package's
change history or the reference checkout's path are trimmed. Hashing is
hashlib's alone: the JAX package's C++ codec (``native.py``) has no binding
here.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from pathlib import Path

from .joinlink import chunk_bytes
from .utils import sha256_hex

DEFAULT_PIECE_SIZE = 4 * 1024 * 1024  # fits the 32 MiB WS frame with headroom


def split_pieces(data: bytes, piece_size: int = DEFAULT_PIECE_SIZE) -> list[bytes]:
    """(reference pieces.py:7-8)"""
    return chunk_bytes(data, piece_size)


def piece_hashes(pieces: list[bytes]) -> list[str]:
    """(reference pieces.py:11-12) — hashlib, one piece at a time."""
    return [sha256_hex(p) for p in pieces]


def verify_and_reassemble(pieces: list[bytes], hashes: list[str]) -> bytes:
    """Verify each piece hash then concatenate (reference pieces.py:15-21)."""
    if len(pieces) != len(hashes):
        raise ValueError(f"piece/hash count mismatch: {len(pieces)} vs {len(hashes)}")
    bad = next((i for i, (p, h) in enumerate(zip(pieces, hashes))
                if sha256_hex(p) != h), -1)
    if bad >= 0:
        got = sha256_hex(pieces[bad])
        raise ValueError(f"piece {bad} hash mismatch: {got[:12]} != {hashes[bad][:12]}")
    return b"".join(pieces)


def save_pieces(pieces: list[bytes], directory: Path | str) -> list[Path]:
    """Persist pieces content-addressed to disk (reference pieces.py:24-32)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    import tempfile

    out = []
    for p in pieces:
        path = directory / sha256_hex(p)
        if not path.exists():
            # mkstemp for a concurrency-safe unique tmp (same pattern as
            # utils.save_json) — a fixed ".tmp" suffix would let two writers
            # interleave and publish corrupt bytes under the content hash
            fd, tmp = tempfile.mkstemp(dir=str(directory), suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                f.write(p)
            os.replace(tmp, path)
        out.append(path)
    return out


def load_piece(directory: Path | str, digest: str) -> bytes:
    data = (Path(directory) / digest).read_bytes()
    if sha256_hex(data) != digest:
        raise ValueError(f"on-disk piece corrupt: {digest[:12]}")
    return data


# ---- shard manifests ---------------------------------------------------------


@dataclass
class ShardPiece:
    """One parameter-shard piece: which param, which mesh slice, which hash."""

    param: str  # flat param path, e.g. "layers/3/attn/wq"
    shard_index: int  # index along the sharded axis
    shard_count: int  # total shards of this param
    axis: int | None  # tensor axis that is sharded (None = replicated piece)
    mesh_axis: str | None  # mesh axis name ("model", "expert", ...)
    shape: list[int] = field(default_factory=list)  # shard shape
    dtype: str = "bfloat16"
    nbytes: int = 0
    sha256: str = ""


@dataclass
class ShardManifest:
    """Content-addressed description of a fully sharded checkpoint.

    `pieces_for(mesh_axis_index)` returns exactly the pieces a peer at the
    given coordinate on `mesh_axis` must fetch — replicated pieces plus its
    slice of each sharded param.
    """

    model: str
    total_bytes: int = 0
    pieces: list[ShardPiece] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(
            {
                "model": self.model,
                "total_bytes": self.total_bytes,
                "pieces": [asdict(p) for p in self.pieces],
            },
            separators=(",", ":"),
        )

    @classmethod
    def from_json(cls, raw: str) -> "ShardManifest":
        obj = json.loads(raw)
        m = cls(model=obj["model"], total_bytes=obj.get("total_bytes", 0))
        m.pieces = [ShardPiece(**p) for p in obj.get("pieces", [])]
        return m

    def pieces_for(self, coords: dict[str, int] | str, index: int | None = None) -> list[ShardPiece]:
        """Pieces a peer at the given mesh coordinates must fetch: replicated
        pieces plus, for every mesh axis the peer has a coordinate on, its
        slice of each param sharded on that axis.

        `coords` is {mesh_axis: index}; the legacy ("axis", i) call form is
        accepted too. Raises if the manifest shards a param on an axis the
        peer supplied no coordinate for — silently dropping those params
        would hand the peer an incomplete checkpoint.
        """
        if isinstance(coords, str):
            coords = {coords: int(index)}  # legacy (mesh_axis, index) form
        out = []
        for p in self.pieces:
            if p.mesh_axis is None:
                out.append(p)
            elif p.mesh_axis in coords:
                if p.shard_index == coords[p.mesh_axis]:
                    out.append(p)
            else:
                raise ValueError(
                    f"param {p.param!r} is sharded on mesh axis {p.mesh_axis!r} "
                    f"but coords only cover {sorted(coords)}"
                )
        return out

    def piece_by_hash(self, digest: str) -> ShardPiece | None:
        for p in self.pieces:
            if p.sha256 == digest:
                return p
        return None


def build_shard_manifest(model: str, params: dict, partition_specs: dict, mesh_axes: dict[str, int]) -> tuple[ShardManifest, dict[str, bytes]]:
    """Shard a flat {path: np.ndarray} param dict per {path: PartitionSpec-like
    tuple} and emit (manifest, {sha256: piece_bytes}).

    `partition_specs[path]` is a tuple with one entry per tensor axis; entries
    are a mesh-axis name or None. Only the first sharded axis is split (one
    level — matches TP-style layouts where each param shards on one axis).
    `mesh_axes` maps axis name → size.
    """
    import numpy as np

    manifest = ShardManifest(model=model)
    blobs: dict[str, bytes] = {}
    pending: list[tuple] = []

    for path in sorted(params):
        arr = np.asarray(params[path])
        spec = tuple(partition_specs.get(path) or ())
        axis = None
        mesh_axis = None
        for i, entry in enumerate(spec):
            if entry is not None:
                axis, mesh_axis = i, entry
                break
        if axis is None or mesh_axes.get(mesh_axis, 1) <= 1:
            shards = [arr]
            axis = mesh_axis = None
        else:
            n = mesh_axes[mesh_axis]
            if arr.shape[axis] % n != 0:
                raise ValueError(
                    f"{path}: axis {axis} size {arr.shape[axis]} not divisible by mesh axis {mesh_axis}={n}"
                )
            shards = np.split(arr, n, axis=axis)
        for idx, shard in enumerate(shards):
            data = np.ascontiguousarray(shard).tobytes()
            pending.append((path, idx, len(shards), axis, mesh_axis, shard, data))

    digests = piece_hashes([p[-1] for p in pending])
    for (path, idx, count, axis, mesh_axis, shard, data), digest in zip(
        pending, digests
    ):
        blobs[digest] = data
        manifest.pieces.append(
            ShardPiece(
                param=path,
                shard_index=idx,
                shard_count=count,
                axis=axis,
                mesh_axis=mesh_axis,
                shape=list(shard.shape),
                dtype=str(shard.dtype),
                nbytes=len(data),
                sha256=digest,
            )
        )
        manifest.total_bytes += len(data)
    return manifest, blobs


def assemble_params_from_pieces(
    manifest: ShardManifest,
    blobs: dict[str, bytes],
    coords: dict[str, int] | str,
    index: int | None = None,
) -> dict:
    """Rebuild the {path: np.ndarray} shard dict for one mesh coordinate from
    hash-verified piece bytes."""
    import numpy as np

    out: dict = {}
    for p in manifest.pieces_for(coords, index):
        data = blobs.get(p.sha256)
        if data is None:
            raise KeyError(f"missing piece {p.sha256[:12]} for {p.param}")
        if sha256_hex(data) != p.sha256:
            raise ValueError(f"piece corrupt for {p.param}[{p.shard_index}]")
        out[p.param] = np.frombuffer(data, dtype=p.dtype).reshape(p.shape)
    return out
