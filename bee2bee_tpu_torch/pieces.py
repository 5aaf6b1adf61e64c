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
here. What differs from the JAX module:

- **Pieces fit the frame.** A piece travels in one ``PIECE_DATA`` frame,
  which links cap at ``protocol.MAX_FRAME`` (32 MiB). The JAX publisher
  makes one piece per tensor; at llama-3-8b widths almost none fits
  (``tok_embed`` is 1.05 GB, one layer's ``wq`` 32 MiB before the header).
  ``build_shard_manifest`` here publishes a tensor of more than
  ``DEFAULT_PIECE_SIZE`` bytes as shards along one axis, in the manifest's
  existing ``shard_count`` / ``axis`` fields with ``mesh_axis`` None
  (shards may be unequal). The JAX package's ``load_native`` and its full
  mesh fetch concatenate such shards unchanged. A coordinate fetch would
  keep one shard of such a tensor, so ``assemble_params_from_pieces``
  refuses it (ROADMAP.md queue A item 14).
- **bfloat16 without ml_dtypes.** A bf16 piece carries the dtype string
  "bfloat16" (the name ml_dtypes gives numpy). Here the host holds it as
  its 16-bit pattern in ``HOST_BF16``, a one-field structured dtype named
  "bfloat16": it stacks, splits and concatenates like any numpy array and
  refuses arithmetic. ``dtype_name`` and ``host_dtype`` map between the
  piece's string and the array, so no ``frombuffer`` of a piece needs
  ml_dtypes.
- ``reassemble`` is the full reassembly (verify each piece, concatenate
  each tensor's shards) that ``models/loader.load_native`` and the mesh
  join (``meshnet/weights.py``) share.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from pathlib import Path

import numpy as np

from .joinlink import chunk_bytes
from .unported import unported
from .utils import sha256_hex

DEFAULT_PIECE_SIZE = 4 * 1024 * 1024  # fits the 32 MiB WS frame with headroom

# bfloat16's bit pattern under the name "bfloat16" (see the module docstring)
HOST_BF16 = np.dtype([("bfloat16", "<u2")])


def dtype_name(a) -> str:
    """The piece dtype string of a host array: "bfloat16" for HOST_BF16 and
    for an ml_dtypes bfloat16 array, numpy's name otherwise."""
    return a.dtype.names[0] if a.dtype.names else a.dtype.name


def host_dtype(name: str) -> np.dtype:
    """The numpy dtype a piece of dtype string ``name`` is read into."""
    return HOST_BF16 if name == "bfloat16" else np.dtype(name)


def piece_array(data: bytes, piece: "ShardPiece") -> np.ndarray:
    """A piece's bytes as its shard array (read only, no copy)."""
    return np.frombuffer(data, dtype=host_dtype(piece.dtype)).reshape(piece.shape)


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


def _split_to_budget(path: str, arr, budget: int) -> tuple[int, list]:
    """(axis, shards) of a tensor whose bytes exceed ``budget``: the first
    axis whose one-index slab fits splits into as few near-equal shards
    (np.array_split) as keep each within the budget."""
    for axis, n in enumerate(arr.shape):
        slab = arr.nbytes // n
        if slab <= budget:
            per = budget // slab
            return axis, np.array_split(arr, -(-n // per), axis=axis)
    raise ValueError(f"{path}: no axis of {arr.shape} splits under {budget} bytes")


def build_shard_manifest(model: str, params: dict, partition_specs: dict,
                         mesh_axes: dict[str, int],
                         split_to_frame: bool = True) -> tuple[ShardManifest, dict[str, bytes]]:
    """Shard a flat {path: np.ndarray} param dict per {path: PartitionSpec-like
    tuple} and emit (manifest, {sha256: piece_bytes}).

    `partition_specs[path]` is a tuple with one entry per tensor axis; entries
    are a mesh-axis name or None. Only the first sharded axis is split (one
    level — matches TP-style layouts where each param shards on one axis).
    `mesh_axes` maps axis name → size. With ``split_to_frame`` an unsharded
    tensor of more than DEFAULT_PIECE_SIZE bytes becomes shards along one
    axis (``_split_to_budget``, ``mesh_axis`` None); adapter manifests keep
    the JAX package's whole-tensor pieces, which its adapter fetch needs.
    """
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
            if split_to_frame and arr.nbytes > DEFAULT_PIECE_SIZE:
                axis, shards = _split_to_budget(path, arr, DEFAULT_PIECE_SIZE)
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
                dtype=dtype_name(shard),
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
    hash-verified piece bytes. A tensor split to the frame budget (shards
    with ``mesh_axis`` None) raises: every coordinate needs it whole, and
    joining its shards at a coordinate is ROADMAP.md queue A item 14."""
    out: dict = {}
    for p in manifest.pieces_for(coords, index):
        if p.mesh_axis is None and p.shard_count > 1:
            raise unported(f"a coordinate fetch of {p.param!r}, split into "
                           f"{p.shard_count} pieces to fit the frame", 14)
        out[p.param] = piece_array(_verified(blobs, p), p)
    return out


def _verified(blobs: dict[str, bytes], p: ShardPiece) -> bytes:
    data = blobs.get(p.sha256)
    if data is None:
        raise KeyError(f"missing piece {p.sha256[:12]} for {p.param}")
    if sha256_hex(data) != p.sha256:
        raise ValueError(f"piece corrupt for {p.param}[{p.shard_index}]")
    return data


def reassemble(manifest: ShardManifest, blobs: dict[str, bytes]) -> dict:
    """The whole {path: np.ndarray} tree of a manifest: every piece
    hash-verified, each tensor's shards (mesh or frame-budget) concatenated
    along their axis. Unsplit tensors are read-only views of ``blobs``."""
    flat: dict = {}
    parts: dict[str, list] = {}
    axes: dict[str, int] = {}
    for p in manifest.pieces:
        arr = piece_array(_verified(blobs, p), p)
        if p.shard_count > 1:
            parts.setdefault(p.param, [None] * p.shard_count)[p.shard_index] = arr
            axes[p.param] = p.axis
        else:
            flat[p.param] = arr
    for name, shards in parts.items():
        if any(s is None for s in shards):
            raise KeyError(f"{name}: the manifest lists {len(shards)} shards, "
                           f"some are missing")
        flat[name] = np.concatenate(shards, axis=axes[name])
    return flat
