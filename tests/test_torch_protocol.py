"""The port's wire protocol (``bee2bee_tpu_torch/protocol.py``) against the
JAX package's: a JAX node and a CUDA node must read each other's frames.

- Every message type built by ``msg`` encodes to byte-identical JSON in
  both packages, and each package decodes the other's frame to the same
  dict; the wire constants are equal.
- Binary tensor frames (f32, int8, int32, bf16 and a 0-d scalar) encoded by
  one package decode bit for bit in the other. bf16 rides as its 16-bit
  pattern under the dtype string "bfloat16": the port carries it through
  torch, the JAX package through ml_dtypes.
- Importing and using the port's protocol loads no ml_dtypes (the card's
  machine need not have it).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from bee2bee_tpu import protocol as jp
from bee2bee_tpu_torch import protocol as tp

ROOT = Path(__file__).resolve().parent.parent
FIELDS = {
    "peer_id": "peer-1a2b", "rid": "req-9", "text": "héllo\nwörld ✓",
    "tokens": 7, "price_per_token": 0.25, "done": False,
    "meta": {"models": ["llama-3-8b"], "backend": "cuda", "nested": [1, 2.5, None]},
}


@pytest.mark.parametrize("type_", sorted(jp.MESSAGE_TYPES))
def test_message_builders_encode_byte_identical(type_):
    ours = tp.encode(tp.msg(type_, **FIELDS))
    theirs = jp.encode(jp.msg(type_, **FIELDS))
    assert ours == theirs
    assert tp.decode(theirs) == jp.decode(ours) == {"type": type_, **FIELDS}


def test_wire_constants_match():
    names = [n for n in dir(jp) if n.isupper()]
    assert names == [n for n in dir(tp) if n.isupper()]
    for name in names:
        assert getattr(tp, name) == getattr(jp, name), name


def _cases():
    rng = np.random.default_rng(7)
    bf16 = rng.standard_normal((4, 8)).astype(np.float32)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "int8": rng.integers(-128, 127, size=(2, 6), dtype=np.int8),
        "int32": rng.integers(0, 1 << 30, size=(9,), dtype=np.int32),
        "bf16": bf16.astype(ml_dtypes.bfloat16),
        "scalar": np.float32(-2.75),
    }


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        assert a.dtype == torch.bfloat16
        return a.view(torch.int16).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _as_torch(a):
    """The tensor a CUDA node would hand the codec: bf16 as a torch tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_tensor_frames_cross_bit_equal(direction):
    cases = _cases()
    header = {"type": jp.KV_BLOCKS, "rid": "mig-1", "seq": 3}
    if direction == "jax_to_port":
        raw = jp.encode_binary(header, cases)
        message, got = tp.decode_binary(raw)
    else:
        raw = tp.encode_binary(header, {k: _as_torch(v) for k, v in cases.items()})
        # the port's frame is the JAX frame, byte for byte
        assert raw == jp.encode_binary(header, cases)
        message, got = jp.decode_binary(raw)
    assert message == header
    assert list(got) == list(cases)
    for name, want in cases.items():
        assert list(np.shape(got[name])) == list(np.shape(want)), name
        assert np.array_equal(_bits(got[name]), _bits(want)), name
    assert isinstance(got["bf16"], torch.Tensor if direction == "jax_to_port" else np.ndarray)


def test_port_encodes_numpy_like_torch():
    cases = _cases()
    header = {"type": jp.TASK, "task_id": "t1"}
    assert tp.encode_binary(header, cases) == tp.encode_binary(
        header, {k: _as_torch(v) for k, v in cases.items()})


def test_protocol_loads_no_ml_dtypes():
    code = (
        "import sys, torch\n"
        "from bee2bee_tpu_torch import protocol as p\n"
        "x = torch.arange(6, dtype=torch.float32).reshape(2, 3).to(torch.bfloat16)\n"
        "m, t = p.decode_binary(p.encode_binary({'type': 'ping'}, {'x': x}))\n"
        "assert torch.equal(t['x'], x)\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('ml_dtypes', 'jax', 'bee2bee_tpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
