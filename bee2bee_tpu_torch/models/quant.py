"""Weight-only int8 quantization for serving.

Decode is bandwidth-bound on the WEIGHTS (every step streams all of them);
storing the big matmul weights as int8 + per-output-channel f32 scales
halves that traffic against bf16, with activations left in their type.

Representation: a quantized weight is the subtree {"q": int8 [..., in,
out], "s": f32 [..., out]} in place of the dense array. Per-OUT-channel
scales commute with the matmul — (x @ q) * s == x @ (q * s) — so
core.matmul applies them after the dot.

What quantizes: attention projections (wq/wk/wv/wo), the dense-MLP
weights (w_up/w_gate/w_down) and the MoE expert stacks (moe/w_up, w_gate,
w_down: [E, in, out], scales [E, out], amax over the in dim per expert).
Embeddings (a gather, often tied to the LM head), norms and the MoE router
stay dense.

The port of ``bee2bee_tpu/models/quant.py``: ``QUANT_SUFFIXES``,
``is_quantized``, ``quantize_weight``, ``dequantize_weight`` and
``quantize_params`` on numpy are copies, bit for bit. Added here:

- ``quantize_weight_torch``: the same arithmetic on a tensor, on its own
  device (the same f32 ops in the same order: amax over the in dim, a
  divide by 127, round half to even, clip), so q and s are bit-equal to
  numpy's on the same f32 input; random llama-3-8b weights are made on
  the card and quantized there, tensor by tensor.
- ``quantize_params_``: quantize a port parameter dict IN PLACE, each
  dense tensor dropped as soon as its int8 form exists.
- **One layout everywhere.** The engine keeps JAX's ``{"q": int8 [in,
  out], "s": f32 [out]}``: the int8-weight GEMM (ops/int8_gemm.py) reads
  it as it lies through TMA maps, and its wrapper refuses on the card a
  shape the maps cannot take. An expert stack keeps {"q": int8 [E, in,
  out], "s": f32 [E, out]} on every device: the grouped expert GEMM
  (ops/moe.py) reads it as it lies and converts in registers.
- ``dequant_scratch_bytes``: the peak scratch of a product that converts
  the widest weight into the engine's dtype (the HBM ledger's
  ``int8_dequant_scratch``): every product of the CPU's plain version,
  only f32 prefill chunks on the card (bf16 runs a kernel at every
  width); no expert stack needs any.
"""

from __future__ import annotations

import numpy as np
import torch

# path suffixes (models/partition path convention) that quantize
QUANT_SUFFIXES = (
    "attn/wq", "attn/wk", "attn/wv", "attn/wo",
    "mlp/w_up", "mlp/w_gate", "mlp/w_down",
    "moe/w_up", "moe/w_gate", "moe/w_down",  # per-expert scales
)


def is_quantized(w) -> bool:
    """An int8 weight ({"q", "s"})."""
    return isinstance(w, dict) and "q" in w and "s" in w


def quantize_weight(w: np.ndarray) -> dict:
    """[..., in, out] float -> {"q": int8 same shape, "s": f32 [..., out]}
    with symmetric per-out-channel scales (amax over the in dim)."""
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=-2)  # [..., out]
    s = (amax / 127.0).astype(np.float32)
    safe = np.where(s == 0.0, 1.0, s)
    q = np.clip(np.rint(w / safe[..., None, :]), -127, 127).astype(np.int8)
    return {"q": q, "s": s}


def dequantize_weight(qw: dict) -> np.ndarray:
    return qw["q"].astype(np.float32) * qw["s"][..., None, :]


def quantize_params(params: dict) -> dict:
    """Return a copy of the param tree with QUANT_SUFFIXES weights
    replaced by {"q","s"} subtrees (host-side numpy)."""

    def walk(node, path=""):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        if path.endswith(QUANT_SUFFIXES):
            return quantize_weight(np.asarray(node))
        return node

    return walk(params)


def quantize_weight_torch(w: torch.Tensor) -> dict:
    """``quantize_weight`` on a tensor, on its device: the same f32
    operations in the same order, so q and s are bit-equal to numpy's on
    the same f32 input (torch.round rounds half to even, as np.rint). An
    expert stack [E, in, out] goes one expert at a time into preallocated
    q and s (the same values: the amax is per expert)."""
    if w.dim() == 3:
        qw = empty_quantized_stack(w.shape, w.device)
        for e in range(w.shape[0]):
            quantize_expert_into(qw, e, w[e])
        return qw
    wf = w.float()
    s = wf.abs().amax(dim=-2) / 127.0
    safe = torch.where(s == 0.0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(wf / safe.unsqueeze(-2)), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def empty_quantized_stack(shape, device) -> dict:
    """{"q" [E, in, out] int8, "s" [E, out] f32}, uninitialised: an int8
    expert stack for ``quantize_expert_into`` to fill expert by expert."""
    E, _, out = shape
    return {"q": torch.empty(tuple(shape), dtype=torch.int8, device=device),
            "s": torch.empty((E, out), dtype=torch.float32, device=device)}


def quantize_expert_into(qw: dict, e: int, w: torch.Tensor) -> None:
    """Expert ``e`` of an int8 stack: ``quantize_weight_torch`` of its
    [in, out] weight ``w``, written into qw["q"][e] and qw["s"][e]."""
    qe = quantize_weight_torch(w)
    qw["q"][e], qw["s"][e] = qe["q"], qe["s"]


def _quantized_slots(params: dict):
    """(holder dict, key) of every weight QUANT_SUFFIXES names in a port
    parameter dict (layers as a list)."""
    for lp in params.get("layers", []):
        for group in ("attn", "mlp", "moe"):
            sub = lp.get(group)
            if not isinstance(sub, dict):
                continue
            for key in list(sub):
                if f"{group}/{key}" in QUANT_SUFFIXES:
                    yield sub, key


def quantize_params_(params: dict) -> dict:
    """Quantize a port parameter dict IN PLACE (and return it): each
    QUANT_SUFFIXES weight becomes {"q", "s"}, computed on the weight's own
    device; the dense tensor's last reference goes before the next weight
    is touched, so peak memory holds one dense weight beside the int8 ones,
    never two copies of the layer stack."""
    for holder, key in _quantized_slots(params):
        w = holder[key]
        if is_quantized(w):
            continue
        qw = quantize_weight_torch(w)
        holder[key] = None
        del w
        holder[key] = qw
    return params


def dequant_scratch_bytes(params: dict, dtype: torch.dtype, device="cuda") -> int:
    """The most scratch one product over an int8 weight of ``params`` holds
    beside its output where the weight is converted into ``dtype`` before
    the product: on the CPU every product (the plain version), on the card
    an f32 chunk wider than the GEMM's decode kernel takes (ops/int8_gemm.py
    ``int8_gemm_route``: "dequant"); a bf16 engine on the card holds none.
    The widest weight's K * N elements of ``dtype``; 0 without int8
    weights. Expert stacks take none: the grouped expert GEMM converts in
    registers on every route."""
    if torch.device(device).type != "cpu" and dtype != torch.float32:
        return 0
    most = 0
    for holder, key in _quantized_slots(params):
        w = holder[key]
        if not is_quantized(w) or w["q"].dim() == 3:
            continue
        most = max(most, w["q"].numel() * dtype.itemsize)
    return most
