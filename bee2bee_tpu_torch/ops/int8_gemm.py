"""The int8-weight GEMM: y = (x @ q) * s for a weight-only quantized
projection (models/quant.py), x bf16 or f32 [..., K], q int8 [K, N], s f32
[N], y in x's type.

No Pallas kernel of the JAX package is replaced: its ``core.matmul``
computes ``(x @ q.astype(x.dtype)) * s`` and XLA fuses the int8 convert
into the dot's operand read. PyTorch has no such fusion, so on the card
the product goes through a hand-written kernel
(``csrc/int8_weight_gemm.cu``) that reads every int8 weight byte once per
row tile and never materialises a bf16 copy.

- **The layout**: the kernels read the JAX layout ``{"q": int8 [K, N],
  "s": f32 [N]}`` as it lies, through 2-D TMA maps (boxes of 64 inputs x
  128 channels), so the engine keeps the weights as JAX does and nothing
  is repacked. The wrapper refuses on the card a shape the maps cannot
  take: K % 8 != 0 (x's rows 16-byte aligned) or N % 16 != 0 (the
  weight's).
- **The plain version** ``int8_weight_matmul_ref``: the JAX formula,
  ``(x @ q.to(x.dtype)) * s.to(x.dtype)``. The CPU tests hold it against
  JAX ``core.matmul``; on the card the smoke holds the kernel against it
  (the kernel rounds once, after the scale, where the formula rounds the
  dot and the product: within a bf16 ulp or two).
- **Two kernels, three forms** (``int8_gemm_route``, from the token count
  M and x's type, host facts):
  - ``decode`` (kernel A, M <= ``CROSSOVER_M``, every decode and verify
    root): one row tile of 8 * ceil(M / 8) tokens, bf16 on wgmma
    (``int8_weight_matmul.launches``) or f32 on 2xTF32 mma.sync
    (``.f32_launches``);
  - ``prefill`` (kernel B, bf16 M > ``CROSSOVER_M``): row tiles of 128 or
    256 tokens on wgmma, no scratch (``.prefill_launches``);
  - ``dequant`` (f32 M > ``CROSSOVER_M``): the JAX package's own product,
    the weight converted to f32 into scratch, ``torch.matmul`` with the
    full-f32 product PyTorch runs by default (``allow_tf32`` False), then
    the scale (``.dequant_launches``).
  ``int8_weight_matmul_group`` takes up to three weights that share x in
  one launch (wq|wk|wv and w_up|w_gate: 4 launches a layer). CPU tensors
  take the plain version. Anything else raises: no route falls back to
  another, and no type other than bf16 and f32 reaches the card.
- **The plan** (``gemm_plan``: the row tile and the K splits) is a
  function of (M, K, the widths, SM count) only, so a captured CUDA graph
  keeps it. A split writes f32 partial sums into scratch, and a second
  pass adds them in split order, scales and rounds once (no float atomics:
  a replay and an eager call agree bit for bit); the call, both passes,
  counts as one launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_SOURCE = "int8_weight_gemm.cu"
# the widest token count kernel A (one decode tile) takes; wider chunks
# run kernel B (bf16) or the dequantize route (f32)
CROSSOVER_M = 64
# a work item's output channels and a stage's inputs (the kernel's
# kChannels and kSlab)
_CHANNELS = 128
_SLAB = 64
# K splits: at most this many, each at least _MIN_STAGES stages of 64
# inputs, on one row tile of at most _MAX_SPLIT_ROWS rows (the kernel's)
_MAX_SPLITS = 16
_MIN_STAGES = 4
_MAX_SPLIT_ROWS = 128
# the plan's model of the card, fitted to the split sweeps of
# int8_gemm_probe.py (--kernel, --families) on an H100 SXM (700 W): the
# rate the kernel streams weights at when enough SMs read, the most one SM
# reads alone, and what a split adds beside its partial sums' bytes
_STREAM_BYTES_PER_S = 2.8e12
_SM_BYTES_PER_S = 25e9
_SPLIT_SECONDS = 5e-6


@functools.lru_cache(maxsize=1024)
def gemm_plan(M: int, K: int, Ns: tuple, n_sm: int) -> tuple[int, int]:
    """(row tile, K splits) for M tokens against weights of widths ``Ns``
    sharing K: host shapes only. The tile: 8 * ceil(M / 8) rows up to
    CROSSOVER_M (kernel A), else 128 rows up to 128 tokens and 256 beyond
    where its tiles alone fill the card. Splits (one tile of at most 128
    rows only): the count in 1.._MAX_SPLITS, each keeping _MIN_STAGES
    stages, that the model of the card finishes first: the weight streamed
    at _STREAM_BYTES_PER_S, or at _SM_BYTES_PER_S an SM where the busiest
    SM's items take longer, plus a split's cost and its partial sums'
    bytes (written and read)."""
    groups = sum(-(-N // _CHANNELS) for N in Ns)
    nk = -(-K // _SLAB)
    if M <= CROSSOVER_M:
        br = 8 * -(-M // 8)
    elif M <= 128 or -(-M // 256) * groups < n_sm:
        br = 128
    else:
        br = 256
    if br > _MAX_SPLIT_ROWS or M > br:
        return br, 1
    stream_s = K * sum(Ns) / _STREAM_BYTES_PER_S
    best = None
    for s in range(1, max(1, min(_MAX_SPLITS, nk // _MIN_STAGES)) + 1):
        per_sm = -(-groups * s // n_sm) * (-(-nk // s)) * _SLAB * _CHANNELS
        t = max(stream_s, per_sm / _SM_BYTES_PER_S)
        if s > 1:
            t += _SPLIT_SECONDS + 8 * s * M * sum(Ns) / _STREAM_BYTES_PER_S
        if best is None or t < best[0]:
            best = (t, s)
    return br, best[1]


# x's types the kernels are built for, and their codes in the C entry
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def int8_gemm_route(M: int, dtype=torch.bfloat16) -> str:
    """The route a CUDA call of M tokens of x in ``dtype`` takes: "decode"
    (kernel A in ``dtype``), "prefill" (kernel B, bf16) or "dequant" (f32);
    a type no form takes raises."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"int8 weight GEMM: {dtype} activations (the kernel is built "
                        "for bfloat16 and float32)")
    if M <= CROSSOVER_M:
        return "decode"
    return "prefill" if dtype == torch.bfloat16 else "dequant"


def _dequant_matmul(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(x @ q.to(x.dtype)) * s.to(x.dtype): the weight converted into x's
    type (the scratch), then the product (the JAX formula, rounding as it
    does)."""
    return (x2 @ q.to(x2.dtype)) * s.to(x2.dtype)


def int8_weight_matmul_ref(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The plain version: the JAX ``core.matmul`` formula. x [..., K] ->
    [..., N]."""
    out = _dequant_matmul(x.reshape(-1, x.shape[-1]), q, s)
    return out.reshape(*x.shape[:-1], s.shape[0])


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# weights one launch takes (the kernel's kMaxWeights)
MAX_GROUP = 3


def _kernel_fn():
    """The kernels' C entry point, built and bound on first use."""
    from ._build import load

    fn = load(_SOURCE).b2b_int8_weight_gemm
    if fn.argtypes is None:
        weight = [ctypes.c_void_p] * 4 + [ctypes.c_int]
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + weight * MAX_GROUP
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return fn


def _check_kernel_args(x2, q, s):
    M, K = x2.shape
    N = s.shape[0]
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"int8 weight GEMM: {x2.dtype} activations (the kernel is "
                        "built for bfloat16 and float32)")
    if q.dtype != torch.int8 or q.dim() != 2:
        raise ValueError(f"int8 weight GEMM: weight {q.dtype} {tuple(q.shape)}, "
                         "expected int8 [K, N]")
    if s.dtype != torch.float32 or s.dim() != 1:
        raise ValueError(f"int8 weight GEMM: scales {s.dtype} {tuple(s.shape)}")
    if K % 8 or N % 16 or tuple(q.shape) != (K, N):
        raise ValueError(f"int8 weight GEMM: x [{M}, {K}] against a [{q.shape[0]}, "
                         f"{q.shape[1]}] weight with {N} scales (K % 8 and N % 16 must "
                         "be 0)")
    for name, t in (("x", x2), ("weight", q), ("scales", s)):
        if t.device != x2.device:
            raise ValueError(f"int8 weight GEMM: {name} on {t.device}, x on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8 weight GEMM: {name} is not contiguous")
    for name, t in (("x", x2), ("weight", q), ("scales", s)):
        if t.data_ptr() % 16:
            raise ValueError(f"int8 weight GEMM: {name} is not 16-byte aligned")


def _launch_kernel(x2: torch.Tensor, ws: list, plan: tuple | None = None) -> list:
    """Launch the kernel once for the weights ``ws`` (1..MAX_GROUP, the
    same K) on checked arguments; ``plan`` (row tile, splits) defaults to
    ``gemm_plan``'s. Returns the outputs; the caller counts the launch."""
    M, K = x2.shape
    for w in ws:
        _check_kernel_args(x2, w["q"], w["s"])
    Ns = tuple(w["s"].shape[0] for w in ws)
    br, splits = plan or gemm_plan(M, K, Ns, _sm_count(x2.device.index))
    stream = torch.cuda.current_stream(x2.device)
    ys = [torch.empty((M, N), dtype=x2.dtype, device=x2.device) for N in Ns]
    part = None
    if splits > 1:
        part = torch.empty(splits * M * sum(Ns), dtype=torch.float32, device=x2.device)
    args, at = [], 0
    for w, y, N in zip(ws, ys, Ns):
        p = part.data_ptr() + 4 * at if part is not None else None
        at += splits * M * N
        args += [w["q"].data_ptr(), w["s"].data_ptr(), y.data_ptr(), p, N]
    args += [None, None, None, None, 0] * (MAX_GROUP - len(ws))
    err = _kernel_fn()(x2.data_ptr(), _DTYPE_CODE[x2.dtype], len(ws), *args, M, K, br, splits,
                       stream.cuda_stream)
    if err:
        raise RuntimeError(f"int8 weight GEMM kernel launch failed: cuda error {err}")
    return ys


# the counter of each route's launches (int8_weight_matmul.<name>)
_COUNTER = {("decode", torch.bfloat16): "launches", ("decode", torch.float32): "f32_launches",
            ("prefill", torch.bfloat16): "prefill_launches",
            ("dequant", torch.float32): "dequant_launches"}


def int8_weight_matmul_group(x: torch.Tensor, ws: list) -> list:
    """``[x @ q * s for each int8 weight {"q", "s"} in ws]`` (the same K):
    x [..., K] -> [..., N_i] each, in x's type. CPU tensors take the plain
    version; CUDA tensors the route ``int8_gemm_route`` names, ONE launch
    for up to MAX_GROUP weights, counted in the route's counter
    (``_COUNTER``); other devices raise."""
    if not 1 <= len(ws) <= MAX_GROUP:
        raise ValueError(f"int8_weight_matmul_group: {len(ws)} weights (one launch "
                         f"takes 1 to {MAX_GROUP})")
    x2 = x.reshape(-1, x.shape[-1])
    if x2.device.type == "cpu":
        outs = [_dequant_matmul(x2, w["q"], w["s"]) for w in ws]
    elif x2.device.type != "cuda":
        raise ValueError(f"int8_weight_matmul: no kernel for {x2.device}")
    else:
        route = int8_gemm_route(x2.shape[0], x2.dtype)
        x2 = x2.contiguous()
        if route == "dequant":
            for w in ws:
                _check_kernel_args(x2, w["q"], w["s"])
            outs = [_dequant_matmul(x2, w["q"], w["s"]) for w in ws]
        else:
            outs = _launch_kernel(x2, ws)
        name = _COUNTER[(route, x2.dtype)]
        setattr(int8_weight_matmul, name, getattr(int8_weight_matmul, name) + 1)
    return [out.reshape(*x.shape[:-1], out.shape[-1]) for out in outs]


def int8_weight_matmul(x: torch.Tensor, w: dict) -> torch.Tensor:
    """``x @ q * s`` for one int8 weight ``w = {"q", "s"}``: x [..., K] ->
    [..., N] (``int8_weight_matmul_group`` of one)."""
    return int8_weight_matmul_group(x, [w])[0]


int8_weight_matmul.launches = 0
int8_weight_matmul.f32_launches = 0
int8_weight_matmul.prefill_launches = 0
int8_weight_matmul.dequant_launches = 0
# what a captured CUDA graph's replay adds back (engine/graphs.py)
LAUNCH_COUNTERS = ("launches", "f32_launches", "prefill_launches", "dequant_launches")
