"""The int8-weight GEMM: y = (x @ q) * s for a weight-only quantized
projection (models/quant.py), x bf16 or f32 [..., K], q int8 [K, N], s f32
[N], y in x's type.

No Pallas kernel of the JAX package is replaced: its ``core.matmul``
computes ``(x @ q.astype(x.dtype)) * s`` and XLA fuses the int8 convert
into the dot's operand read. PyTorch has no such fusion, so on the card
the product goes through a hand-written kernel
(``csrc/int8_weight_gemm.cu``) that reads every int8 weight byte once and
never materialises a bf16 copy.

- **The packed layout** (``pack_weight``): the engine repacks each int8
  weight once at load from the JAX ``[K, N]`` into ``[N/16, K/32, 32, 16]``
  int8, one 16-output-channel x 32-input chunk per 512 bytes in the
  kernel's mma fragment order (16 bytes a lane; the chunk's inputs
  permuted so that a lane's x fragment is 8 consecutive inputs).
  ``unpack_weight`` inverts it exactly. K must be a multiple of 32 and N of
  16 (every model the port serves); others stay in the JAX layout and run
  the plain version on the CPU.
- **The plain version** ``int8_weight_matmul_ref``: the JAX formula,
  ``(x @ q.to(x.dtype)) * s.to(x.dtype)``, on the packed layout. The CPU
  tests hold it against JAX ``core.matmul``; on the card the smoke holds
  the kernel against it (the kernel rounds once, after the scale, where the
  formula rounds the dot and the product: within a bf16 ulp or two).
- **Two forms of the kernel**, by x's type: bf16 (bf16 mma.sync) and f32
  (2xTF32 mma.sync: the int8 weight is exact in TF32, x splits into a
  TF32 hi and lo; within about 2^-21 of x's value a product, where the
  JAX f32 product rounds nothing but the sums). Each rounds once, after
  the scale.
- **Dispatch** (``int8_gemm_route``, from the token count M and x's type,
  host facts): M <= ``MAX_KERNEL_M`` (64: every decode and verify root)
  launches the kernel in x's type, counted in
  ``int8_weight_matmul.launches`` (bf16) or ``.f32_launches`` (the f32
  form) (``int8_weight_matmul_group`` takes up
  to three weights that share x in one launch: wq|wk|wv and w_up|w_gate,
  4 launches a layer); wider chunks (prefill) take the ``dequant``
  route, the JAX package's own product: the weight unpacked and converted
  to x's type into scratch (an f32 scratch is twice the bf16 one),
  ``torch.matmul`` (in f32 with the full-f32
  product PyTorch runs by default, ``allow_tf32`` False), then the scale,
  counted in ``int8_weight_matmul.dequant_launches``. CPU tensors take
  the plain version. Anything else raises: no route falls back to
  another, and no type other than bf16 and f32 reaches the card.
- **The split plan** (``gemm_plan``) is a function of (K, N, SM count)
  only, so a captured CUDA graph keeps it: the kernel's thread-block
  clusters split K in rank order and reduce without atomics, so a replay
  and an eager call agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_SOURCE = "int8_weight_gemm.cu"
# the widest token count the kernel takes (its accumulators hold 8 tiles of 8)
MAX_KERNEL_M = 64
# blocks the split plan aims for, per SM (4 warps a block)
_BLOCKS_PER_SM = 16
_MAX_CLUSTER = 8
# the fewest 32-input chunks a cluster rank should stream
_MIN_CHUNKS = 8


def pack_weight(q: torch.Tensor) -> torch.Tensor:
    """int8 [K, N] (JAX layout) -> the kernel's [N/16, K/32, 32, 16], on
    q's device. Chunk (n-tile, k-chunk), lane g*4+t, byte s*8+w*4+jhi*2+jlo
    holds weight row k = 32*kc + 8t + 4s + 2w + jlo, channel 16*nt +
    8*jhi + g."""
    K, N = q.shape
    if K % 32 or N % 16:
        raise ValueError(f"int8 weight [{K}, {N}]: K % 32 and N % 16 must be 0")
    wt = q.t().reshape(N // 16, 2, 8, K // 32, 4, 2, 2, 2)
    return wt.permute(0, 3, 2, 4, 5, 6, 1, 7).contiguous().view(N // 16, K // 32, 32, 16)


def _unpacked_t(qp: torch.Tensor) -> torch.Tensor:
    """The packed weight as a [N, K] view-permutation (no copy yet)."""
    Nt, Kc = qp.shape[:2]
    v = qp.view(Nt, Kc, 8, 4, 2, 2, 2, 2).permute(0, 6, 2, 1, 3, 4, 5, 7)
    return v  # [Nt, jhi, g, Kc, t, s, w, jlo] = [N, K] once reshaped


def unpack_weight(qp: torch.Tensor, N: int | None = None) -> torch.Tensor:
    """The packed weight back in the JAX layout, int8 [K, N]."""
    Nt, Kc = qp.shape[:2]
    wt = _unpacked_t(qp).reshape(Nt * 16, Kc * 32)
    if N is not None:
        wt = wt[:N]
    return wt.t().contiguous()


@functools.lru_cache(maxsize=256)
def gemm_plan(K: int, N: int, n_sm: int) -> tuple[int, int]:
    """(cluster size, 32-input chunks a cluster rank) for a [K, N] weight:
    host shapes only. A block owns 64 channels; the cluster splits K into
    cs ranges, doubling cs (to 8) while the grid stays under
    _BLOCKS_PER_SM blocks an SM and each rank keeps _MIN_CHUNKS chunks."""
    groups = -(-N // 64)
    kc = K // 32
    cs = 1
    while (cs < _MAX_CLUSTER and groups * cs * 2 <= _BLOCKS_PER_SM * n_sm
           and kc // (cs * 2) >= _MIN_CHUNKS):
        cs *= 2
    return cs, -(-kc // cs)


# x's types the kernel is built for, and their codes in its C entry
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def int8_gemm_route(M: int, dtype=torch.bfloat16) -> str:
    """The route a CUDA call of M tokens of x in ``dtype`` takes: "kernel"
    (its form in ``dtype``) or "dequant"; a type no form takes raises."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"int8 weight GEMM: {dtype} activations (the kernel is built "
                        "for bfloat16 and float32)")
    return "kernel" if M <= MAX_KERNEL_M else "dequant"


def _dequant_matmul(x2: torch.Tensor, qp: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(x @ q.to(x.dtype)) * s.to(x.dtype) on the packed layout: the weight
    unpacked into an int8 [N, K] scratch, then converted into x's type,
    then the product (the JAX formula, rounding as it does). The unpack
    moves int16 pairs: the two inputs (2w + jlo) a pair holds stay
    adjacent in both layouts, so the permuting copy moves half the
    elements."""
    N = s.shape[0]
    Nt, Kc = qp.shape[:2]
    wt = torch.empty((Nt * 16, Kc * 32), dtype=torch.int8, device=x2.device)
    pairs = qp.view(torch.int16).view(Nt, Kc, 8, 4, 2, 2, 2)  # ... jhi; jlo pairs
    wt.view(torch.int16).view(Nt, 2, 8, Kc, 4, 2, 2).copy_(
        pairs.permute(0, 6, 2, 1, 3, 4, 5))
    return (x2 @ wt[:N].to(x2.dtype).t()) * s.to(x2.dtype)


def int8_weight_matmul_ref(x: torch.Tensor, qp: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The plain version: the JAX ``core.matmul`` formula on the packed
    layout. x [..., K] -> [..., N]."""
    out = _dequant_matmul(x.reshape(-1, x.shape[-1]), qp, s)
    return out.reshape(*x.shape[:-1], s.shape[0])


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# weights one launch takes (the kernel's kMaxWeights)
MAX_GROUP = 3


def _kernel_fn():
    """The kernel's C entry point, built and bound on first use."""
    from ._build import load

    fn = load(_SOURCE).b2b_int8_weight_gemm
    if fn.argtypes is None:
        weight = [ctypes.c_void_p] * 3 + [ctypes.c_int]
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + weight * MAX_GROUP
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return fn


def _check_kernel_args(x2, qp, s):
    M, K = x2.shape
    N = s.shape[0]
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"int8 weight GEMM: {x2.dtype} activations (the kernel is "
                        "built for bfloat16 and float32)")
    if qp.dtype != torch.int8 or qp.dim() != 4 or tuple(qp.shape[2:]) != (32, 16):
        raise ValueError(f"int8 weight GEMM: packed weight {qp.dtype} "
                         f"{tuple(qp.shape)}, expected int8 [N/16, K/32, 32, 16]")
    if s.dtype != torch.float32 or s.dim() != 1:
        raise ValueError(f"int8 weight GEMM: scales {s.dtype} {tuple(s.shape)}")
    if K % 32 or qp.shape[1] * 32 != K or qp.shape[0] * 16 != N:
        raise ValueError(f"int8 weight GEMM: x [{M}, {K}] against a packed "
                         f"[{qp.shape[0] * 16}, {qp.shape[1] * 32}] weight with "
                         f"{N} scales")
    for name, t in (("x", x2), ("packed weight", qp), ("scales", s)):
        if t.device != x2.device:
            raise ValueError(f"int8 weight GEMM: {name} on {t.device}, x on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8 weight GEMM: {name} is not contiguous")
    for name, t in (("x", x2), ("packed weight", qp)):
        if t.data_ptr() % 16:
            raise ValueError(f"int8 weight GEMM: {name} is not 16-byte aligned")


def _launch_kernel(x2: torch.Tensor, ws: list) -> list:
    """Launch the kernel once for the weights ``ws`` (1..MAX_GROUP, the
    same K) on checked arguments and count the launch. The split plan is
    the widest weight's."""
    M, K = x2.shape
    if M > MAX_KERNEL_M:
        raise ValueError(f"int8 weight GEMM kernel: {M} tokens (it takes "
                         f"{MAX_KERNEL_M})")
    args, ys = [], []
    for w in ws:
        _check_kernel_args(x2, w["qp"], w["s"])
        y = torch.empty((M, w["s"].shape[0]), dtype=x2.dtype, device=x2.device)
        ys.append(y)
        args += [w["qp"].data_ptr(), w["s"].data_ptr(), y.data_ptr(), y.shape[1]]
    args += [None, None, None, 0] * (MAX_GROUP - len(ws))
    cs, per = gemm_plan(K, max(y.shape[1] for y in ys), _sm_count(x2.device.index))
    err = _kernel_fn()(x2.data_ptr(), _DTYPE_CODE[x2.dtype], len(ws), *args, M, K, cs, per,
                       torch.cuda.current_stream(x2.device).cuda_stream)
    if err:
        raise RuntimeError(f"int8 weight GEMM kernel launch failed: cuda error {err}")
    if x2.dtype == torch.float32:
        int8_weight_matmul.f32_launches += 1
    else:
        int8_weight_matmul.launches += 1
    return ys


def int8_weight_matmul_group(x: torch.Tensor, ws: list) -> list:
    """``[x @ q * s for each packed int8 weight {"qp", "s"} in ws]`` (the
    same K): x [..., K] -> [..., N_i] each, in x's type. CPU tensors take
    the plain version; CUDA tensors the route ``int8_gemm_route`` names:
    the kernel's form in x's type, ONE launch for up to MAX_GROUP weights, counted in
    ``int8_weight_matmul.launches`` (bf16) or ``.f32_launches``, or the
    dequantize + matmul product of
    each, counted once in ``.dequant_launches``; other devices raise."""
    if not 1 <= len(ws) <= MAX_GROUP:
        raise ValueError(f"int8_weight_matmul_group: {len(ws)} weights (one launch "
                         f"takes 1 to {MAX_GROUP})")
    x2 = x.reshape(-1, x.shape[-1])
    if x2.device.type == "cpu":
        outs = [_dequant_matmul(x2, w["qp"], w["s"]) for w in ws]
    elif x2.device.type != "cuda":
        raise ValueError(f"int8_weight_matmul: no kernel for {x2.device}")
    elif int8_gemm_route(x2.shape[0], x2.dtype) == "kernel":
        outs = _launch_kernel(x2.contiguous(), ws)
    else:
        for w in ws:
            _check_kernel_args(x2.contiguous(), w["qp"], w["s"])
        outs = [_dequant_matmul(x2, w["qp"], w["s"]) for w in ws]
        int8_weight_matmul.dequant_launches += 1
    return [out.reshape(*x.shape[:-1], out.shape[-1]) for out in outs]


def int8_weight_matmul(x: torch.Tensor, w: dict) -> torch.Tensor:
    """``x @ q * s`` for one packed int8 weight ``w = {"qp", "s"}``: x [...,
    K] -> [..., N] (``int8_weight_matmul_group`` of one)."""
    return int8_weight_matmul_group(x, [w])[0]


int8_weight_matmul.launches = 0
int8_weight_matmul.f32_launches = 0
int8_weight_matmul.dequant_launches = 0
# what a captured CUDA graph's replay adds back (engine/graphs.py)
LAUNCH_COUNTERS = ("launches", "f32_launches", "dequant_launches")
