"""The routed expert product of a mixture-of-experts layer.

No Pallas kernel of the JAX package is replaced: its ``core._moe`` runs
every expert on every token with XLA einsums and weights the unpicked ones
by 0 (``_moe_routed`` packs per-group capacity buffers with one-hot
einsums). On the card the port runs each expert only on the rows routed
to it, through a hand-written grouped GEMM (``csrc/moe_expert_gemm.cu``;
its source note says why and what bounds it). Three parts:

- **The plan** (``moe_plan``): plain torch on the logits' device, static
  shapes, no host sync and no op whose output shape depends on the data,
  so a root that runs it is captured as a CUDA graph. From the router
  logits [N, E] f32 (the product in x's type, then the cast, as JAX
  rounds them): the top k by JAX's tie rule (``lax.top_k`` keeps the lower
  expert first on equal logits: a stable descending sort, whose first k
  are taken; ``torch.topk`` gives no order among equals), a softmax over
  the k in f32, the N·k assignments (token-major, slot-minor) sorted
  stably by expert, the per-expert counts (``scatter_add_``) and row
  offsets [E + 1], and the tile map: tile i is (expert, first row) for
  tiles of ``br`` rows, ``ceil(N·k / br) + E`` tiles at most, the real
  tiles first and their count on the device (``tile_count``), the slots
  past it naming expert E, which the kernel skips. With a
  capacity (``moe_impl="routed"``) the plan marks the assignments JAX's
  ``_moe_routed`` drops: within each group of g tokens an expert keeps the
  first C assignments in token-major, slot-minor order; a dropped one gets
  weight 0 and the sentinel expert E, so it sorts after every kept row and
  no tile covers it.
- **The product** ``moe_expert_matmul(x, tok, plan, ws)``: ``y[r] =
  x[tok[r]] @ W[e(r)]`` (times the int8 scales ``s[e(r)]``) for every kept
  sorted row r, for up to two expert stacks that share x in ONE launch
  (w_up and w_gate); ``tok`` None means x's rows are the sorted rows (the
  down product over h). Experts are the JAX layout [E, K, N]: dense in x's
  type, or int8 {"q" [E, K, N], "s" [E, N] f32} (models/quant.py), which
  the kernel reads as it lies and converts in registers. Four forms, by
  x's and the experts' types, each counted on the wrapper:
  ``moe_expert_matmul.launches`` (bf16 x, bf16 experts), ``.int8_launches``
  (bf16 x, int8 experts), ``.f32_launches`` (f32, f32) and
  ``.int8_f32_launches`` (f32 x, int8 experts); the CUDA kernels each call
  launched, by ``kernel_route``, in ``moe_expert_matmul.routes``. bf16 x
  runs the warp-specialised ``wgmma`` kernel, its K split where
  ``k_splits`` says; f32 x the FFMA kernel. Rows the kernel does not
  cover (dropped assignments) are left unwritten; ``moe_combine`` masks
  them.
- **The plain version** ``moe_expert_matmul_ref``: the same per-row
  product by a loop over experts, each expert's rows as one matmul in x's
  type (an int8 expert by the JAX formula ``(x @ q.astype(x.dtype)) *
  s.astype(x.dtype)``); it reads the offsets on the host. CPU tensors take
  it; the smoke holds the kernel against it on the card. No route falls
  back to it for a CUDA tensor: anything the kernel does not take raises.

``moe_combine`` sums each token's k rows, each times its weight cast to
the output's type (JAX casts the weights to the einsum's type), in f32,
then casts; a dropped assignment adds exactly 0.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

_SOURCE = "moe_expert_gemm.cu"
# x's types the kernel is built for, and their codes in its C entry
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# rows a tile may hold (the kernel's instantiations: the wgmma form's for
# bf16 x, the FFMA form's for f32 x) and the widths it tiles
TILE_ROWS = (8, 16, 32, 64, 128, 256)
TILE_ROWS_F32 = (8, 16, 32, 64)
CHANNELS = 64  # N % CHANNELS == 0 (the wgmma form's last 128-channel group may be half)
INPUTS = 64  # inputs a stage of the wgmma form: K % INPUTS == 0
INPUTS_F32 = 32  # of the FFMA form
MAX_WEIGHTS = 2  # expert stacks one launch takes
# the K split rule (``k_splits``): the card's streaming multiprocessors (an
# H100 SXM), the items an SM it aims for, the least K it splits and the
# least inputs a split keeps
SMS = 132
SPLIT_ITEMS_PER_SM = 4
SPLIT_MIN_K = 4096
SPLIT_MIN_INPUTS = 1024
MAX_SPLITS = 8


@dataclass
class MoEPlan:
    """The device-side routing of one MoE layer call (``moe_plan``).

    ``tok`` [A] int32: the token of each sorted row; ``inv`` [A] int64: the
    sorted row of each assignment (token-major, slot-minor); ``weights`` [A]
    f32: each assignment's routing weight (0 where dropped); ``keep`` [A]
    bool or None (no capacity: nothing dropped); ``offsets`` [E + 1] int32:
    expert e's rows are [offsets[e], offsets[e + 1]), dropped rows past
    offsets[E]; ``tile_expert`` / ``tile_row`` [n_tiles] int32: each tile's
    expert (E: no tile) and first row, the real tiles first;
    ``tile_count`` [1] int32: the real tiles; ``br`` rows a tile;
    ``n_tokens``, ``k``, ``n_experts``."""

    tok: torch.Tensor
    inv: torch.Tensor
    weights: torch.Tensor
    keep: torch.Tensor | None
    offsets: torch.Tensor
    tile_expert: torch.Tensor
    tile_row: torch.Tensor
    tile_count: torch.Tensor
    br: int
    n_tokens: int
    k: int
    n_experts: int

    @property
    def n_tiles(self) -> int:
        return self.tile_expert.shape[0]


def tile_rows(assignments: int, n_experts: int, dtype=torch.bfloat16) -> int:
    """The tile height for ``assignments`` rows over ``n_experts`` experts
    (host shapes only): the smallest height of x's form (TILE_ROWS for
    bf16, TILE_ROWS_F32 for f32) that holds the mean rows an expert, the
    largest past it. Decode and verify steps take 8 or 16; a 2,048-token
    chunk 128 (qwen3-30b-a3b) or 256 (mixtral-8x7b) in bf16, 64 in f32."""
    heights = TILE_ROWS_F32 if dtype == torch.float32 else TILE_ROWS
    mean = -(-assignments // n_experts)
    return next((br for br in heights if br >= mean), heights[-1])


def tile_bound(assignments: int, n_experts: int, br: int) -> int:
    """The most tiles ``assignments`` rows over ``n_experts`` experts can
    take in tiles of ``br`` rows: each expert's last tile may be partial."""
    return -(-assignments // br) + n_experts


def k_splits(assignments: int, n_experts: int, K: int, N: int) -> int:
    """The K splits of a bf16-x launch over ``assignments`` rows, ``n_experts``
    experts, K inputs and N output channels of all its weights (host shapes
    only): 1 unless the tiles are of decode height (8-32 rows) and K is at
    least SPLIT_MIN_K; then the least power of two that gives the estimated
    items (min(E, A) tiles, the distinct experts at most, x 128-channel
    groups x splits) SPLIT_ITEMS_PER_SM an SM, at most MAX_SPLITS, each
    split a whole number of stages and at least SPLIT_MIN_INPUTS inputs.
    mixtral-8x7b's w_down at decode and verify: 4; every other served
    launch 1."""
    if tile_rows(assignments, n_experts) > 32 or K < SPLIT_MIN_K:
        return 1
    items = min(n_experts, assignments) * -(-N // 128)
    splits = 1
    while (splits < MAX_SPLITS and items * splits < SPLIT_ITEMS_PER_SM * SMS
           and (K // INPUTS) % (2 * splits) == 0 and K // (2 * splits) >= SPLIT_MIN_INPUTS):
        splits *= 2
    return splits


def routed_capacity(n_tokens: int, k: int, n_experts: int, group_size: int,
                    factor: float) -> tuple[int, int]:
    """(group size g, capacity C) of JAX ``_moe_routed`` for a call of
    ``n_tokens`` tokens: g = min(group_size, N), C = min(g, ceil(g·k/E ·
    factor)), in the same python float arithmetic."""
    g = min(group_size, n_tokens)
    return g, min(g, int(math.ceil(g * k / n_experts * factor)))


def moe_plan(logits: torch.Tensor, k: int, capacity: tuple[int, int] | None = None,
             br: int | None = None, dtype=torch.bfloat16) -> MoEPlan:
    """The plan of one MoE call from its router logits [N, E] f32 (see the
    module docstring). ``capacity``: (g, C) of ``routed_capacity`` for the
    routed impl, None for the dense one (nothing dropped). ``br``: the tile
    height (default ``tile_rows`` for x's type ``dtype``)."""
    N, E = logits.shape
    A = N * k
    device = logits.device
    br = br or tile_rows(A, E, dtype)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    weights = torch.softmax(vals[:, :k], dim=-1).reshape(A)
    eid = idx[:, :k].reshape(A)
    arange = torch.arange(A, device=device)
    keep = None
    if capacity is not None:
        g, C = capacity
        # position of each assignment among its group's assignments to the
        # same expert, in token-major, slot-minor order (a stable sort by
        # (group, expert) keeps that order inside each key)
        key = (arange // (g * k)) * E + eid
        by_key = torch.sort(key, stable=True).indices
        n_keys = (-(-N // g)) * E
        cnt = torch.zeros(n_keys, dtype=torch.long, device=device)
        cnt.scatter_add_(0, key, torch.ones_like(key))
        start = torch.cumsum(cnt, 0) - cnt
        pos = torch.empty_like(key)
        pos.scatter_(0, by_key, arange - start[key[by_key]])
        keep = pos < C
        eid = torch.where(keep, eid, E)
        weights = torch.where(keep, weights, 0.0)
    order = torch.sort(eid, stable=True).indices  # sorted row -> assignment
    inv = torch.empty_like(order)
    inv.scatter_(0, order, arange)
    counts = torch.zeros(E + 1, dtype=torch.long, device=device)
    counts.scatter_add_(0, eid, torch.ones_like(eid))
    ends = torch.cumsum(counts[:E], 0)
    offsets = torch.cat([ends.new_zeros(1), ends])
    tiles = (counts[:E] + br - 1) // br
    tile_end = torch.cumsum(tiles, 0)
    slot = torch.arange(tile_bound(A, E, br), device=device)
    expert = torch.searchsorted(tile_end, slot, right=True)  # E past the last tile
    at = expert.clamp(max=E - 1)
    row = offsets[at] + (slot - (tile_end[at] - tiles[at])) * br
    return MoEPlan(
        tok=(order // k).to(torch.int32), inv=inv, weights=weights, keep=keep,
        offsets=offsets.to(torch.int32), tile_expert=expert.to(torch.int32),
        tile_row=row.to(torch.int32), tile_count=tile_end[-1:].to(torch.int32), br=br,
        n_tokens=N, k=k, n_experts=E,
    )


def moe_combine(y: torch.Tensor, plan: MoEPlan, dtype: torch.dtype) -> torch.Tensor:
    """Each token's output: its k sorted rows of ``y`` [A, D], each times
    its weight rounded to ``dtype`` (JAX's ``weights.astype(out.dtype)``),
    summed in f32 over the slots, cast to ``dtype``. [N, D]. A dropped
    assignment's row (never written) adds exactly 0."""
    rows = y.index_select(0, plan.inv).float()
    prod = rows * plan.weights.to(dtype).float()[:, None]
    if plan.keep is not None:
        prod = torch.where(plan.keep[:, None], prod, 0.0)
    return prod.view(plan.n_tokens, plan.k, -1).sum(dim=1).to(dtype)


def _expert_shape(w) -> tuple[int, int, int]:
    t = w["q"] if isinstance(w, dict) else w
    return tuple(t.shape)


def moe_expert_matmul_ref(x: torch.Tensor, tok, plan: MoEPlan, ws: list) -> list:
    """The plain version: for each expert e, its sorted rows [offsets[e],
    offsets[e + 1]) of ``x[tok]`` (or of x) times its matrix in x's type;
    int8 experts by the JAX formula. Rows past offsets[E] (dropped) stay 0.
    Returns [rows, N_i] in x's type per weight."""
    rows = plan.tok.shape[0]
    xs = x if tok is None else x.index_select(0, tok.long())
    offsets = plan.offsets.tolist()
    outs = []
    for w in ws:
        E, _, N = _expert_shape(w)
        y = torch.zeros((rows, N), dtype=x.dtype, device=x.device)
        for e in range(E):
            a, b = offsets[e], offsets[e + 1]
            if a == b:
                continue
            if isinstance(w, dict):
                y[a:b] = (xs[a:b] @ w["q"][e].to(x.dtype)) * w["s"][e].to(x.dtype)
            else:
                y[a:b] = xs[a:b] @ w[e]
        outs.append(y)
    return outs


def _kernel_fn():
    """The kernel's C entry point, built and bound on first use."""
    from ._build import load

    fn = load(_SOURCE).b2b_moe_expert_gemm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = i
        fn.argtypes = ([p, p, i, i, i] + [p, p, p, p, i] * MAX_WEIGHTS
                       + [p, p, p, p, p, i, i, i, i, i, i, p])
    return fn


def kernel_route(dtype, int8: bool, br: int, splits: int) -> str:
    """The CUDA kernels one wrapper call launches for x's type, the
    experts' type, the tile height and the K splits: the name counted in
    ``moe_expert_matmul.routes``."""
    wt = "int8" if int8 else ("bf16" if dtype == torch.bfloat16 else "f32")
    if dtype == torch.float32:
        return f"moe_expert_gemm_kernel<{br},f32,{wt}>"
    route = f"moe_expert_gemm_kernel_wgmma<{br},{wt}>"
    return route + (f" x {splits} splits + moe_expert_gemm_kernel_reduce<{wt}>"
                    if splits > 1 else "")


def _check_kernel_args(x: torch.Tensor, tok, plan: MoEPlan, ws: list) -> tuple[int, list]:
    """The kernel's contract; raises on anything else. Returns (the
    experts' type code, [(dense or q, scales or None, N)])."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"moe_expert_matmul: {x.dtype} activations (the kernel is built "
                        "for bfloat16 and float32)")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"moe_expert_matmul: x must be a contiguous [rows, K] tensor, "
                         f"got {tuple(x.shape)}")
    if not 1 <= len(ws) <= MAX_WEIGHTS:
        raise ValueError(f"moe_expert_matmul: {len(ws)} weights (one launch takes 1 to "
                         f"{MAX_WEIGHTS})")
    K = x.shape[1]
    E = plan.n_experts
    rows = plan.tok.shape[0]
    f32 = x.dtype == torch.float32
    inputs, heights = (INPUTS_F32, TILE_ROWS_F32) if f32 else (INPUTS, TILE_ROWS)
    if K % inputs:
        raise ValueError(f"moe_expert_matmul: K = {K} (the kernel takes K % {inputs} == 0 "
                         f"for {x.dtype} x)")
    if plan.br not in heights:
        raise ValueError(f"moe_expert_matmul: tile height {plan.br} (built for {heights} "
                         f"for {x.dtype} x)")
    if tok is None and x.shape[0] != rows:
        raise ValueError(f"moe_expert_matmul: x has {x.shape[0]} rows, the plan {rows}")
    index = [plan.offsets, plan.tile_expert, plan.tile_row, plan.tile_count] + (
        [] if tok is None else [tok])
    for name, t in zip(("offsets", "tile_expert", "tile_row", "tile_count", "tok"), index):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"moe_expert_matmul: {name} must be contiguous int32 on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    codes, args = set(), []
    for w in ws:
        if isinstance(w, dict):
            q, s = w["q"], w["s"]
            if q.dtype != torch.int8 or s.dtype != torch.float32:
                raise ValueError(f"moe_expert_matmul: int8 experts {q.dtype} / scales "
                                 f"{s.dtype}")
            codes.add(1)
        else:
            q, s = w, None
            if q.dtype != x.dtype:
                raise TypeError(f"moe_expert_matmul: {q.dtype} experts beside {x.dtype} x "
                                "(the experts are in x's type or int8)")
            codes.add(0)
        if q.dim() != 3 or q.shape[0] != E or q.shape[1] != K or q.shape[2] % CHANNELS:
            raise ValueError(f"moe_expert_matmul: experts {tuple(q.shape)} against x "
                             f"[{x.shape[0]}, {K}] and {E} experts (N % {CHANNELS} == 0)")
        if s is not None and tuple(s.shape) != (E, q.shape[2]):
            raise ValueError(f"moe_expert_matmul: scales {tuple(s.shape)}")
        for name, t in (("experts", q), ("scales", s)):
            if t is not None and (t.device != x.device or not t.is_contiguous()):
                raise ValueError(f"moe_expert_matmul: {name} must be contiguous on "
                                 f"{x.device}")
        args.append((q, s, q.shape[2]))
    if len(codes) != 1:
        raise ValueError("moe_expert_matmul: one launch takes experts of one type")
    return codes.pop(), args


def _launch_kernel(x: torch.Tensor, tok, plan: MoEPlan, ws: list) -> list:
    """Launch the kernel once for ``ws`` on checked arguments (bf16 x: K
    split by ``k_splits``, each split's f32 partial sums in a scratch of
    [splits, rows, N]) and count the launch under its form and its route."""
    wtype, args = _check_kernel_args(x, tok, plan, ws)
    rows, K = plan.tok.shape[0], x.shape[1]
    splits, xs = 1, None
    if x.dtype == torch.bfloat16:
        splits = k_splits(rows, plan.n_experts, K, sum(N for _, _, N in args))
        if tok is not None:  # x's rows in sorted order, for the kernel's TMA tiles
            xs = torch.empty((rows, K), dtype=x.dtype, device=x.device)
    ys, flat = [], []
    for q, s, N in args:
        y = torch.empty((rows, N), dtype=x.dtype, device=x.device)
        part = (torch.empty((splits, rows, N), dtype=torch.float32, device=x.device)
                if splits > 1 else None)
        ys.append(y)
        flat += [q.data_ptr(), None if s is None else s.data_ptr(), y.data_ptr(),
                 None if part is None else part.data_ptr(), N]
    flat += [None, None, None, None, 0] * (MAX_WEIGHTS - len(args))
    err = _kernel_fn()(
        x.data_ptr(), None if tok is None else tok.data_ptr(), _DTYPE_CODE[x.dtype], wtype,
        len(args), *flat, plan.offsets.data_ptr(), plan.tile_expert.data_ptr(),
        plan.tile_row.data_ptr(), plan.tile_count.data_ptr(),
        None if xs is None else xs.data_ptr(), plan.n_tiles, rows, plan.n_experts, K, plan.br,
        splits, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"moe_expert_matmul kernel launch failed: cuda error {err}")
    name = {(torch.bfloat16, 0): "launches", (torch.bfloat16, 1): "int8_launches",
            (torch.float32, 0): "f32_launches", (torch.float32, 1): "int8_f32_launches"}
    counter = name[(x.dtype, wtype)]
    setattr(moe_expert_matmul, counter, getattr(moe_expert_matmul, counter) + 1)
    route = kernel_route(x.dtype, wtype == 1, plan.br, splits)
    moe_expert_matmul.routes[route] = moe_expert_matmul.routes.get(route, 0) + 1
    return ys


def moe_expert_matmul(x: torch.Tensor, tok, plan: MoEPlan, ws: list) -> list:
    """``[y_i]``, y_i[r] = x[tok[r]] @ ws[i][e(r)] over the plan's kept
    sorted rows (``tok`` None: x's row r), for 1 or 2 expert stacks that
    share x: [rows, N_i] in x's type each. CPU tensors take the plain
    version; CUDA tensors ONE launch of the kernel's form for (x's type,
    the experts' type); other devices raise."""
    if x.device.type == "cpu":
        return moe_expert_matmul_ref(x, tok, plan, ws)
    if x.device.type != "cuda":
        raise ValueError(f"moe_expert_matmul: no kernel for {x.device}")
    return _launch_kernel(x, tok, plan, ws)


moe_expert_matmul.launches = 0
moe_expert_matmul.int8_launches = 0
moe_expert_matmul.f32_launches = 0
moe_expert_matmul.int8_f32_launches = 0
# launches by kernel route (``kernel_route``), beside the form counters
moe_expert_matmul.routes = {}
# what a captured CUDA graph's replay adds back (engine/graphs.py)
LAUNCH_COUNTERS = ("launches", "int8_launches", "f32_launches", "int8_f32_launches")
