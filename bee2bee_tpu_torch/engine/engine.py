"""InferenceEngine: the serving core of the PyTorch port.

The port of ``bee2bee_tpu/engine/engine.py`` for the main path: one
model's parameters on the card, a tokenizer, the paged KV pool's
geometry, the prefill forward, and ``generate`` / ``generate_stream`` on
top of the continuous-batching scheduler (engine/scheduler.py).

- **Bucketed prefill**: prompts pad up to a bucket (or run in fixed
  ``prefill_chunk`` chunks); the pool write ceil drops the padded tail,
  so a prompt claims only the blocks covering its length.
- **Continuous batching** over ONE paged KV pool with per-row block
  tables (engine/paged.py); attention is the ragged paged op
  (ops/ragged.py), the hand-written CUDA kernel on the card.
- **int8 KV pool** (``cache_dtype="int8"``): pages store int8 K/V with
  one f32 scale per (kv head, page), quantized on write by the forward;
  the pool holds about twice the sessions in the same memory, and the
  ragged op runs its int8 form.
- **Device**: ``device=None`` means the CUDA card and raises without one;
  the tests pass ``device="cpu"``, where the same code runs the plain
  PyTorch versions of the kernels. On the card the engine refuses at
  build, by name, what its attention kernels cannot run
  (``check_card_supported``); the CPU runs any of it.

- **Prompt prefix cache** (``prefix_cache_entries``,
  ``BEE2BEE_PREFIX_CACHE``): admission from the longest cached prompt
  prefix over shared pool blocks (engine/scheduler.py); the pool is sized
  with room for the entries' pins.
- **Economics plane** (engine/introspect.py): the capture sentinel, the
  HBM ledger (weights, KV pool, drafter, the int8 dequantize scratch),
  the goodput/MFU meter and the pool forecast, built before the first
  forward; ``info["introspect"]``.
- **Captured roots**: on the card the prefill chunk, the first token's
  sample, the decode step and the speculative verify step are CUDA
  graphs the scheduler captures per key (engine/graphs.py); the sentinel
  declares each root's key space here and in the scheduler.
- **Speculative decoding** (``spec_tokens``, engine/spec.py): the
  scheduler's greedy rows draft from the tiered drafter stack (n-gram;
  the resident model drafter, ``drafter=<model>``, engine/drafter.py;
  ``drafter="mesh"``, a draft-role peer) and one ``[B, K+1]`` verify step
  (``_spec_verify``) accepts the longest matching prefix.
- **int8 weights** (``quantize="int8"``, models/quant.py): the
  projections are quantized per output channel at load (a random init on
  the device, tensor by tensor; ``lora_path`` merged in first, as in
  JAX) and kept for the int8-weight GEMM (ops/int8_gemm.py), which every
  root runs on the card: a decode kernel beside bf16 or f32 activations
  (a form for each), a prefill kernel for bf16 chunks wider than 64
  tokens, and a dequantize product for f32 ones. A random init of an int8
  engine quantizes each weight as it is drawn (each expert stack expert by
  expert), so it never holds the dense model.
- **Mixture of experts** (mixtral-8x7b, qwen3-30b-a3b): the routed expert
  product (ops/moe.py: the plan on the device, the grouped expert GEMM on
  the card) runs inside every captured root; int8 expert stacks stay in
  the JAX layout, which the expert GEMM reads.
- **Multi-LoRA serving** (``max_adapters``, adapters/pool.py): a pool of
  hot-swappable adapters over the one base; ``load_adapter`` /
  ``unload_adapter`` page them in and out without a restart, and a
  request names its adapter (``adapter=``); a mixed batch serves base and
  adapter rows in one replayed step. The pool's device writes run on the
  scheduler thread between its passes (``BatchScheduler.run_on_device``).

- **Live migration** (``migration_signature``, ``import_generation``;
  engine/scheduler.py ``checkpoint``): a running generation's pool blocks
  leave as host tensors and scatter into another engine's pool in place,
  and decode resumes from the last emitted token with no prefill; without
  blocks the target re-prefills prompt + accepted. meshnet/migrate.py
  moves them between nodes (drain, prefill handoff, pool-pressure
  failover), to and from the JAX package's nodes too.

- **Checkpoints** (``checkpoint_path``, models/loader.py): a local HF
  checkpoint or a native piece checkpoint, its config resolved from the
  checkpoint when the model is ``"auto"``; the tokenizer comes from the
  same path (engine/tokenizer.py).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..metrics import get_registry
from ..models import core
from ..models.config import ModelConfig, resolve_model_config
from ..models.params import init_params
from ..models.quant import dequant_scratch_bytes, quantize_params_
from ..ops.moe import CHANNELS as MOE_CHANNELS
from ..ops.ragged import _BLOCK_SIZES, _DTYPE_CODE, _HEAD_DIMS
from ..unported import unported
from .paged import ceil_div
from .sampling import sample_batched
from .tokenizer import load_tokenizer

logger = logging.getLogger("bee2bee_tpu_torch.engine")

# per-request serving distributions, observed at retirement (scheduler
# thread) — the same metric names as the JAX engine
_H_TTFT = get_registry().histogram(
    "engine.ttft_ms", "time to first token per request (ms)"
)
_H_INTER_TOKEN = get_registry().histogram(
    "engine.inter_token_ms", "mean inter-token latency per request (ms)"
)
_H_E2E = get_registry().histogram(
    "engine.e2e_latency_ms", "submit-to-done latency per request (ms)"
)
_C_TOKENS_OUT = get_registry().counter(
    "engine.tokens_generated", "tokens generated across all requests"
)

DEFAULT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)

DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}
# the pool may also store int8 pages with per-page scales
CACHE_DTYPES = {**DTYPES, "int8": torch.int8}


def _env_flag(name: str, default: bool) -> bool:
    """Bool knob: unset -> default; "0"/"false"/"off"/"no" -> False."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    return raw.strip().lower() not in ("0", "false", "off", "no")


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        return int(raw)
    except ValueError:
        logger.warning("%s=%r is not an int; using %d", name, raw, default)
        return default


@dataclass
class EngineConfig:
    max_seq_len: int = 2048
    dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"
    prefill_buckets: tuple = DEFAULT_BUCKETS
    rng_seed: int = 0
    # tokens decoded per chunk; the host reads the sampled tokens once per
    # window of up to max_inflight_chunks chunks (streaming requests pin
    # the window to one chunk)
    decode_chunk: int = 32
    max_batch: int = 8
    max_inflight_chunks: int = 8
    # "auto" / "flash": the ragged paged op (the CUDA kernel on the card,
    # its plain version on the CPU) — the port's only attention
    attention: str = "auto"
    # chunked prefill: fixed chunks of this many tokens; None = whole-
    # prompt buckets
    prefill_chunk: int | None = None
    kv_block_size: int = 16
    # total pool blocks incl. the null block 0; None sizes the pool so it
    # cannot run dry (max_batch full rows plus the decode-chunk overshoot)
    kv_pool_blocks: int | None = None
    # prompt prefix cache: keep up to this many prompts' blocks pinned and
    # admit a prompt that extends one from its shared blocks, prefilling
    # only the rest (0 = off)
    prefix_cache_entries: int = 0
    # self-speculative decoding (engine/spec.py): draft up to this many
    # tokens per step and verify them in ONE [B, K+1] forward, accepting
    # the longest exact prefix. Greedy non-penalized rows only; 0 = off
    spec_tokens: int = 0
    # suffix n-gram lengths the n-gram drafter tries, longest first
    spec_min_match: int = 2
    spec_max_match: int = 8
    # per-row adaptive disable: after spec_probe_tokens drafted tokens a
    # row's tier whose acceptance sits below spec_min_accept fails
    spec_min_accept: float = 0.25
    spec_probe_tokens: int = 64
    # model-tier drafter: "" = n-gram only; "mesh" = a draft-role peer;
    # else a registry name loaded resident beside the target (random
    # init from drafter_seed). Requires spec_tokens > 0. None = resolve
    # from BEE2BEE_DRAFTER at construction
    drafter: str | None = None
    # rng seed of a random-init drafter; None = rng_seed, which makes a
    # same-name drafter weight-identical to a random-init target
    drafter_seed: int | None = None
    # weight-only quantization: "none" | "int8" (models/quant.py): the
    # projections stream from device memory as int8 through the int8-weight
    # GEMM (BEE2BEE_QUANTIZE / --quantize int8)
    quantize: str = "none"
    # batched multi-LoRA serving (adapters/pool.py): slots for hot-
    # swappable adapters over the one resident base model; a mixed batch
    # serves base and adapter rows in one step. 0 = off
    max_adapters: int = 0
    # ---- the decode hot loop (engine/scheduler.py). None = resolve from
    # the environment at construction; always a plain bool/int after
    # __post_init__.
    # dispatch window N+1 while window N's token readback is still in
    # flight (BEE2BEE_OVERLAP, default on)
    decode_overlap: bool | None = None
    # depth of the in-flight readback ring; 2 = double-buffered
    # (BEE2BEE_READBACK_DEPTH, default 2; clamped to >= 1)
    readback_depth: int | None = None
    # the JAX engine's choice between its fused root and the split
    # penalty root, which decode the same tokens (BEE2BEE_FUSED_ROOT,
    # default on). Resolved so that one set of engine options configures
    # either package; the port has one decode root, which always carries
    # the penalty counts, and reads nothing of this field
    fused_root: bool | None = None
    # grow-only batch bucket while work flows, released after an idle
    # window (BEE2BEE_BATCH_STICKY, default on)
    batch_sticky: bool | None = None

    def __post_init__(self):
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            self.prefill_chunk = None
        if self.kv_block_size < 1:
            raise ValueError(f"kv_block_size must be >= 1, got {self.kv_block_size}")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype={self.dtype!r}: one of {sorted(DTYPES)}")
        if self.cache_dtype not in CACHE_DTYPES:
            raise NotImplementedError(
                f"EngineConfig.cache_dtype={self.cache_dtype!r} is not "
                "implemented in the PyTorch port yet"
            )
        # each field of the JAX engine this port does not run yet, with the
        # ROADMAP.md queue A item that ports it
        items = {
            # dense: the no-cache forward; sp: sequence-parallel serving
            "attention": (self.attention not in ("auto", "flash"),
                          12 if self.attention == "dense" else 14),
        }
        for name, (set_, item) in items.items():
            if set_:
                raise unported(f"EngineConfig.{name}={getattr(self, name)!r}", item)
        if self.quantize in ("", None):
            self.quantize = "none"
        if self.quantize not in ("none", "int8"):
            raise ValueError(f"quantize={self.quantize!r}: only 'int8' or 'none'")
        if self.max_adapters < 0:
            self.max_adapters = 0
        if self.spec_tokens < 0:  # NodeConfig's 0-means-disabled sentinel
            self.spec_tokens = 0
        if self.spec_tokens and not (
            1 <= self.spec_min_match <= self.spec_max_match
        ):
            raise ValueError(
                f"need 1 <= spec_min_match <= spec_max_match, got "
                f"{self.spec_min_match}..{self.spec_max_match}"
            )
        if self.decode_overlap is None:
            self.decode_overlap = _env_flag("BEE2BEE_OVERLAP", True)
        if self.fused_root is None:
            self.fused_root = _env_flag("BEE2BEE_FUSED_ROOT", True)
        if self.batch_sticky is None:
            self.batch_sticky = _env_flag("BEE2BEE_BATCH_STICKY", True)
        if self.readback_depth is None:
            self.readback_depth = _env_int("BEE2BEE_READBACK_DEPTH", 2)
        self.readback_depth = max(1, int(self.readback_depth))
        if self.drafter is None:
            self.drafter = (os.environ.get("BEE2BEE_DRAFTER") or "").strip()
        if self.drafter_seed is None:
            self.drafter_seed = self.rng_seed
        if self.drafter and not self.spec_tokens:
            raise ValueError(
                "drafter set but spec_tokens is 0: the drafter feeds the "
                "speculative verify path — set spec_tokens (--spec) too"
            )


def check_card_supported(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                         device) -> None:
    """On a CUDA device, raise NotImplementedError naming every setting the
    attention kernels (ops/ragged.py) cannot run, which would otherwise
    build the engine and then raise at its first forward: a ``dtype``
    other than bfloat16 or float32, a ``cache_dtype`` other than ``dtype``
    or int8, a head_dim or a ``kv_block_size`` the kernels are not built
    for, or an expert shape the grouped expert GEMM (ops/moe.py) does not
    take (d_model and d_ff multiples of 64). int8 weights run beside bf16
    and f32 activations alike (the int8-weight GEMM and the expert GEMM
    have a form for each). Any other device runs the plain versions:
    nothing is refused."""
    if torch.device(device).type != "cuda":
        return
    dtypes = [name for name, dtype in DTYPES.items() if dtype in _DTYPE_CODE]
    missing = []
    if engine_cfg.dtype not in dtypes:
        missing.append(f"dtype={engine_cfg.dtype!r} (the kernels take {dtypes})")
    if engine_cfg.cache_dtype not in (engine_cfg.dtype, "int8"):
        missing.append(
            f"cache_dtype={engine_cfg.cache_dtype!r} beside dtype="
            f"{engine_cfg.dtype!r} (the pool is in the query's type or int8)"
        )
    if model_cfg.head_dim not in _HEAD_DIMS:
        missing.append(f"head_dim {model_cfg.head_dim} (the kernels are built "
                       f"for {_HEAD_DIMS})")
    if engine_cfg.kv_block_size not in _BLOCK_SIZES:
        missing.append(f"kv_block_size={engine_cfg.kv_block_size} (the kernels "
                       f"are built for {_BLOCK_SIZES})")
    D, F_ = model_cfg.d_model, model_cfg.d_ff
    if model_cfg.is_moe and (D % MOE_CHANNELS or F_ % MOE_CHANNELS):
        missing.append(f"experts of d_model {D} and d_ff {F_} (the expert GEMM takes "
                       f"multiples of {MOE_CHANNELS})")
    if missing:
        raise NotImplementedError(
            f"{model_cfg.name} on {device}: the port's CUDA kernels do not "
            f"take {'; '.join(missing)}"
        )


@dataclass
class GenerationResult:
    text: str
    token_ids: list[int]
    prompt_tokens: int
    new_tokens: int
    ttft_s: float  # time to first token
    latency_s: float
    tokens_per_sec: float
    finish_reason: str  # "stop" | "length" | "eos"
    timings: dict = field(default_factory=dict)


class MetricsAggregator:
    """Rolling real-throughput accounting for a serving node: every
    completed generation reports (new_tokens, latency_s); ``snapshot``
    gives tokens/sec over a sliding window. Thread-safe."""

    def __init__(self, window_s: float = 60.0):
        self.window_s = window_s
        self._events: list[tuple[float, int, float]] = []
        self._lock = threading.Lock()
        self._total_tokens = 0
        self._total_requests = 0

    def record(self, new_tokens: int, latency_s: float) -> None:
        with self._lock:
            self._events.append((time.time(), int(new_tokens), float(latency_s)))
            self._total_tokens += int(new_tokens)
            self._total_requests += 1
            self._prune()

    def _prune(self) -> None:
        cutoff = time.time() - self.window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.pop(0)

    def snapshot(self) -> dict:
        with self._lock:
            self._prune()
            toks = sum(e[1] for e in self._events)
            lats = sorted(e[2] for e in self._events if e[2] > 0)
            if self._events:
                span = max(time.time() - self._events[0][0], self._events[0][2], 1e-3)
                span = min(span, self.window_s)
            else:
                span = 1.0
            p50 = lats[min(len(lats) // 2, len(lats) - 1)] if lats else None
            return {
                "tokens_per_sec": round(toks / span, 3),
                "window_tokens": toks,
                "p50_latency_s": round(p50, 4) if p50 is not None else None,
                "total_tokens": self._total_tokens,
                "total_requests": self._total_requests,
            }


class InferenceEngine:
    def __init__(
        self,
        model: str | ModelConfig,
        params=None,
        engine_config: EngineConfig | None = None,
        tokenizer=None,
        device=None,
        lora_path: str | None = None,
        checkpoint_path: str | None = None,
    ):
        """``params``: the port's parameter dict already on ``device``
        (models/params.py; ``params_from_numpy`` carries a JAX tree
        across, int8 weights included), or None: the weights of
        ``checkpoint_path`` (a local HF or native checkpoint,
        models/loader.py) when given, else a random init from
        ``rng_seed``. ``model`` is a registry name, a ModelConfig, or
        ``"auto"`` (or a name the registry does not hold) with a checkpoint,
        whose own config then decides. ``lora_path``: an adapter .npz
        (train/lora.py) merged into the weights at load, before any
        quantization."""
        self.device = resolve_device(device)
        self.model_cfg = resolve_model_config(model, checkpoint_path)
        # config errors fail here, before a multi-GB load
        core.check_supported(self.model_cfg)
        self.engine_cfg = engine_config or EngineConfig()
        check_card_supported(self.model_cfg, self.engine_cfg, self.device)
        self.max_seq_len = min(self.engine_cfg.max_seq_len, self.model_cfg.max_seq_len)
        self.dtype = DTYPES[self.engine_cfg.dtype]
        self.cache_dtype = CACHE_DTYPES[self.engine_cfg.cache_dtype]
        self.metrics = MetricsAggregator()
        quantized = self.engine_cfg.quantize == "int8"
        self.load_stats: dict = {}  # the checkpoint load's seconds and bytes
        if params is None and checkpoint_path:
            from ..models.loader import load_checkpoint, to_device

            # an int8 engine keeps the dense checkpoint on the host and
            # uploads it tensor by tensor, each projection quantized as it
            # lands (peak device memory stays int8-sized); the adapter
            # merge runs on the host, before quantizing
            params = load_checkpoint(checkpoint_path, self.model_cfg, self.dtype,
                                     self.device, host=quantized, stats=self.load_stats)
            if quantized:
                if lora_path:  # merged at the engine's dtype, as on the device
                    params = _merge_lora(_cast_floats(params, self.dtype), lora_path,
                                         self.model_cfg)
                    lora_path = None
                params = to_device(params, self.device, self.dtype, quantize=True,
                                   stats=self.load_stats)
        elif params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.engine_cfg.rng_seed)
            # an int8 engine quantizes each projection as it is drawn and
            # each expert stack expert by expert: a random mixtral-8x7b
            # never holds its 93 GB of bf16 (models/params.py). An adapter
            # merges into the dense draw first, so then the tree is drawn
            # dense and quantized after the merge, as JAX orders it
            params = init_params(self.model_cfg, gen, self.device, self.dtype,
                                 quantize=quantized and not lora_path)
        else:
            # the caller's tree is not rewritten: merging and quantizing
            # replace entries of this engine's copy (tensors are shared)
            params = _copy_tree(params)
        if lora_path:
            # base + trained low-rank deltas, merged BEFORE quantization so
            # the int8 scales see the finetuned weights (train/lora.py)
            params = _merge_lora(params, lora_path, self.model_cfg)
        if quantized:
            # in place, each dense weight dropped as its int8 form lands
            # (a no-op for weights the checkpoint upload quantized)
            quantize_params_(params)
        self.params = params
        self.tokenizer = tokenizer or load_tokenizer(checkpoint_path,
                                                     self.model_cfg.vocab_size)
        # the sampling stream: one generator on the device, used only by
        # the scheduler thread
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.engine_cfg.rng_seed)
        # forward passes run (prefill chunks + decode steps): with the
        # kernel's launch count it shows every attention call went through
        # the kernel (n_layers launches per forward). A replayed decode
        # graph adds the forwards its capture ran (engine/scheduler.py)
        self.forward_calls = 0
        self._mutex = threading.Lock()
        self._scheduler = None  # created on first generate
        # the economics plane (engine/introspect.py), before the first
        # forward: the sentinel the roots register with, the HBM ledger,
        # the goodput meter
        from .introspect import (
            EngineIntrospection,
            declared_batch_sizes,
            declared_table_width,
        )

        self.introspect = EngineIntrospection(self.model_cfg, self.device)
        self.introspect.ledger.register("weights", lambda: self.params)
        if quantized:
            # f32 prefill chunks on the card (and the CPU's plain version)
            # convert a weight into scratch of this engine's dtype
            # (ops/int8_gemm.py); a bf16 engine on the card holds none
            scratch = dequant_scratch_bytes(self.params, self.dtype, self.device)
            if scratch:
                self.introspect.ledger.register("int8_dequant_scratch", lambda: scratch)
        # the prefill root's declared capture space: its bucket widths
        # (what _bucket_for can return, and the fixed chunk) x the pow2
        # table widths; a capture outside it is a storm, as in JAX
        widths = {b for b in self.engine_cfg.prefill_buckets
                  if b <= self.max_seq_len} | {self.max_seq_len}
        if self.engine_cfg.prefill_chunk:
            widths.add(self.engine_cfg.prefill_chunk)
        self.declared_prefill_widths = frozenset(widths)
        bpr = self.blocks_per_row
        self.introspect.sentinel.register(
            "prefill",
            allowed=lambda key: (key[0] in self.declared_prefill_widths
                                 and declared_table_width(key[1], bpr)),
        )
        # the verify root: the decode key's fields plus K
        bs_ok = declared_batch_sizes(self.engine_cfg.max_batch)
        self.introspect.sentinel.register(
            "spec_verify",
            allowed=lambda key: (key[0] in bs_ok and declared_table_width(key[1], bpr)
                                 and key[-1] == self.engine_cfg.spec_tokens),
        )
        # model-tier drafter (engine/drafter.py): resident beside the
        # target, tokenizer-compat gated at boot (a typed DrafterLoadError,
        # never a garbage-draft loop). "mesh" loads nothing here: the
        # scheduler builds the MeshDrafter and meshnet/draft.py attaches
        # its transport
        self.drafter_model = None
        if self.engine_cfg.drafter and self.engine_cfg.drafter != "mesh":
            from .drafter import DraftModel, validate_drafter_compat

            self.drafter_model = DraftModel(
                self.engine_cfg.drafter,
                spec_tokens=self.engine_cfg.spec_tokens,
                batch=self.engine_cfg.max_batch,
                target_max_seq_len=self.max_seq_len,
                dtype=self.engine_cfg.dtype,
                seed=self.engine_cfg.drafter_seed,
                sentinel=self.introspect.sentinel,
                device=self.device,
            )
            validate_drafter_compat(
                self.model_cfg, self.tokenizer, self.drafter_model.cfg,
                self.drafter_model.tokenizer or self.tokenizer,
            )
            self.introspect.ledger.register(
                "drafter", lambda: self.drafter_model.hbm_source()
                if self.drafter_model is not None else None
            )
        # batched multi-LoRA serving: the hot-swap pool. Construction is
        # cheap: the stacks are allocated at the first load_adapter, whose
        # rank/targets fix the pool geometry
        self.adapter_pool = None
        if self.engine_cfg.max_adapters > 0:
            from ..adapters.pool import AdapterPool

            self.adapter_pool = AdapterPool(
                self.model_cfg, self.engine_cfg.max_adapters, self.device
            )
            # the HBM ledger: the stacked A/B factors + scales ((None,
            # None) before the first load reads as 0)
            self.introspect.ledger.register(
                "adapter_pool", lambda: self.adapter_pool.device_args()
            )

    # ------------------------------------------------------------ forward

    def forward(self, tokens, pool, offset, block_tables, **kw):
        """core.forward with this engine's params and config, counted."""
        self.forward_calls += 1
        return core.forward(
            self.params, self.model_cfg, tokens, pool, offset, block_tables, **kw
        )

    def _prefill(self, tokens, pool, true_len, offset, block_tables,
                 write_floor=None, write_ceil=None, lora=None):
        """tokens [B, Tb] padded; returns last_logits [B, V] at each row's
        ``true_len - 1`` (``_prefill_fn``). The chunk scatters into the
        rows' mapped blocks; ``write_floor`` keeps re-fed positions below a
        CoW share point out of the shared blocks, ``write_ceil`` drops the
        padded tail so a short prompt claims only the blocks covering its
        real length. Every argument may be a device tensor: the
        scheduler's prefill root passes slices of static buffers. ``lora``:
        an adapter row's arguments (``forward``'s ``adapters``,
        ``adapter_ids``, ``adapter_scales``), the JAX ``_lora_args_row``."""
        logits, _ = self.forward(
            tokens, pool, offset, block_tables,
            paged_write_floor=write_floor, paged_write_ceil=write_ceil,
            logits_index=true_len - 1, **(lora or {}),
        )
        return logits[:, 0]

    def _spec_verify(self, cur, drafts, lens, pool, offsets, tables, temperature,
                     top_k, top_p, min_p=None, any_sampled=False, counts=None,
                     repetition=None, presence=None, frequency=None, lora=None):
        """Speculative-decode verify (``_spec_verify_fn``): one [B, K+1]
        forward checks a whole draft. Returns (next tokens [B], accepted
        [B]); with ``counts`` the penalty counts are bumped in place.

        ``cur`` [B] is each row's last accepted token, ``drafts`` [B, K]
        the proposals (zero past ``lens`` [B]). The chunk [cur | drafts]
        writes through the paged pool at each row's offset. Position j's
        logits predict token j+1, so a draft token is correct iff it
        equals the greedy argmax one position earlier; ``accepted`` is the
        longest such prefix, capped at ``lens``. The next token is sampled
        from the logits at the accept position: for greedy rows the token
        plain decode would give, for non-drafting rows (lens 0) their one
        normal sample. Rejected positions sit at/past the row's new offset
        (offset + accepted + 1), where causality hides them. ``lora``: the
        rows' adapter arguments (``forward``'s ``adapters``,
        ``adapter_ids``, ``adapter_scales``), None for an all-base batch."""
        B, K = drafts.shape
        tokens = torch.cat([cur[:, None], drafts], dim=1)
        logits, _ = self.forward(tokens, pool, offsets, tables, **(lora or {}))
        greedy = torch.argmax(logits, dim=-1)
        pos = torch.arange(K, device=drafts.device)[None, :]
        match = (drafts == greedy[:, :-1]) & (pos < lens[:, None])
        # longest all-match prefix: cumprod zeroes everything after the
        # first mismatch, the sum counts the survivors
        accepted = torch.cumprod(match.int(), dim=1).sum(dim=1)
        rows = torch.arange(B, device=drafts.device)
        last = logits[rows, accepted]
        pen = {}
        if counts is not None:
            # a penalized row never drafts, so its accepted is 0; the
            # accepted drafts of the other rows are counted so the shared
            # counts stay coherent (duplicate tokens accumulate)
            gain = (pos < accepted[:, None]).to(counts.dtype)
            counts.select(1, 1).scatter_add_(1, drafts, gain)
            pen = dict(counts=counts, repetition=repetition, presence=presence,
                       frequency=frequency)
        nxt = sample_batched(last, self.generator, temperature, top_k, top_p,
                             min_p, any_sampled=any_sampled, **pen)
        if counts is not None:
            counts[rows, 1, nxt] += 1
        return nxt, accepted

    def _bucket_for(self, n: int) -> int:
        for b in self.engine_cfg.prefill_buckets:
            if b >= n and b <= self.max_seq_len:
                return b
        return self.max_seq_len

    # ---- paged-pool geometry (engine/paged.py holds the allocator) ----

    @property
    def blocks_per_row(self) -> int:
        """Max pool blocks one row can map: capacity plus the decode-chunk
        overshoot (a window may write up to decode_chunk - 2 positions
        past capacity before the host sees the stop)."""
        return ceil_div(
            self.max_seq_len + self.engine_cfg.decode_chunk,
            self.engine_cfg.kv_block_size,
        )

    @property
    def pool_blocks(self) -> int:
        """Total pool blocks: explicit kv_pool_blocks, or sized so the free
        list cannot run dry: the null block, max_batch full rows and the
        prefix entries' worst-case pins."""
        if self.engine_cfg.kv_pool_blocks is not None:
            return self.engine_cfg.kv_pool_blocks
        pin = ceil_div(self.max_seq_len, self.engine_cfg.kv_block_size)
        return (1 + self.engine_cfg.max_batch * self.blocks_per_row
                + self.engine_cfg.prefix_cache_entries * pin)

    @property
    def kv_info(self) -> dict:
        return {
            "cache_dtype": self.engine_cfg.cache_dtype,
            "block_size": int(self.engine_cfg.kv_block_size),
            "pool_blocks": int(self.pool_blocks),
            # usable tokens (block 0 is the reserved null block)
            "capacity_tokens": int(
                (self.pool_blocks - 1) * self.engine_cfg.kv_block_size
            ),
        }

    @property
    def kv_quantized(self) -> bool:
        """True when the pool stores int8 pages + per-page-per-head
        scales (EngineConfig.cache_dtype='int8')."""
        return self.cache_dtype == torch.int8

    def new_pool(self):
        return core.init_paged_pool(
            self.model_cfg, self.pool_blocks, self.engine_cfg.kv_block_size,
            self.cache_dtype, self.device,
        )

    # ------------------------------------------------------------ public API

    @property
    def scheduler(self):
        """The continuous-batching scheduler (lazy: allocates the pool on
        first use)."""
        if self._scheduler is None:
            from .scheduler import BatchScheduler

            with self._mutex:
                if self._scheduler is None:
                    self._scheduler = BatchScheduler(
                        self, max_batch=self.engine_cfg.max_batch
                    )
        return self._scheduler

    # ---------------------------------------------- multi-adapter serving

    def load_adapter(self, name: str, adapters: dict | None = None,
                     lcfg=None, path: str | None = None) -> int:
        """Pin one LoRA adapter into the hot-swap pool (fresh load,
        in-place refresh, or LRU-evicting a cold adapter) WITHOUT
        restarting the engine. Pass (adapters, lcfg) directly (the DHT
        fetch path) or ``path`` to an adapter .npz, whose versioned sha256
        manifest is verified on read. Typed AdapterLoadError on a
        corrupt/mismatched adapter; returns the pool slot. Callable from
        any thread: the device part runs on the scheduler thread between
        its passes (``BatchScheduler.run_on_device``), so it lands after
        every step already dispatched and before the next."""
        if self.adapter_pool is None:
            raise RuntimeError(
                "multi-adapter serving is off (EngineConfig.max_adapters=0)"
            )
        if path is not None:
            from ..train.lora import load_adapters

            adapters, lcfg = load_adapters(path, model_cfg=self.model_cfg)
        if adapters is None or lcfg is None:
            raise ValueError("load_adapter needs (adapters, lcfg) or path")
        return self.adapter_pool.load(name, adapters, lcfg,
                                      run=self.scheduler.run_on_device)

    def unload_adapter(self, name: str) -> bool:
        """Evict a resident adapter; AdapterPoolBusy while rows are in
        flight on it (the refcount hot-swap guard)."""
        if self.adapter_pool is None:
            return False
        return self.adapter_pool.evict(name, run=self.scheduler.run_on_device)

    evict_adapter = unload_adapter

    def has_adapter(self, name: str) -> bool:
        return self.adapter_pool is not None and self.adapter_pool.has(name)

    def resident_adapters(self) -> list[str]:
        return self.adapter_pool.resident() if self.adapter_pool else []

    # ---------------------------------------------------- live migration

    def migration_signature(self) -> dict:
        """Pool-compat fingerprint a KV import is validated against: two
        engines whose signatures match have bit-compatible pool block
        layouts (same per-layer K/V geometry, block size and storage
        dtype), so exported blocks scatter straight in. The keys and
        values are the JAX engine's: ``cache_dtype`` is numpy's dtype name
        ("bfloat16", "int8", "float32"), so a JAX node and a port node with
        the same pool compare equal."""
        cfg = self.model_cfg
        return {
            "model": cfg.name,
            "n_layers": cfg.n_layers,
            "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim,
            "block_size": self.engine_cfg.kv_block_size,
            "cache_dtype": self.engine_cfg.cache_dtype,
        }

    def import_generation(self, snap: dict, kv: dict | None = None):
        """Resume a migrated generation (scheduler.checkpoint's snapshot, or
        a JAX node's): rebuild the Request, prime its accepted output, and
        submit it on the import path. With ``kv`` (the pool blocks: host
        torch tensors or numpy arrays, ml_dtypes bf16 included) the
        scheduler scatters the shipped blocks and decodes on with zero
        prefill; without, it re-prefills prompt + accepted (the fallback
        rung). Returns the live Request; its events queue carries
        {"imported": True} on success, then the usual token/done events.
        Raises ValueError, with the JAX engine's texts, on a snapshot this
        engine cannot host."""
        from .scheduler import Request

        ids = [int(t) for t in snap.get("ids") or []]
        out = [int(t) for t in snap.get("out") or []]
        if not ids:
            raise ValueError("import: empty prompt")
        if snap.get("model") and snap["model"] != self.model_cfg.name:
            raise ValueError(
                f"import: snapshot is for model {snap['model']!r}, "
                f"this engine serves {self.model_cfg.name!r}"
            )
        adapter = snap.get("adapter") or None
        if adapter and not self.has_adapter(adapter):
            # the row's K/V (and its decode) ran under this adapter's
            # deltas: resuming without it would be silent corruption
            raise ValueError(
                f"import: adapter {adapter!r} is not resident on this engine"
            )
        req = Request(
            ids,
            int(snap.get("max_new_tokens") or 0),
            snap.get("temperature", 0.0),
            int(snap.get("top_k") or 0),
            float(snap.get("top_p") if snap.get("top_p") is not None else 1.0),
            set(int(t) for t in snap.get("stop") or []),
            None if snap.get("eos") is None else int(snap["eos"]),
            self.tokenizer,
            stream=True,  # the migration bridge reads token events
            repetition_penalty=float(snap.get("repetition_penalty") or 1.0),
            presence_penalty=float(snap.get("presence_penalty") or 0.0),
            frequency_penalty=float(snap.get("frequency_penalty") or 0.0),
            min_p=float(snap.get("min_p") or 0.0),
            tenant=str(snap.get("tenant") or "default"),
            adapter=adapter,
        )
        req.out_ids = out
        # the already-streamed text was emitted at the source: the delta
        # decoder starts past it
        req._flushed_text = self.tokenizer.decode(out) if out else ""
        if kv is not None:
            if not out:
                raise ValueError("import: KV snapshot without accepted tokens")
            offset = int(snap.get("offset") or 0)
            if offset != len(ids) + len(out) - 1:
                raise ValueError(
                    f"import: offset {offset} breaks the live-row invariant "
                    f"(prompt {len(ids)} + out {len(out)} - 1)"
                )
            if offset + 1 >= self.max_seq_len:
                raise ValueError(
                    f"import: offset {offset} leaves no room in "
                    f"max_seq_len={self.max_seq_len}"
                )
            if int(snap.get("block_size") or 0) != self.engine_cfg.kv_block_size:
                raise ValueError(
                    f"import: block_size {snap.get('block_size')} != "
                    f"{self.engine_cfg.kv_block_size}"
                )
            # the block tensors must match the pool geometry exactly, and an
            # int8 pool demands the scales too (and only then): a mismatch
            # rejects typed here, never on the scheduler thread
            cfg = self.model_cfg
            nb = ceil_div(offset, self.engine_cfg.kv_block_size)
            cache_dt = self.engine_cfg.cache_dtype
            pool_shape = (cfg.n_layers, cfg.n_kv_heads, nb,
                          self.engine_cfg.kv_block_size, cfg.head_dim)
            want = {"k": (pool_shape, cache_dt), "v": (pool_shape, cache_dt)}
            if self.kv_quantized:
                sshape = (cfg.n_layers, cfg.n_kv_heads, nb)
                want["k_scale"] = (sshape, "float32")
                want["v_scale"] = (sshape, "float32")
            got_names = set(kv) if isinstance(kv, dict) else set()
            if got_names != set(want):
                raise ValueError(
                    f"import: kv tensors {sorted(got_names)} != pool "
                    f"layout {sorted(want)} (cache_dtype {cache_dt})"
                )
            for name, (wshape, wdt) in want.items():
                arr = kv.get(name)
                shape = tuple(int(d) for d in getattr(arr, "shape", ()))
                if shape != wshape:
                    raise ValueError(
                        f"import: kv[{name!r}] shape {shape} != pool "
                        f"geometry {wshape}"
                    )
                got_dt = dtype_name(getattr(arr, "dtype", None))
                if got_dt != wdt:
                    # wrong-dtype bytes pass the sha256 (it hashes what was
                    # sent) but would scatter garbage bit patterns
                    raise ValueError(
                        f"import: kv[{name!r}] dtype {got_dt} != pool "
                        f"dtype {wdt}"
                    )
            req.import_state = {
                "offset": offset, "cur": int(snap["cur"]),
                "kv": {name: host_tensor(kv[name]) for name in want},
            }
        elif out:
            # re-prefill rung: the KV of prompt + out[:-1] is recomputed
            # here; out[-1] is the resume token (its K/V is written by the
            # first decode forward, as for any freshly sampled token)
            seq = ids + out[:-1]
            if len(seq) + 1 >= self.max_seq_len:
                raise ValueError(
                    f"import: {len(seq)} accepted positions leave no room "
                    f"in max_seq_len={self.max_seq_len}"
                )
            req.import_state = {"seq": seq, "cur": out[-1], "kv": None}
        # else: nothing was ever decoded, a plain fresh admission
        self.scheduler.submit(req)
        return req

    def close(self):
        """Stop the scheduler thread (idempotent) and drop out of the
        economics digest: a closed engine keeps neither its tensors
        reachable through the ledger nor its gauges."""
        with self._mutex:
            sch, self._scheduler = self._scheduler, None
        if sch is not None:
            sch.shutdown()
        if self.drafter_model is not None:
            self.drafter_model.close()
            self.drafter_model = None
        self.introspect.close()

    def _stop_set(self, stop_tokens):
        stop = set(int(t) for t in (stop_tokens or []))
        eos = self.tokenizer.eos_token_id
        if eos is not None and eos >= 0:
            stop.add(int(eos))
        return stop, eos

    def _make_request(
        self, prompt, max_new_tokens, temperature, top_k, top_p, stop_tokens,
        stream: bool = False, repetition_penalty: float = 1.0,
        presence_penalty: float = 0.0, frequency_penalty: float = 0.0,
        min_p: float = 0.0, tenant: str = "default",
        adapter: str | None = None,
    ):
        from .scheduler import Request

        ids = self.tokenizer.encode(prompt) if isinstance(prompt, str) else list(prompt)
        # clamp generation to what the pool can hold while keeping at
        # least a small prompt window (the JAX engine's serving rule)
        min_prompt = max(1, min(len(ids), 16))
        max_gen = self.max_seq_len - 1 - min_prompt
        if max_gen < 1:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} leaves no room in "
                f"max_seq_len={self.max_seq_len}"
            )
        max_new_tokens = max(0, min(max_new_tokens, max_gen))
        # left-truncate so prompt + generation fits
        budget = self.max_seq_len - 1 - max(max_new_tokens, 1)
        if len(ids) > budget:
            ids = ids[-budget:]
        if repetition_penalty is not None and repetition_penalty <= 0:
            raise ValueError(
                f"repetition_penalty must be > 0, got {repetition_penalty}"
            )
        if min_p is not None and not (0.0 <= min_p <= 1.0):
            raise ValueError(f"min_p must be in [0, 1], got {min_p}")
        if adapter:
            # typed BEFORE submission (UnknownAdapter -> /v1 404, p2p
            # unknown_adapter); the admission-time acquire re-checks, as an
            # eviction can race a queued request
            from ..adapters import UnknownAdapter

            if self.adapter_pool is None:
                raise UnknownAdapter(
                    f"adapter {adapter!r}: multi-adapter serving is off "
                    "(EngineConfig.max_adapters=0)"
                )
            if not self.adapter_pool.has(adapter):
                raise UnknownAdapter(f"adapter {adapter!r} is not resident")
        stop, eos = self._stop_set(stop_tokens)
        return Request(
            ids, max_new_tokens, temperature, top_k, top_p, stop, eos,
            self.tokenizer, stream=stream,
            repetition_penalty=repetition_penalty,
            presence_penalty=presence_penalty,
            frequency_penalty=frequency_penalty,
            min_p=min_p,
            tenant=tenant,
            adapter=adapter,
        )

    @staticmethod
    def _event_error(ev: dict) -> Exception:
        """Typed exception for a failed-generation event: an admission-race
        unknown_adapter keeps its type across the event queue; everything
        else is a RuntimeError."""
        if ev.get("error_kind") == "unknown_adapter":
            from ..adapters import UnknownAdapter

            return UnknownAdapter(ev.get("error", "unknown adapter"))
        return RuntimeError(ev.get("error", "generation failed"))

    def _build_result(self, req) -> GenerationResult:
        t = req.timing
        t_first = t.t_first or t.t_done
        latency = t.t_done - t.t_submit
        decode_time = t.t_done - t_first
        n_out = len(req.out_ids)
        tps = n_out / decode_time if decode_time > 0 and n_out else 0.0
        self.metrics.record(n_out, latency)
        ttft_ms = (t_first - t.t_submit) * 1000.0
        if n_out or req.finish != "cancelled":
            _H_TTFT.observe(ttft_ms)
            _H_E2E.observe(latency * 1000.0)
            if n_out > 1:
                _H_INTER_TOKEN.observe(decode_time * 1000.0 / (n_out - 1))
            _C_TOKENS_OUT.inc(n_out)
        timings = {
            "prefill_bucket": req.bucket,
            "decode_s": round(decode_time, 4),
            "chunks": req.chunks_decoded,
            "queue_wait_ms": (
                round((t.t_admit - t.t_submit) * 1000.0, 3) if t.t_admit else None
            ),
            "prefill_ms": (
                round((t_first - t.t_admit) * 1000.0, 3) if t.t_admit else None
            ),
            "ttft_ms": round(ttft_ms, 3),
            "decode_tokens": n_out,
            "tokens_per_s": round(tps, 2),
            "spec_acceptance": (
                round(req.spec_accepted / req.spec_drafted, 4)
                if req.spec_drafted else None
            ),
        }
        return GenerationResult(
            text=self.tokenizer.decode(req.out_ids),
            token_ids=list(req.out_ids),
            prompt_tokens=req.prompt_tokens,
            new_tokens=n_out,
            ttft_s=round(t_first - t.t_submit, 4),
            latency_s=round(latency, 4),
            tokens_per_sec=round(tps, 2),
            finish_reason=req.finish or "length",
            timings=timings,
        )

    def generate_stream(
        self,
        prompt: str | list[int],
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        stop_tokens: list[int] | None = None,
        repetition_penalty: float = 1.0,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
        min_p: float = 0.0,
        tenant: str = "default",
        adapter: str | None = None,
    ) -> Iterator[dict]:
        """Yield {"token": last_id, "tokens": ids, "text": piece} per
        decode chunk, then {"done": True, "result": GenerationResult}.
        Concurrent callers share the scheduler's batch."""
        req = self._make_request(
            prompt, max_new_tokens, temperature, top_k, top_p, stop_tokens,
            stream=True, repetition_penalty=repetition_penalty,
            presence_penalty=presence_penalty,
            frequency_penalty=frequency_penalty,
            min_p=min_p, tenant=tenant, adapter=adapter,
        )
        if req.max_new_tokens <= 0:
            req.timing.t_first = req.timing.t_done = time.perf_counter()
            yield {"done": True, "result": self._build_result(req)}
            return
        self.scheduler.submit(req)
        try:
            while True:
                ev = req.events.get()
                if ev.get("done") and ev.get("result") is None:
                    raise self._event_error(ev)
                yield ev
                if ev.get("done"):
                    return
        finally:
            # consumer closed the generator early: release the batch row
            if req.finish is None:
                req.cancelled = True

    def generate(self, prompt, **kw) -> GenerationResult:
        """Non-streaming generation via the same scheduler path; blocks
        until the request retires (EOS / stop / budget)."""
        stop_tokens = kw.pop("stop_tokens", None)
        req = self._make_request(
            prompt,
            kw.get("max_new_tokens", 128),
            kw.get("temperature", 0.0),
            kw.get("top_k", 0),
            kw.get("top_p", 1.0),
            stop_tokens,
            repetition_penalty=kw.get("repetition_penalty", 1.0),
            presence_penalty=kw.get("presence_penalty", 0.0),
            frequency_penalty=kw.get("frequency_penalty", 0.0),
            min_p=kw.get("min_p", 0.0),
            tenant=kw.get("tenant", "default"),
            adapter=kw.get("adapter"),
        )
        if req.max_new_tokens <= 0:
            req.timing.t_first = req.timing.t_done = time.perf_counter()
            return self._build_result(req)
        self.scheduler.submit(req)
        while True:
            ev = req.events.get()
            if ev.get("done"):
                if ev.get("result") is None:
                    raise self._event_error(ev)
                return ev["result"]

    @property
    def info(self) -> dict:
        return {
            "model": self.model_cfg.name,
            "n_params": int(sum(
                t.numel() for t in _leaves(self.params)
            )),
            "dtype": self.engine_cfg.dtype,
            "max_seq_len": self.max_seq_len,
            "platform": self.device.type,
            "device": (
                torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu"
            ),
            "kv": self.kv_info,
            "spec": self._spec_info(),
            **({"adapters": self.adapter_pool.info}
               if self.adapter_pool is not None else {}),
            # compiles (graph captures) per root, MFU/goodput over the
            # trailing window and the HBM ledger; refresh() also brings
            # the engine.* economics gauges current
            "introspect": self.introspect.refresh(),
        }


    def _spec_info(self) -> dict:
        """info["spec"] as JAX gives it: read off the scheduler's stats
        when it exists (info never allocates the pool); the per-tier
        split when a drafter is configured."""
        sch = self._scheduler
        st = sch.stats if sch is not None else None
        drafted = st.spec_drafted if st else 0
        out = {
            "spec_tokens": self.engine_cfg.spec_tokens,
            "drafted": drafted,
            "accepted": st.spec_accepted if st else 0,
            "acceptance": round(st.spec_accepted / drafted, 4) if drafted else 0.0,
        }
        if self.engine_cfg.drafter:
            out["drafter"] = self.engine_cfg.drafter
            out["tiers"] = dict(st.spec_tiers) if st else {}
        return out


# torch dtypes by numpy's names, which the migration wire and the JAX
# package use
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
                torch.float16: "float16", torch.int8: "int8"}


def dtype_name(dt) -> str | None:
    """numpy's name of a torch or numpy dtype (ml_dtypes' bfloat16 is
    "bfloat16" too), so a dtype is checked without importing ml_dtypes."""
    if isinstance(dt, torch.dtype):
        return _DTYPE_NAMES.get(dt, str(dt))
    return getattr(dt, "name", None)


def host_tensor(arr) -> torch.Tensor:
    """A shipped block tensor as a host torch tensor: torch as it is, a
    numpy array through its bytes (an ml_dtypes bf16 array through its
    int16 view)."""
    if isinstance(arr, torch.Tensor):
        return arr
    a = np.ascontiguousarray(arr)
    if not a.flags.writeable:  # a view of a received frame's bytes
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _merge_lora(params, lora_path, model_cfg):
    from ..train.lora import load_adapters, merge_lora

    adapters, lcfg = load_adapters(lora_path, model_cfg=model_cfg)
    return merge_lora(params, adapters, lcfg)


def _cast_floats(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_floats(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def _copy_tree(tree):
    """The dicts and lists of a parameter tree copied, its tensors shared."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
