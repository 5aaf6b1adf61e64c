"""Per-row token sampling on the device: greedy / temperature / top-k /
top-p / min-p, after occurrence penalties.

The port of ``bee2bee_tpu/engine/sampling.py``'s ``apply_penalties`` and
``sample_batched``. Every knob is a [B] tensor, so one decode step serves
any mix of concurrent requests' settings. The masks are the JAX
package's, step for step; only the draw differs: ``jax.random`` keys
become an explicit ``torch.Generator``, and the categorical draw is a
Gumbel-max over exponential noise (argmax of p / E, E ~ Exp(1)), which
samples the same distribution without a host sync. Sampled tokens
therefore never match the JAX package's bit for bit; greedy tokens and
the kept sets do.
"""

from __future__ import annotations

import torch


def apply_penalties(
    logits,  # [B, V] float32
    counts,  # [B, 2, V] int32: [:, 0] prompt occurrences, [:, 1] generated
    repetition,  # [B] float32; 1.0 = off (HF-style multiplicative)
    presence,  # [B] float32; 0.0 = off (flat tax on any generated token)
    frequency,  # [B] float32; 0.0 = off (per-generated-occurrence tax)
):
    """Occurrence penalties, applied before temperature/argmax: repetition
    follows HF (divide positive logits, multiply negative ones, over
    prompt + generated tokens); presence/frequency follow OpenAI
    (generated tokens only)."""
    gen = counts[:, 1]
    seen_any = (counts[:, 0] > 0) | (gen > 0)
    rep = repetition[:, None]
    logits = torch.where(
        seen_any, torch.where(logits > 0, logits / rep, logits * rep), logits
    )
    logits = logits - presence[:, None] * (gen > 0).to(logits.dtype)
    return logits - frequency[:, None] * gen.to(logits.dtype)


def masked_logits(logits, temperature, top_k, top_p, min_p=None):
    """Temperature-scaled logits with every token outside the row's
    min-p / top-k / top-p sets at -inf — the JAX ``sampled_path`` masks in
    the same order (min-p on the scaled softmax, then top-k, then the
    nucleus over the already-masked logits; the top token always
    survives)."""
    V = logits.shape[-1]
    l = logits / torch.clamp(temperature, min=1e-6)[:, None]
    # a python scalar, not a tensor built from one: that would be a host
    # copy, which a captured CUDA graph cannot hold
    neg_inf = float("-inf")
    if min_p is not None:
        probs0 = torch.softmax(l, dim=-1)
        floor = min_p[:, None] * probs0.amax(dim=-1, keepdim=True)
        l = torch.where(probs0 >= floor, l, neg_inf)
    sorted_l = torch.sort(l, dim=-1, descending=True).values
    k_eff = torch.clamp(torch.where(top_k > 0, top_k, V), 1, V).long()
    kth = torch.gather(sorted_l, 1, (k_eff - 1)[:, None])
    l = torch.where(l < kth, neg_inf, l)
    sorted_m = torch.sort(l, dim=-1, descending=True).values
    probs = torch.softmax(sorted_m, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_p[:, None]
    keep[:, 0] = True
    cutoff = torch.where(keep, sorted_m, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where(l < cutoff, neg_inf, l)


def sample_batched(
    logits,  # [B, V] float32
    generator: torch.Generator,
    temperature,  # [B] float32; <= 0 -> greedy for that row
    top_k,  # [B] int32; <= 0 -> no top-k restriction
    top_p,  # [B] float32; >= 1 -> no nucleus restriction
    min_p=None,  # [B] float32 or None (off)
    counts=None,  # optional [B, 2, V] int32 -> penalties first
    repetition=None,  # [B] float32 (with counts)
    presence=None,  # [B] float32 (with counts)
    frequency=None,  # [B] float32 (with counts)
    any_sampled: bool | None = None,
):
    """Next tokens [B] (int64). Greedy rows take the argmax; sampled rows
    draw from their masked distribution with ``generator``.

    An all-greedy batch pays the argmax only. That choice is a host-side
    branch: ``any_sampled`` is the caller's host knowledge of whether some
    row has temperature > 0 (the scheduler keeps the knobs on the host);
    left None, it is read from ``temperature``, which costs one device
    sync when the tensor lives on the card."""
    if counts is not None:
        logits = apply_penalties(logits, counts, repetition, presence, frequency)
    greedy = torch.argmax(logits, dim=-1)
    if any_sampled is None:
        any_sampled = bool((temperature > 0).any())
    if not any_sampled:
        return greedy
    probs = torch.softmax(masked_logits(logits, temperature, top_k, top_p, min_p), dim=-1)
    noise = torch.empty_like(probs).exponential_(generator=generator)
    # a zero draw would turn a masked token's 0/0 into NaN
    noise.clamp_(min=torch.finfo(noise.dtype).tiny)
    sampled = torch.argmax(probs / noise, dim=-1)
    return torch.where(temperature <= 0, greedy, sampled)
