#!/usr/bin/env python3
"""A probe of the port's mixture-of-experts forwards over an int8 pool, on
one CUDA card. Run from the root of a checkout:

  python3 moe_probe.py

The 2-layer f32 forward of each MoE preset at full width
(``chip_smoke.phase_moe_forward``'s model, prompt and 8 greedy steps) over
an f32 and an int8 pool, with the attention and the expert product each
through its kernel or its plain version, all four ways, against the
all-plain forward: the logits' max abs error and whether the greedy tokens
equal. The smoke holds qwen3-30b-a3b's int8-pool forwards per call because
of what this shows (``chip_smoke.MOE_INT8_POOL_PER_CALL``).

Prints the card's name and power limit; exits non-zero without a card.
"""

from __future__ import annotations

import sys
from dataclasses import replace
from pathlib import Path

import torch


def int8_pool(cs, card: str) -> None:
    from bee2bee_tpu_torch.models.config import get_config
    from bee2bee_tpu_torch.ops.ragged import ragged_paged_attention, ragged_paged_attention_ref

    for name, perturb in (("qwen3-30b-a3b", cs.perturb_qwen), ("mixtral-8x7b", cs.perturb_norms)):
        cfg = replace(get_config(name), n_layers=2, name=f"{name}-2layers")
        cfg, params, run = cs.forward_setup(cfg, cs.MOE_PROMPT)
        perturb(params, cs.SEED + 7)
        for pool in (torch.float32, torch.int8):
            res = {}
            for attn, experts in (("plain", "plain"), ("kernel", "kernel"), ("plain", "kernel"),
                                  ("kernel", "plain")):
                fn = ragged_paged_attention if attn == "kernel" else ragged_paged_attention_ref
                if experts == "plain":
                    with cs.plain_experts():
                        res[(attn, experts)] = run(fn, pool)
                else:
                    res[(attn, experts)] = run(fn, pool)
            torch.cuda.synchronize()
            ref_logits, ref_steps, ref_toks = res[("plain", "plain")]
            for (attn, experts), (logits, steps, toks) in res.items():
                err = max((logits - ref_logits).abs().max().item(),
                          (steps - ref_steps).abs().max().item())
                cs.log(f"moe int8-pool {name} f32 over {str(pool)[6:]} pool: attention {attn}, "
                       f"experts {experts}: logits max abs err vs all-plain {err:.3e}, max "
                       f"|logit| {ref_logits.abs().max().item():.3f}, greedy tokens equal "
                       f"{toks == ref_toks}; card {card}")
        del params, run
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_probe: no CUDA device available", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    import chip_smoke as cs

    card, _ = cs.phase_device_and_build()
    int8_pool(cs, card)
    cs.log(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
