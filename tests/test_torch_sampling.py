"""The PyTorch port's sampling (bee2bee_tpu_torch/engine/sampling.py)
against the JAX package's (bee2bee_tpu/engine/sampling.py).

The same logits, counts and knobs, made from a seed with numpy, go to
both. Penalties and greedy tokens must agree exactly. Draws cannot (the
port samples with a torch.Generator, the JAX package with jax.random),
so the sampled path is checked on its kept sets: the tokens the JAX
sampler ever draws over many rows are exactly the tokens the port's
masks keep (every kept token is built to carry >= 2% of the mass, so
4096 draws miss one with probability < 1e-30), and the port never draws
outside its kept set.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bee2bee_tpu.engine import sampling as jsampling
from bee2bee_tpu_torch.engine import sampling

V = 24
N_DRAWS = 4096


def _logits(B=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, V)) * 2.0).astype(np.float32)


def _counts(B=3, seed=1):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 3, size=(B, 2, V)).astype(np.int32)
    c[rng.random((B, 2, V)) < 0.6] = 0
    return c


def test_apply_penalties_exact():
    logits, counts = _logits(), _counts()
    rep = np.asarray([1.0, 1.3, 0.7], np.float32)
    pres = np.asarray([0.0, 0.5, 1.5], np.float32)
    freq = np.asarray([0.25, 0.0, 0.75], np.float32)
    want = jsampling.apply_penalties(
        jnp.asarray(logits), jnp.asarray(counts), jnp.asarray(rep),
        jnp.asarray(pres), jnp.asarray(freq),
    )
    got = sampling.apply_penalties(
        torch.from_numpy(logits), torch.from_numpy(counts), torch.from_numpy(rep),
        torch.from_numpy(pres), torch.from_numpy(freq),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("penalized", [False, True], ids=["plain", "penalized"])
def test_greedy_rows_exact(penalized):
    """All-greedy batch (argmax only) and greedy rows inside a mixed
    batch: the same tokens as the JAX sampler, penalties included."""
    logits, counts = _logits(B=4, seed=2), _counts(B=4, seed=3)
    temps = np.asarray([0.0, 0.0, 0.9, 0.0], np.float32)
    topk = np.zeros((4,), np.int32)
    topp = np.ones((4,), np.float32)
    pen = [np.full((4,), 1.4, np.float32), np.full((4,), 0.3, np.float32),
           np.full((4,), 0.2, np.float32)] if penalized else [None] * 3
    jargs = [jnp.asarray(a) if a is not None else None
             for a in [counts if penalized else None, *pen]]
    targs = [torch.from_numpy(a) if a is not None else None
             for a in [counts if penalized else None, *pen]]
    for t in (np.zeros_like(temps), temps):
        want = jsampling.sample_batched(
            jnp.asarray(logits), jax.random.key(0), jnp.asarray(t),
            jnp.asarray(topk), jnp.asarray(topp), None, *jargs,
        )
        got = sampling.sample_batched(
            torch.from_numpy(logits), torch.Generator().manual_seed(0),
            torch.from_numpy(t), torch.from_numpy(topk), torch.from_numpy(topp),
            None, *targs,
        )
        greedy = t <= 0
        np.testing.assert_array_equal(got.numpy()[greedy], np.asarray(want)[greedy])


def _flat_logits(n_keep_hint=6, seed=4):
    """A row whose top tokens share a sizeable mass: the top
    ``n_keep_hint`` logits sit within 1.5 of each other, the rest far
    below — every token a mask can keep carries >= 2% of the mass."""
    rng = np.random.default_rng(seed)
    row = np.full((V,), -9.0, np.float32)
    idx = rng.permutation(V)
    row[idx[:n_keep_hint]] = np.linspace(1.5, 0.0, n_keep_hint)
    row[idx[n_keep_hint:n_keep_hint + 6]] = np.linspace(-0.5, -1.5, 6)
    return row


KNOBS = {
    "top_k": dict(top_k=4, top_p=1.0, min_p=0.0),
    "top_p": dict(top_k=0, top_p=0.7, min_p=0.0),
    "min_p": dict(top_k=0, top_p=1.0, min_p=0.3),
    "all_three": dict(top_k=8, top_p=0.8, min_p=0.1),
    "top_k_and_min_p": dict(top_k=6, top_p=1.0, min_p=0.05),
}


def _knob_rows(k, n):
    return (
        np.full((n,), 0.9, np.float32),
        np.full((n,), k["top_k"], np.int32),
        np.full((n,), k["top_p"], np.float32),
        np.full((n,), k["min_p"], np.float32),
    )


@pytest.fixture(scope="module")
def jax_supports():
    """Every knob setting's JAX draws in ONE call: the knobs are per row,
    so the cases stack into one [len(KNOBS) * N_DRAWS, V] batch."""
    names = sorted(KNOBS)
    rows = [_knob_rows(KNOBS[n], N_DRAWS) for n in names]
    cols = [np.concatenate(c) for c in zip(*rows)]
    logits = np.tile(_flat_logits(), (len(names) * N_DRAWS, 1))
    draws = np.asarray(jsampling.sample_batched(
        jnp.asarray(logits), jax.random.key(7),
        *(jnp.asarray(c) for c in cols),
    )).reshape(len(names), N_DRAWS)
    return {n: set(np.unique(d).tolist()) for n, d in zip(names, draws)}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_kept_sets_match_jax(knob, jax_supports):
    row = _flat_logits()
    temps, topk, topp, minp = (torch.from_numpy(a) for a in _knob_rows(KNOBS[knob], N_DRAWS))
    minp = minp if KNOBS[knob]["min_p"] else None
    masked = sampling.masked_logits(
        torch.from_numpy(row[None]), temps[:1], topk[:1], topp[:1],
        minp[:1] if minp is not None else None,
    )[0]
    kept = set(torch.nonzero(torch.isfinite(masked)).flatten().tolist())
    probs = torch.softmax(masked, dim=-1)
    assert probs[sorted(kept)].min() >= 0.02  # the draw count is enough
    assert jax_supports[knob] == kept
    got = sampling.sample_batched(
        torch.from_numpy(np.tile(row, (N_DRAWS, 1))),
        torch.Generator().manual_seed(7), temps, topk, topp, minp,
    )
    assert set(got.unique().tolist()) <= kept


def test_any_sampled_flag_skips_the_sampled_path():
    """The host-side all-greedy branch: ``any_sampled=False`` returns the
    argmax even where a row's temperature is > 0 (the caller vouches for
    its knobs), and leaving it None reads the temperatures."""
    logits = torch.from_numpy(_logits(B=2, seed=5))
    temps = torch.tensor([0.0, 1.0])
    knobs = (temps, torch.zeros(2, dtype=torch.int32), torch.ones(2))
    gen = torch.Generator().manual_seed(0)
    out = sampling.sample_batched(logits, gen, *knobs, any_sampled=False)
    torch.testing.assert_close(out, logits.argmax(-1))
    state = gen.get_state()
    sampling.sample_batched(logits, gen, torch.zeros(2), *knobs[1:])
    assert torch.equal(gen.get_state(), state)  # all greedy: no draw
