"""Weight-only int8 quantization in the PyTorch port (``models/quant.py``,
``ops/int8_gemm.py``), against the JAX package on the same numpy inputs.

- ``quantize_weight`` / ``quantize_params`` are bit-equal to JAX's, and the
  torch form (``quantize_weight_torch``, ``quantize_params_``) to numpy's on
  the same f32 input.
- The kernels read the JAX layout as it lies: their wrapper's check takes
  every projection shape the served int8-weight families launch and
  refuses by name the shapes the kernels cannot take; the plain int8
  matmul equals JAX ``core.matmul`` (f32: within 1e-5; bf16: within two
  bf16 ulps of the output's scale), and ``core.matmul`` is that wrapper.
  A CPU model of the kernels' arithmetic
  (tests/int8_gemm_model.py: 64-input stages, f32 split partials reduced
  in split order, one rounding) stays within the card's tolerances of the
  plain version and of JAX at M from 1 to 2,048; the f32 form's 2xTF32
  arithmetic stays within 2e-7 of the exact product and 1e-5 of JAX's f32
  one, split as the plan splits it too.
- The plan and the route are functions of host shapes (decode kernel to
  64 tokens, prefill kernel beyond in bf16, the dequantize route beyond in
  f32); a CUDA-less device raises.
- ``params_from_numpy`` carries a JAX-quantized tree across (int8 stays
  int8), and the port's quantized forward gives JAX's logits (f32, within
  1e-4).
- A port ``quantize="int8"`` engine and a JAX one on the same weights
  decode the same greedy tokens (quantized on either side), ``lora_path``
  merges before quantization in both (a random int8 engine's too), and
  the ledger counts the int8 bytes and scales.
- ``check_card_supported`` takes int8 weights beside bf16 and f32
  activations (ROADMAP.md queue A item 18: the GEMM's f32 form); the route
  names the kernel for both types and refuses others.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee2bee_tpu.engine import EngineConfig as JaxEngineConfig
from bee2bee_tpu.engine import InferenceEngine as JaxEngine
from bee2bee_tpu.models import core as jcore
from bee2bee_tpu.models import quant as jquant
from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
from bee2bee_tpu_torch.engine.engine import check_card_supported
from bee2bee_tpu_torch.models import core, quant
from bee2bee_tpu_torch.models.config import get_config
from bee2bee_tpu_torch.models.params import params_from_numpy, params_to_numpy
from bee2bee_tpu_torch.ops import int8_gemm
from bee2bee_tpu_torch.train.lora import LoraConfig, save_adapters

CFG = get_config("tiny-llama")
KW = dict(max_seq_len=128, dtype="float32", cache_dtype="float32", decode_chunk=4,
          prefill_buckets=(16, 32, 64), max_batch=4)
PROMPTS = ([5, 6, 7, 8, 9, 10, 11, 12], list(range(30, 70)), [400, 3, 77] * 5)


@pytest.fixture(scope="module")
def jax_dense():
    """The JAX init's f32 tiny-llama weights, layers stacked [L, ...]
    (numpy): what the JAX engine quantizes and merges adapters into."""
    return jax.device_get(jcore.init_params(CFG, jax.random.key(0), dtype=jnp.float32))


def _weights(seed, shape, zero_col=False):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if zero_col:
        w[..., 3] = 0.0  # an all-zero output channel: scale 0 -> safe 1
    return w


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def _layer(tree, i):
    """Layer i of a JAX tree (layers stacked [L, ...] or a per-layer list)."""
    layers = tree["layers"]
    if isinstance(layers, (list, tuple)):
        return layers[i]
    return jax.tree.map(lambda a: np.asarray(a)[i], layers)


@pytest.mark.parametrize("shape,zero_col", [((64, 96), False), ((64, 32), True),
                                            ((3, 128, 48), False)])
def test_quantize_weight_bit_equal_to_jax(shape, zero_col):
    w = _weights(1, shape, zero_col)
    want = jquant.quantize_weight(w)
    got = quant.quantize_weight(w)
    tgot = quant.quantize_weight_torch(torch.from_numpy(w))
    for part in ("q", "s"):
        np.testing.assert_array_equal(_bits(got[part]), _bits(want[part]))
        np.testing.assert_array_equal(_bits(tgot[part].numpy()), _bits(want[part]))
    np.testing.assert_array_equal(quant.dequantize_weight(got),
                                  jquant.dequantize_weight(want))


def test_quantize_params_bit_equal_to_jax(jax_dense):
    want = jquant.quantize_params(jax_dense)
    got = quant.quantize_params(jax_dense)
    leaves_w, tree_w = jax.tree.flatten(want)
    leaves_g, tree_g = jax.tree.flatten(got)
    assert tree_w == tree_g
    for a, b in zip(leaves_w, leaves_g):
        np.testing.assert_array_equal(_bits(np.asarray(a)), _bits(np.asarray(b)))
    # the torch form, in place on the port's tree, gives the same q and s
    params = params_from_numpy(jax_dense, CFG, "cpu", torch.float32)
    quant.quantize_params_(params)
    for i, lp in enumerate(params["layers"]):
        for grp, name in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
                          ("mlp", "w_up"), ("mlp", "w_gate"), ("mlp", "w_down")):
            ref = _layer(want, i)[grp][name]
            np.testing.assert_array_equal(lp[grp][name]["q"].numpy(), ref["q"])
            np.testing.assert_array_equal(_bits(lp[grp][name]["s"].numpy()),
                                          _bits(ref["s"]))
    assert all(torch.is_tensor(params[k]) for k in ("tok_embed", "lm_head") if k in params)


# the families served with int8 weights on the card
INT8_FAMILIES = ("llama-3-8b", "qwen2-7b", "gemma-3-4b", "phi-3-mini", "distilgpt2",
                 "mixtral-8x7b")


def served_projections(name: str) -> list:
    """(K, (N of each weight of one launch)) for the int8-weight GEMM's
    launches of one layer of ``name``, grouped as the engine launches them:
    wq|wk|wv, wo, and for a dense MLP w_up|w_gate (w_up alone for a gelu
    MLP) and w_down; an MoE layer's experts take the expert GEMM."""
    cfg = get_config(name)
    d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    out = [(d, (hq, hkv, hkv)), (hq, (d,))]
    if not cfg.is_moe:
        gated = getattr(cfg, "mlp", "swiglu") != "gelu"
        out += [(d, (cfg.d_ff,) * (2 if gated else 1)), (cfg.d_ff, (d,))]
    return out


@pytest.mark.parametrize("family", INT8_FAMILIES)
def test_kernel_takes_every_served_projection(family):
    """Every projection shape a served int8-weight family launches, as the
    quantizer leaves it (the JAX layout [K, N], which the TMA maps read as
    it lies), passes the wrapper's check at every M; the plan gives each
    launch a tile and splits the kernel takes."""
    for K, Ns in served_projections(family):
        for N in Ns:
            w = quant.quantize_weight_torch(torch.ones((K, N)))
            assert w["q"].dtype == torch.int8 and w["q"].shape == (K, N)
            for M in (1, 64, 65):
                int8_gemm._check_kernel_args(torch.zeros((M, K), dtype=torch.bfloat16),
                                             w["q"], w["s"])
        for M in (1, 8, 40, 64, 65, 2048):
            br, splits = int8_gemm.gemm_plan(M, K, Ns, 132)
            assert (br == 8 * -(-M // 8)) if M <= 64 else br in (128, 256)
            assert 1 <= splits <= -(-K // 64) and (splits == 1 or br <= 128)


def test_kernel_check_refuses_unaligned_shapes():
    """The wrapper refuses by name what the kernels' TMA maps cannot take
    (K % 8, N % 16), a weight that is not int8 [K, N] and scales that are
    not f32; the CPU's plain version runs any shape."""
    x = torch.zeros((2, 44), dtype=torch.bfloat16)
    s16 = torch.ones(16)
    with pytest.raises(ValueError, match="K % 8"):
        int8_gemm._check_kernel_args(x, torch.zeros((44, 16), dtype=torch.int8), s16)
    with pytest.raises(ValueError, match="N % 16"):
        int8_gemm._check_kernel_args(x[:, :32].contiguous(),
                                     torch.zeros((32, 24), dtype=torch.int8), torch.ones(24))
    with pytest.raises(ValueError, match="expected int8"):
        int8_gemm._check_kernel_args(x[:, :32].contiguous(), torch.zeros((32, 16)), s16)
    with pytest.raises(ValueError, match="scales"):
        int8_gemm._check_kernel_args(x[:, :32].contiguous(),
                                     torch.zeros((32, 16), dtype=torch.int8), s16.double())
    wq = {"q": torch.ones((44, 16), dtype=torch.int8), "s": torch.full((16,), 0.5)}
    assert torch.equal(core.matmul(torch.ones((2, 44)), wq), torch.full((2, 16), 22.0))


@pytest.mark.parametrize("M", [1, 5, 40, 70])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_plain_int8_matmul_matches_jax_matmul(M, dtype):
    """The plain version against JAX ``core.matmul``, the same numpy
    inputs. f32: the same formula, 1e-5;
    bf16: both round the dot and the scaled product to bf16, in their own
    summation orders: within two bf16 ulps (2^-7) of the output's scale."""
    K, N = 128, 96
    qw = jquant.quantize_weight(_weights(3, (K, N)) / np.sqrt(K))
    x = np.random.default_rng(M).standard_normal((2, M, K)).astype(np.float32)
    want = np.asarray(jcore.matmul(jnp.asarray(x, dtype), qw), np.float32)
    w = {"q": torch.from_numpy(qw["q"]), "s": torch.from_numpy(qw["s"])}
    tdtype = torch.float32 if dtype is np.float32 else torch.bfloat16
    got = int8_gemm.int8_weight_matmul(torch.from_numpy(x).to(tdtype), w)
    assert got.dtype == tdtype and got.shape == (2, M, N)
    tol = 1e-5 if dtype is np.float32 else 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    # core.matmul is the wrapper
    x_t = torch.from_numpy(x).to(tdtype)
    assert torch.equal(core.matmul(x_t, w), got)


@pytest.mark.parametrize("M,K,N", [(1, 1024, 256), (8, 1024, 256), (40, 1000, 192),
                                   (64, 512, 128), (65, 1024, 256), (600, 512, 384),
                                   (2048, 256, 128)])
@pytest.mark.parametrize("dtype", [jnp.bfloat16, np.float32], ids=["bf16", "f32"])
def test_kernel_model_matches_plain_and_jax(M, K, N, dtype):
    """The CPU model of the kernels' arithmetic (tests/int8_gemm_model.py:
    stages, accumulator chains, splits) under the plan ``gemm_plan`` gives
    at M from 1 to 2,048 (K = 1000: a partial last stage), and under every
    other split count in 1..4: bf16
    within 2^-6 of the largest |output| of the plain version and of JAX
    ``core.matmul`` (the smoke's tolerance for the kernels on the card),
    f32 (the decode kernel's form, M <= 64) within 1e-5 (the card's is
    1e-4). Splitting moves bf16 outputs by at most a rounding."""
    from int8_gemm_model import gemm

    f32 = dtype is np.float32
    if f32 and M > int8_gemm.CROSSOVER_M:
        assert int8_gemm.int8_gemm_route(M, torch.float32) == "dequant"
        return
    qw = jquant.quantize_weight(_weights(M + K, (K, N)) / np.sqrt(K))
    x = np.random.default_rng(M).standard_normal((M, K)).astype(np.float32)
    tdtype = torch.float32 if f32 else torch.bfloat16
    xt = torch.from_numpy(x).to(tdtype)
    x = xt.float().numpy()  # the values the kernel reads
    plain = int8_gemm.int8_weight_matmul(xt, {"q": torch.from_numpy(qw["q"]),
                                              "s": torch.from_numpy(qw["s"])}).float().numpy()
    want = np.asarray(jcore.matmul(jnp.asarray(x, dtype), qw), np.float32)
    scale = np.abs(want).max()
    tol = (1e-5 if f32 else 2.0 ** -6) * scale
    br, planned = int8_gemm.gemm_plan(M, K, (N,), 132)
    nk = -(-K // 64)
    for splits in sorted({planned, *range(1, min(4, nk) + 1)} if br <= 128 else {planned}):
        got = torch.from_numpy(gemm(x, qw["q"], qw["s"], splits, f32, br)).to(tdtype)
        got = got.float().numpy()
        assert np.abs(got - plain).max() <= tol, splits
        assert np.abs(got - want).max() <= tol, splits


@pytest.mark.parametrize("M", [1, 8, 40])
def test_2xtf32_model_of_the_f32_gemm_matches_jax_matmul(M):
    """The arithmetic of the GEMM's f32 form (csrc/int8_weight_gemm.cu): the
    int8 weight exact in TF32, x split into TF32 hi + lo (cvt.rna's
    rounding, tests/tf32_attention_model.py), two products summed (here in
    float64), the scale once after the sum. At qwen2-7b's w_down depth (K =
    18944) it stays within 2e-7 of the largest |output| of the exact product
    and within 1e-5 of JAX's f32 ``core.matmul`` (whose own f32 sums sit
    further from the exact one); one product (hi alone) would miss the
    1e-4 the card's smoke holds the kernel to."""
    from tf32_attention_model import split

    K, N = 18944, 48
    qw = jquant.quantize_weight(_weights(7, (K, N)) / np.sqrt(K))
    x = np.random.default_rng(M + 100).standard_normal((M, K)).astype(np.float32)
    jax_f32 = np.asarray(jcore.matmul(jnp.asarray(x), qw), np.float64)
    q = qw["q"].astype(np.float64)
    s = qw["s"].astype(np.float64)
    exact = (x.astype(np.float64) @ q) * s
    hi, lo = (t.astype(np.float64) for t in split(x))
    two = (((lo @ q) + (hi @ q)) * s).astype(np.float32)
    one = ((hi @ q) * s).astype(np.float32)
    scale = np.abs(exact).max()
    assert np.abs(two - exact).max() <= 2e-7 * scale
    assert np.abs(two - jax_f32).max() <= 1e-5 * scale
    assert np.abs(one - exact).max() > 1e-4 * scale
    # as the kernel sums it: f32 partials of 64-input stages, lo before hi,
    # the plan's K splits reduced in split order
    from int8_gemm_model import gemm

    splits = int8_gemm.gemm_plan(M, K, (N,), 132)[1]
    for n in sorted({splits, 1, 3}):
        staged = gemm(x, qw["q"], qw["s"], n, f32_form=True)
        assert np.abs(staged - exact).max() <= 1e-5 * scale
        assert np.abs(staged - jax_f32).max() <= 1e-5 * scale


@pytest.mark.parametrize("Ns", [(64, 32, 32), (128, 128), (96,)], ids=["qkv", "upgate", "one"])
def test_grouped_matmul_equals_one_by_one(Ns):
    """``matmul_group`` (one kernel launch on the card) gives each weight's
    ``matmul``; dense weights go one by one; more than three refuse."""
    K = 64
    rng = np.random.default_rng(len(Ns))
    ws = []
    for N in Ns:
        qw = quant.quantize_weight(rng.standard_normal((K, N)).astype(np.float32))
        ws.append({"q": torch.from_numpy(qw["q"]), "s": torch.from_numpy(qw["s"])})
    x = torch.from_numpy(rng.standard_normal((3, 5, K)).astype(np.float32))
    got = core.matmul_group(x, ws)
    assert [tuple(y.shape) for y in got] == [(3, 5, N) for N in Ns]
    for y, w in zip(got, ws):
        assert torch.equal(y, core.matmul(x, w))
    dense = [torch.ones((K, N)) for N in Ns]
    assert all(torch.equal(y, x @ d) for y, d in zip(core.matmul_group(x, dense), dense))
    with pytest.raises(ValueError, match="1 to 3"):
        int8_gemm.int8_weight_matmul_group(x, ws * 4)


def test_wrapper_routes_and_refuses_other_devices():
    """bf16: the decode kernel up to CROSSOVER_M tokens, the prefill kernel
    beyond (no dequantize route); f32: the decode kernel's f32 form, then
    the dequantize route. Other devices raise; the CPU runs the plain
    version and counts nothing."""
    m = int8_gemm.CROSSOVER_M
    assert int8_gemm.int8_gemm_route(1) == "decode"
    assert int8_gemm.int8_gemm_route(m) == "decode"
    assert int8_gemm.int8_gemm_route(m + 1) == "prefill"
    assert int8_gemm.int8_gemm_route(2048) == "prefill"
    assert int8_gemm.int8_gemm_route(m, torch.float32) == "decode"
    assert int8_gemm.int8_gemm_route(m + 1, torch.float32) == "dequant"
    assert set(int8_gemm._COUNTER.values()) == set(int8_gemm.LAUNCH_COUNTERS)
    w = {"q": torch.zeros((32, 32), dtype=torch.int8, device="meta"),
         "s": torch.zeros((32,), device="meta")}
    with pytest.raises(ValueError, match="no kernel for meta"):
        int8_gemm.int8_weight_matmul(torch.zeros((1, 32), device="meta"), w)
    # core.matmul never converts the weight off the CPU: it is the wrapper
    with pytest.raises(ValueError, match="no kernel for meta"):
        core.matmul(torch.zeros((1, 32), device="meta"), w)
    # the plain version runs on the CPU and counts no launch
    def counts():
        return [getattr(int8_gemm.int8_weight_matmul, n) for n in int8_gemm.LAUNCH_COUNTERS]

    before = counts()
    wc = {"q": torch.ones((32, 32), dtype=torch.int8), "s": torch.full((32,), 0.5)}
    for M in (3, 100):
        assert torch.equal(int8_gemm.int8_weight_matmul(torch.ones((M, 32)), wc),
                           torch.full((M, 32), 16.0))
    assert counts() == before


@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                                 (64, 32)])
def test_gemm_plan_covers_k_from_host_shapes(K, N):
    """The plan's tile holds a decode root's M in one tile (kernel A) and
    is 128 or 256 rows beyond; every K split keeps at least one stage of
    64 inputs, splits only on tiles of at most 128 rows, and the plan is
    the same for the same host shapes."""
    nk = -(-K // 64)
    for M in (1, 7, 8, 40, 64, 65, 128, 129, 600, 2048):
        br, splits = int8_gemm.gemm_plan(M, K, (N,), 132)
        if M <= int8_gemm.CROSSOVER_M:
            assert br == 8 * -(-M // 8)
        else:
            assert br in (128, 256) and (M > 128 or br == 128)
        assert 1 <= splits <= min(nk, int8_gemm._MAX_SPLITS)
        assert splits == 1 or (br <= 128 and nk // splits >= int8_gemm._MIN_STAGES)
        assert int8_gemm.gemm_plan(M, K, (N,), 132) == (br, splits)  # host shapes only


def test_params_from_numpy_carries_quantized_weights(jax_dense):
    qtree = jquant.quantize_params(jax_dense)
    params = params_from_numpy(qtree, CFG, "cpu", torch.float32)
    wq = params["layers"][1]["attn"]["wq"]
    assert wq["q"].dtype == torch.int8 and wq["s"].dtype == torch.float32
    np.testing.assert_array_equal(wq["q"].numpy(), _layer(qtree, 1)["attn"]["wq"]["q"])
    assert params["layers"][0]["ln1"]["scale"].dtype == torch.float32
    # and back out in the JAX tree, bit for bit
    back = params_to_numpy(params)["layers"]["attn"]["wq"]
    np.testing.assert_array_equal(back["q"], qtree["layers"]["attn"]["wq"]["q"])
    np.testing.assert_array_equal(_bits(back["s"]), _bits(qtree["layers"]["attn"]["wq"]["s"]))


def test_quantized_forward_logits_match_jax(jax_dense):
    """One forward of a 24-token chunk over the paged pool with int8
    weights: the port's logits within 1e-4 of JAX's (f32)."""
    from bee2bee_tpu.models import core as jc

    qtree = jquant.quantize_params(jax_dense)
    ids = np.random.default_rng(5).integers(3, 500, (2, 24)).astype(np.int32)
    BS, MB = 16, 2
    tables = np.arange(1, 2 * MB + 1, dtype=np.int32).reshape(2, MB)
    jpool = jc.init_paged_pool(CFG, 2 * MB + 1, BS, dtype=jnp.float32)
    jlogits, _ = jc.forward(jax.tree.map(jnp.asarray, qtree), CFG, jnp.asarray(ids),
                            jpool, jnp.int32(0), block_tables=jnp.asarray(tables))
    params = params_from_numpy(qtree, CFG, "cpu", torch.float32)
    pool = core.init_paged_pool(CFG, 2 * MB + 1, BS, torch.float32, "cpu")
    logits, _ = core.forward(params, CFG, torch.from_numpy(ids).long(), pool, 0,
                             torch.from_numpy(tables))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def jax_int8_tokens(jax_dense):
    """The JAX int8-weight engine's greedy tokens on PROMPTS."""
    eng = JaxEngine("tiny-llama", params=jax_dense, engine_config=JaxEngineConfig(
        quantize="int8", kv_block_size=16, **KW))
    try:
        yield [eng.generate(p, max_new_tokens=20, temperature=0.0).token_ids
               for p in PROMPTS]
    finally:
        eng.close()


@pytest.mark.parametrize("where", ["port_quantizes", "jax_quantized"])
def test_int8_engine_greedy_tokens_equal_jax(jax_dense, jax_int8_tokens, where):
    """The port's quantize="int8" engine on the JAX weights (quantized by
    the port, or carried across already quantized) decodes JAX's greedy
    tokens; its ledger counts the int8 bytes and the f32 scales."""
    tree = jax_dense if where == "port_quantizes" else jquant.quantize_params(jax_dense)
    params = params_from_numpy(tree, CFG, "cpu", torch.float32)
    eng = InferenceEngine("tiny-llama", params=params, device="cpu",
                          engine_config=EngineConfig(quantize="int8", **KW))
    try:
        got = [eng.generate(p, max_new_tokens=20, temperature=0.0).token_ids
               for p in PROMPTS]
        assert got == jax_int8_tokens
        wq = eng.params["layers"][0]["attn"]["wq"]
        assert set(wq) == {"q", "s"}
        # the caller's tree was not rewritten
        assert torch.is_tensor(params["layers"][0]["attn"]["wq"]) or "q" in \
            params["layers"][0]["attn"]["wq"]
        D, F, L, V = CFG.d_model, CFG.d_ff, CFG.n_layers, CFG.vocab_size
        qkv_o = D * CFG.n_heads * CFG.head_dim * 2 + 2 * D * CFG.n_kv_heads * CFG.head_dim
        int8_bytes = L * (qkv_o + 3 * D * F)
        scale_bytes = 4 * L * (D + 2 * CFG.n_kv_heads * CFG.head_dim + D + 2 * F + D)
        dense_bytes = 4 * (V * D * (1 if CFG.tie_embeddings else 2) + D + 2 * L * D)
        ledger = eng.introspect.ledger.snapshot()["components"]["weights"]
        assert ledger == int8_bytes + scale_bytes + dense_bytes
    finally:
        eng.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ledger_counts_the_dequantize_scratch_in_the_engine_dtype(dtype):
    """An int8-weight engine's HBM ledger holds the dequantize route's
    peak scratch at its widest projection (w_up, w_gate, w_down: d_model x
    d_ff), the weight's copy in the engine's dtype: on the CPU (the plain
    version converts on every product) 4 bytes a weight in f32 and 2 in
    bf16. On the card only f32 engines keep it (their chunks wider than 64
    tokens take the dequantize route); a bf16 engine's prefill runs a
    kernel, so it holds none. A dense engine has no such component."""
    item = {"float32": 4, "bfloat16": 2}[dtype]
    kw = dict(KW, dtype=dtype)
    eng = InferenceEngine("tiny-llama", device="cpu",
                          engine_config=EngineConfig(quantize="int8", **kw))
    dense = InferenceEngine("tiny-llama", device="cpu", engine_config=EngineConfig(**kw))
    try:
        comps = eng.introspect.ledger.snapshot()["components"]
        assert comps["int8_dequant_scratch"] == CFG.d_model * CFG.d_ff * item
        assert comps["int8_dequant_scratch"] == quant.dequant_scratch_bytes(
            eng.params, getattr(torch, dtype), "cpu")
        on_card = quant.dequant_scratch_bytes(eng.params, getattr(torch, dtype), "cuda")
        assert on_card == (CFG.d_model * CFG.d_ff * 4 if dtype == "float32" else 0)
        assert "int8_dequant_scratch" not in dense.introspect.ledger.snapshot()["components"]
    finally:
        eng.close()
        dense.close()


def test_lora_path_merged_before_quantization(jax_dense, tmp_path):
    """``lora_path`` with ``quantize="int8"``: both packages merge the
    adapter into the dense weights first, then quantize: the same greedy
    tokens, and int8 weights within one quantization step of JAX's (the
    merges sum in other orders, so a value on a rounding edge may fall the
    other way)."""
    rng = np.random.default_rng(9)
    lcfg = LoraConfig(rank=4, alpha=8.0, targets=("wq", "wv", "w_down"))
    io = {"wq": (64, 64), "wv": (64, 32), "w_down": (128, 64)}
    adapters = {t: {"a": rng.standard_normal((CFG.n_layers, i, 4)).astype(np.float32) * 0.1,
                    "b": rng.standard_normal((CFG.n_layers, 4, o)).astype(np.float32) * 0.1}
                for t, (i, o) in io.items()}
    path = tmp_path / "lora.npz"
    save_adapters(path, adapters, lcfg)
    jeng = JaxEngine("tiny-llama", params=jax_dense, lora_path=str(path),
                     engine_config=JaxEngineConfig(quantize="int8", kv_block_size=16, **KW))
    eng = InferenceEngine("tiny-llama", params=params_from_numpy(jax_dense, CFG, "cpu",
                                                                 torch.float32),
                          device="cpu", lora_path=str(path),
                          engine_config=EngineConfig(quantize="int8", **KW))
    base = InferenceEngine("tiny-llama", params=params_from_numpy(jax_dense, CFG, "cpu",
                                                                  torch.float32),
                           device="cpu", engine_config=EngineConfig(quantize="int8", **KW))
    try:
        for p in PROMPTS:
            want = jeng.generate(p, max_new_tokens=16, temperature=0.0).token_ids
            assert eng.generate(p, max_new_tokens=16, temperature=0.0).token_ids == want
        got_q = eng.params["layers"][0]["mlp"]["w_down"]["q"]
        want_q = jquant.quantize_params(
            {"layers": {"mlp": {"w_down": _layer(jax_dense, 0)["mlp"]["w_down"]
                                + lcfg.scaling * adapters["w_down"]["a"][0]
                                @ adapters["w_down"]["b"][0]}}})["layers"]["mlp"]["w_down"]["q"]
        assert np.abs(got_q.numpy().astype(int) - want_q.astype(int)).max() <= 1
        base_q = base.params["layers"][0]["mlp"]["w_down"]["q"]
        assert not torch.equal(got_q, base_q)  # the merge reached the int8 weights
    finally:
        jeng.close()
        eng.close()
        base.close()


def test_lora_path_on_a_random_int8_engine(tmp_path):
    """``lora_path`` with ``quantize="int8"`` and no weights given: the
    random tree is drawn dense, the adapter merged into it, then quantized
    (JAX's order; an int8 tree would refuse the merge). The engine builds,
    and its greedy tokens equal a JAX int8 engine's given the port's dense
    draw (the same seed, no adapter) and the same adapter."""
    rng = np.random.default_rng(10)
    lcfg = LoraConfig(rank=4, alpha=8.0, targets=("wq", "wv", "w_down"))
    io = {"wq": (64, 64), "wv": (64, 32), "w_down": (128, 64)}
    adapters = {t: {"a": rng.standard_normal((CFG.n_layers, i, 4)).astype(np.float32) * 0.1,
                    "b": rng.standard_normal((CFG.n_layers, 4, o)).astype(np.float32) * 0.1}
                for t, (i, o) in io.items()}
    path = tmp_path / "lora.npz"
    save_adapters(path, adapters, lcfg)
    eng = InferenceEngine("tiny-llama", device="cpu", lora_path=str(path),
                          engine_config=EngineConfig(quantize="int8", **KW))
    dense = InferenceEngine("tiny-llama", device="cpu", engine_config=EngineConfig(**KW))
    jeng = JaxEngine("tiny-llama", params=params_to_numpy(dense.params), lora_path=str(path),
                     engine_config=JaxEngineConfig(quantize="int8", kv_block_size=16, **KW))
    try:
        assert quant.is_quantized(eng.params["layers"][0]["mlp"]["w_down"])
        for p in PROMPTS:
            want = jeng.generate(p, max_new_tokens=16, temperature=0.0).token_ids
            assert eng.generate(p, max_new_tokens=16, temperature=0.0).token_ids == want
    finally:
        jeng.close()
        eng.close()
        dense.close()


# the name is historical: the test held the refusal the GEMM's f32 form lifted
def test_card_refuses_int8_weights_beside_f32_by_item():
    """Since queue A item 18 the card takes int8 weights beside f32
    activations too (the GEMM's 2xTF32 form); int4 is still refused."""
    llama = get_config("llama-3-8b")
    check_card_supported(llama, EngineConfig(quantize="int8"), "cuda")
    check_card_supported(llama, EngineConfig(quantize="int8", cache_dtype="int8"), "cuda")
    for cache in ("float32", "int8"):
        ecfg = EngineConfig(quantize="int8", dtype="float32", cache_dtype=cache)
        check_card_supported(llama, ecfg, "cuda")
        check_card_supported(llama, ecfg, "cpu")
    assert int8_gemm.int8_gemm_route(40, torch.float32) == "decode"
    assert int8_gemm.int8_gemm_route(65, torch.float32) == "dequant"
    with pytest.raises(TypeError, match="bfloat16 and float32"):
        int8_gemm.int8_gemm_route(8, torch.float16)
    with pytest.raises(ValueError, match="only 'int8' or 'none'"):
        EngineConfig(quantize="int4")
