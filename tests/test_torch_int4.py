"""Group-wise int4 weights of the port (ops/quant, K9's plain version, the
int4 engine) against the JAX package, on the CPU; mirrors tests/test_int4.py.

Quantizers must match bit for bit. K9's plain version matches the JAX Pallas
kernel in interpret mode within that test's rtol/atol 2e-5 (the same
dequantized weights, float32 sums in another order). The int4 engine is
exact on power-of-two grid weights (codes x 2^-3 with every group's column
saturated at 7), and its greedy streams equal the JAX int4 engine's.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_colpali_tpu.generation.engine import GemmaDecodeEngine as JEngine
from multimodal_colpali_tpu.models.configs import Gemma3TextConfig as JG3
from multimodal_colpali_tpu.models.registry import gemma3_random_params as j_random_params
from multimodal_colpali_tpu.models.registry import (
    gemma3_random_params_int8 as j_random_params_int8)
from multimodal_colpali_tpu.ops import int4_matmul as JI4
from multimodal_colpali_tpu.ops import quant as JQ
from multimodal_colpali_tpu_torch import serve
from multimodal_colpali_tpu_torch.generation.engine import GemmaDecodeEngine
from multimodal_colpali_tpu_torch.generation.paged import PagedContinuousBatcher
from multimodal_colpali_tpu_torch.generation.scheduler import ContinuousBatcher
from multimodal_colpali_tpu_torch.models import registry as TR
from multimodal_colpali_tpu_torch.models.configs import Gemma3TextConfig
from multimodal_colpali_tpu_torch.models.convert import engine_params_from_jax
from multimodal_colpali_tpu_torch.ops import int4_matmul as TI4
from multimodal_colpali_tpu_torch.ops import quant as TQ

torch.set_num_threads(1)

PROMPTS = [[5, 9, 17, 3, 22, 41], [40, 2], list(range(3, 20)), [33]]
JCFG, TCFG = JG3.tiny(vocab_size=64), Gemma3TextConfig.tiny(vocab_size=64)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    return np.asarray(a).view(np.int32)


def _same(t, j):
    """A tensor equal, element for element and in dtype, to a JAX array."""
    j = np.asarray(j)
    assert str(t.dtype).split(".")[-1] == j.dtype.name
    if t.dtype == torch.bfloat16:
        t, j = t.float(), j.astype(np.float32)
    np.testing.assert_array_equal(t.numpy(), j)


# -- the format -------------------------------------------------------------------

@pytest.mark.parametrize("k,n,group", [(64, 24, 16), (512, 96, 256), (512, 96, 64),
                                       (96, 40, 32), (8, 5, 2)])
def test_quantize_int4_bit_exact(k, n, group):
    w = (np.random.default_rng(k + n + group).standard_normal((k, n)) * 0.07).astype(np.float32)
    w[:group, 0] = 0.0          # an all-zero (group, column) keeps scale 1/7
    j = JQ.quantize_int4(jnp.asarray(w), group=group)
    t = TQ.quantize_int4(_t(w), group=group)
    assert t["q4"].dtype == torch.uint8 and t["q4"].shape == (k // 2, n)
    assert t["scale"].dtype == torch.float32 and t["scale"].shape == (k // group, n)
    np.testing.assert_array_equal(t["q4"].numpy(), np.asarray(j["q4"]))
    np.testing.assert_array_equal(_bits(t["scale"].numpy()), _bits(j["scale"]))
    assert TQ.int4_group(t) == JQ.int4_group(j) == group
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(TQ.dequantize_int4(t, dtype).float().numpy(),
                                      np.asarray(JQ.dequantize_int4(j, jdtype), np.float32))


def test_packing_is_split_per_group():
    """Byte row r of group g holds row g*G + r in its low nibble and row
    g*G + G/2 + r in its high one, each as code + 8 (quant.py:160-170)."""
    codes = np.arange(32, dtype=np.float32).reshape(32, 1) % 15 - 7    # -7..7
    codes[0] = codes[16] = 7.0                                          # scale 1 per group
    q = TQ.quantize_int4(_t(codes), group=16)
    packed = q["q4"].numpy()[:, 0].astype(int)
    for g in range(2):
        for r in range(8):
            assert packed[g * 8 + r] & 15 == codes[g * 16 + r, 0] + 8
            assert packed[g * 8 + r] >> 4 == codes[g * 16 + 8 + r, 0] + 8


def test_quantize_int4_roundtrip_error_bound_and_grid():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 24)).astype(np.float32) * 0.07
    q = TQ.quantize_int4(_t(w), group=16)
    d = TQ.dequantize_int4(q).numpy()
    bound = np.repeat(q["scale"].numpy(), 16, axis=0) / 2 + 1e-8
    assert (np.abs(w - d) <= bound).all()
    codes = rng.integers(-7, 8, (24, 12)).astype(np.float32)
    codes[::8] = 7.0
    grid = codes * np.float32(2.0 ** -3)
    q = TQ.quantize_int4(_t(grid), group=8)
    np.testing.assert_array_equal(TQ.dequantize_int4(q).numpy(), grid)
    np.testing.assert_array_equal(q["scale"].numpy(), np.full((3, 12), 2.0 ** -3, np.float32))
    with pytest.raises(ValueError, match="not divisible"):
        TQ.quantize_int4(_t(grid), group=16)


def test_int4_group_for_matches_jax():
    for k in (1, 2, 3, 6, 8, 16, 24, 48, 96, 100, 128, 5376, 21504, 4304, 7):
        for group in (256, 64, 16):
            assert TQ._int4_group_for(k, group) == JQ._int4_group_for(k, group), (k, group)


# -- K9's plain version and q_dense ---------------------------------------------------

@pytest.mark.parametrize("m", [1, 4, 16])
def test_int4_matmul_reference_matches_pallas_interpret(m):
    rng = np.random.default_rng(3)
    k, n, group = 512, 256, 256
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    q = JQ.quantize_int4(jnp.asarray(w), group=group)
    x = rng.standard_normal((m, k)).astype(np.float32)
    want = JI4.int4_matmul_kn(jnp.asarray(x), q["q4"], q["scale"], block_n=128, interpret=True)
    got = TI4.int4_matmul_kn(_t(x), _t(q["q4"]), _t(q["scale"]))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(JI4.int4_matmul_xla(
        jnp.asarray(x), q["q4"], q["scale"])), rtol=2e-5, atol=2e-5)


def test_int4_matmul_reference_dequantizes_to_x_dtype():
    """bf16 x: the weight is rounded to bf16 before the product, as
    int4_matmul_xla does."""
    rng = np.random.default_rng(4)
    q = TQ.quantize_int4(_t(rng.standard_normal((64, 32)).astype(np.float32)), group=16)
    x = _t(rng.standard_normal((3, 64)).astype(np.float32)).to(torch.bfloat16)
    got = TI4.int4_matmul_reference(x, q["q4"], q["scale"])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, x @ TQ.dequantize_int4(q, torch.bfloat16))
    assert TI4.int4_matmul_kn(x, q["q4"], q["scale"], out_dtype=torch.float32).dtype == \
        torch.float32


@pytest.mark.parametrize("m,n,k,sms,want", [
    (8, 21504, 5376, 132, 3),     # gemma-3-27b up/gate: 84 column blocks, one wave of 264
    (8, 5376, 21504, 132, 12),    # down: 21 column blocks
    (16, 5376, 21504, 132, 12),   # M = 9-16: the same decode tile, two B tiles
    (1, 1024, 5376, 132, 5),      # few columns: at least 8 steps a split
    (4, 80, 96, 132, 1),          # one step only
    (8, 262656, 5376, 132, 1),    # more column blocks than a wave
])
def test_int4_split_count_plans_the_decode_tile(m, n, k, sms, want):
    """The decode tile (M <= 16) splits K to fill one wave of two blocks an SM,
    each split a whole number of 64-row steps and at least 8 of them, so its
    float32 partial stays at most 1/16 of the codes' bytes."""
    splits = TI4.split_count(m, n, k, sms)
    assert splits == want
    steps = -(-(k // 2) // 64)
    per = -(-steps // splits)
    assert 1 <= splits <= steps and (splits - 1) * per < steps
    assert splits == 1 or per >= 8
    partial, codes = splits * m * n * 4, k // 2 * n
    assert splits == 1 or partial <= codes / 16 * (m / 8)


@pytest.mark.parametrize("m,n,k,want", [
    (17, 300, 128, 1),            # one stage of 32 byte rows: nothing to split
    (512, 21504, 5376, 1),        # 4 x 84 blocks of 128 tokens x 256 columns: over a wave
    (2048, 5376, 21504, 1),
    (512, 5376, 21504, 3),        # 84 blocks: 3 splits make 2 full waves
    (300, 5376, 21504, 2),        # 63 blocks: 2 splits make one wave
])
def test_int4_split_count_plans_the_prefill_tile(m, n, k, want):
    """The prefill tile (K8a's too) splits K only where its grid of
    128-token x 256-column blocks is smaller than a wave: at most 4 ways, at
    least 4 stages of 32 byte rows a split, each split whole stages."""
    assert TI4.split_count(m, n, k, 132) == want
    for sms in (1, 132, 1000):
        splits = TI4.split_count(m, n, k, sms)
        steps = -(-(k // 2) // 32)
        per = -(-steps // splits)
        assert 1 <= splits <= min(steps, 4) and (splits - 1) * per < steps
        assert splits == 1 or per >= 4
        assert splits == 1 or -(-m // 128) * -(-n // 256) < sms
    assert TI4.gathers(m, 16) and TI4.gathers(m, 2) and not TI4.gathers(m, 64)
    assert not TI4.gathers(m, 256) and not TI4.gathers(8, 16)


def test_q_dense_dispatches_int4_like_jax():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((32, 16)).astype(np.float32) * 0.1
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    jq = JQ.quantize_int4(jnp.asarray(w), group=16)
    tq = TQ.quantize_int4(_t(w), group=16)
    assert TQ.is_quantized_int4(tq) and not TQ.is_quantized(tq)
    got = TQ.q_dense(_t(x), tq, _t(b))
    assert got.shape == (2, 3, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(JQ.q_dense(jnp.asarray(x), jq,
                                                                  jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)


def test_quantize_lm_params_int4_matches_jax():
    params = j_random_params(JCFG, seed=0)
    # eager: under jit XLA may turn the division by 127 or 7 into a product
    # with the reciprocal, one ulp off a true division for some scales
    j = JQ.quantize_lm_params_int4(params)
    t = TQ.quantize_lm_params_int4(engine_params_from_jax(params, device="cpu"))
    assert TQ.is_quantized(t["embed"]["embed_tokens"])          # the table stays int8
    jl, tl = dict(TR.tree_leaves(j)), dict(TR.tree_leaves(t))
    assert jl.keys() == tl.keys()
    for key in jl:
        _same(tl[key], jl[key])
    qk = t["language_model"]["layers_0"]["self_attn"]["q_proj"]["kernel"]
    assert TQ.is_quantized_int4(qk) and TQ.int4_group(qk) == 16      # hidden 16 -> group 16
    # a kernel whose K admits no even group stays int8
    odd = TQ.quantize_lm_params_int4({"embed": t["embed"],
                                      "language_model": {"kernel": torch.ones(7, 4)}})
    assert TQ.is_quantized(odd["language_model"]["kernel"])


# -- the engine ------------------------------------------------------------------------

def _grid_params_int4(params, seed: int):
    """Kernels on the int4 x 2^-3 grid with saturated groups, the embed table
    on the int8 x 2^-7 grid (tests/test_int4.py:100-130)."""
    rng = np.random.default_rng(seed)

    def kernel_grid(shape):
        g = JQ._int4_group_for(shape[0], 256)
        codes = rng.integers(-7, 8, shape).astype(np.float32)
        codes[::g, :] = 7.0
        return codes * np.float32(2.0 ** -3)

    def walk(t):
        if isinstance(t, dict):
            return {k: (kernel_grid(np.asarray(v).shape)
                        if k == "kernel" and np.asarray(v).ndim == 2 else walk(v))
                    for k, v in t.items()}
        return np.asarray(t)

    shape = np.asarray(params["embed"]["embed_tokens"]).shape
    codes = rng.integers(-127, 128, shape).astype(np.float32)
    codes[np.arange(shape[0]), rng.integers(0, shape[1], shape[0])] = 127.0
    return {"language_model": walk(params["language_model"]),
            "embed": {"embed_tokens": codes * np.float32(2.0 ** -7)}}


def test_int4_engine_exact_on_grid_weights():
    params = _grid_params_int4(j_random_params(JCFG, seed=0), seed=7)
    tparams = engine_params_from_jax(params, device="cpu")
    nat = GemmaDecodeEngine(TCFG, tparams, device="cpu")
    q = GemmaDecodeEngine(TCFG, tparams, weight_dtype="int4", device="cpu")
    jq = JEngine(JCFG, params, dtype=jnp.float32, weight_dtype="int4")
    assert q.weight_dtype == "int4"
    qk = q.params["language_model"]["layers_0"]["self_attn"]["q_proj"]["kernel"]
    assert TQ.is_quantized_int4(qk)
    np.testing.assert_array_equal(TQ.dequantize_int4(qk).numpy(),
                                  params["language_model"]["layers_0"]["self_attn"]["q_proj"]
                                  ["kernel"])
    ln = nat.next_token_logits(PROMPTS, bucket=32)
    lq = q.next_token_logits(PROMPTS, bucket=32)
    np.testing.assert_allclose(ln, lq, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lq, np.asarray(jq.next_token_logits(PROMPTS, bucket=32)),
                               rtol=0, atol=1e-5)
    gq = q.generate(PROMPTS, max_new_tokens=10)
    assert gq == nat.generate(PROMPTS, max_new_tokens=10)
    assert gq == jq.generate(PROMPTS, max_new_tokens=10)


@pytest.mark.parametrize("seed", [1, 2])
def test_int4_engine_matches_jax_on_random_weights(seed):
    """Arbitrary weights: both engines quantize the same float32 tree into the
    same bytes, so their logits agree to float32 sum order and greedy streams
    token for token."""
    params = j_random_params(JCFG, seed=seed)
    jq = JEngine(JCFG, params, dtype=jnp.float32, weight_dtype="int4")
    q = GemmaDecodeEngine(TCFG, engine_params_from_jax(params, device="cpu"),
                          weight_dtype="int4", device="cpu")
    np.testing.assert_allclose(q.next_token_logits(PROMPTS, bucket=32),
                               np.asarray(jq.next_token_logits(PROMPTS, bucket=32)),
                               rtol=1e-5, atol=1e-5)
    assert q.generate(PROMPTS, max_new_tokens=8) == jq.generate(PROMPTS, max_new_tokens=8)


def test_batchers_equal_generate_with_int4_weights():
    eng = GemmaDecodeEngine(TCFG, engine_params_from_jax(j_random_params(JCFG, seed=2),
                                                         device="cpu"),
                            weight_dtype="int4", device="cpu")
    want = [eng.generate([p], max_new_tokens=7)[0] for p in PROMPTS]
    dense = ContinuousBatcher(eng, batch_slots=2, max_seq_len=64, chunk=3)
    assert dense.generate(PROMPTS, max_new_tokens=7) == want
    paged = PagedContinuousBatcher(eng, batch_slots=2, max_seq_len=64, chunk=3, page_size=8)
    assert paged.generate(PROMPTS, max_new_tokens=7) == want


def test_random_int4_tree_is_detected_and_matches_jax_layout():
    """gemma3_random_params_int8(fmt="int4") builds the tree the engine's own
    quantization builds, in the layout of the JAX package's random int4 tree,
    and the engine detects it as pre-quantized int4."""
    pre = TR.gemma3_random_params_int8(TCFG, seed=0, device="cpu", fmt="int4")
    jpre = j_random_params_int8(JCFG, seed=0, fmt="int4")
    tl, jl = dict(TR.tree_leaves(pre)), dict(TR.tree_leaves(jpre))
    assert tl.keys() == jl.keys()
    for key in tl:
        assert tuple(tl[key].shape) == tuple(jl[key].shape), key
        assert str(tl[key].dtype).split(".")[-1] == str(jl[key].dtype), key
    eng = GemmaDecodeEngine(TCFG, pre, dtype=torch.bfloat16, device="cpu")
    assert eng.weight_dtype == "int4"
    assert eng.params["language_model"]["layers_0"]["mlp"]["down_proj"]["kernel"]["scale"].dtype \
        == torch.float32
    out = eng.generate(PROMPTS[:2], max_new_tokens=6)
    assert all(len(t) == 6 for t in out)
    with pytest.raises(ValueError, match="fmt"):
        TR.gemma3_random_params_int8(TCFG, device="cpu", fmt="int2")


def test_load_gemma3_lm_int4():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg, params, _ = TR.load_gemma3_lm("tiny-gemma3", device="cpu", dtype=torch.float32,
                                           weight_dtype="int4")
    assert TQ.is_quantized_int4(params["language_model"]["layers_1"]["mlp"]["up_proj"]["kernel"])
    assert TQ.is_quantized(params["embed"]["embed_tokens"])
    with pytest.raises(ValueError, match="weight_dtype"):
        TR.load_gemma3_lm("tiny-gemma3", device="cpu", weight_dtype="int3")


def test_engine_params_from_jax_carries_an_int4_tree():
    """uint8 codes and float32 scales cross unchanged, even with a bf16 dtype."""
    jtree = jax.jit(JQ.quantize_lm_params_int4)(j_random_params(JCFG, seed=0))
    t = engine_params_from_jax(jtree, device="cpu", dtype=torch.bfloat16)
    qk = t["language_model"]["layers_2"]["self_attn"]["o_proj"]["kernel"]
    jk = jtree["language_model"]["layers_2"]["self_attn"]["o_proj"]["kernel"]
    assert qk["q4"].dtype == torch.uint8 and qk["scale"].dtype == torch.float32
    np.testing.assert_array_equal(qk["q4"].numpy(), np.asarray(jk["q4"]))
    np.testing.assert_array_equal(_bits(qk["scale"].numpy()), _bits(jk["scale"]))
    norm = t["language_model"]["layers_2"]["input_layernorm"]["weight"]
    assert norm.dtype == torch.bfloat16
    eng = GemmaDecodeEngine(TCFG, t, dtype=torch.bfloat16, device="cpu")
    assert eng.weight_dtype == "int4"


def test_int4_with_a_mesh_raises():
    """JAX's refusal (engine.py:387-393): group packing does not split."""
    params = TR.gemma3_random_params(TCFG, seed=0, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="int4.*TP meshes"):
        GemmaDecodeEngine(TCFG, params, device="cpu", weight_dtype="int4", mesh=object())


@pytest.mark.parametrize("model", ["tiny-gemma3", "tiny-colpali"])
def test_serve_cli_builds_an_int4_engine(model):
    args = serve.parse_args(["--model", model, "--device", "cpu", "--dtype", "float32",
                             "--paged", "--weight-dtype", "int4"])
    eng, tok, _, _ = serve.build(args)
    assert eng.device.type == "cpu" and eng.weight_dtype == "int4"
    kernels = [v for path, v in TR.tree_leaves(eng.params["language_model"])
               if path[-1] == "q4"]
    assert kernels and all(v.dtype == torch.uint8 for v in kernels)
    out = eng.generate([tok.encode("hello")], max_new_tokens=3)
    assert len(out[0]) == 3
