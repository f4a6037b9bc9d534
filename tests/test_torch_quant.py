"""Weight-only int8 of the port (ops/quant, K8a/K8b plain versions) against
the JAX package, on the CPU.

Quantizers must match bit for bit; the int8 products match the JAX Pallas
kernels in interpret mode on dividing shapes (and the XLA path the JAX
dispatch falls back to on odd ones) within tests/test_quant.py's 2% of the
output's largest value; the int8 engine is exact on power-of-two grid
weights, as in tests/test_quant.py:97.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_colpali_tpu.generation.engine import GemmaDecodeEngine as JEngine
from multimodal_colpali_tpu.models.colpali import ColPaliModel as JColPali
from multimodal_colpali_tpu.models.configs import ColPaliModelConfig as JColPaliCfg
from multimodal_colpali_tpu.models.configs import Gemma3TextConfig as JG3
from multimodal_colpali_tpu.models.registry import fast_random_params, gemma3_random_params
from multimodal_colpali_tpu.ops import int8_matmul as JI
from multimodal_colpali_tpu.ops import quant as JQ
from multimodal_colpali_tpu_torch.generation.engine import GemmaDecodeEngine
from multimodal_colpali_tpu_torch.models.configs import ColPaliModelConfig, Gemma3TextConfig
from multimodal_colpali_tpu_torch.models.convert import engine_params_from_jax
from multimodal_colpali_tpu_torch.ops import int8_matmul as TI
from multimodal_colpali_tpu_torch.ops import quant as TQ

torch.set_num_threads(1)

PROMPTS = [[5, 9, 17, 3, 22, 41], [40, 2], list(range(3, 20)), [33]]


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("shape,axis", [((64, 24), 0), ((24, 64), 1), ((37, 5), 0),
                                        ((8, 33), 1)])
def test_quantize_int8_bit_exact(shape, axis):
    rng = np.random.default_rng(sum(shape) + axis)
    w = (rng.standard_normal(shape) * 0.07).astype(np.float32)
    w[0] = 0.0          # an all-zero slice keeps scale 1/127
    j = JQ.quantize_int8(jnp.asarray(w), axis=axis)
    t = TQ.quantize_int8(_t(w), axis=axis)
    np.testing.assert_array_equal(t["q8"].numpy(), np.asarray(j["q8"]))
    np.testing.assert_array_equal(_bits(t["scale"].numpy()), _bits(j["scale"]))


@pytest.mark.parametrize("rows", [70, 512, 600])
def test_quantize_embed_int8_bit_exact_and_padded(rows):
    w = np.random.default_rng(rows).standard_normal((rows, 8)).astype(np.float32)
    j = JQ.quantize_embed_int8(jnp.asarray(w))
    t = TQ.quantize_embed_int8(_t(w))
    assert t["q8"].shape[0] % TQ.EMBED_PAD == 0 and t["q8"].shape == j["q8"].shape
    np.testing.assert_array_equal(t["q8"].numpy(), np.asarray(j["q8"]))
    np.testing.assert_array_equal(_bits(t["scale"].numpy()), _bits(j["scale"]))
    assert not t["q8"][rows:].any() and bool((t["scale"][rows:] == 1.0).all())


def _mm_case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    codes = rng.integers(-127, 128, (k, n)).astype(np.int8)
    codes_t = rng.integers(-127, 128, (n, k)).astype(np.int8)
    scale = (np.abs(rng.standard_normal(n)) * 0.01).astype(np.float32)
    return x, codes, codes_t, scale


@pytest.mark.parametrize("m,k,n", [(1, 512, 1024), (4, 512, 1024), (16, 512, 1024),
                                   (3, 96, 80), (5, 40, 24)])
def test_int8_matmul_plain_matches_pallas_interpret(m, k, n):
    """K8a and K8b plain versions against the TPU kernels in interpret mode
    (dividing shapes) or the XLA path the JAX dispatch takes (odd ones), in
    bf16: within 2% of the output's largest value (tests/test_quant.py:195)."""
    x, codes, codes_t, scale = _mm_case(m, k, n, m * 7 + k + n)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = _t(x).to(torch.bfloat16)
    want = np.asarray(JI.int8_matmul_kn(xj, jnp.asarray(codes), jnp.asarray(scale),
                                        interpret=True), np.float32)
    got = TI.int8_matmul_kn(xt, _t(codes), _t(scale)).float().numpy()
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()
    want = np.asarray(JI.int8_matmul_nk(xj, jnp.asarray(codes_t), jnp.asarray(scale),
                                        out_dtype=jnp.float32, interpret=True))
    got = TI.int8_matmul_nk(xt, _t(codes_t), _t(scale), out_dtype=torch.float32).numpy()
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


def test_int8_matmul_split_count_covers_k():
    """Every split range is a whole number of K steps and none is empty, on
    cards small and large: K8a's tiles step 64 K rows at every M, K8b's 64
    for decode's M <= 16, else 32. K8a's decode tile fills one wave of two
    blocks an SM (at least 8 steps a split); its prefill tile splits only a
    grid of 128-token x 256-column blocks smaller than a wave, at most 4 ways."""
    for m, n, k in [(4, 4096, 5376), (8, 5376, 21504), (4, 21504, 5376), (1, 128, 40),
                    (512, 21504, 5376), (8, 262656, 5376), (3, 80, 96), (1504, 5376, 21504),
                    (512, 5376, 21504), (17, 300, 37)]:
        for sms in (1, 132, 1000):
            for nk in (False, True):
                splits = TI.split_count(m, n, k, sms, nk=nk)
                steps = -(-k // (64 if m <= 16 or not nk else 32))
                per = -(-steps // splits)
                assert 1 <= splits <= steps and (splits - 1) * per < steps
            if m <= 16:
                assert splits_kn(m, n, k, sms) == 1 or -(-k // 64) // splits_kn(m, n, k, sms) >= 8
            else:
                blocks = -(-m // 128) * -(-n // 256)
                assert splits_kn(m, n, k, sms) <= (1 if blocks >= sms else 4)
    assert splits_kn(8, 21504, 5376, 132) == 3       # gemma-3-27b up/gate: 84 column blocks
    assert splits_kn(8, 5376, 21504, 132) == 12      # down: 21 column blocks
    assert splits_kn(512, 21504, 5376, 132) == 1     # 336 prefill blocks: more than a wave
    assert splits_kn(512, 5376, 21504, 132) == 3     # 84 blocks: 3 splits fill 2 waves


def splits_kn(m, n, k, sms):
    return TI.split_count(m, n, k, sms)


@pytest.mark.parametrize("case", ["plain", "int8", "int8_bias"])
def test_q_dense_matches_jax(case):
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((32, 16)) * 0.1).astype(np.float32)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32) if case == "int8_bias" else None
    jk = JQ.quantize_int8(jnp.asarray(w), axis=0) if case != "plain" else jnp.asarray(w)
    tk = TQ.quantize_int8(_t(w), axis=0) if case != "plain" else _t(w)
    want = JQ.q_dense(jnp.asarray(x), jk, None if b is None else jnp.asarray(b))
    got = TQ.q_dense(_t(x), tk, None if b is None else _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantized", [False, True])
def test_q_take_and_q_logits_match_jax(quantized):
    rng = np.random.default_rng(12)
    table = rng.standard_normal((70, 16)).astype(np.float32)
    hidden = rng.standard_normal((3, 16)).astype(np.float32)
    ids = np.array([[0, 5, 69], [3, 3, 1]], np.int32)
    jt = JQ.quantize_embed_int8(jnp.asarray(table)) if quantized else jnp.asarray(table)
    tt = TQ.quantize_embed_int8(_t(table)) if quantized else _t(table)
    np.testing.assert_allclose(TQ.q_take(tt, _t(ids)).numpy(),
                               np.asarray(JQ.q_take(jt, jnp.asarray(ids))), rtol=0, atol=0)
    want = np.asarray(JQ.q_logits(jnp.asarray(hidden), jt, out_dim=70))
    got = TQ.q_logits(_t(hidden), tt, out_dim=70)
    assert got.shape == (3, 70)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bf16_table_logits_keep_float32_sums():
    """A bf16 tied head returns float32 logits equal to the float32 product
    of the bf16-rounded operands (quant.py:123-133), computed over vocab
    slices on the CPU."""
    rng = np.random.default_rng(5)
    table = _t(rng.standard_normal((640, 32)).astype(np.float32)).to(torch.bfloat16)
    hidden = _t(rng.standard_normal((4, 32)).astype(np.float32)).to(torch.bfloat16).float()
    got = TQ.q_logits(hidden, table)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, hidden @ table.float().T, rtol=0, atol=1e-5)


def _grid_params(params, seed: int):
    """Every quantizable leaf on the int8 x 2^-7 grid with one +-127 per
    channel, so ``quantize_int8`` recovers codes and scale exactly
    (tests/test_quant.py:60-93)."""
    rng = np.random.default_rng(seed)
    s = np.float32(2.0 ** -7)

    def grid(shape, channel_axis):
        codes = rng.integers(-127, 128, shape).astype(np.float32)
        if channel_axis == 0:
            codes[rng.integers(0, shape[0], shape[1]), np.arange(shape[1])] = 127.0
        else:
            codes[np.arange(shape[0]), rng.integers(0, shape[1], shape[0])] = 127.0
        return codes * s

    def walk(t):
        if isinstance(t, dict):
            return {k: (grid(np.asarray(v).shape, 0) if k == "kernel" and np.asarray(v).ndim == 2
                        else walk(v)) for k, v in t.items()}
        return np.asarray(t)

    return {"language_model": walk(params["language_model"]),
            "embed": {"embed_tokens": grid(np.asarray(params["embed"]["embed_tokens"]).shape,
                                           1)}}


def _tiny(arch):
    if arch == "gemma3":
        jcfg = JG3.tiny(vocab_size=64)
        return jcfg, Gemma3TextConfig.tiny(vocab_size=64), gemma3_random_params(jcfg, seed=0)
    ccfg = JColPaliCfg.tiny(vocab_size=64)
    params = jax.tree.map(np.asarray, fast_random_params(JColPali(ccfg), ccfg, seed=3))
    return ccfg.text, ColPaliModelConfig.tiny(vocab_size=64).text, params


@pytest.mark.parametrize("arch", ["gemma1", "gemma3"])
def test_int8_engine_exact_on_grid_weights(arch):
    """On grid weights the port's int8 engine has no quantization error: its
    logits equal the native engine's and the JAX int8 engine's to ~1 ulp,
    and greedy streams agree token for token."""
    jcfg, tcfg, base = _tiny(arch)
    params = _grid_params(base, seed=7)
    tparams = engine_params_from_jax(params, device="cpu")
    nat = GemmaDecodeEngine(tcfg, tparams, device="cpu")
    q = GemmaDecodeEngine(tcfg, tparams, weight_dtype="int8", device="cpu")
    jq = JEngine(jcfg, params, dtype=jnp.float32, weight_dtype="int8")
    qk = q.params["language_model"]["layers_0"]["self_attn"]["q_proj"]["kernel"]
    assert TQ.is_quantized(qk)
    np.testing.assert_array_equal(TQ.dequantize(qk).numpy(),
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


def test_int8_engine_matches_jax_on_random_weights():
    """Arbitrary scales: the port's and the JAX int8 engines quantize the
    same float32 weights into the same codes, so their logits agree to
    float32 sum order and greedy streams token for token."""
    jcfg, tcfg, params = _tiny("gemma3")
    jq = JEngine(jcfg, params, dtype=jnp.float32, weight_dtype="int8")
    q = GemmaDecodeEngine(tcfg, engine_params_from_jax(params, device="cpu"),
                          weight_dtype="int8", device="cpu")
    np.testing.assert_allclose(q.next_token_logits(PROMPTS, bucket=32),
                               np.asarray(jq.next_token_logits(PROMPTS, bucket=32)),
                               rtol=1e-5, atol=1e-5)
    assert q.generate(PROMPTS, max_new_tokens=8) == jq.generate(PROMPTS, max_new_tokens=8)


def test_pre_quantized_tree_shared_between_engines():
    """A tree quantized by one engine is detected by the next (no re-cast of
    the float32 scales) and shared, not copied."""
    _, tcfg, params = _tiny("gemma3")
    e1 = GemmaDecodeEngine(tcfg, engine_params_from_jax(params, device="cpu"),
                           dtype=torch.bfloat16, weight_dtype="int8", device="cpu")
    e2 = GemmaDecodeEngine(tcfg, e1.params, dtype=torch.bfloat16, device="cpu")
    assert e2.weight_dtype == "int8"
    t1, t2 = e1.params["embed"]["embed_tokens"], e2.params["embed"]["embed_tokens"]
    assert t2["q8"].data_ptr() == t1["q8"].data_ptr() and t2["scale"].dtype == torch.float32
    assert e2.generate(PROMPTS, max_new_tokens=6) == e1.generate(PROMPTS, max_new_tokens=6)
