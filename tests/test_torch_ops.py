"""The port's retrieval operators against the JAX package, on the CPU.

The same numpy inputs (from a seed) go through each JAX function and its
counterpart in ``multimodal_colpali_tpu_torch``; where the JAX function
reaches a Pallas kernel it runs in interpret mode, as the JAX package's
own tests run it. On a CPU tensor each port wrapper takes its plain
PyTorch version; the kernels themselves are checked on the card by
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_colpali_tpu.models import layers as JL
from multimodal_colpali_tpu.ops import attention as JA
from multimodal_colpali_tpu.ops import maxsim as JM
from multimodal_colpali_tpu.ops import preprocess as JP
from multimodal_colpali_tpu.ops import topk as JT
from multimodal_colpali_tpu_torch.models import layers as TL
from multimodal_colpali_tpu_torch.ops import attention as TA
from multimodal_colpali_tpu_torch.ops import maxsim as TM
from multimodal_colpali_tpu_torch.ops import preprocess as TP
from multimodal_colpali_tpu_torch.ops import topk as TT

torch.set_num_threads(1)

# fp32 on both sides; sums are taken in another order
RTOL, ATOL = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


# -- MaxSim -----------------------------------------------------------------

def _maxsim_case(name):
    rng = np.random.default_rng(MAXSIM_CASES.index(name))
    shapes = {"random": (2, 5, 7, 12, 128), "b1": (1, 4, 6, 9, 128),
              "odd_p": (3, 6, 9, 16, 8), "empty_pages": (2, 5, 8, 10, 16),
              "tied": (2, 3, 6, 5, 8)}
    b, nq, p, nt, dim = shapes[name]
    q = rng.standard_normal((b, nq, dim), dtype=np.float32)
    d = rng.standard_normal((p, nt, dim), dtype=np.float32)
    q_lens = rng.integers(1, nq + 1, size=b).astype(np.int32)
    d_lens = rng.integers(1, nt + 1, size=p).astype(np.int32)
    if name == "empty_pages":
        d_lens[[0, 3, 7]] = 0
    if name == "tied":  # duplicate pages and small integer values tie exactly
        q = rng.integers(-2, 3, size=q.shape).astype(np.float32)
        d = rng.integers(-2, 3, size=d.shape).astype(np.float32)
        d[3], d[5] = d[1], d[0]
        d_lens[3], d_lens[5] = d_lens[1], d_lens[0]
    return q, d, q_lens, d_lens


MAXSIM_CASES = ["random", "b1", "odd_p", "empty_pages", "tied"]


@pytest.mark.parametrize("case", MAXSIM_CASES)
def test_maxsim_matches_jax_reference(case):
    q, d, q_lens, d_lens = _maxsim_case(case)
    want = np.asarray(JM.maxsim_scores_reference(_j(q), _j(d), _j(q_lens), _j(d_lens)))
    got = TM.maxsim_scores(_t(q), _t(d), _t(q_lens), _t(d_lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["random", "odd_p", "empty_pages"])
def test_maxsim_matches_pallas_interpret(case):
    q, d, q_lens, d_lens = _maxsim_case(case)
    want = np.asarray(JM.maxsim_scores_pallas(_j(q), _j(d), _j(q_lens), _j(d_lens),
                                              block_pages=4, interpret=True))
    got = TM.maxsim_scores(_t(q), _t(d), _t(q_lens), _t(d_lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_maxsim_without_lengths_matches_jax():
    q, d, _, _ = _maxsim_case("random")
    want = np.asarray(JM.maxsim_scores_reference(_j(q), _j(d)))
    np.testing.assert_allclose(TM.maxsim_scores(_t(q), _t(d)).numpy(), want,
                               rtol=RTOL, atol=ATOL)


def test_maxsim_bf16_corpus_matches_jax():
    q, d, q_lens, d_lens = _maxsim_case("random")
    qb, db = _j(q).astype(jnp.bfloat16), _j(d).astype(jnp.bfloat16)
    want = np.asarray(JM.maxsim_scores_reference(qb, db, _j(q_lens), _j(d_lens)))
    got = TM.maxsim_scores(_t(q).to(torch.bfloat16), _t(d).to(torch.bfloat16),
                           _t(q_lens), _t(d_lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_maxsim_empty_page_is_finite_mask_sum():
    q, d, q_lens, d_lens = _maxsim_case("empty_pages")
    got = TM.maxsim_scores(_t(q), _t(d), _t(q_lens), _t(d_lens)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, 0], -q_lens.astype(np.float64) * 1e30, rtol=1e-6)
    assert (got[:, [0, 3, 7]].max() < got[:, [1, 2, 4, 5, 6]].min())
    assert TM.MASK_VALUE == JM.MASK_VALUE


@pytest.mark.parametrize("case", MAXSIM_CASES)
def test_maxsim_top_ids_bit_equal_to_jax(case):
    q, d, q_lens, d_lens = _maxsim_case(case)
    j_scores = JM.maxsim_scores_reference(_j(q), _j(d), _j(q_lens), _j(d_lens))
    k = min(5, d.shape[0])
    _, want = JT.topk_with_stable_ties(j_scores, k)
    _, got = TT.topk_with_stable_ties(TM.maxsim_scores(_t(q), _t(d), _t(q_lens), _t(d_lens)), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_maxsim_rejects_unknown_device():
    q = torch.zeros((1, 2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TM.maxsim_scores(q, torch.zeros((3, 4, 8), device="meta"))


# -- stable top-k -------------------------------------------------------------

@pytest.mark.parametrize("shape,k,levels", [
    ((40,), 7, 3), ((3, 25), 25, 2), ((2, 4, 16), 5, 4), ((1, 9), 1, 1), ((5, 100), 10, 6)])
def test_topk_ties_bit_equal_to_jax(shape, k, levels):
    rng = np.random.default_rng(sum(shape) * 31 + k)
    scores = rng.integers(0, levels, size=shape).astype(np.float32) * 0.5 - 1.0
    jv, ji = JT.topk_with_stable_ties(_j(scores), k)
    tv, ti = TT.topk_with_stable_ties(_t(scores), k)
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# -- preprocess ----------------------------------------------------------------

def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.view(torch.int16).int() - b.view(torch.int16).int()).abs().max())


@pytest.mark.parametrize("mean,std", [((0.5,) * 3, (0.5,) * 3),
                                      ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))])
@pytest.mark.parametrize("shape", [(2, 28, 28, 3), (1, 5, 7, 3)])
def test_normalize_matches_jax_within_one_ulp(shape, mean, std):
    x = np.random.default_rng(3).integers(0, 256, size=shape, dtype=np.uint8)
    got = TP.normalize_images(_t(x), mean, std)
    assert got.dtype == torch.bfloat16 and got.shape == shape
    ref = np.array(JP.normalize_images_reference(_j(x), mean, std).astype(jnp.float32))
    assert _bf16_ulps(got, torch.from_numpy(ref).to(torch.bfloat16)) <= 1
    pallas = np.array(JP.normalize_images(_j(x), tuple(mean), tuple(std),
                                            interpret=True).astype(jnp.float32))
    assert _bf16_ulps(got, torch.from_numpy(pallas).to(torch.bfloat16)) <= 1


# -- attention -----------------------------------------------------------------

def _qkv(seed, b=2, s=24, h=2, d=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]


def _masks(kind, b, s, seed):
    rng = np.random.default_rng(seed + 100)
    lens = np.asarray([s, max(1, s // 3)], np.int32)[:b]
    valid = rng.integers(0, 2, size=(b, s)).astype(bool)
    valid[:, 0] = True
    return {
        "none": {}, "kv_lens": {"kv_lens": lens}, "kv_valid": {"kv_valid": valid},
        "causal": {"causal": True},
        "all": {"kv_lens": lens, "kv_valid": valid, "causal": True},
    }[kind]


ATTN_KINDS = ["none", "kv_lens", "kv_valid", "causal", "all"]


@pytest.mark.parametrize("kind", ATTN_KINDS)
@pytest.mark.parametrize("head_dim", [24, 32])
def test_attention_matches_jax_einsum(kind, head_dim):
    q, k, v = _qkv(7, d=head_dim)
    masks = _masks(kind, 2, 24, 7)
    jkw = {n: (_j(a) if isinstance(a, np.ndarray) else a) for n, a in masks.items()}
    tkw = {n: (_t(a) if isinstance(a, np.ndarray) else a) for n, a in masks.items()}
    want = np.asarray(JL.attention(_j(q), _j(k), _j(v), mask=None, scale=0.125, **jkw))
    got = TA.fused_attention(_t(q), _t(k), _t(v), scale=0.125, **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ATTN_KINDS)
def test_attention_matches_pallas_interpret(kind):
    q, k, v = _qkv(11, d=24)
    masks = _masks(kind, 2, 24, 11)
    want = np.asarray(JA.fused_attention(
        _j(q), _j(k), _j(v), _j(masks["kv_lens"]) if "kv_lens" in masks else None,
        _j(masks["kv_valid"]) if "kv_valid" in masks else None, scale=0.2,
        causal=masks.get("causal", False), block_q=8, interpret=True))
    tkw = {n: (_t(a) if isinstance(a, np.ndarray) else a) for n, a in masks.items()}
    got = TA.fused_attention(_t(q), _t(k), _t(v), scale=0.2, **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_attention_fully_masked_row_is_uniform():
    q, k, v = _qkv(5, b=1, s=10)
    lens = np.zeros((1,), np.int32)
    got = TA.fused_attention(_t(q), _t(k), _t(v), _t(lens), scale=0.3).numpy()
    want = np.asarray(JL.attention(_j(q), _j(k), _j(v), mask=None, scale=0.3,
                                   kv_lens=_j(lens)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[0, 3], v[0].mean(axis=0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("explicit_mask", [False, True])
def test_layers_attention_gqa_matches_jax(explicit_mask):
    q, k, v = _qkv(13, h=4, d=16)
    k1, v1 = k[:, :, :1], v[:, :, :1]
    mask = np.random.default_rng(1).integers(0, 2, size=(2, 1, 1, 24)).astype(bool)
    mask[..., 0] = True
    jm, tm = (_j(mask), _t(mask)) if explicit_mask else (None, None)
    want = np.asarray(JL.attention(_j(q), _j(k1), _j(v1), mask=jm, scale=0.1))
    got = TL.attention(_t(q), _t(k1), _t(v1), mask=tm, scale=0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_rope_and_norms_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 3, 8)).astype(np.float32)
    pos = np.cumsum(np.ones((2, 6), np.int32), axis=1)
    np.testing.assert_allclose(TL.rope(_t(x), _t(pos)).numpy(),
                               np.asarray(JL.rope(_j(x), _j(pos))), rtol=RTOL, atol=1e-5)
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    rms = TL.RMSNorm(16, device="cpu", dtype=torch.float32)
    rms.weight.data.copy_(_t(w))
    want = JL.RMSNorm().apply({"params": {"weight": _j(w)}}, _j(h))
    np.testing.assert_allclose(rms(_t(h)).numpy(), np.asarray(want), rtol=RTOL, atol=1e-5)
    ln = TL.LayerNorm(16, device="cpu", dtype=torch.float32)
    ln.weight.data.copy_(_t(w))
    ln.bias.data.copy_(_t(bias))
    want = JL.LayerNorm().apply({"params": {"weight": _j(w), "bias": _j(bias)}}, _j(h))
    np.testing.assert_allclose(ln(_t(h)).numpy(), np.asarray(want), rtol=RTOL, atol=1e-5)
