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


@pytest.mark.parametrize("dtype,s,d,rows", [
    (torch.bfloat16, 1024, 72, 128),   # ColPali's So400m: tensor cores, 128-row blocks
    (torch.bfloat16, 1024, 64, 128),   # ColSmol's SigLIP-768 inside K5a/K5b
    (torch.bfloat16, 40, 128, 64),     # short rows: 64-row blocks
    (torch.bfloat16, 511, 8, 64),
    (torch.bfloat16, 577, 20, 0),      # D not whole 16-byte chunks: CUDA cores
    (torch.bfloat16, 1024, 128, 64),   # D > 80: one 16-row tile a warp
    (torch.bfloat16, 64, 136, 0),      # past the widest head
    (torch.float32, 1024, 72, 0),      # float32: not this path (3xTF32, kernel_path)
])
def test_attention_block_rows_choose_the_path(dtype, s, d, rows):
    """K2's wrapper picks the bf16 tensor-core path (and its query block) or
    another path from dtype and shape alone, before any launch."""
    assert TA.block_rows(dtype, s, d) == rows


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


# -- int8 MaxSim (K4's plain version) and the quantizer -----------------------------

@pytest.mark.parametrize("case", ["random", "odd_p", "empty_pages", "tied"])
def test_maxsim_int8_matches_pallas_interpret(case):
    q, d, q_lens, d_lens = _maxsim_case(case)
    jc, js = JM.quantize_corpus_int8(_j(d))
    want = np.asarray(JM.maxsim_scores_int8_pallas(_j(q), jc, js, _j(q_lens), _j(d_lens),
                                                   block_pages=4, interpret=True))
    tc, ts = TM.quantize_corpus_int8(_t(d))
    got = TM.maxsim_scores_int8(_t(q), tc, ts, _t(q_lens), _t(d_lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    if case == "empty_pages":
        np.testing.assert_allclose(got[:, 0], -q_lens.astype(np.float64) * 1e30, rtol=1e-6)


def test_maxsim_int8_rounds_query_to_bf16():
    q, d, _, _ = _maxsim_case("random")
    tc, ts = TM.quantize_corpus_int8(_t(d))
    a = TM.maxsim_scores_int8(_t(q), tc, ts)
    b = TM.maxsim_scores_int8(_t(q).to(torch.bfloat16).float(), tc, ts)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_corpus_int8_bit_identical_to_jax(dtype):
    rng = np.random.default_rng(17)
    d = rng.standard_normal((9, 13, 32)).astype(np.float32) * 3
    d[2, 4] = 0.0                          # all-zero token: scale 1.0
    d[5, 1, :] = 0.5 * np.arange(32) / 31  # a token whose values round at .5
    jc, js = JM.quantize_corpus_int8(_j(d).astype(getattr(jnp, dtype)))
    tc, ts = TM.quantize_corpus_int8(_t(d).to(getattr(torch, dtype)))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[2, 4]) == 1.0


# -- two-stage search ------------------------------------------------------------------

def _two_stage_corpus(seed, tied=False, p=24, nt=11, dim=16):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((p, nt, dim)).astype(np.float32)
    lens = rng.integers(1, nt + 1, p).astype(np.int32)
    lens[[2, 9]] = 0
    if tied:
        # integer tokens, power-of-two lengths (exact means) and duplicate
        # pages tie exactly whatever order a sum is taken in
        d = rng.integers(-2, 3, size=d.shape).astype(np.float32)
        lens = rng.choice([1, 2, 4, 8], p).astype(np.int32)
        lens[[2, 9]] = 0
        d[:, 1] = d[:, 0]  # duplicate tokens inside a page
        for a, b in ((5, 1), (7, 3), (12, 3)):
            d[a], lens[a] = d[b], lens[b]
    q = rng.standard_normal((6, dim)).astype(np.float32)
    if tied:
        q = rng.integers(-1, 2, size=q.shape).astype(np.float32)
    return q, d, lens


TWO_STAGE_CASES = [("float32", False), ("bfloat16", False), ("float32", True)]


@pytest.mark.parametrize("dtype,tied", TWO_STAGE_CASES)
def test_pooling_matches_jax(dtype, tied):
    from multimodal_colpali_tpu.ops import two_stage as JS
    from multimodal_colpali_tpu_torch.ops import two_stage as TS

    _, d, lens = _two_stage_corpus(1, tied)
    jd, td = _j(d).astype(getattr(jnp, dtype)), _t(d).to(getattr(torch, dtype))
    want = np.asarray(JS.pool_corpus(jd, _j(lens)).astype(jnp.float32))
    got = TS.pool_corpus(td, _t(lens))
    assert got.dtype == td.dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6, atol=1e-6)
    assert not got[[2, 9]].any()
    for k in (1, 3, 5):
        want = np.asarray(JS.pool_corpus_fps(jd, _j(lens), k=k).astype(jnp.float32))
        got = TS.pool_corpus_fps(td, _t(lens), k=k)
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype,tied", TWO_STAGE_CASES)
@pytest.mark.parametrize("centroids", [1, 3])
@pytest.mark.parametrize("rescore_from", ["originals", "int8"])
def test_two_stage_topk_matches_jax(dtype, tied, centroids, rescore_from):
    from multimodal_colpali_tpu.ops import two_stage as JS
    from multimodal_colpali_tpu_torch.ops import two_stage as TS

    q, d, lens = _two_stage_corpus(2, tied)
    jd, td = _j(d).astype(getattr(jnp, dtype)), _t(d).to(getattr(torch, dtype))
    jp, jc, js = JS.build_two_stage_index(jd, _j(lens), n_centroids=centroids)
    tp, tc, ts = TS.build_two_stage_index(td, _t(lens), n_centroids=centroids)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    full = rescore_from == "originals"
    for q_len, n_cand, k in ((6, 10, 5), (4, 24, 24), (1, 3, 3)):
        jv, ji = JS.two_stage_maxsim_topk(_j(q), jnp.int32(q_len), jp, jc, js, _j(lens), k=k,
                                          n_candidates=n_cand, d_full=jd if full else None)
        tv, ti = TS.two_stage_maxsim_topk(_t(q), q_len, tp, tc, ts, _t(lens), k=k,
                                          n_candidates=n_cand, d_full=td if full else None)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype,tied", TWO_STAGE_CASES)
def test_coarse_topk_and_rescore_candidates_match_jax(dtype, tied):
    from multimodal_colpali_tpu.ops import two_stage as JS
    from multimodal_colpali_tpu_torch.ops import two_stage as TS

    q, d, lens = _two_stage_corpus(3, tied)
    jd, td = _j(d).astype(getattr(jnp, dtype)), _t(d).to(getattr(torch, dtype))
    jp, tp = JS.pool_corpus(jd, _j(lens)), TS.pool_corpus(td, _t(lens))
    for n_cand in (1, 8, 24):
        want = np.asarray(JS.coarse_topk(_j(q), jnp.int32(5), jp, _j(lens), n_candidates=n_cand))
        got = TS.coarse_topk(_t(q), 5, tp, _t(lens), n_candidates=n_cand)
        np.testing.assert_array_equal(got.numpy(), want)
        assert not {2, 9} & set(got.tolist()[:n_cand - 2])  # empty pages rank last
    cand = np.asarray([4, 2, 5, 1, 9, 0], np.int32)
    jv, jo = JS.rescore_candidates(_j(q), jnp.int32(6), jd[cand], _j(lens[cand]), k=6)
    tv, to = TS.rescore_candidates(_t(q), 6, td[cand], _t(lens[cand]), k=6)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-4)
    assert tv[-2:].max() < -1e29  # the two empty pages


# -- fused SigLIP layer (K5a-c plain versions) -------------------------------------------

def _layer_weights(seed, h=256, inter=512):
    """Flax-layout float32 weights, bf16-valued where the kernels round them."""
    rng = np.random.default_rng(seed)

    def w(i, o):
        return (rng.standard_normal((i, o)) * i ** -0.5).astype(np.float32)

    def v(n, base=0.0):
        return (base + 0.1 * rng.standard_normal(n)).astype(np.float32)

    p = dict(g1=v(h, 1.0), b1=v(h), wq=w(h, h), bq=v(h), wk=w(h, h), bk=v(h), wv=w(h, h),
             bv=v(h), wo=w(h, h), bo=v(h), g2=v(h, 1.0), b2=v(h), w1=w(h, inter), bb1=v(inter),
             w2=w(inter, h), bb2=v(h))
    for k in ("wq", "wk", "wv", "wo", "w1", "w2"):
        p[k] = np.asarray(jnp.asarray(p[k]).astype(jnp.bfloat16).astype(jnp.float32))
    return p


def _jax_args(p, keys):
    return [_j(p[k]) for k in keys]


def _port_args(p, keys):
    # torch layout: a dense weight is the transpose of the flax kernel
    return [_t(p[k].T.copy() if p[k].ndim == 2 else p[k]) for k in keys]


LAYER_KEYS = ("g1", "b1", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "g2", "b2",
              "w1", "bb1", "w2", "bb2")


@pytest.mark.parametrize("which", ["layer", "attn", "mlp"])
def test_fused_layer_plain_versions_match_pallas_interpret(which):
    from multimodal_colpali_tpu.ops import fused_layer as JF
    from multimodal_colpali_tpu_torch.ops import fused_layer as TF

    p = _layer_weights(5)
    x = np.random.default_rng(6).standard_normal((2, 256, 256)).astype(np.float32)
    xj, xt = _j(x).astype(jnp.bfloat16), _t(x).to(torch.bfloat16)
    if which == "layer":
        keys = LAYER_KEYS
        want = JF.fused_vit_layer(xj, *_jax_args(p, keys), heads=4, interpret=True)
        got = TF.fused_vit_layer(xt, *_port_args(p, keys), heads=4)
    elif which == "attn":
        keys = LAYER_KEYS[:10]
        want = JF.fused_vit_attention_block(xj, *_jax_args(p, keys), heads=4, interpret=True)
        got = TF.fused_vit_attention_block(xt, *_port_args(p, keys), heads=4)
    else:
        keys = LAYER_KEYS[10:]
        want = JF.fused_mlp_block(xj, *_jax_args(p, keys), interpret=True)
        got = TF.fused_mlp_block(xt, *_port_args(p, keys))
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    # tests/test_fused_layer.py's tolerance: bf16 intermediates round apart
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=3e-2, atol=3e-2)


def test_layer_plans_and_gate_follow_jax():
    from multimodal_colpali_tpu.ops import fused_layer as JF
    from multimodal_colpali_tpu_torch.ops import fused_layer as TF

    shapes = [(1024, 768, 3072, 12), (1024, 1152, 4304, 16), (256, 256, 512, 4),
              (16, 768, 3072, 12), (1024, 768, 3072, 10)]
    for s, h, inter, heads in shapes:
        for db in (2, 4):
            assert TF.layer_plan(s, h, inter, heads, db) == JF.layer_plan(s, h, inter, heads, db)
            assert TF.attention_block_plan(s, h, heads, db) == \
                JF.attention_block_plan(s, h, heads, db)
        assert TF.mlp_block_plan(h, inter) == JF.mlp_block_plan(h, inter)
    colsmol = torch.empty((2, 1024, 768), dtype=torch.bfloat16, device="meta")
    so400m = torch.empty((2, 1024, 1152), dtype=torch.bfloat16, device="meta")
    assert not TL._fused_layer_enabled(colsmol, 768, 3072, 12)  # auto: CUDA only
    TL.set_fused_layer(True)
    try:
        assert TL._fused_layer_enabled(colsmol, 768, 3072, 12)
        assert not TL._fused_layer_enabled(so400m, 1152, 4304, 16)
        assert not TL._fused_layer_enabled(colsmol[:, :16], 768, 3072, 12)
    finally:
        TL.set_fused_layer(None)
    TL.set_fused_layer(False)
    try:
        assert not TL._fused_layer_enabled(colsmol, 768, 3072, 12)
    finally:
        TL.set_fused_layer(None)
    with pytest.raises(ValueError):
        TL.set_fused_parts("qkv")


class _CudaLike:
    """The shape, dtype and device of a CUDA tensor, with no card needed."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype, self.device = shape, dtype, torch.device("cuda")

    def element_size(self):
        return torch.empty((), dtype=self.dtype).element_size()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_gate_admits_every_cuda_dtype_the_plan_admits(dtype):
    """On a CUDA tensor the auto gate asks only ``layer_plan`` (fed the
    element size), as the JAX gate asks only the plan on a TPU: a dtype the
    kernels do not take raises in them instead of running the unfused layer."""
    from multimodal_colpali_tpu.ops import fused_layer as JF

    for s, h, inter, heads in [(1024, 768, 3072, 12), (256, 256, 512, 4),
                               (1024, 1152, 4304, 16)]:
        x = _CudaLike((2, s, h), dtype)
        want = JF.layer_plan(s, h, inter, heads, x.element_size()) is not None
        assert TL._fused_layer_enabled(x, h, inter, heads) == want
    assert TL._fused_layer_enabled(_CudaLike((2, 256, 256), dtype), 256, 512, 4)
    assert not TL._fused_layer_enabled(_CudaLike((2, 1024, 1152), dtype), 1152, 4304, 16)


@pytest.mark.parametrize("parts", ["both", "attn", "mlp"])
def test_siglip_layer_fused_path_matches_unfused(parts):
    """``set_fused_layer(True)`` routes a SigLIP layer through the fused
    functions (their plain versions on the CPU); the result matches the
    unfused layer within the fused kernels' tolerance."""
    from multimodal_colpali_tpu_torch.models.configs import SiglipVisionConfig
    from multimodal_colpali_tpu_torch.models.siglip import SiglipEncoderLayer

    cfg = SiglipVisionConfig(hidden_size=256, intermediate_size=512, num_hidden_layers=1,
                             num_attention_heads=4, image_size=128, patch_size=8)
    layer = SiglipEncoderLayer(cfg, device="cpu", dtype=torch.bfloat16)
    p = _layer_weights(7)
    names = {"layer_norm1.weight": "g1", "layer_norm1.bias": "b1",
             "self_attn.q_proj.weight": "wq", "self_attn.q_proj.bias": "bq",
             "self_attn.k_proj.weight": "wk", "self_attn.k_proj.bias": "bk",
             "self_attn.v_proj.weight": "wv", "self_attn.v_proj.bias": "bv",
             "self_attn.out_proj.weight": "wo", "self_attn.out_proj.bias": "bo",
             "layer_norm2.weight": "g2", "layer_norm2.bias": "b2",
             "mlp.fc1.weight": "w1", "mlp.fc1.bias": "bb1", "mlp.fc2.weight": "w2",
             "mlp.fc2.bias": "bb2"}
    layer.load_state_dict({n: _port_args(p, (k,))[0] for n, k in names.items()})
    x = _t(np.random.default_rng(8).standard_normal((2, 256, 256)).astype(np.float32))
    x = x.to(torch.bfloat16)
    with torch.no_grad():
        want = layer(x)
        TL.set_fused_layer(True)
        TL.set_fused_parts(parts)
        try:
            got = layer(x)
        finally:
            TL.set_fused_layer(None)
            TL.set_fused_parts("both")
    assert not torch.equal(got, want)  # the fused functions really ran
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=3e-2, atol=3e-2)
