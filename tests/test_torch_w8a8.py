"""The port's W8A8 int8 encoders (``ops/quant``: ``quantize_act_int8``,
``w8a8_dense``, ``quantize_encoder_params``; ``load_retriever(quantize=
"int8")``; ``Gemma3MMEngine(vision_dtype="int8")``) against the JAX
package's, on the CPU at tiny size.

Codes and scales are compared with JAX's eager functions bit for bit (under
``jit`` XLA may divide by 127 as a product with the reciprocal, one ulp
away). Embeddings of an int8 retriever are held against JAX's int8 retriever
in float32 (per-token cosine >= 0.999; JAX quantizes under ``jit``) and
against the port's own bf16 forward (mean cosine >= 0.98, JAX's bound in
``tests/test_w8a8.py``).
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_colpali_tpu.generation.gemma3_mm import Gemma3MMEngine as JMM
from multimodal_colpali_tpu.models import registry as JR
from multimodal_colpali_tpu.ops import quant as JQ
from multimodal_colpali_tpu_torch.generation import Gemma3MMEngine, GemmaDecodeEngine
from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.models import load_retriever
from multimodal_colpali_tpu_torch.models.configs import SiglipVisionConfig
from multimodal_colpali_tpu_torch.models.convert import (
    flatten_flax, gemma3_mm_params_from_jax, torch_name)
from multimodal_colpali_tpu_torch.models.siglip import SiglipEncoderLayer, SiglipVisionTower
from multimodal_colpali_tpu_torch.ops import fused_layer as FL
from multimodal_colpali_tpu_torch.ops import quant as TQ

from tests.test_torch_gemma3_mm import _cfgs, _pixels

torch.set_num_threads(1)

FAMILIES = ["tiny-colpali", "tiny-colidefics3", "tiny-colflor", "tiny-colqwen2",
            "tiny-colgranite"]


def _jax_retriever(name, quantize=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JR.load_retriever(name, seed=0, dtype=jnp.float32, quantize=quantize)


def _port_retriever(name, flat, dtype, quantize=None):
    return load_retriever(name, device="cpu", dtype=dtype, params=flat, quantize=quantize)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(name, the JAX float32 retriever, its flat float32 tree)."""
    jr = _jax_retriever(request.param)
    flat = flatten_flax(jax.tree.map(np.asarray, jr.params))
    return request.param, jr, flat


def _pages(seed, n=3, size=(45, 37)):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8), "RGB")
            for _ in range(n)]


# -- the functions ------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [((5, 64), np.float32), ((2, 3, 48), np.float32),
                                         ((7, 40), "bfloat16")])
def test_quantize_act_int8_equals_jax_eager(shape, dtype):
    """Codes and scales bit for bit, a zero row (scale 1/127) included."""
    x = np.random.default_rng(len(shape)).normal(size=shape).astype(np.float32) * 3
    x.reshape(-1, shape[-1])[1] = 0.0
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    q, s = TQ.quantize_act_int8(tx)
    jq, js = JQ.quantize_act_int8(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.shape == (*shape[:-1], 1)
    assert float(s.reshape(-1)[1]) == np.float32(1.0) / np.float32(127.0)


def test_w8a8_dense_exact_on_a_saturated_grid():
    """Every weight column and activation row holds its absmax at 127 steps,
    so both quantize exactly and the int32 product is exact: the result
    equals ``x @ codes * scale`` bit for bit, and JAX's (tests/test_w8a8.py:34)."""
    rng = np.random.default_rng(0)
    k, n, m = 64, 32, 8
    codes = rng.integers(-126, 127, (k, n))
    codes[0, :] = 127
    w = (codes / 127.0).astype(np.float32)             # the flax kernel [in, out]
    x = rng.integers(-126, 127, (m, k)).astype(np.float32)
    x[:, 0] = 127.0
    q = TQ.quantize_int8(torch.from_numpy(w.T.copy()), axis=1)   # the port's [out, in]
    np.testing.assert_array_equal(q["q8"].numpy().astype(np.int64), codes.T)
    got = TQ.w8a8_dense(torch.from_numpy(x), q["q8"], q["scale"]).numpy()
    want = (x.astype(np.int64) @ codes).astype(np.float32) * q["scale"].numpy()[None, :]
    np.testing.assert_array_equal(got, want)
    jgot = JQ.w8a8_dense(jnp.asarray(x), JQ.quantize_int8(jnp.asarray(w), axis=0))
    np.testing.assert_array_equal(got, np.asarray(jgot))


@pytest.mark.parametrize("m,k,n", [(1, 24, 8), (9, 37, 21), (40, 64, 48)])
def test_int8_mm_is_the_exact_integer_product(m, k, n):
    rng = np.random.default_rng(m)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (n, k)).astype(np.int8)
    got = TQ.int8_mm(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ w.astype(np.int64).T)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_dense_equals_jax_on_random_inputs(dtype):
    """Same codes, exact sums and the same float32 epilogue: JAX's result
    bit for bit, with a bias, on a 3-D input, in float32 and bf16."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    w = rng.normal(size=(48, 24)).astype(np.float32) * 0.2
    b = rng.normal(size=(24,)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx, jw, jb = (jnp.asarray(a, jdt) for a in (x, w, b))
    want = JQ.w8a8_dense(jx, JQ.quantize_int8(jw, axis=0), jb)
    tw = torch.from_numpy(w.T.copy()).to(dtype)
    q = TQ.quantize_int8(tw, axis=1)
    got = TQ.w8a8_dense(torch.from_numpy(x).to(dtype), q["q8"], q["scale"],
                        torch.from_numpy(b).to(dtype))
    assert got.dtype == dtype and got.shape == (2, 5, 24)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_dense_runs_w8a8_once_quantized():
    """A quantized ``Dense`` holds int8 codes and a float32 scale a channel
    and runs ``w8a8_dense``; its bias stays in the model's dtype."""
    d = L.Dense(32, 16, device="cpu", dtype=torch.float32)
    torch.nn.init.normal_(d.weight)
    torch.nn.init.normal_(d.bias)
    x = torch.randn(3, 32, generator=torch.Generator().manual_seed(0))
    plain = d(x)
    TQ.quantize_encoder_params(d)
    assert d.weight.dtype == torch.int8 and d.weight_scale.dtype == torch.float32
    assert d.weight_scale.shape == (16,) and d.bias.dtype == torch.float32
    np.testing.assert_array_equal(d(x).numpy(),
                                  TQ.w8a8_dense(x, d.weight, d.weight_scale, d.bias).numpy())
    cos = torch.nn.functional.cosine_similarity(d(x).flatten(), plain.flatten(), dim=0)
    assert float(cos) > 0.999
    assert "weight_scale" in d.state_dict()


# -- retrievers ------------------------------------------------------------------------

def test_quantized_leaves_and_codes_equal_jax(family):
    """The port's int8 parameters are exactly the JAX leaves that
    ``quantize_encoder_params`` turns into dicts (mapped through
    ``convert.torch_name``), with JAX's eager codes and scales, made from
    the bf16 weights as JAX's Retriever makes them."""
    name, jr, flat = family
    r = _port_retriever(name, flat, torch.bfloat16, quantize="int8")
    bf16 = jax.tree.map(lambda p: jnp.asarray(p, jnp.bfloat16), jr.params)
    jq = flatten_flax(jax.tree.map(np.asarray, JQ.quantize_encoder_params(bf16)))
    want = {torch_name(k[: -len("/q8")]) for k in jq if k.endswith("/kernel/q8")}
    state = r.model.state_dict()
    got = {n for n, t in state.items() if t.dtype == torch.int8}
    assert got == want and len(got) > 10
    for key in jq:
        if key.endswith("/kernel/q8"):
            w = torch_name(key[: -len("/q8")])
            np.testing.assert_array_equal(state[w].numpy(), jq[key].T, err_msg=w)
            np.testing.assert_array_equal(state[w + "_scale"].numpy(),
                                          jq[key[:-2] + "scale"], err_msg=w)
    # everything else keeps the model's dtype: convs, norms, biases, tables
    others = {n: t.dtype for n, t in state.items() if n not in got and not n.endswith("_scale")}
    assert set(others.values()) == {torch.bfloat16}


def test_quantized_embeddings_match_jax_int8(family):
    """float32 on both sides: the port's int8 retriever against JAX's, pages
    and queries, per-token cosine >= 0.999."""
    name, _, flat = family
    jr = _jax_retriever(name, quantize="int8")
    r = _port_retriever(name, flat, torch.float32, quantize="int8")
    pages = _pages(1)
    queries = ["what binds selectins", "glycan"]
    for got, want in ((r.embed_images(pages), jr.embed_images(pages)),
                      (r.embed_queries(queries), jr.embed_queries(queries))):
        for a, b in zip(got, want):
            assert a.shape == b.shape
            assert float(np.min(np.sum(a * b, axis=-1))) >= 0.999


def test_quantized_embeddings_stay_near_bf16(family):
    """The port's int8 forward against its own bf16 one: mean per-token
    cosine >= 0.98 (JAX's bound), pages and queries."""
    name, _, flat = family
    bf = _port_retriever(name, flat, torch.bfloat16)
    q8 = _port_retriever(name, flat, torch.bfloat16, quantize="int8")
    pages = _pages(2)
    for a, b in zip(bf.embed_images(pages), q8.embed_images(pages)):
        assert a.shape == b.shape
        assert float(np.mean(np.sum(a * b, axis=-1))) > 0.98
    a, b = bf.embed_queries(["what is a glycan?"])[0], q8.embed_queries(["what is a glycan?"])[0]
    assert float(np.mean(np.sum(a * b, axis=-1))) > 0.98


@pytest.mark.parametrize("name", ["tiny-colidefics3", "tiny-colgranite"])
def test_quantized_dynamic_layouts_embed(name):
    """W8A8 with image splitting / anyres: one group a layout, finite unit
    vectors of the layout's length."""
    with pytest.warns(UserWarning, match="random init"):
        r = load_retriever(name, device="cpu", dtype=torch.float32, quantize="int8",
                           dynamic_resolution=True)
    pages = [np.random.default_rng(i).integers(0, 256, hw + (3,), dtype=np.uint8)
             for i, hw in enumerate([(40, 90), (90, 40), (41, 88)])]
    groups = r.processor.group_by_grid(pages)
    assert len(groups) >= 2
    embs = r.embed_images(pages)
    for grid, idxs in groups:
        n = r.processor.process_images([pages[idxs[0]]], grid=grid)["input_ids"].shape[1]
        for i in idxs:
            assert embs[i].shape == (n, 8) and np.isfinite(embs[i]).all()
            np.testing.assert_allclose(np.linalg.norm(embs[i], axis=-1), 1.0, atol=1e-3)


def test_unknown_quantize_mode_raises_before_loading():
    with pytest.raises(ValueError, match="unknown quantize mode 'fp4'"):
        load_retriever("tiny-colpali", device="cpu", quantize="fp4")


# -- the K5 gate -------------------------------------------------------------------------

def test_fused_layer_gate_is_off_for_int8_layers(monkeypatch):
    """A SigLIP-768 layer at a shape the fused plan admits takes K5a (here
    its plain version: the gate forced on) in bf16, and never once its
    projections are int8 (siglip.py:52-84): it then runs the unfused layer
    on ``w8a8_dense``."""
    cfg = SiglipVisionConfig(hidden_size=768, intermediate_size=3072, num_hidden_layers=1,
                             num_attention_heads=12, image_size=256, patch_size=16)
    layer = SiglipEncoderLayer(cfg, device="cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    for n, p in layer.named_parameters():
        with torch.no_grad():
            p.normal_(0.0, 0.02, generator=gen) if p.dim() == 2 else p.fill_(
                1.0 if "norm" in n and n.endswith("weight") else 0.0)
    calls = []
    real = FL.fused_vit_layer
    monkeypatch.setattr(FL, "fused_vit_layer", lambda *a, **k: calls.append(1) or real(*a, **k))
    dense_calls = []
    real_w8a8 = L.w8a8_dense
    monkeypatch.setattr(L, "w8a8_dense",
                        lambda *a, **k: dense_calls.append(1) or real_w8a8(*a, **k))
    x = torch.randn(1, 256, 768, generator=gen)
    L.set_fused_layer(True)
    try:
        want = layer(x)
        assert calls == [1] and not dense_calls
        TQ.quantize_encoder_params(layer)
        got = layer(x)
    finally:
        L.set_fused_layer(None)
    assert calls == [1] and len(dense_calls) == 6
    cos = torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0)
    assert float(cos) > 0.999


# -- Gemma-3's W8A8 tower -------------------------------------------------------------------

@pytest.fixture(scope="module")
def gemma3_pair():
    jcfg, cfg = _cfgs(4)
    params = jax.tree.map(np.asarray, JR.gemma3_mm_random_params(jcfg, seed=7))
    jmm = JMM(jcfg, jax.tree.map(jnp.asarray, params), dtype=jnp.float32, vision_dtype="int8")
    lm, tower_sd, projector = gemma3_mm_params_from_jax(params, cfg, device="cpu")
    tower = SiglipVisionTower(cfg.vision, device="cpu", dtype=torch.float32).eval()
    tower.load_state_dict(tower_sd)
    eng = GemmaDecodeEngine(cfg.text, lm, device="cpu")
    return jmm, Gemma3MMEngine(cfg, tower, projector, lm=eng, vision_dtype="int8")


def test_gemma3_int8_tower_quantizes_the_tower_only(gemma3_pair):
    jmm, mm = gemma3_pair
    q = {n for n, p in mm.vision_tower.named_parameters() if p.dtype == torch.int8}
    jq = flatten_flax(jax.tree.map(np.asarray, jmm.vision_params))
    assert q == {torch_name(k[: -len("/q8")]) for k in jq if k.endswith("/q8")}
    assert all(t.dtype == torch.float32 for t in flatten_flax(mm.projector).values())
    with pytest.raises(ValueError, match="vision_dtype"):
        Gemma3MMEngine(mm.cfg, mm.vision_tower, mm.projector, lm=mm.lm, vision_dtype="int4")


def test_gemma3_int8_soft_tokens_and_stream_match_jax(gemma3_pair):
    """Soft tokens against JAX's W8A8 tower within 1e-4 relative to their
    scale (JAX's codes come from ``jit``); the greedy stream equal to JAX's
    or first differing where JAX's top two logits are within 0.05."""
    jmm, mm = gemma3_pair
    pix = _pixels(3, 2)[None]
    want = np.asarray(jmm._image_features(jmm._vp, jnp.asarray(pix)))
    got = mm._image_features(torch.from_numpy(pix)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))
    prompt = mm.build_mm_prompt([5, 9, 11], bos_id=2, n_images=2)
    got_ids = mm.generate([prompt], pix, max_new_tokens=10)[0]
    want_ids = jmm.generate([prompt], pix, max_new_tokens=10)[0]
    if got_ids != want_ids:
        i = next(j for j, (a, b) in enumerate(zip(got_ids, want_ids)) if a != b)
        logits = np.asarray(jmm.next_token_logits([prompt + want_ids[:i]], pix))[0]
        top = np.sort(logits)[-2:]
        assert top[1] - top[0] < 0.05, (got_ids, want_ids)
