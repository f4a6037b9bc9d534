"""Image-conditioned generation of the port (``PaliGemmaEngine``, both
batchers, the HTTP server) against the JAX package's, on the CPU.

A tiny ColPali with random weights from the JAX registry is carried over to
the port's model with ``params_from_flax``; both engines run in float32, so
greedy streams must be token-identical to JAX's ``PaliGemmaEngine`` with one
image and with several, and each batcher must serve image requests beside
text requests exactly as the isolated engines do (the counterparts of
``tests/test_paged.py`` and ``tests/test_generation_engine.py``'s
multimodal cases).
"""

import base64
import io
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_colpali_tpu.generation.engine import GemmaDecodeEngine as JEngine
from multimodal_colpali_tpu.generation.engine import ModuloTokenizer as JModTok
from multimodal_colpali_tpu.generation.engine import PaliGemmaEngine as JPali
from multimodal_colpali_tpu.generation.scheduler import ContinuousBatcher as JDense
from multimodal_colpali_tpu.generation.server import GenerationServer as JServer
from multimodal_colpali_tpu.models.colpali import ColPaliModel as JColPali
from multimodal_colpali_tpu.models.configs import ColPaliModelConfig as JCfg
from multimodal_colpali_tpu.models.processing import ImagePreprocessor as JPre
from multimodal_colpali_tpu.models.registry import fast_random_params
from multimodal_colpali_tpu_torch import serve
from multimodal_colpali_tpu_torch.generation import (
    ContinuousBatcher, Gemma3MMEngine, GemmaDecodeEngine, GenerationServer, ModuloTokenizer,
    PagedContinuousBatcher, PaliGemmaEngine)
from multimodal_colpali_tpu_torch.models.colpali import ColPaliModel
from multimodal_colpali_tpu_torch.models.configs import ColPaliModelConfig
from multimodal_colpali_tpu_torch.models.convert import (
    engine_params_from_state_dict, params_from_flax)
from multimodal_colpali_tpu_torch.models.processing import ImagePreprocessor

torch.set_num_threads(1)

TEXT = [40, 2, 7]


@pytest.fixture(scope="module")
def tiny():
    """(JAX params as numpy, port model) of one tiny random ColPali."""
    jcfg = JCfg.tiny(vocab_size=64)
    params = jax.tree.map(np.asarray, fast_random_params(JColPali(jcfg), jcfg, seed=3))
    cfg = ColPaliModelConfig.tiny(vocab_size=64)
    model = ColPaliModel(cfg, device="cpu", dtype=torch.float32).eval()
    model.load_state_dict(params_from_flax(params, cfg))
    return params, model


@pytest.fixture(scope="module", params=["native", "int8"])
def engines(request, tiny):
    """(JAX text engine, JAX PaliGemma, port text engine, port PaliGemma)
    for one weight format; the port's PaliGemma decodes through the text engine."""
    params, model = tiny
    jparams = jax.tree.map(jnp.asarray, params)
    jeng = JEngine(JCfg.tiny(vocab_size=64).text, jparams, weight_dtype=request.param)
    jmm = JPali(JCfg.tiny(vocab_size=64), jparams, weight_dtype=request.param)
    eng = _text_engine(model, request.param)
    return jeng, jmm, eng, PaliGemmaEngine(model, lm=eng)


def _text_engine(model, weight_dtype="native"):
    return GemmaDecodeEngine(model.cfg.text, engine_params_from_state_dict(model.state_dict()),
                             weight_dtype=weight_dtype, device="cpu")


def _pixels(seed, n):
    cfg = ColPaliModelConfig.tiny(vocab_size=64)
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, cfg.vision.image_size, cfg.vision.image_size, 3)
                               ).astype(np.float32)


@pytest.mark.parametrize("n_images", [1, 2])
def test_generate_matches_jax(engines, n_images):
    """Greedy streams equal JAX's, for a batch of two rows of different
    lengths (left padding inside the bidirectional prefix)."""
    _, jmm, _, mm = engines
    pix = np.stack([_pixels(4, n_images), _pixels(5, n_images)])
    prompts = [mm.build_mm_prompt([5, 9, 11], bos_id=2, n_images=n_images),
               mm.build_mm_prompt([17, 3], bos_id=2, newline_ids=[10], n_images=n_images)]
    assert prompts[0] == jmm.build_mm_prompt([5, 9, 11], bos_id=2, n_images=n_images)
    want = jmm.generate(prompts, pix, max_new_tokens=8)
    assert mm.generate(prompts, pix, max_new_tokens=8) == want
    if n_images == 2:
        # both images condition the stream: their order matters
        assert mm.generate(prompts[:1], pix[:1, ::-1].copy(), max_new_tokens=8) != want[:1]


@pytest.mark.parametrize("n_images", [1, 2])
def test_next_token_logits_match_jax(engines, n_images):
    _, jmm, _, mm = engines
    pix = _pixels(6, n_images)[None]
    prompt = mm.build_mm_prompt([5, 9, 11, 30], bos_id=2, n_images=n_images)
    want = np.asarray(jmm.next_token_logits([prompt], pix, bucket=8))
    got = mm.next_token_logits([prompt], pix, bucket=8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_engine_shares_the_retrievers_weights(tiny):
    """The tower and projector are the model's own modules, and the native
    LM tree holds views of the model's parameters: nothing is copied."""
    _, model = tiny
    mm = PaliGemmaEngine(model, lm=_text_engine(model))
    assert mm.vision_tower is model.vision_tower and mm.projector is model.multi_modal_projector
    lm_q = mm.lm.params["language_model"]["layers_0"]["self_attn"]["q_proj"]["kernel"]
    assert lm_q.data_ptr() == model.language_model.layers[0].self_attn.q_proj.weight.data_ptr()
    text = GemmaDecodeEngine(model.cfg.text, mm.lm.params, device="cpu", weight_dtype="int8")
    shared = PaliGemmaEngine(model, lm=text)
    assert shared.lm is text and shared.lm.weight_dtype == "int8"


def test_generate_records_the_top_two_gap_of_each_step(engines):
    """With ``record_top2`` the shared decode loop keeps each step's gap
    between the top two logits: step 0's is the prefill logits' gap, and
    recording changes no token."""
    _, _, eng, mm = engines
    pix = _pixels(7, 1)
    prompt = mm.build_mm_prompt([5, 9, 11], bos_id=2)
    want = mm.generate([prompt], pix[None], max_new_tokens=5)
    eng.record_top2 = True
    try:
        assert mm.generate([prompt], pix[None], max_new_tokens=5) == want
        gaps = eng.top2_gaps
        assert eng.generate([TEXT], max_new_tokens=3) == eng.generate([TEXT], max_new_tokens=3)
        text_gaps = eng.top2_gaps
    finally:
        eng.record_top2 = False
    assert gaps.shape == (1, 5) and bool((gaps >= 0).all())
    top2 = np.sort(mm.next_token_logits([prompt], pix[None])[0])[-2:]
    np.testing.assert_allclose(gaps[0, 0], top2[1] - top2[0], rtol=1e-4, atol=1e-5)
    top2 = np.sort(eng.next_token_logits([TEXT])[0])[-2:]
    assert text_gaps.shape == (1, 3)
    np.testing.assert_allclose(text_gaps[0, 0], top2[1] - top2[0], rtol=1e-4, atol=1e-5)


def test_dense_batcher_mixes_image_and_text(engines):
    """An image request admitted into a running text batch decodes exactly
    as the isolated engine does, and its text neighbour as the text engine
    (test_generation_engine.py:554); an identical image request hits the
    prefill cache, other pixels miss it."""
    _, _, eng, mm = engines
    pix = _pixels(4, 1)
    prompt = mm.build_mm_prompt([5, 9, 11], bos_id=2)
    want_mm = mm.generate([prompt], pix, max_new_tokens=6, bucket=len(prompt))[0]
    want_txt = eng.generate([TEXT], max_new_tokens=8)[0]
    bat = ContinuousBatcher(eng, batch_slots=2, max_seq_len=64, chunk=3,
                            prompt_bucket=len(prompt), mm_engine=mm)
    assert bat.supports_multimodal
    txt = bat.submit(TEXT, max_new_tokens=8)
    with bat._lock:
        bat._admit()
        bat._step_chunk()          # the text slot is mid-decode when the image joins
    img = bat.submit(prompt, max_new_tokens=6, pixel_values=pix[0])
    bat.drain()
    assert img.result(timeout=60) == want_mm
    assert txt.result(timeout=60) == want_txt
    assert bat.generate([prompt], max_new_tokens=6, pixel_values=[pix]) == [want_mm]
    assert bat.prefill_cache_hits == 1
    # the same pixels as a tensor hit it too (the digest is of dtype, shape
    # and bytes); other pixels miss it
    bat.generate([prompt], max_new_tokens=6, pixel_values=[torch.from_numpy(pix)])
    assert bat.prefill_cache_hits == 2
    bat.generate([prompt], max_new_tokens=6, pixel_values=[np.zeros_like(pix)])
    assert bat.prefill_cache_hits == 2
    bare = ContinuousBatcher(eng, batch_slots=1, max_seq_len=64)
    with pytest.raises(ValueError, match="mm_engine"):
        bare.submit([5], max_new_tokens=2, pixel_values=pix).result(timeout=5)


@pytest.mark.parametrize("n_images", [1, 2])
def test_paged_batcher_mixes_image_and_text(engines, n_images):
    """test_paged.py:185-205 and :652: one or two context images per
    request, beside a text request, token-identical to the isolated engines."""
    _, _, eng, mm = engines
    pix = _pixels(6, n_images)
    prompt = mm.build_mm_prompt([5, 9, 11], bos_id=2, n_images=n_images)
    want = mm.generate([prompt], pix[None], max_new_tokens=6, bucket=len(prompt))[0]
    bat = PagedContinuousBatcher(eng, batch_slots=2, max_seq_len=96, chunk=3,
                                 prompt_bucket=len(prompt), mm_engine=mm, page_size=8)
    txt = bat.submit(TEXT, max_new_tokens=8)
    img = bat.submit(prompt, max_new_tokens=6, pixel_values=pix)
    bat.drain()
    assert img.result(timeout=60) == want
    assert txt.result(timeout=60) == eng.generate([TEXT], max_new_tokens=8)[0]


def test_paged_preemption_resumes_an_image_request_causally(engines):
    """test_paged.py:468: a preempted image request re-prefills its prompt
    bidirectionally and its generated tokens causally, so its stream equals
    the run without preemption."""
    _, _, eng, mm = engines
    pix = _pixels(0, 1)
    prompt = mm.build_mm_prompt([5, 9, 17], bos_id=2)

    def run(pool_pages):
        bat = PagedContinuousBatcher(eng, batch_slots=2, max_seq_len=64, chunk=2,
                                     page_size=8, mm_engine=mm, pool_pages=pool_pages)
        txt = bat.submit(list(range(2, 14)), max_new_tokens=12)
        with bat._lock:
            bat._admit()
            bat._step_chunk()      # the text request is older: the image one is the victim
        img = bat.submit(prompt, max_new_tokens=10, pixel_values=[pix[0]])
        bat.drain()
        return bat, txt.result(10), img.result(10)

    base, txt0, img0 = run(None)
    assert base.preemptions == 0
    tight, txt1, img1 = run(5)
    assert tight.preemptions > 0
    assert (txt1, img1) == (txt0, img0)
    assert img0 == mm.generate([prompt], pix, max_new_tokens=10, bucket=16)[0]


def test_paged_image_prompts_never_share_pages(engines):
    """test_paged.py:498: a bidirectional prefix makes each page depend on
    the whole prompt, so image prompts with equal leading tokens share none."""
    _, _, eng, mm = engines
    pix = _pixels(0, 1)
    ids = mm.build_mm_prompt([5, 9, 17], bos_id=2)
    ids2 = ids[:-1] + [24]
    kw = dict(batch_slots=2, max_seq_len=64, chunk=2, page_size=8, mm_engine=mm)
    bat = PagedContinuousBatcher(eng, prefix_caching=True, **kw)
    futs = [bat.submit(ids, max_new_tokens=4, pixel_values=[pix[0]]),
            bat.submit(ids2, max_new_tokens=4, pixel_values=[pix[0]])]
    bat.drain()
    got = [f.result(10) for f in futs]
    assert bat.prefix_cache_hits == 0 and bat.prefix_prefill_hits == 0
    ref = PagedContinuousBatcher(eng, **kw)
    futs = [ref.submit(ids, max_new_tokens=4, pixel_values=[pix[0]]),
            ref.submit(ids2, max_new_tokens=4, pixel_values=[pix[0]])]
    ref.drain()
    assert got == [f.result(10) for f in futs]


class _NotBatchable:
    batcher_compatible = False


@pytest.mark.parametrize("cls", [ContinuousBatcher, PagedContinuousBatcher])
def test_batchers_refuse_engines_they_cannot_carry(engines, cls):
    eng = engines[2]
    with pytest.raises(ValueError, match="_NotBatchable is not batcher-compatible"):
        cls(eng, mm_engine=_NotBatchable())


# -- the HTTP server -----------------------------------------------------------------

MCQ = {"type": "json_schema", "json_schema": {"name": "mcq", "schema": {
    "type": "object", "properties": {"answer": {"type": "string",
                                                "enum": ["A", "B", "C", "D"]}}}}}


def _data_url(seed, size=40):
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _ask(base_url, body):
    req = urllib.request.Request(base_url + "/chat/completions", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())["choices"][0]["message"]["content"]


def _image_body(n_images, **kw):
    parts = [{"type": "text", "text": "what does the figure show?"}]
    parts += [{"type": "image_url", "image_url": {"url": _data_url(s)}} for s in range(n_images)]
    parts.append({"type": "image_url", "image_url": {"url": "data:image/png;base64,AAAA"}})
    return {"model": "tiny", "messages": [{"role": "user", "content": parts}], **kw}


def test_server_answers_images_as_the_jax_server(engines):
    """A PNG data-URL request (an undecodable part skipped, as in JAX) and an
    MCQ over two images get the JAX server's replies, through the port's
    dense batcher with an mm_engine and through the bare engines."""
    jeng, jmm, eng, mm = engines
    cfg = ColPaliModelConfig.tiny(vocab_size=64)
    tok, jtok = ModuloTokenizer(64), JModTok(64)
    pre, jpre = ImagePreprocessor(cfg.vision.image_size), JPre(cfg.vision.image_size)
    bodies = [_image_body(1, max_tokens=6), _image_body(2, max_tokens=5),
              _image_body(2, response_format=MCQ)]
    jbat = JDense(jeng, batch_slots=2, max_seq_len=256, chunk=4, mm_engine=jmm).serve()
    try:
        with JServer(jbat, jtok, mm_engine=jmm, image_preprocessor=jpre) as srv:
            want = [_ask(srv.base_url, b) for b in bodies]
    finally:
        jbat.shutdown()
    assert json.loads(want[2])["answer"] in "ABCD"
    bat = ContinuousBatcher(eng, batch_slots=2, max_seq_len=256, chunk=4, mm_engine=mm).serve()
    try:
        with GenerationServer(bat, tok, mm_engine=mm, image_preprocessor=pre) as srv:
            assert [_ask(srv.base_url, b) for b in bodies] == want
    finally:
        bat.shutdown()
    with GenerationServer(eng, tok, mm_engine=mm, image_preprocessor=pre) as srv:
        assert [_ask(srv.base_url, b) for b in bodies] == want


def test_serve_builds_the_image_engine_for_colpali(monkeypatch):
    """serve.build gives a ColPali retriever's text engine a
    PaliGemmaEngine on the same weights (07_serve.py:255-277), also under
    int8 weights, where the image engine decodes through the quantized tree."""
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    for wd in ("native", "int8"):
        args = serve.parse_args(["--model", "tiny-colpali", "--device", "cpu",
                                 "--dtype", "float32", "--weight-dtype", wd])
        with pytest.warns(UserWarning, match="random init"):
            eng, tok, mm, pre = serve.build(args)
        assert mm.lm is eng and eng.weight_dtype == wd
        assert isinstance(pre, ImagePreprocessor)
        pix = pre([np.full((28, 28, 3), 200, np.uint8)])
        ids = mm.build_mm_prompt(tok.encode("hi"), bos_id=tok.bos_id)
        bat = PagedContinuousBatcher(eng, batch_slots=2, max_seq_len=64, mm_engine=mm)
        assert bat.generate([ids], max_new_tokens=4, pixel_values=[pix]) == \
            mm.generate([ids], pix[None], max_new_tokens=4)
    # a Gemma-3 name gets its own image engine (test_torch_gemma3_mm.py), not PaliGemma's
    args = serve.parse_args(["--model", "tiny-gemma3", "--device", "cpu"])
    with pytest.warns(UserWarning, match="random init"):
        mm = serve.build(args)[2]
    assert isinstance(mm, Gemma3MMEngine) and not isinstance(mm, PaliGemmaEngine)
