"""The port's Gemma-3 multimodal generator (``Gemma3MMEngine``, its loader,
both batchers, prefix caching, the server and ``serve.build``) against the
JAX package's and against HF ``Gemma3ForConditionalGeneration``, on the CPU.

Each case of ``tests/test_gemma3_mm.py`` has its counterpart here. JAX's
random tiny params (``gemma3_mm_random_params``) are carried over as numpy
arrays with ``convert.gemma3_mm_params_from_jax``; both packages run in
float32, so greedy streams must be token-identical to the JAX engine's with
one image and with two, for native, int8 and int4 LM weights, and its
next-token logits within rtol 1e-4 / atol 1e-5 (the PaliGemma tests'
bound). HF models are built in-process from tiny configs, saved as
safetensors and loaded through ``load_gemma3_mm(checkpoint_dir=)``; their
logits must match at JAX's 3e-4.
"""

import hashlib
import json
import urllib.request
import warnings
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_colpali_tpu.generation.engine import GemmaDecodeEngine as JEngine
from multimodal_colpali_tpu.generation.engine import ModuloTokenizer as JModTok
from multimodal_colpali_tpu.generation.gemma3_mm import Gemma3MMEngine as JMM
from multimodal_colpali_tpu.generation.paged import PagedContinuousBatcher as JPaged
from multimodal_colpali_tpu.generation.scheduler import ContinuousBatcher as JDense
from multimodal_colpali_tpu.generation.server import GenerationServer as JServer
from multimodal_colpali_tpu.models import hf_import as JH
from multimodal_colpali_tpu.models import registry as JR
from multimodal_colpali_tpu.models.configs import Gemma3MMConfig as JCfg
from multimodal_colpali_tpu.models.configs import Gemma3TextConfig as JText
from multimodal_colpali_tpu.models.configs import SiglipVisionConfig as JVision
from multimodal_colpali_tpu.models.processing import ImagePreprocessor as JPre
from multimodal_colpali_tpu_torch import serve
from multimodal_colpali_tpu_torch.generation import (
    ContinuousBatcher, Gemma3MMEngine, GemmaDecodeEngine, GenerationServer, ModuloTokenizer,
    PagedContinuousBatcher)
from multimodal_colpali_tpu_torch.generation.scheduler import _pixel_digest, _Request
from multimodal_colpali_tpu_torch.models import hf_import as TH
from multimodal_colpali_tpu_torch.models import registry as TR
from multimodal_colpali_tpu_torch.models.configs import (
    Gemma3MMConfig, Gemma3TextConfig, SiglipVisionConfig)
from multimodal_colpali_tpu_torch.models.convert import gemma3_mm_params_from_jax
from multimodal_colpali_tpu_torch.models.processing import ImagePreprocessor
from multimodal_colpali_tpu_torch.models.siglip import SiglipVisionTower

from tests.test_torch_checkpoint import _flat, save_sharded

torch.set_num_threads(1)

TEXT = [40, 2, 7]
WEIGHTS = ["native", "int8", "int4"]


def _cfgs(mm_tokens: int):
    """The tiny config of both packages with ``mm_tokens`` soft tokens an image."""
    vision = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=2, image_size=28, patch_size=14)
    jcfg = JCfg(vision=JVision(**vision), text=JText.tiny(vocab_size=64), image_token_id=63,
                mm_tokens_per_image=mm_tokens)
    cfg = Gemma3MMConfig(vision=SiglipVisionConfig(**vision),
                         text=Gemma3TextConfig.tiny(vocab_size=64), image_token_id=63,
                         mm_tokens_per_image=mm_tokens)
    return jcfg, cfg


def _port(cfg, params, weight_dtype="native"):
    """(text engine, Gemma3MMEngine) of the port on JAX's numpy params."""
    lm, tower_sd, projector = gemma3_mm_params_from_jax(params, cfg, device="cpu")
    tower = SiglipVisionTower(cfg.vision, device="cpu", dtype=torch.float32).eval()
    tower.load_state_dict(tower_sd)
    eng = GemmaDecodeEngine(cfg.text, lm, weight_dtype=weight_dtype, device="cpu")
    return eng, Gemma3MMEngine(cfg, tower, projector, lm=eng)


def _jax(jcfg, params, weight_dtype="native"):
    jparams = jax.tree.map(jnp.asarray, params)
    return (JEngine(jcfg.text, jparams, dtype=jnp.float32, weight_dtype=weight_dtype),
            JMM(jcfg, jparams, dtype=jnp.float32, weight_dtype=weight_dtype))


def _random(mm_tokens: int, seed: int):
    jcfg, cfg = _cfgs(mm_tokens)
    params = jax.tree.map(np.asarray, JR.gemma3_mm_random_params(jcfg, seed=seed))
    return jcfg, cfg, params


@pytest.fixture(scope="module")
def tiny_params():
    """The registry's tiny-gemma3 (one soft token an image), seed 4, as numpy."""
    return _random(1, 4)


@pytest.fixture(scope="module", params=WEIGHTS)
def engines(request, tiny_params):
    """(JAX text engine, JAX Gemma3MMEngine, port text engine, port
    Gemma3MMEngine) for one LM weight format."""
    jcfg, cfg, params = tiny_params
    return (*_jax(jcfg, params, request.param), *_port(cfg, params, request.param))


@pytest.fixture(scope="module")
def tiny4():
    """Four soft tokens an image, so spans cross the pages of 4 tokens:
    (JAX text engine, JAX mm engine, port text engine, port mm engine)."""
    jcfg, cfg, params = _random(4, 6)
    return (*_jax(jcfg, params), *_port(cfg, params))


def _pixels(seed, n, size=28):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, size, size, 3)).astype(np.float32)


# -- the engine against JAX's ----------------------------------------------------------

def test_config_and_registry_equal_jax():
    for name, make in JR.GEMMA3_MM_CONFIGS.items():
        j, t = make(), TR.GEMMA3_MM_CONFIGS[name]()
        assert (t.image_token_id, t.mm_tokens_per_image) == (j.image_token_id,
                                                             j.mm_tokens_per_image), name
        assert t.vision.num_patches == j.vision.num_patches, name
        assert t.text.hidden_size == j.text.hidden_size, name
    assert sorted(TR.GEMMA3_MM_CONFIGS) == sorted(JR.GEMMA3_MM_CONFIGS)
    big = TR.GEMMA3_MM_CONFIGS["google/gemma-3-27b-it"]()
    assert big.vision.num_patches == 4096 and big.vision.hidden_size == 1152
    assert big.mm_tokens_per_image == 256 and big.image_token_id == 262144
    assert "gemma-3-1b" not in TR.GEMMA3_MM_CONFIGS


@pytest.mark.parametrize("n_images", [1, 2])
def test_generate_matches_jax(engines, n_images):
    """Greedy streams equal JAX's for a batch of two rows of different
    lengths (left padding before the image spans), for every weight format."""
    _, jmm, _, mm = engines
    pix = np.stack([_pixels(4, n_images), _pixels(5, n_images)])
    prompts = [mm.build_mm_prompt([5, 9, 11], bos_id=2, n_images=n_images),
               mm.build_mm_prompt([17, 3], bos_id=2, newline_ids=[10], n_images=n_images)]
    assert prompts == [jmm.build_mm_prompt([5, 9, 11], bos_id=2, n_images=n_images),
                       jmm.build_mm_prompt([17, 3], bos_id=2, newline_ids=[10],
                                           n_images=n_images)]
    want = jmm.generate(prompts, pix, max_new_tokens=12)
    assert mm.generate(prompts, pix, max_new_tokens=12) == want


@pytest.mark.parametrize("n_images", [1, 2])
def test_next_token_logits_match_jax(engines, n_images):
    _, jmm, _, mm = engines
    pix = _pixels(6, n_images)[None]
    prompt = mm.build_mm_prompt([5, 9, 11, 30], bos_id=2, n_images=n_images, boi_id=61,
                                eoi_id=62)
    want = np.asarray(jmm.next_token_logits([prompt], pix, bucket=8))
    got = mm.next_token_logits([prompt], pix, bucket=8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_image_features_and_spans_match_jax(tiny4):
    """The projector's soft tokens and the span mask, the two pieces that
    differ from PaliGemma's: within rtol 1e-5 and equal."""
    _, jmm, _, mm = tiny4
    pix = _pixels(3, 2)[None]
    want = np.asarray(jmm._image_features(jmm._vp, jnp.asarray(pix)))
    got = mm._image_features(torch.from_numpy(pix))
    assert got.shape == (1, 2 * mm.cfg.mm_tokens_per_image, mm.cfg.text.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    ids = [[0, 2, 63, 63, 63, 63, 7, 63, 63, 63, 63, 63, 63, 63, 63, 9]]
    assert np.array_equal(mm._span_bidir(torch.tensor(ids)).numpy(),
                          np.asarray(jmm._span_bidir(jnp.asarray(ids))))


def test_two_images_both_condition_the_logits(tiny4):
    _, _, _, mm = tiny4
    pix = _pixels(2, 2)
    prompt = mm.build_mm_prompt([5, 9, 11], bos_id=2, n_images=2)
    a = mm.next_token_logits([prompt], pix[None])
    b = mm.next_token_logits([prompt], pix[::-1][None].copy())
    assert not np.allclose(a, b)


def test_vision_int8_raises_and_the_engine_shares_the_lm(tiny_params, monkeypatch):
    """``--vision-dtype int8`` builds, as JAX's: a W8A8 SigLIP tower (its
    projections int8, ``ops/quant``) beside a projector in the LM's dtype.
    Only an unknown value raises: the argument parser refuses it, as JAX's
    engine and the port's refuse it with a ValueError. The image engine
    decodes through the text engine it is given: one LM tree."""
    jcfg, cfg, params = tiny_params
    eng, mm = _port(cfg, params, "int8")
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    with pytest.warns(UserWarning, match="random init"):
        e8, _, m8, _ = serve.build(serve.parse_args(["--model", "tiny-gemma3", "--device",
                                                     "cpu", "--vision-dtype", "int8"]))
    assert m8.lm is e8 and m8.vision_tower.layers[0].mlp.fc1.weight.dtype == torch.int8
    assert m8.vision_tower.patch_embedding.weight.dtype == torch.bfloat16
    assert m8.projector["mm_input_projection"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="vision_dtype"):
        Gemma3MMEngine(cfg, mm.vision_tower, mm.projector, lm=eng, vision_dtype="fp8")
    with pytest.raises(SystemExit):
        serve.parse_args(["--model", "tiny-gemma3", "--vision-dtype", "fp8"])
    with pytest.raises(ValueError):
        JMM(jcfg, jax.tree.map(jnp.asarray, params), vision_dtype="fp8")
    assert mm.lm is eng and mm.lm.weight_dtype == "int8"
    assert (mm.first_position, mm.shares_prefix_pages) == (0, True)


# -- HF Gemma3ForConditionalGeneration ---------------------------------------------------

def _hf_model(cfg):
    from transformers import Gemma3Config, Gemma3ForConditionalGeneration

    v, t = cfg.vision, cfg.text
    hf_cfg = Gemma3Config(
        vision_config=dict(hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
                           num_hidden_layers=v.num_hidden_layers,
                           num_attention_heads=v.num_attention_heads, image_size=v.image_size,
                           patch_size=v.patch_size),
        text_config=dict(vocab_size=t.vocab_size, hidden_size=t.hidden_size,
                         intermediate_size=t.intermediate_size,
                         num_hidden_layers=t.num_hidden_layers,
                         num_attention_heads=t.num_attention_heads,
                         num_key_value_heads=t.num_key_value_heads, head_dim=t.head_dim,
                         sliding_window=t.sliding_window,
                         layer_types=list(t.layer_types_resolved), rope_theta=t.rope_theta,
                         rope_local_base_freq=t.rope_local_base_freq,
                         rope_scaling={"rope_type": "linear", "factor": t.rope_scaling_factor},
                         query_pre_attn_scalar=t.query_pre_attn_scalar),
        mm_tokens_per_image=cfg.mm_tokens_per_image, image_token_index=cfg.image_token_id,
        boi_token_index=61, eoi_token_index=62)
    torch.manual_seed(0)
    hf = Gemma3ForConditionalGeneration(hf_cfg).eval()
    # HF leaves the projector matrix at its zeros init; zero features would
    # make the comparison blind to the images (test_gemma3_mm.py:64-67)
    with torch.no_grad():
        hf.model.multi_modal_projector.mm_input_projection_weight.normal_(0, 0.3)
    return hf


@pytest.fixture(scope="module")
def hf_ckpt(tmp_path_factory):
    """(cfg, HF model, float32 checkpoint, bf16 checkpoint, old-layout
    float32 checkpoint), 4 soft tokens an image."""
    jcfg, cfg = _cfgs(4)
    hf = _hf_model(cfg)
    sd = hf.state_dict()
    root = tmp_path_factory.mktemp("gemma3mm")
    old = {}
    for k, v in sd.items():   # the layout transformers < 4.52 wrote
        k = k.replace("model.language_model.", "language_model.model.")
        old[k.replace("model.vision_tower.", "vision_tower.").replace(
            "model.multi_modal_projector.", "multi_modal_projector.")] = v
    return (jcfg, cfg, hf, save_sharded(sd, root / "f32"),
            save_sharded(sd, root / "bf16", dtype=torch.bfloat16), save_sharded(old, root / "old"))


def _loaded(cfg, path, weight_dtype="native"):
    """The port's engines from ``load_gemma3_mm(checkpoint_dir=path)``,
    the registry's own tiny config swapped for ``cfg``."""
    saved = TR.GEMMA3_MM_CONFIGS["tiny-gemma3"]
    TR.GEMMA3_MM_CONFIGS["tiny-gemma3"] = lambda: cfg
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")      # a found checkpoint: no random-init warning
            got_cfg, params, tok = TR.load_gemma3_mm("tiny-gemma3", device="cpu",
                                                     dtype=torch.float32, checkpoint_dir=path,
                                                     weight_dtype=weight_dtype)
    finally:
        TR.GEMMA3_MM_CONFIGS["tiny-gemma3"] = saved
    assert got_cfg is cfg and tok is None
    eng = GemmaDecodeEngine(cfg.text, {k: params[k] for k in ("embed", "language_model")},
                            device="cpu")
    return eng, Gemma3MMEngine(cfg, params["vision_tower"], params["multi_modal_projector"],
                               lm=eng)


def _hf_generate(hf, prompt, pix, max_new, image_token_id):
    ids = torch.tensor([prompt], dtype=torch.long)
    with torch.no_grad():
        out = hf.generate(input_ids=ids, attention_mask=torch.ones_like(ids),
                          token_type_ids=(ids == image_token_id).long(),
                          pixel_values=torch.from_numpy(pix.transpose(0, 3, 1, 2).copy()),
                          max_new_tokens=max_new, do_sample=False)
    return out[0, len(prompt):].tolist()


@pytest.mark.parametrize("layout", ["f32", "old"])
def test_prefill_logits_match_hf(hf_ckpt, layout):
    """Both HF layouts load through ``checkpoint_dir=``; the next-token
    logits of an image prompt (boi/eoi markers) match HF's at JAX's 3e-4."""
    _, cfg, hf, f32, _, old = hf_ckpt
    _, mm = _loaded(cfg, f32 if layout == "f32" else old)
    prompt = mm.build_mm_prompt([5, 9, 11, 3], bos_id=2, boi_id=61, eoi_id=62)
    pix = _pixels(0, 1)
    got = mm.next_token_logits([prompt], pix[None], bucket=len(prompt))
    ids = torch.tensor([prompt], dtype=torch.long)
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=torch.ones_like(ids),
                  token_type_ids=(ids == cfg.image_token_id).long(),
                  pixel_values=torch.from_numpy(pix.transpose(0, 3, 1, 2).copy())
                  ).logits[0, -1].numpy()
    np.testing.assert_allclose(got[0], want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("n_images", [1, 2])
def test_greedy_generation_matches_hf(hf_ckpt, n_images):
    """Greedy decode against HF's, long enough to cross the sliding window
    (8), with one image and with two."""
    _, cfg, hf, f32, _, _ = hf_ckpt
    _, mm = _loaded(cfg, f32)
    prompt = mm.build_mm_prompt([5, 9, 11, 3, 17, 42][:6 - 3 * (n_images - 1)], bos_id=2,
                                n_images=n_images, boi_id=61, eoi_id=62)
    pix = _pixels(n_images, n_images)
    got = mm.generate([prompt], pix[None], max_new_tokens=14, bucket=len(prompt))[0]
    assert got == _hf_generate(hf, prompt, pix, 14, cfg.image_token_id)


def test_converter_tree_equals_jax(hf_ckpt):
    """``gemma3_mm_params_from_hf`` gives JAX's tree leaf for leaf, from the
    float32 file and from the bf16 one (the port keeps the file's bf16, JAX
    reads the same numbers as float32)."""
    jcfg, cfg, _, f32, bf16, _ = hf_ckpt
    for path in (f32, bf16):
        want = JH.gemma3_mm_params_from_hf(JH.load_state_dict(path), jcfg)
        got = TH.gemma3_mm_params_from_hf(TH.load_state_dict(path), cfg)
        a, b = list(_flat(got)), list(_flat(want))
        assert [p for p, _ in a] == [p for p, _ in b]
        for (p, g), (_, w) in zip(a, b):
            assert g.dtype == (torch.float32 if path == f32 else torch.bfloat16), p
            assert torch.equal(g.float(), torch.from_numpy(np.asarray(w, np.float32))), p


def test_load_gemma3_mm_places_and_quantizes_leaf_by_leaf(hf_ckpt):
    """From the bf16 file: the tower's and projector's tensors equal the
    file's, the LM leaves equal ``load_gemma3_lm``'s from the same file,
    native and int8 (the bytes of the text loader), and JAX's loader reads
    the same checkpoint."""
    _, cfg, _, _, bf16, _ = hf_ckpt
    saved = TR.GEMMA3_MM_CONFIGS["tiny-gemma3"]
    TR.GEMMA3_MM_CONFIGS["tiny-gemma3"] = lambda: cfg
    try:
        for fmt in ("native", "int8"):
            _, mm_params, _ = TR.load_gemma3_mm("tiny-gemma3", device="cpu",
                                                checkpoint_dir=bf16, weight_dtype=fmt)
            _, lm_params, _ = TR.load_gemma3_lm("tiny-gemma3", device="cpu",
                                                checkpoint_dir=bf16, weight_dtype=fmt)
            a = list(_flat({k: mm_params[k] for k in ("embed", "language_model")}))
            b = list(_flat(lm_params))
            assert [p for p, _ in a] == [p for p, _ in b]
            for (p, x), (_, y) in zip(a, b):
                assert x.dtype == y.dtype and torch.equal(x, y), (fmt, p)
    finally:
        TR.GEMMA3_MM_CONFIGS["tiny-gemma3"] = saved
    sd = TH.load_state_dict(bf16)
    tower = mm_params["vision_tower"]
    assert tower.patch_embedding.weight.dtype == torch.bfloat16
    assert torch.equal(tower.patch_embedding.weight,
                       sd["model.vision_tower.vision_model.embeddings.patch_embedding.weight"])
    assert torch.equal(tower.layers[1].mlp.fc2.weight,
                       sd["model.vision_tower.vision_model.encoder.layers.1.mlp.fc2.weight"])
    assert torch.equal(mm_params["multi_modal_projector"]["mm_input_projection"],
                       sd["model.multi_modal_projector.mm_input_projection_weight"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, jparams, _ = JR.load_gemma3_mm("tiny-gemma3", checkpoint_dir=bf16)
    for got, want in ((mm_params["multi_modal_projector"]["mm_input_projection"],
                       jparams["multi_modal_projector"]["mm_input_projection"]),
                      (tower.position_embedding, jparams["vision_tower"]["position_embedding"])):
        assert torch.equal(got.float(), torch.from_numpy(np.asarray(want, np.float32)))


# -- both batchers, preemption, prefix caching ----------------------------------------------

@pytest.mark.parametrize("cls", [ContinuousBatcher, PagedContinuousBatcher])
def test_through_batchers(engines, cls):
    """An image request decodes in the slot batch beside a text request,
    each stream equal to its isolated engine's and to the JAX batcher's."""
    jeng, jmm, eng, mm = engines
    pix = _pixels(3, 1)
    prompt = mm.build_mm_prompt([5, 9, 11], bos_id=2)
    want_mm = mm.generate([prompt], pix[None], max_new_tokens=6, bucket=16)[0]
    want_txt = eng.generate([TEXT], max_new_tokens=8)[0]
    assert want_mm == jmm.generate([prompt], pix[None], max_new_tokens=6, bucket=16)[0]
    kw = {"page_size": 8} if cls is PagedContinuousBatcher else {}
    bat = cls(eng, batch_slots=2, max_seq_len=64, chunk=3, mm_engine=mm, **kw)
    txt = bat.submit(TEXT, max_new_tokens=8)
    img = bat.submit(prompt, max_new_tokens=6, pixel_values=pix)
    bat.drain()
    assert img.result(60) == want_mm and txt.result(60) == want_txt


def test_preemption_resumes(engines):
    """A preempted image request resumes through the causal extension at
    0-indexed positions and still equals the uninterrupted stream; the
    preemptions equal the JAX batcher's on the same traffic."""
    jeng, jmm, eng, mm = engines
    pix = _pixels(5, 1)
    prompt = mm.build_mm_prompt([5, 9, 11, 3, 17], bos_id=2)
    want = mm.generate([prompt], pix[None], max_new_tokens=10, bucket=16)[0]
    counts = []
    for cls, e, m in ((PagedContinuousBatcher, eng, mm), (JPaged, jeng, jmm)):
        bat = cls(e, batch_slots=3, max_seq_len=64, chunk=3, page_size=8, pool_pages=8,
                  mm_engine=m)
        img = bat.submit(prompt, max_new_tokens=10, pixel_values=pix)
        txts = [bat.submit(list(range(2, 16)), max_new_tokens=8) for _ in range(2)]
        bat.drain()
        assert img.result(60) == want
        for f in txts:
            assert len(f.result(60)) == 8
        counts.append(bat.preemptions)
    assert counts[0] == counts[1] and counts[0] > 0


def test_resume_extension_is_contiguous(tiny4):
    """The resumed prompt's generated rows follow its own directly: with 3
    generated tokens (13 pad rows in their bucket) and the window of 8
    reaching back into the prompt, the next token is still the
    uninterrupted stream's, and the last position is n - 1 (0-indexed)."""
    _, _, eng, mm = tiny4
    pix = _pixels(11, 1)
    prompt = mm.build_mm_prompt([5, 9, 11, 3, 17], bos_id=2)
    want = mm.generate([prompt], pix[None], max_new_tokens=8, bucket=16)[0]
    n_gen = 3
    bat = ContinuousBatcher(eng, batch_slots=2, max_seq_len=64, chunk=4, mm_engine=mm)
    pix_t = torch.from_numpy(pix)
    req = _Request(list(prompt), 8, 0.0, 0, Future(), eos_id=-1, tokens=list(want[:n_gen]),
                   pixel_values=pix_t, pix_digest=_pixel_digest(pix_t))
    prompt_eff = list(prompt) + list(want[:n_gen])
    s = max(((len(prompt_eff) + bat.bucket - 1) // bat.bucket) * bat.bucket, bat.bucket)
    assert s - len(prompt_eff) > 0
    _, _, logits, last_pos = bat._full_prefill(req, prompt_eff, s)
    assert int(torch.argmax(logits)) == want[n_gen]
    assert last_pos == len(prompt_eff) - 1


def _both(tiny4, kw, run):
    """``run(batcher, mm)`` on the port's paged batcher and on JAX's with
    the same arguments -> (port result, JAX result, port counters, JAX
    counters)."""
    jeng, jmm, eng, mm = tiny4
    out = []
    for cls, e, m in ((PagedContinuousBatcher, eng, mm), (JPaged, jeng, jmm)):
        bat = cls(e, mm_engine=m, **kw)
        res = run(bat, m)
        out.append((res, (bat.prefix_cache_hits, bat.prefix_prefill_hits)))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def test_prefix_caching_shares_the_image_prefix(tiny4):
    """Three questions over one image and preamble share the prefix pages
    (the span-crossing one too) and prefill only their tails; streams equal
    the isolated engine's, counters equal JAX's."""
    _, _, _, mm = tiny4
    pix = _pixels(7, 1)
    base = mm.build_mm_prompt([5, 9, 11, 3, 17, 8, 2], bos_id=2)      # 12 tokens, 3 pages
    prompts = [base + [40, 41], base + [50], base + [33, 34, 35]]
    want = [mm.generate([p], pix[None], max_new_tokens=6, bucket=16)[0] for p in prompts]

    def run(bat, m):
        futs = [bat.submit(p, max_new_tokens=6, pixel_values=pix) for p in prompts]
        bat.drain()
        return [f.result(60) for f in futs]

    got, jgot, counts, jcounts = _both(tiny4, dict(batch_slots=3, max_seq_len=64, chunk=3,
                                                   page_size=4, prefix_caching=True), run)
    assert got == want == jgot
    assert counts == jcounts and counts[0] >= 4 and counts[1] >= 1


@pytest.mark.parametrize("marks", [True, False])
def test_prefix_caching_of_several_images_needs_their_markers(tiny4, marks):
    """Two questions over the same two images. With ``<start_of_image>`` and
    ``<end_of_image>`` around each image (the chat template's layout), each
    span has ``mm_tokens_per_image`` tokens and the second question shares
    the image pages and prefills its tail alone; without them the two spans
    are one run of 8, which the span check refuses in both packages. Streams
    equal the isolated engine's, counters JAX's."""
    _, _, _, mm = tiny4
    pix = _pixels(12, 2)
    kw = dict(boi_id=61, eoi_id=62) if marks else {}
    base = mm.build_mm_prompt([5, 9, 11, 3, 17, 8, 2], bos_id=2, n_images=2, **kw)
    prompts = [base + [40, 41], base + [50]]
    want = [mm.generate([p], pix[None], max_new_tokens=6, bucket=16)[0] for p in prompts]

    def run(bat, m):
        futs = [bat.submit(p, max_new_tokens=6, pixel_values=pix) for p in prompts]
        bat.drain()
        return [f.result(60) for f in futs]

    got, jgot, counts, jcounts = _both(tiny4, dict(batch_slots=2, max_seq_len=64, chunk=3,
                                                   page_size=4, prefix_caching=True), run)
    assert got == want == jgot and counts == jcounts
    assert (counts[1] == 1 and counts[0] >= 4) if marks else counts == (0, 0)


def test_can_admit_counts_live_prefix_reuse(tiny4):
    """A request sharing a live request's image prefix needs only its
    remainder from the pool (3 cached pages + 1 fresh of 2 free); another
    image shares nothing (4 fresh > 2). As JAX, keyed by each package's
    own pixel digest."""
    _, _, eng, mm = tiny4
    pix = _pixels(9, 1)
    base = mm.build_mm_prompt([5, 9, 11, 3, 17, 8, 2], bos_id=2)
    p2 = list(base) + [50]
    results = []
    for bat, digest in (
            (PagedContinuousBatcher(eng, batch_slots=2, max_seq_len=64, chunk=3, page_size=4,
                                    pool_pages=7, mm_engine=mm, prefix_caching=True),
             _pixel_digest(torch.from_numpy(pix))),
            (JPaged(tiny4[0], batch_slots=2, max_seq_len=64, chunk=3, page_size=4,
                    pool_pages=7, mm_engine=tiny4[1], prefix_caching=True),
             hashlib.sha1(np.ascontiguousarray(pix).tobytes()).hexdigest())):
        f1 = bat.submit(base + [40, 41], max_new_tokens=6, pixel_values=pix)
        with bat._lock:
            bat._admit()
        assert any(r is not None for r in bat._slots)
        results.append((bat._can_admit(16, len(p2), 2, tokens=p2, mm=True, ctx=digest),
                        bat._can_admit(16, len(p2), 2, tokens=p2, mm=True, ctx="other")))
        bat.drain()
        f1.result(30)
    assert results == [(True, False), (True, False)]


def test_prefix_caching_different_images_never_alias(tiny4):
    """The digest is in the chain root: the same tokens with other pixels
    reuse no page."""
    _, _, _, mm = tiny4
    pix_a, pix_b = _pixels(8, 1), _pixels(18, 1)
    prompt = mm.build_mm_prompt([5, 9, 11, 3, 17, 8, 2], bos_id=2) + [40]
    want_b = mm.generate([prompt], pix_b[None], max_new_tokens=6, bucket=16)[0]

    def run(bat, m):
        fa = bat.submit(prompt, max_new_tokens=6, pixel_values=pix_a)
        bat.drain()
        after_a = bat.prefix_cache_hits
        fb = bat.submit(prompt, max_new_tokens=6, pixel_values=pix_b)
        bat.drain()
        fa.result(60)
        return fb.result(60), bat.prefix_cache_hits - after_a

    got, jgot, counts, jcounts = _both(tiny4, dict(batch_slots=2, max_seq_len=64, chunk=3,
                                                   page_size=4, prefix_caching=True), run)
    assert got == jgot == (want_b, 0) and counts == jcounts


def test_prefix_caching_malformed_span_is_disabled(tiny4):
    """A truncated image run (3 tokens, not 4) neither registers nor reuses
    pages, and still decodes as the isolated engine does."""
    _, _, _, mm = tiny4
    pix = _pixels(9, 1)
    bad = [2] + [mm.cfg.image_token_id] * 3 + [5, 9, 11, 3, 17]
    want = [mm.generate([bad + [t]], pix[None], max_new_tokens=5, bucket=16)[0]
            for t in (40, 50)]

    def run(bat, m):
        futs = [bat.submit(bad + [t], max_new_tokens=5, pixel_values=pix) for t in (40, 50)]
        bat.drain()
        return [f.result(60) for f in futs]

    got, jgot, counts, jcounts = _both(tiny4, dict(batch_slots=2, max_seq_len=64, chunk=3,
                                                   page_size=4, prefix_caching=True), run)
    assert got == want and counts == jcounts == (0, 0)
    assert len(jgot) == 2


def test_paligemma_prompts_still_never_share():
    """PaliGemma's bidirectional prefix keeps its image prompts out of
    sharing with prefix caching on, in both packages."""
    from multimodal_colpali_tpu.generation.engine import PaliGemmaEngine as JPali
    from multimodal_colpali_tpu.models.colpali import ColPaliModel as JColPali
    from multimodal_colpali_tpu.models.configs import ColPaliModelConfig as JColCfg
    from multimodal_colpali_tpu_torch.generation import PaliGemmaEngine
    from multimodal_colpali_tpu_torch.models.colpali import ColPaliModel
    from multimodal_colpali_tpu_torch.models.configs import ColPaliModelConfig
    from multimodal_colpali_tpu_torch.models.convert import (
        engine_params_from_state_dict, params_from_flax)

    jcfg = JColCfg.tiny(vocab_size=64)
    params = jax.tree.map(np.asarray, JR.fast_random_params(JColPali(jcfg), jcfg, seed=3))
    cfg = ColPaliModelConfig.tiny(vocab_size=64)
    model = ColPaliModel(cfg, device="cpu", dtype=torch.float32).eval()
    model.load_state_dict(params_from_flax(params, cfg))
    eng = GemmaDecodeEngine(cfg.text, engine_params_from_state_dict(model.state_dict()),
                            device="cpu")
    mm = PaliGemmaEngine(model, lm=eng)
    assert (mm.first_position, mm.shares_prefix_pages) == (1, False)
    jparams = jax.tree.map(jnp.asarray, params)
    pix = _pixels(10, 1)
    prompt = mm.build_mm_prompt([5, 9, 11, 3], bos_id=2)
    for bat in (PagedContinuousBatcher(eng, batch_slots=2, max_seq_len=64, chunk=3, page_size=4,
                                       mm_engine=mm, prefix_caching=True),
                JPaged(JEngine(jcfg.text, jparams), batch_slots=2, max_seq_len=64, chunk=3,
                       page_size=4, mm_engine=JPali(jcfg, jparams), prefix_caching=True)):
        futs = [bat.submit(prompt + [t], max_new_tokens=5, pixel_values=pix) for t in (40, 50)]
        bat.drain()
        for f in futs:
            f.result(60)
        assert (bat.prefix_cache_hits, bat.prefix_prefill_hits) == (0, 0)


# -- the server and serve.build ---------------------------------------------------------------

MCQ = {"type": "json_schema", "json_schema": {"name": "mcq", "schema": {
    "type": "object", "properties": {"answer": {"type": "string",
                                                "enum": ["A", "B", "C", "D"]}}}}}


def _ask(base_url, body):
    req = urllib.request.Request(base_url + "/chat/completions", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())["choices"][0]["message"]["content"]


def _data_url(seed, size=40):
    import base64
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _image_body(n_images, **kw):
    parts = [{"type": "text", "text": "what does the figure show?"}]
    parts += [{"type": "image_url", "image_url": {"url": _data_url(s)}} for s in range(n_images)]
    return {"model": "tiny", "messages": [{"role": "user", "content": parts}], **kw}


def test_server_answers_images_as_the_jax_server(tiny4):
    """1- and 2-image requests and an MCQ over two images get the JAX
    server's replies through the port's paged batcher with prefix caching
    and through the bare engines; the images condition the answer."""
    jeng, jmm, eng, mm = tiny4
    tok, jtok = ModuloTokenizer(64), JModTok(64)
    bodies = [_image_body(1, max_tokens=6), _image_body(2, max_tokens=5),
              _image_body(2, response_format=MCQ)]
    jbat = JDense(jeng, batch_slots=2, max_seq_len=256, chunk=4, mm_engine=jmm).serve()
    try:
        with JServer(jbat, jtok, mm_engine=jmm, image_preprocessor=JPre(28)) as srv:
            want = [_ask(srv.base_url, b) for b in bodies]
    finally:
        jbat.shutdown()
    assert json.loads(want[2])["answer"] in "ABCD"
    pre = ImagePreprocessor(28)
    bat = PagedContinuousBatcher(eng, batch_slots=2, max_seq_len=256, chunk=4, page_size=4,
                                 mm_engine=mm, prefix_caching=True).serve()
    try:
        with GenerationServer(bat, tok, mm_engine=mm, image_preprocessor=pre) as srv:
            assert [_ask(srv.base_url, b) for b in bodies] == want
    finally:
        bat.shutdown()
    with GenerationServer(eng, tok, mm_engine=mm, image_preprocessor=pre) as srv:
        assert [_ask(srv.base_url, b) for b in bodies] == want
        text_only = {"model": "tiny", "max_tokens": 6, "messages": [
            {"role": "user", "content": "what does the figure show?"}]}
        assert _ask(srv.base_url, text_only) != want[0]


def test_serve_builds_the_image_engine_for_gemma3(monkeypatch):
    """serve.build loads a Gemma-3 name with a multimodal config through
    ``load_gemma3_mm`` and gives its text engine a ``Gemma3MMEngine`` on the
    same LM (07_serve.py:218-245), also under int8 weights; pixels from its
    preprocessor condition a batcher's stream as the engine's."""
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    for wd in ("native", "int8"):
        args = serve.parse_args(["--model", "tiny-gemma3", "--device", "cpu", "--dtype",
                                 "float32", "--weight-dtype", wd])
        assert args.vision_dtype == "native"
        with pytest.warns(UserWarning, match="random init"):
            eng, tok, mm, pre = serve.build(args)
        assert isinstance(mm, Gemma3MMEngine) and mm.lm is eng and eng.weight_dtype == wd
        assert isinstance(pre, ImagePreprocessor) and pre.image_size == 28
        pix = pre([np.full((28, 28, 3), 200, np.uint8)])
        ids = mm.build_mm_prompt(tok.encode("hi"), bos_id=tok.bos_id)
        bat = PagedContinuousBatcher(eng, batch_slots=2, max_seq_len=64, mm_engine=mm,
                                     prefix_caching=True)
        assert bat.generate([ids], max_new_tokens=4, pixel_values=[pix]) == \
            mm.generate([ids], pix[None], max_new_tokens=4)


def test_serve_refuses_vision_int8_before_loading(monkeypatch):
    """int8 is a vision dtype now (``serve.build`` loads and quantizes the
    tower); a dtype the server does not know is refused by the argument
    parser, before anything loads."""
    def boom(*a, **k):
        raise AssertionError("loaded before refusing")

    monkeypatch.setattr(TR, "load_gemma3_mm", boom)
    args = serve.parse_args(["--model", "tiny-gemma3", "--device", "cpu", "--vision-dtype",
                             "int8"])
    assert args.vision_dtype == "int8"
    with pytest.raises(AssertionError, match="loaded before refusing"):
        serve.build(args)                   # int8 goes on to load
    with pytest.raises(SystemExit):
        serve.parse_args(["--model", "tiny-gemma3", "--vision-dtype", "int4"])


def test_gemma3_1b_is_served_as_text_where_jax_raises(monkeypatch):
    """gemma-3-1b is text-only upstream and has no multimodal config: JAX's
    07 calls ``load_gemma3_mm``, which raises ``KeyError``; the port serves
    it as text, with no image engine (a deliberate difference, ROADMAP §3).
    The 1b's weights are swapped for the tiny LM's to keep this small."""
    with pytest.raises(KeyError):
        JR.load_gemma3_mm("gemma-3-1b")
    with pytest.raises(KeyError):
        TR.load_gemma3_mm("gemma-3-1b", device="cpu")
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    monkeypatch.setitem(TR.GEMMA3_CONFIGS, "gemma-3-1b", Gemma3TextConfig.tiny)
    args = serve.parse_args(["--model", "gemma-3-1b", "--device", "cpu", "--dtype", "float32"])
    with pytest.warns(UserWarning, match="random init"):
        eng, tok, mm, pre = serve.build(args)
    assert (mm, pre) == (None, None) and eng.cfg == Gemma3TextConfig.tiny()


def test_load_gemma3_mm_without_a_checkpoint_in_both_packages(tmp_path, monkeypatch):
    """No checkpoint found: both registries warn and random-init, the port's
    tower by JAX's fill rule (LayerNorm weights 1, biases 0), its projector
    norm 0; quantized LM formats are made leaf by leaf."""
    monkeypatch.setenv("COLPALI_TPU_CKPT_DIR", str(tmp_path))
    with pytest.warns(UserWarning, match="random init"):
        jcfg, jparams, jtok = JR.load_gemma3_mm("tiny-gemma3")
    with pytest.warns(UserWarning, match="random init"):
        cfg, params, tok = TR.load_gemma3_mm("tiny-gemma3", device="cpu", dtype=torch.float32)
    assert tok is None and jtok is None
    tower = params["vision_tower"]
    assert isinstance(tower, SiglipVisionTower)
    assert torch.equal(tower.layers[0].layer_norm1.weight, torch.ones(32))
    assert torch.equal(tower.layers[0].self_attn.q_proj.bias, torch.zeros(32))
    proj = params["multi_modal_projector"]
    assert torch.equal(proj["mm_soft_emb_norm"]["weight"], torch.zeros(32))
    assert proj["mm_input_projection"].shape == \
        np.asarray(jparams["multi_modal_projector"]["mm_input_projection"]).shape
    assert abs(float(proj["mm_input_projection"].std()) - 32 ** -0.5) < 0.05
    assert params["embed"]["embed_tokens"].shape == \
        np.asarray(jparams["embed"]["embed_tokens"]).shape
    with pytest.warns(UserWarning, match="random init"):
        _, q, _ = TR.load_gemma3_mm("tiny-gemma3", device="cpu", weight_dtype="int4")
    assert GemmaDecodeEngine(cfg.text, {k: q[k] for k in ("embed", "language_model")},
                             device="cpu").weight_dtype == "int4"
    with pytest.raises(ValueError):
        TR.load_gemma3_mm("tiny-gemma3", device="cpu", weight_dtype="fp8")
