"""The port's Llama-3.2-Vision (Mllama) model and image engine
(``models/mllama``, ``generation/mllama_mm``, the registry, the converters and
llama3 rope scaling) against the JAX package's, on the CPU.

JAX's tiny random parameters (``mllama_random_params``, seed 2: gates 0.25,
so every cross block and gated embedding does something) are carried over
with ``convert.mllama_params_from_jax``; both packages run in float32. The
tiled tower agrees within rtol 1e-5 / atol 1e-5 at the 1x1 and a 2-tile
layout (float32 sums in another order than XLA's: 3.9e-6 at most); the query-blocked attention equals the unblocked one and JAX's
``blocked_masked_attention`` within 1e-6; prefill logits within rtol 1e-4 /
atol 1e-5 for text alone, one image, two images and a leading BOS; greedy
streams are token-identical to JAX's ``generate`` for native, int8 and int4
weights, also through both plain batchers, and the quantized trees equal
JAX's eager quantizer byte for byte.
The preprocessor equals JAX's Pillow path within 1e-6 with Pillow refused,
llama3's ``inv_freq`` equals JAX's exactly, and the HF converter's tree
equals JAX's leaf for leaf on a tiny ``MllamaForConditionalGeneration``.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_colpali_tpu.generation.engine import LlamaDecodeEngine as JText
from multimodal_colpali_tpu.generation.mllama_mm import MllamaImagePreprocessor as JPre
from multimodal_colpali_tpu.generation.mllama_mm import MllamaMMEngine as JMM
from multimodal_colpali_tpu.models import hf_import as JH
from multimodal_colpali_tpu.models import registry as JR
from multimodal_colpali_tpu.models.mllama import MllamaVisionTower as JTower
from multimodal_colpali_tpu.models.mllama import blocked_masked_attention as j_blocked
from multimodal_colpali_tpu.ops import quant as JQ
from multimodal_colpali_tpu_torch.generation.engine import LlamaDecodeEngine
from multimodal_colpali_tpu_torch.generation.mllama_mm import (
    MllamaImagePreprocessor, MllamaMMEngine)
from multimodal_colpali_tpu_torch.generation.paged import PagedContinuousBatcher
from multimodal_colpali_tpu_torch.generation.scheduler import ContinuousBatcher
from multimodal_colpali_tpu_torch.models import hf_import as TH
from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.models import registry as TR
from multimodal_colpali_tpu_torch.models.convert import mllama_params_from_jax
from multimodal_colpali_tpu_torch.models.mllama import (
    MllamaVisionTower, blocked_masked_attention, gqa_attention)
from multimodal_colpali_tpu_torch.ops.quant import is_quantized, is_quantized_int4

torch.set_num_threads(1)

TEXT = [40, 2, 7]


def jax_params(seed: int = 2):
    cfg = JR.MLLAMA_CONFIGS["tiny-mllama"]()
    return cfg, jax.tree.map(np.asarray, JR.mllama_random_params(cfg, seed=seed))


def jax_quantized(params, fmt: str):
    """JAX's eager quantizers over the LM and the cross layers' kernels."""
    q = JQ.quantize_lm_params(params) if fmt == "int8" else JQ.quantize_lm_params_int4(params)

    def leaf(w):
        g = JQ._int4_group_for(w.shape[0], 256) if fmt == "int4" else 0
        return JQ.quantize_int4(w, group=g) if g else JQ.quantize_int8(w, axis=0)

    def walk(t):
        return {k: (leaf(jnp.asarray(v)) if k == "kernel" else walk(v)) if isinstance(v, dict)
                or k == "kernel" else v for k, v in t.items()}

    q = dict(q)
    q["cross_layers"] = walk(params["cross_layers"])
    return jax.tree.map(np.asarray, q)


def build(params, fmt: str = "native", tiles=(1, 1)):
    """(port text engine, port image engine) over a JAX tree (float32)."""
    tcfg = TR.MLLAMA_CONFIGS["tiny-mllama"]()
    lm_tree, tower_state, projector, cross = mllama_params_from_jax(params, tcfg, device="cpu")
    tower = MllamaVisionTower(tcfg.vision, device="cpu", dtype=torch.float32)
    tower.load_state_dict(tower_state)
    lm = LlamaDecodeEngine(tcfg.text, lm_tree, dtype=torch.float32, weight_dtype=fmt,
                           device="cpu")
    return lm, MllamaMMEngine(tcfg, tower.eval(), projector, cross, lm, tiles=tiles)


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX params, JAX text engine, JAX image engine, port text, port image)."""
    cfg, params = jax_params()
    jp = jax.tree.map(jnp.asarray, params)
    lm, mm = build(params)
    return (cfg, params, JText(cfg.text, jp, dtype=jnp.float32),
            JMM(cfg, jp, dtype=jnp.float32), lm, mm)


def images(cfg, seed: int, n: int, n_tiles: int = 1) -> np.ndarray:
    """``[N, T, H, W, 3]`` tile stacks, slots past ``n_tiles`` zero."""
    sz, t = cfg.vision.image_size, cfg.vision.max_num_tiles
    pix = np.zeros((n, t, sz, sz, 3), np.float32)
    pix[:, :n_tiles] = np.random.default_rng(seed).standard_normal((n, n_tiles, sz, sz, 3))
    return pix


# -- configs and the tower ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["llama-3.2-11b-vision", "tiny-mllama",
                                  "AdaptLLM/biomed-Llama-3.2-11B-Vision-Instruct"])
def test_configs_equal_jax(name):
    j, t = JR.MLLAMA_CONFIGS[name](), TR.MLLAMA_CONFIGS[name]()
    assert dataclasses.asdict(t.vision) == dataclasses.asdict(j.vision)
    assert dataclasses.asdict(t.text) == dataclasses.asdict(j.text)
    assert (t.cross_attention_layers, t.image_token_id, t.cross_schedule, t.total_layers) == \
        (j.cross_attention_layers, j.image_token_id, j.cross_schedule, j.total_layers)
    v = t.vision
    assert (v.supported_aspect_ratios, v.num_patches_padded, v.output_dim) == \
        (j.vision.supported_aspect_ratios, j.vision.num_patches_padded, j.vision.output_dim)
    if name != "tiny-mllama":
        assert t.total_layers == 40 and v.output_dim == 7680 and v.num_patches == 1601
        assert t.text.rope_llama3 == (8.0, 1.0, 4.0, 8192) and v.num_patches_padded == 1608


@pytest.mark.parametrize("n_tiles,ar_id", [(1, 1), (2, 3)], ids=["1x1", "2x1"])
def test_vision_tower_matches_jax(pair, n_tiles, ar_id):
    cfg, params, _, _, _, mm = pair
    t = cfg.vision.max_num_tiles
    pix = images(cfg, 10 + n_tiles, 2, n_tiles)
    ids = np.full((2,), ar_id, np.int32)
    ar_mask = np.zeros((2, t), np.int32)
    ar_mask[:, :n_tiles] = 1
    want = JTower(cfg.vision).apply(
        {"params": jax.tree.map(jnp.asarray, params["vision_tower"])},
        jnp.asarray(pix), jnp.asarray(ids), jnp.asarray(ar_mask))
    got = mm.vision_tower(torch.from_numpy(pix), torch.from_numpy(ids), torch.from_numpy(ar_mask))
    assert got.shape == (2, t * cfg.vision.num_patches, cfg.vision.output_dim)
    # float32 sums in another order: up to 3.9e-6 apart on outputs of up to 5.8
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_blocked_attention_matches_unblocked_and_jax():
    rng = np.random.default_rng(9)
    b, n, h, d = 2, 300, 3, 8
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(3))
    mask = rng.random((b, 1, n, n)) < 0.8
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    whole = L.attention(tq, tk, tv, mask=tm, scale=d ** -0.5)
    got = blocked_masked_attention(tq, tk, tv, tm, scale=d ** -0.5, block=128)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)
    want = j_blocked(*(jnp.asarray(a) for a in (q, k, v, mask)), scale=d ** -0.5, block=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # a mask broadcast over the query rows, as the decode hooks pass it
    row = torch.from_numpy(rng.random((b, 1, 1, n)) < 0.8)
    np.testing.assert_allclose(
        blocked_masked_attention(tq, tk, tv, row, scale=d ** -0.5, block=128).numpy(),
        L.attention(tq, tk, tv, mask=row, scale=d ** -0.5).numpy(), rtol=1e-6, atol=1e-6)


def test_gqa_attention_folds_the_group_into_query_rows():
    """The cross-attention core: no K/V repeat, the repeated einsum's result."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 5, 8, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 40, 2, 16)).astype(np.float32))
            for _ in range(2))
    mask = torch.from_numpy(rng.random((2, 1, 5, 40)) < 0.7)
    want = L.attention(q, k, v, mask=mask, scale=0.25)
    for block in (None, 2):
        got = gqa_attention(q, k, v, mask, 0.25, block=block)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    # a mask broadcast over the query rows, as the decode hooks pass it
    got = gqa_attention(q, k, v, mask[:, :, :1], 0.25)
    np.testing.assert_allclose(got.numpy(), L.attention(q, k, v, mask=mask[:, :, :1],
                                                        scale=0.25).numpy(), rtol=1e-6,
                               atol=1e-6)


# -- preprocessing and rope ------------------------------------------------------------------

class _RefusePIL:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "PIL":
            raise ImportError(f"refused: {name}")


@pytest.mark.parametrize("tiles", [(1, 1), (2, 1), (1, 2)], ids=["1x1", "2x1", "1x2"])
def test_preprocessor_equals_jax_s_pillow_without_pillow(tiles, monkeypatch):
    from PIL import Image

    cfg = JR.MLLAMA_CONFIGS["tiny-mllama"]()
    rng = np.random.default_rng(7)
    arrays = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in ((40, 50), (28, 28), (90, 31), (56, 28))]
    want = JPre(cfg, tiles=tiles)([Image.fromarray(a) for a in arrays])
    monkeypatch.setattr(sys, "meta_path", [_RefusePIL(), *sys.meta_path])
    for name in [m for m in sys.modules if m.split(".")[0] == "PIL"]:
        monkeypatch.delitem(sys.modules, name)
    tcfg = TR.MLLAMA_CONFIGS["tiny-mllama"]()
    got = MllamaImagePreprocessor(tcfg, tiles=tiles)(arrays)
    assert got.shape == want.shape == (4, 2, 28, 28, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got_t = MllamaImagePreprocessor(tcfg, tiles=tiles, device="cpu")(
        [torch.from_numpy(a) for a in arrays])
    np.testing.assert_allclose(got_t, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="aspect"):
        MllamaImagePreprocessor(tcfg, tiles=(2, 2))


def test_llama3_inv_freq_equals_jax_and_plain_rope_is_unchanged():
    from multimodal_colpali_tpu.models import qwen2vl as JQV
    from multimodal_colpali_tpu.models.idefics3 import LlamaTextConfig as JCfg
    from multimodal_colpali_tpu_torch.models import qwen2vl as TQV
    from multimodal_colpali_tpu_torch.models.configs import LlamaTextConfig, LlavaNextMMConfig

    for theta, hd, scaling in ((500_000.0, 128, (8.0, 1.0, 4.0, 8192)),
                               (10_000.0, 12, (8.0, 1.0, 4.0, 16))):
        half = hd // 2
        inv = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
        got = TQV.llama3_inv_freq(inv, scaling)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, JQV._llama3_inv_freq(inv, scaling))
    assert LlavaNextMMConfig.llava_next_llama3_8b().text.rope_llama3 is None
    pos = np.arange(0, 40_000, 997, dtype=np.int64)[None]
    for scaling in (None, (8.0, 1.0, 4.0, 8192)):
        tcfg = dataclasses.replace(LlamaTextConfig.llama3_8b(), rope_llama3=scaling)
        jcfg = dataclasses.replace(JCfg.llama3_8b(), rope_llama3=scaling)
        p3 = np.broadcast_to(pos, (3,) + pos.shape)
        got = TQV.mrope_cos_sin(tcfg, torch.from_numpy(p3.copy()))
        want = JQV.mrope_cos_sin(jcfg, jnp.asarray(p3))
        for g, w in zip(got, want):     # cos / sin of equal angles, another libm
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_llama3_scaled_llama_streams_equal_jax():
    """The Llama body with rope_llama3 past ``original_max_position_embeddings``
    (the divided band in play) against JAX's ``LlamaDecodeEngine``."""
    from multimodal_colpali_tpu.models.idefics3 import LlamaTextConfig as JCfg
    from multimodal_colpali_tpu_torch.models.configs import LlamaTextConfig
    from multimodal_colpali_tpu_torch.models.convert import engine_params_from_jax

    scaling = (8.0, 1.0, 4.0, 16)
    jcfg = dataclasses.replace(JCfg.tiny_lm(vocab_size=64), rope_llama3=scaling,
                               tie_word_embeddings=False)
    tcfg = dataclasses.replace(LlamaTextConfig.tiny_lm(vocab_size=64), rope_llama3=scaling,
                               tie_word_embeddings=False)
    params = jax.tree.map(np.asarray, JR.qwen2vl_random_params(jcfg, 4))
    prompt = [int(x) for x in np.random.default_rng(4).integers(2, 60, size=40)]
    want = JText(jcfg, jax.tree.map(jnp.asarray, params), dtype=jnp.float32).generate(
        [prompt], max_new_tokens=8)
    lm = LlamaDecodeEngine(tcfg, engine_params_from_jax(params, device="cpu"),
                           dtype=torch.float32, device="cpu")
    assert lm.generate([prompt], max_new_tokens=8) == want


# -- the engine ------------------------------------------------------------------------------

PROMPTS = {
    "text-only": lambda mm: [5, 9, 11, 3, 8],
    "one-image": lambda mm: mm.build_mm_prompt([5, 9, 11, 3]),
    "two-images": lambda mm: mm.build_mm_prompt([7, 3, 12], n_images=2),
    "leading-bos": lambda mm: mm.build_mm_prompt([5, 9, 11], bos_id=1),
}


@pytest.mark.parametrize("case", list(PROMPTS))
def test_prefill_logits_match_jax(pair, case):
    cfg, _, _, jmm, _, mm = pair
    prompt = PROMPTS[case](mm)
    n = 2 if case == "two-images" else 1
    pix = images(cfg, 20 + n, n)[None]
    np.testing.assert_allclose(mm.next_token_logits([prompt], pix),
                               jmm.next_token_logits([prompt], pix), rtol=1e-4, atol=1e-5)


def test_cross_masks_match_hf_s_processor(pair):
    """``_cross_masks`` against HF's ``get_cross_attention_token_mask`` and its
    dense form: a row that attends an image attends exactly HF's tiles; a row
    that attends none (HF's zero row) keeps uniform attention over every key
    and a zeroed MLP."""
    from transformers.models.mllama.processing_mllama import (
        convert_sparse_cross_attention_mask_to_dense, get_cross_attention_token_mask)

    cfg, _, _, _, _, mm = pair
    img = cfg.image_token_id
    c = cfg.vision
    for prompt in ([1, img, 5, 9, img, 3, 4], [1, 7, img, img, 5, 6], [img, 2, 3]):
        n_img = prompt.count(img)
        spans = get_cross_attention_token_mask(list(prompt), img)
        dense = np.asarray(convert_sparse_cross_attention_mask_to_dense(
            [spans], num_tiles=[[1] * len(spans)], max_num_tiles=c.max_num_tiles,
            length=len(prompt)))[0]                                  # [S, N, T]
        ids = torch.tensor([prompt])
        keys, full_row = mm._cross_masks(ids, torch.ones_like(ids), n_img)
        keys = keys[0, 0].reshape(len(prompt), n_img, c.max_num_tiles, c.num_patches)
        attends = dense.any(axis=(1, 2))
        np.testing.assert_array_equal(full_row[0, :, 0].numpy(), attends.astype(np.float32))
        for s in range(len(prompt)):
            if attends[s]:
                np.testing.assert_array_equal(keys[s].all(dim=-1).numpy(), dense[s] == 1)
                assert not keys[s].any(dim=-1).numpy()[dense[s] == 0].any()
            else:
                assert bool(keys[s].all())


def test_jax_keeps_earlier_images_past_a_later_marker(pair):
    """F9: with markers that are not one run (``[bos, img, 5, 9, img, 3]``),
    HF's span of image 0 ends where image 1's marker starts; JAX's mask
    keeps image 0 for every later token. The port follows HF; on
    ``build_mm_prompt``'s layout (one run) the two agree."""
    cfg, _, _, jmm, _, mm = pair
    img = cfg.image_token_id
    prompt = [1, img, 5, 9, img, 3]
    ids = np.asarray([prompt])
    jkeys, _ = jmm._cross_masks(jnp.asarray(ids), jnp.ones_like(jnp.asarray(ids)), 2)
    tkeys, _ = mm._cross_masks(torch.from_numpy(ids), torch.ones(ids.shape, dtype=torch.long), 2)
    per = cfg.vision.max_num_tiles * cfg.vision.num_patches
    j0 = np.asarray(jkeys)[0, 0, :, :per].any(axis=-1)
    t0 = tkeys[0, 0, :, :per].any(dim=-1).numpy()
    assert j0.tolist() == [True, True, True, True, True, True]    # row 0: uniform
    assert t0.tolist() == [True, True, True, True, False, False]
    one_run = np.asarray([mm.build_mm_prompt([5, 9], bos_id=1, n_images=3)])
    a, fa = jmm._cross_masks(jnp.asarray(one_run), jnp.ones_like(jnp.asarray(one_run)), 3)
    b, fb = mm._cross_masks(torch.from_numpy(one_run), torch.ones(one_run.shape,
                                                                 dtype=torch.long), 3)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(fb.numpy(), np.asarray(fa))


@pytest.mark.parametrize("fmt", ["native", "int8", "int4"])
def test_greedy_streams_equal_jax_for_every_weight_format(pair, fmt):
    cfg, params, _, jmm, _, mm = pair
    if fmt != "native":
        jq = jax_quantized(params, fmt)
        jmm = JMM(cfg, jax.tree.map(jnp.asarray, jq), dtype=jnp.float32)
        lm, mm = build(params, fmt)
        assert lm.weight_dtype == fmt
        # the port's quantized trees are JAX's eager quantizer's bytes
        got = dict(TR.tree_leaves({"embed": lm.params["embed"],
                                   "language_model": lm.params["language_model"],
                                   "cross_layers": mm.cross_params}))
        want = dict(TR.tree_leaves({k: jq[k] for k in ("embed", "language_model",
                                                       "cross_layers")}))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=str(k))
        q = mm.cross_params[str(cfg.cross_attention_layers[0])]["cross_attn"]["q_proj"]["kernel"]
        assert (is_quantized_int4 if fmt == "int4" else is_quantized)(q)
    reqs = []
    for n_img, prompt in ((1, mm.build_mm_prompt([5, 9, 11], bos_id=1)),
                          (2, mm.build_mm_prompt([7, 3], n_images=2))):
        pix = images(cfg, 30 + n_img, n_img)[None]
        want = jmm.generate([prompt], pix, max_new_tokens=10, bucket=16)
        assert mm.generate([prompt], pix, max_new_tokens=10, bucket=16) == want
        reqs.append((prompt, pix[0], want[0]))
    # both plain batchers in the same format, the two requests side by side
    for cls, kw in ((ContinuousBatcher, {}), (PagedContinuousBatcher, {"page_size": 8})):
        bat = cls(mm.lm, batch_slots=2, max_seq_len=64, chunk=3, mm_engine=mm,
                  cross_max_images=2, **kw)
        futs = [bat.submit(p, max_new_tokens=10, pixel_values=pix) for p, pix, _ in reqs]
        bat.drain()
        assert [f.result(60) for f in futs] == [w for _, _, w in reqs]


def test_multi_tile_layout_matches_jax(pair):
    """The (2, 1) layout: two real tiles an image, pools of 2 x 5 rows."""
    cfg, params, _, _, _, _ = pair
    jmm = JMM(cfg, jax.tree.map(jnp.asarray, params), dtype=jnp.float32, tiles=(2, 1))
    _, mm = build(params, tiles=(2, 1))
    assert (mm.ar_id, mm.n_real_tiles) == (jmm.ar_id, jmm.n_real_tiles) == (3, 2)
    assert mm.packed_cross_tokens_per_image == jmm.packed_cross_tokens_per_image == 10
    assert mm.cross_tokens_per_image == jmm.cross_tokens_per_image == 10
    assert mm.tokens_per_image == jmm.tokens_per_image == 1
    pix = images(cfg, 41, 1, n_tiles=2)[None]
    prompt = mm.build_mm_prompt([5, 9, 11, 3], bos_id=1)
    np.testing.assert_allclose(mm.next_token_logits([prompt], pix),
                               jmm.next_token_logits([prompt], pix), rtol=1e-4, atol=1e-5)
    assert mm.generate([prompt], pix, max_new_tokens=8) == jmm.generate([prompt], pix,
                                                                        max_new_tokens=8)


def test_packed_cross_kv_and_the_raising_prefill(pair):
    cfg, _, _, jmm, _, mm = pair
    pix = torch.from_numpy(images(cfg, 50, 2)[None])
    ckv = mm._cross_kv(mm._cross_states(pix))
    ks, vs = mm.packed_cross_kv(ckv, 2)
    jks, jvs = jmm.packed_cross_kv({g: tuple(jnp.asarray(a.numpy()) for a in kv)
                                    for g, kv in ckv.items()}, 2)
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jks))
    np.testing.assert_array_equal(vs.numpy(), np.asarray(jvs))
    assert ks.shape == (2, 1, 2 * cfg.vision.num_patches, 1, cfg.text.head_dim)
    with pytest.raises(RuntimeError, match="cross"):
        mm.prefill(None, None, None, None, None)
    assert mm.cross_decode and not mm.shares_prefix_pages and mm.image_rank == 4


def test_vision_dtype_int8_is_w8a8_close_to_native(pair):
    cfg, params, _, _, _, _ = pair
    _, mm = build(params)
    _, mm8 = build(params)
    mm8.__init__(mm8.cfg, mm8.vision_tower, mm8.projector, mm8.cross_params, mm8.lm,
                 vision_dtype="int8")
    assert mm8.vision_tower.local_0.fc1.weight.dtype == torch.int8
    pix = torch.from_numpy(images(cfg, 60, 2)[None])
    a = mm._cross_states(pix).reshape(-1).double()
    b = mm8._cross_states(pix).reshape(-1).double()
    assert float(a @ b / (a.norm() * b.norm())) >= 0.98
    with pytest.raises(ValueError, match="vision_dtype"):
        MllamaMMEngine(mm.cfg, mm.vision_tower, mm.projector, mm.cross_params, mm.lm,
                       vision_dtype="int4")


# -- registry and converters --------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["native", "int8", "int4"])
def test_random_params_shapes_gates_and_formats(fmt, monkeypatch):
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    with pytest.warns(UserWarning, match="random init"):
        cfg, params, tok = TR.load_mllama_mm("tiny-mllama", device="cpu", dtype=torch.float32,
                                             weight_dtype=fmt)
    assert tok is None
    jcfg, jparams = jax_params(0)
    lm_keys = {k for k in params if k not in ("vision_tower", "multi_modal_projector")}
    want = {p: np.shape(v) for p, v in TR.tree_leaves({k: jparams[k] for k in lm_keys})}
    got = dict(TR.tree_leaves({k: params[k] for k in lm_keys}))
    if fmt == "native":
        assert {p: tuple(v.shape) for p, v in got.items()} == want
    else:
        assert is_quantized(params["embed"]["embed_tokens"])
    for g in cfg.cross_attention_layers:
        for gate in ("gate_attn", "gate_mlp"):
            assert float(params["cross_layers"][str(g)][gate][0]) == TR.RANDOM_GATE
    tower = params["vision_tower"]
    assert float(tower.pos_gate[0]) == float(tower.global_0.gate_ffn[0]) == TR.RANDOM_GATE
    jt = dict(TR.tree_leaves(jparams["vision_tower"]))
    assert len(jt) == len(tower.state_dict())
    lm = LlamaDecodeEngine(cfg.text, params, dtype=torch.float32, device="cpu")
    assert lm.weight_dtype == fmt
    mm = MllamaMMEngine(cfg, tower, params["multi_modal_projector"], params["cross_layers"], lm)
    pre = MllamaImagePreprocessor(cfg)
    pix = pre([np.full((40, 50, 3), 90, np.uint8)])
    out = mm.generate([mm.build_mm_prompt([3, 5], bos_id=1)], pix[None], max_new_tokens=4)
    assert len(out[0]) == 4


def _hf_cfg(cfg):
    from transformers import MllamaConfig
    from transformers.models.mllama.configuration_mllama import (
        MllamaTextConfig, MllamaVisionConfig)

    v = cfg.vision
    return MllamaConfig(
        vision_config=MllamaVisionConfig(
            hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
            num_hidden_layers=v.num_hidden_layers, num_global_layers=v.num_global_layers,
            num_attention_heads=v.attention_heads, image_size=v.image_size,
            patch_size=v.patch_size, max_num_tiles=v.max_num_tiles, norm_eps=v.norm_eps,
            intermediate_layers_indices=list(v.intermediate_layers_indices),
            supported_aspect_ratios=[[1, 1], [1, 2], [2, 1]], vision_output_dim=v.output_dim),
        text_config=MllamaTextConfig(
            vocab_size=cfg.text.vocab_size, hidden_size=cfg.text.hidden_size,
            intermediate_size=cfg.text.intermediate_size, num_hidden_layers=cfg.total_layers,
            num_attention_heads=cfg.text.num_attention_heads,
            num_key_value_heads=cfg.text.num_key_value_heads,
            cross_attention_layers=list(cfg.cross_attention_layers),
            rope_theta=cfg.text.rope_theta, rope_scaling={"rope_type": "default"},
            rms_norm_eps=cfg.text.rms_norm_eps, tie_word_embeddings=False,
            pad_token_id=0, eos_token_id=1, bos_token_id=1),
        image_token_index=cfg.image_token_id)


def test_hf_converter_equals_jax_leaf_for_leaf():
    from transformers import MllamaForConditionalGeneration

    cfg = JR.MLLAMA_CONFIGS["tiny-mllama"]()
    tcfg = TR.MLLAMA_CONFIGS["tiny-mllama"]()
    torch.manual_seed(0)
    hf = MllamaForConditionalGeneration(_hf_cfg(cfg)).eval()
    sd = hf.state_dict()
    want = dict(TR.tree_leaves(jax.tree.map(np.asarray, JH.mllama_params_from_hf(
        {k: v.clone() for k, v in sd.items()}, cfg))))
    got = dict(TR.tree_leaves(TH.mllama_params_from_hf(sd, tcfg)))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].detach().numpy(), want[k], err_msg=str(k))
    assert got[("embed", "embed_tokens")].shape[0] == cfg.text.vocab_size + 8
    # and the converted tree runs: the tower loads it by name
    lm_tree, tower_state, projector, cross = mllama_params_from_jax(
        JH.mllama_params_from_hf({k: v.clone() for k, v in sd.items()}, cfg), tcfg,
        device="cpu")
    assert set(cross) == {str(g) for g in cfg.cross_attention_layers}
    assert len(tower_state) == len(MllamaVisionTower(tcfg.vision, device="meta",
                                                     dtype=torch.float32).state_dict())


def test_checkpoint_loads_through_the_registry(tmp_path, monkeypatch):
    """``load_mllama_mm(checkpoint_dir=)`` on a tiny HF checkpoint: the tower,
    cross layers and LM as the converter gives them, int8 under weight_dtype."""
    from transformers import MllamaForConditionalGeneration

    from tests.test_torch_checkpoint import save_sharded

    cfg = TR.MLLAMA_CONFIGS["tiny-mllama"]()
    torch.manual_seed(1)
    hf = MllamaForConditionalGeneration(_hf_cfg(cfg)).eval()
    ckpt = tmp_path / "tiny-mllama"
    save_sharded(hf.state_dict(), str(ckpt))
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    cfg2, params, _ = TR.load_mllama_mm("tiny-mllama", device="cpu", dtype=torch.float32,
                                        checkpoint_dir=str(ckpt), weight_dtype="int8")
    assert cfg2 == cfg and is_quantized(params["embed"]["embed_tokens"])
    tree = TH.mllama_params_from_hf(hf.state_dict(), cfg)
    assert torch.equal(params["vision_tower"].global_1.gate_ffn,
                       tree["vision_tower"]["global_1"]["gate_ffn"])
    assert torch.equal(params["cross_layers"]["4"]["gate_mlp"], tree["cross_layers"]["4"]["gate_mlp"])
    assert is_quantized(params["cross_layers"]["1"]["mlp"]["up_proj"]["kernel"])
