"""The port's LLaVA-NeXT image generator (``models/clip.ClipFeatureTower``,
``LlavaNextMMEngine``, its preprocessor and loader) against the JAX
package's, on the CPU.

JAX's tiny random parameters (``llava_next_random_params``, seed 2) are
carried over with ``convert.llava_next_params_from_jax``; both packages run
in float32. The CLIP feature tower agrees within rtol 1e-5; prefill logits
within rtol 1e-4 / atol 1e-5 (the other image engines' bound); greedy
streams with one and two images are token-identical to JAX's ``generate``,
also through the dense, paged and speculative paged batchers beside text.
The preprocessor's pixels equal JAX's Pillow BICUBIC path with Pillow
refused on the port's side, and the int8 random model serves as JAX's does.
"""

import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_colpali_tpu.generation.engine import LlamaDecodeEngine as JText
from multimodal_colpali_tpu.generation.llava_next_mm import (
    LlavaNextImagePreprocessor as JPre)
from multimodal_colpali_tpu.generation.llava_next_mm import LlavaNextMMEngine as JMM
from multimodal_colpali_tpu.models import registry as JR
from multimodal_colpali_tpu.models.clip import ClipFeatureTower as JTower
from multimodal_colpali_tpu_torch.generation.engine import LlamaDecodeEngine
from multimodal_colpali_tpu_torch.generation.llava_next_mm import (
    LlavaNextImagePreprocessor, LlavaNextMMEngine)
from multimodal_colpali_tpu_torch.generation.paged import PagedContinuousBatcher
from multimodal_colpali_tpu_torch.generation.scheduler import ContinuousBatcher
from multimodal_colpali_tpu_torch.generation.speculative import (
    SpeculativePagedContinuousBatcher)
from multimodal_colpali_tpu_torch.models import registry as TR
from multimodal_colpali_tpu_torch.models.clip import ClipFeatureTower
from multimodal_colpali_tpu_torch.models.convert import llava_next_params_from_jax
from multimodal_colpali_tpu_torch.ops.quant import is_quantized

torch.set_num_threads(1)

TEXT = [40, 2, 7]


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX params, JAX text engine, JAX image engine, port text, port image)."""
    cfg = JR.LLAVA_NEXT_CONFIGS["tiny-llava-next"]()
    tcfg = TR.LLAVA_NEXT_CONFIGS["tiny-llava-next"]()
    params = jax.tree.map(np.asarray, JR.llava_next_random_params(cfg, seed=2))
    jp = jax.tree.map(jnp.asarray, params)
    lm_tree, tower_state, projector = llava_next_params_from_jax(params, tcfg, device="cpu")
    tower = ClipFeatureTower(tcfg.vision, tcfg.vision_feature_layer, device="cpu",
                             dtype=torch.float32)
    tower.load_state_dict(tower_state)
    lm = LlamaDecodeEngine(tcfg.text, lm_tree, dtype=torch.float32, device="cpu")
    return (tcfg, params, JText(cfg.text, jp, dtype=jnp.float32),
            JMM(cfg, jp, dtype=jnp.float32), lm,
            LlavaNextMMEngine(tcfg, tower.eval(), projector, lm))


def images(cfg, seed: int, n: int) -> np.ndarray:
    sz = cfg.vision.image_size
    return np.random.default_rng(seed).standard_normal((n, sz, sz, 3)).astype(np.float32)


def test_tokens_per_image_and_layer_cut(pair):
    cfg, _, _, jmm, _, mm = pair
    assert mm.tokens_per_image == jmm.tokens_per_image == 4 + 2 * 3
    assert len(mm.vision_tower.layers) == cfg.feature_layers == 2       # of 3, at -2


def test_clip_feature_tower_matches_jax(pair):
    cfg, params, _, _, _, mm = pair
    pix = images(cfg, 0, 3)
    want = JTower(cfg.vision, cfg.vision_feature_layer).apply(
        {"params": jax.tree.map(jnp.asarray, params["vision_tower"])}, jnp.asarray(pix))
    got = mm.vision_tower(torch.from_numpy(pix))
    assert got.shape == (3, cfg.vision.num_patches, cfg.vision.hidden_size)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_images", [1, 2])
def test_prefill_logits_and_greedy_match_jax(pair, n_images):
    cfg, _, _, jmm, _, mm = pair
    prompt = mm.build_mm_prompt([5, 9, 11, 3], n_images=n_images)
    assert prompt == jmm.build_mm_prompt([5, 9, 11, 3], n_images=n_images)
    pix = images(cfg, n_images, n_images)[None]
    np.testing.assert_allclose(mm.next_token_logits([prompt], pix),
                               jmm.next_token_logits([prompt], pix), rtol=1e-4, atol=1e-5)
    want = jmm.generate([prompt], pix, max_new_tokens=10, bucket=16)
    assert mm.generate([prompt], pix, max_new_tokens=10, bucket=16) == want


@pytest.mark.parametrize("cls,kw", [(ContinuousBatcher, {}),
                                    (PagedContinuousBatcher, {"page_size": 8}),
                                    (SpeculativePagedContinuousBatcher,
                                     {"page_size": 8, "spec_k": 3, "kv_dtype": "native"})],
                         ids=["dense", "paged", "speculative-paged"])
def test_batchers_serve_an_image_request_beside_text(pair, cls, kw):
    cfg, _, jeng, jmm, lm, mm = pair
    pix = images(cfg, 3, 1)
    prompt = mm.build_mm_prompt([5, 9, 11])
    want_mm = jmm.generate([prompt], pix[None], max_new_tokens=6, bucket=16)[0]
    want_txt = jeng.generate([TEXT], max_new_tokens=8)[0]
    bat = cls(lm, batch_slots=2, max_seq_len=64, chunk=3, mm_engine=mm, **kw)
    txt = bat.submit(TEXT, max_new_tokens=8)
    img = bat.submit(prompt, max_new_tokens=6, pixel_values=pix[0])     # one [H, W, 3]
    bat.drain()
    assert img.result(30) == want_mm and txt.result(30) == want_txt


class _RefusePIL:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "PIL":
            raise ImportError(f"refused: {name}")


def test_preprocessor_equals_jax_s_pillow_bicubic_without_pillow(pair, monkeypatch):
    from PIL import Image

    cfg = pair[0]
    rng = np.random.default_rng(7)
    arrays = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in ((40, 50), (28, 28), (90, 31))]
    want = JPre(JR.LLAVA_NEXT_CONFIGS["tiny-llava-next"]())([Image.fromarray(a)
                                                             for a in arrays])
    monkeypatch.setattr(sys, "meta_path", [_RefusePIL(), *sys.meta_path])
    for name in [m for m in sys.modules if m.split(".")[0] == "PIL"]:
        monkeypatch.delitem(sys.modules, name)
    got = LlavaNextImagePreprocessor(cfg)(arrays)
    np.testing.assert_array_equal(got, want)
    # tensors on a device resize there (the card's path, here on the CPU)
    got_t = LlavaNextImagePreprocessor(cfg, device="cpu")([torch.from_numpy(a) for a in arrays])
    np.testing.assert_array_equal(got_t, want)


def test_int8_random_model_serves_as_jax_s(monkeypatch):
    """The leaf-streamed int8 builder: the LM arrives quantized, the engines
    take it without re-casting the float32 scales, and generation runs."""
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg, params, tok = TR.load_llava_next_mm("tiny-llava-next", device="cpu",
                                                 dtype=torch.bfloat16, weight_dtype="int8")
    assert tok is None and is_quantized(params["embed"]["embed_tokens"])
    lm = LlamaDecodeEngine(cfg.text, params, dtype=torch.bfloat16, device="cpu")
    assert lm.weight_dtype == "int8"
    assert lm.params["embed"]["embed_tokens"]["scale"].dtype == torch.float32
    mm = LlavaNextMMEngine(cfg, params["vision_tower"], params["multi_modal_projector"], lm)
    prompt = mm.build_mm_prompt([3, 5, 7])
    pix = LlavaNextImagePreprocessor(cfg)([np.full((50, 40, 3), 90, np.uint8)])
    assert len(mm.generate([prompt], pix[None], max_new_tokens=4, bucket=16)[0]) == 4
    bat = PagedContinuousBatcher(lm, batch_slots=2, max_seq_len=64, chunk=2, page_size=8,
                                 mm_engine=mm)
    f = bat.submit(prompt, max_new_tokens=4, pixel_values=pix[0])
    bat.drain()
    assert f.result(30) == mm.generate([prompt], pix[None], max_new_tokens=4, bucket=16)[0]
