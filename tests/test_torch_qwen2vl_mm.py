"""The port's Qwen2-VL image generator (``Qwen2VLMMEngine``) against the JAX
package's, on the CPU.

JAX's tiny random parameters (``qwen2vl_mm_random_params``, seed 4) are
carried over with ``convert.qwen2vl_mm_params_from_jax``; both packages run
in float32. ``mrope_positions_from_ids`` equals JAX's on every layout
(left padding, text-only rows, two images, an image-final prompt); prefill
logits agree within rtol 1e-4 / atol 1e-5 (the other image engines' bound:
the tower's float32 sums run in another order); greedy streams with one and two images are
token-identical to JAX's ``generate``, also through both batchers beside text
requests, after preemption (the resumed request decodes on from mrope's
position, not from its KV length), under prefix caching and through the
speculative paged batcher. The preprocessor's pixels equal JAX's Pillow
path with Pillow refused on the port's side.
"""

import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_colpali_tpu.generation.engine import Qwen2DecodeEngine as JText
from multimodal_colpali_tpu.generation.qwen2vl_mm import Qwen2VLImagePreprocessor as JPre
from multimodal_colpali_tpu.generation.qwen2vl_mm import Qwen2VLMMEngine as JMM
from multimodal_colpali_tpu.generation.qwen2vl_mm import (
    mrope_positions_from_ids as jax_mrope)
from multimodal_colpali_tpu.models import registry as JR
from multimodal_colpali_tpu_torch.generation.engine import Qwen2DecodeEngine
from multimodal_colpali_tpu_torch.generation.paged import PagedContinuousBatcher
from multimodal_colpali_tpu_torch.generation.qwen2vl_mm import (
    Qwen2VLImagePreprocessor, Qwen2VLMMEngine, mrope_positions_from_ids)
from multimodal_colpali_tpu_torch.generation.scheduler import ContinuousBatcher
from multimodal_colpali_tpu_torch.generation.speculative import (
    SpeculativePagedContinuousBatcher)
from multimodal_colpali_tpu_torch.models import registry as TR
from multimodal_colpali_tpu_torch.models.convert import qwen2vl_mm_params_from_jax
from multimodal_colpali_tpu_torch.models.qwen2vl import Qwen2VisionTower

torch.set_num_threads(1)

TEXT = [40, 2, 7]


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX text engine, JAX image engine, port text engine, port image engine)."""
    cfg = JR._QWEN2VL_FULL["tiny-qwen2vl"]()
    tcfg = TR._QWEN2VL_FULL["tiny-qwen2vl"]()
    params = jax.tree.map(np.asarray, JR.qwen2vl_mm_random_params(cfg, seed=4))
    jp = jax.tree.map(jnp.asarray, params)
    lm_tree, tower_state = qwen2vl_mm_params_from_jax(params, tcfg, device="cpu")
    tower = Qwen2VisionTower(tcfg.vision, device="cpu", dtype=torch.float32)
    tower.load_state_dict(tower_state)
    lm = Qwen2DecodeEngine(tcfg.text, lm_tree, dtype=torch.float32, device="cpu")
    return (tcfg, JText(cfg.text, jp, dtype=jnp.float32), JMM(cfg, jp, dtype=jnp.float32), lm,
            Qwen2VLMMEngine(tcfg, tower.eval(), lm))


def patches(cfg, seed: int, n: int) -> np.ndarray:
    """``[n, P, patch_dim]`` random pre-patchified images at the static grid."""
    from multimodal_colpali_tpu_torch.models.processing_qwen2vl import flatten_patches

    ps = cfg.vision.patch_size
    imgs = np.random.default_rng(seed).standard_normal(
        (n, cfg.grid_h * ps, cfg.grid_w * ps, 3)).astype(np.float32)
    return np.stack([flatten_patches(im, cfg) for im in imgs])


def _layouts(cfg, n_tok):
    img = [cfg.vision_start_token_id] + [cfg.image_token_id] * n_tok + [cfg.vision_end_token_id]
    return {"one-image": img + [5, 9, 11], "text-only": [7, 3, 2, 5, 9, 11, 4, 4],
            "two-images-image-final": [9] + img + [5, 7] + img,
            "image-first-text-between": img + [3, 4] + img + [8]}


@pytest.mark.parametrize("layout", ["one-image", "text-only", "two-images-image-final",
                                    "image-first-text-between"])
def test_mrope_positions_match_jax(pair, layout):
    cfg, _, _, _, mm = pair
    rows = [_layouts(cfg, mm.tokens_per_image)[layout], [5, 6]]
    s = max(len(r) for r in rows) + 3
    ids = np.zeros((2, s), np.int64)
    mask = np.zeros((2, s), np.int64)
    for i, r in enumerate(rows):                     # left padding, as the engines pad
        ids[i, s - len(r):], mask[i, s - len(r):] = r, 1
    want, wlast = jax_mrope(jnp.asarray(ids), jnp.asarray(mask), cfg.image_token_id,
                            mm._grid_merged)
    got, last = mrope_positions_from_ids(torch.from_numpy(ids), torch.from_numpy(mask),
                                         cfg.image_token_id, mm._grid_merged)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(last.numpy(), np.asarray(wlast))
    # the decode position: the largest stream's last column (HF's max + 1 rule)
    np.testing.assert_array_equal(mm.prompt_positions(torch.from_numpy(ids),
                                                      torch.from_numpy(mask))[:, -1].numpy(),
                                  np.asarray(wlast))


@pytest.mark.parametrize("n_images", [1, 2])
def test_prefill_logits_and_greedy_match_jax(pair, n_images):
    cfg, _, jmm, _, mm = pair
    prompt = mm.build_mm_prompt([5, 9, 11, 3], n_images=n_images)
    assert prompt == jmm.build_mm_prompt([5, 9, 11, 3], n_images=n_images)
    pix = patches(cfg, n_images, n_images)[None]
    np.testing.assert_allclose(mm.next_token_logits([prompt], pix),
                               jmm.next_token_logits([prompt], pix), rtol=1e-4, atol=1e-5)
    want = jmm.generate([prompt], pix, max_new_tokens=10, bucket=16)
    assert mm.generate([prompt], pix, max_new_tokens=10, bucket=16) == want
    if n_images == 2:       # the images' order matters
        swapped = pix[:, ::-1].copy()
        assert not np.allclose(mm.next_token_logits([prompt], pix),
                               mm.next_token_logits([prompt], swapped))


@pytest.mark.parametrize("cls,kw", [(ContinuousBatcher, {}),
                                    (PagedContinuousBatcher, {"page_size": 8}),
                                    (SpeculativePagedContinuousBatcher,
                                     {"page_size": 8, "spec_k": 3})],
                         ids=["dense", "paged", "speculative-paged"])
def test_batchers_serve_an_image_request_beside_text(pair, cls, kw):
    """A single image submitted without its stack axis ([P, patch_dim],
    ``image_rank = 2``) decodes in the slot batch beside a text request."""
    cfg, jeng, jmm, lm, mm = pair
    p = patches(cfg, 3, 1)
    prompt = mm.build_mm_prompt([5, 9, 11])
    want_mm = jmm.generate([prompt], p[None], max_new_tokens=6, bucket=16)[0]
    want_txt = jeng.generate([TEXT], max_new_tokens=8)[0]
    bat = cls(lm, batch_slots=2, max_seq_len=64, chunk=3, mm_engine=mm, **kw)
    txt = bat.submit(TEXT, max_new_tokens=8)
    img = bat.submit(prompt, max_new_tokens=6, pixel_values=p[0])
    bat.drain()
    assert img.result(30) == want_mm and txt.result(30) == want_txt


def test_preempted_image_request_resumes_from_mrope_position(pair):
    """The image request is the youngest, so the dry pool preempts it after
    it has generated; it resumes at its own decode position (mrope's, 2 a
    block behind its KV length here) and its stream equals the uninterrupted
    one. (JAX resumes it at ``n_p - 1``, scheduler.py:613.)"""
    cfg, _, jmm, lm, mm = pair
    p = patches(cfg, 5, 1)
    prompt = mm.build_mm_prompt([5, 9, 11, 3, 17])
    want = jmm.generate([prompt], p[None], max_new_tokens=10, bucket=16)[0]
    bat = PagedContinuousBatcher(lm, batch_slots=3, max_seq_len=64, chunk=3, page_size=8,
                                 pool_pages=8, mm_engine=mm)
    resumed = []
    orig = bat._mm_resume_prefill
    bat._mm_resume_prefill = lambda req, s: resumed.append(len(req.tokens)) or orig(req, s)
    txt = [bat.submit(list(range(2, 16)), max_new_tokens=8) for _ in range(2)]
    img = bat.submit(prompt, max_new_tokens=10, pixel_values=p)
    bat.drain()
    assert img.result(30) == want
    assert bat.preemptions > 0 and resumed and min(resumed) > 0, resumed
    for f in txt:
        f.result(30)
    # F7, as the JAX package has it: the same run leaves the uninterrupted stream
    from multimodal_colpali_tpu.generation.paged import PagedContinuousBatcher as JPaged

    jb = JPaged(pair[1], batch_slots=3, max_seq_len=64, chunk=3, page_size=8, pool_pages=8,
                mm_engine=jmm)
    for _ in range(2):
        jb.submit(list(range(2, 16)), max_new_tokens=8)
    jimg = jb.submit(prompt, max_new_tokens=10, pixel_values=p)
    jb.drain()
    assert jb.preemptions > 0 and jimg.result(30) != want


def test_prefix_caching_shares_image_pages(pair):
    """A second question over the same image prefills only its tail at
    mrope's positions, and both streams equal the engine's."""
    cfg, _, jmm, lm, mm = pair
    p = patches(cfg, 6, 1)
    head = mm.build_mm_prompt(list(range(20, 36)))
    prompts = [head + [5, 9], head + [11, 3, 17]]
    want = [jmm.generate([q], p[None], max_new_tokens=8, bucket=16)[0] for q in prompts]
    bat = PagedContinuousBatcher(lm, batch_slots=2, max_seq_len=96, chunk=3, page_size=8,
                                 mm_engine=mm, prefix_caching=True)
    got = []
    for q in prompts:
        f = bat.submit(q, max_new_tokens=8, pixel_values=p)
        bat.drain()
        got.append(f.result(30))
    assert got == want
    assert bat.prefix_prefill_hits == 1 and bat.prefix_cache_hits > 0
    # F8, as the JAX package has it: the span check reads a Gemma-3 field
    from multimodal_colpali_tpu.generation.paged import PagedContinuousBatcher as JPaged

    jb = JPaged(pair[1], batch_slots=2, max_seq_len=96, chunk=3, page_size=8, mm_engine=jmm,
                prefix_caching=True)
    with pytest.raises(AttributeError, match="mm_tokens_per_image"):
        jb.submit(prompts[0], max_new_tokens=8, pixel_values=p)
        jb.drain()


class _RefusePIL:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "PIL":
            raise ImportError(f"refused: {name}")


def test_preprocessor_equals_jax_without_pillow(pair, monkeypatch):
    from PIL import Image

    cfg = pair[0]
    rng = np.random.default_rng(7)
    arrays = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((50, 70), (64, 64))]
    want = JPre(JR._QWEN2VL_FULL["tiny-qwen2vl"]())([Image.fromarray(a) for a in arrays])
    monkeypatch.setattr(sys, "meta_path", [_RefusePIL(), *sys.meta_path])
    for name in [m for m in sys.modules if m.split(".")[0] == "PIL"]:
        monkeypatch.delitem(sys.modules, name)
    got = Qwen2VLImagePreprocessor(cfg)(arrays)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, cfg.grid_h * cfg.grid_w, cfg.vision.patch_dim)


# -- serve -------------------------------------------------------------------------------------

@pytest.mark.parametrize("name,text_cls,mm_cls", [
    ("tiny-qwen2vl", "Qwen2DecodeEngine", "Qwen2VLMMEngine"),
    ("tiny-llava-next", "LlamaDecodeEngine", "LlavaNextMMEngine"),
    ("tiny-llama", "LlamaDecodeEngine", None)])
def test_serve_builds_the_old_models(monkeypatch, name, text_cls, mm_cls):
    """07_serve.py:125-217: the image engine decodes through the text
    engine's LM, quantized once under --weight-dtype; a bare Llama is text."""
    from multimodal_colpali_tpu_torch import serve

    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    args = serve.parse_args(["--model", name, "--device", "cpu", "--dtype", "float32",
                             "--weight-dtype", "int8", "--speculative", "3"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng, tok, mm, pre = serve.build(args)
    assert type(eng).__name__ == text_cls and eng.weight_dtype == "int8"
    if mm_cls is None:
        assert mm is None and pre is None
    else:
        assert type(mm).__name__ == mm_cls
        assert mm.lm is eng
        pix = pre([np.full((40, 60, 3), 120, np.uint8)])
        prompt = mm.build_mm_prompt([3, 5], bos_id=tok.bos_id)
        assert len(mm.generate([prompt], pix[None], max_new_tokens=3)[0]) == 3


SERVE_GUARD = """
import sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "PIL", "pandas", "aiohttp", "transformers"):
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
from multimodal_colpali_tpu_torch import serve
serve.main(sys.argv[1:])
"""


def test_serve_cli_speculative_answers_text_and_an_image_without_pillow():
    """``serve --paged --speculative 3`` as a subprocess on the CPU
    (tests/test_drivers_e2e.py:451's case): a text request twice (the same
    greedy reply) and an image request whose PNG the port decodes itself,
    with jax and PIL refused."""
    import base64
    import json
    import os
    import subprocess
    import urllib.request
    from pathlib import Path

    from multimodal_colpali_tpu_torch.ingest.imageops import encode_png

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo))
    env.pop("COLPALI_TPU_CKPT_DIR", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", SERVE_GUARD, "--model", "tiny-qwen2vl", "--port", "0",
         "--paged", "--speculative", "3", "--max-seq-len", "256", "--dtype", "float32",
         "--device", "cpu"], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        base = None
        for line in proc.stdout:
            if line.startswith("[serve]"):
                base = line.split(" on ")[1].split()[0]
                break
        assert base, "serve did not start"

        def ask(content, n):
            body = {"model": "qwen2-vl", "max_tokens": n,
                    "messages": [{"role": "user", "content": content}]}
            req = urllib.request.Request(base + "/chat/completions", json.dumps(body).encode(),
                                         {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.load(r)["choices"][0]["message"]["content"]

        text = ask("hello world", 8)
        assert text and ask("hello world", 8) == text
        png = encode_png(np.full((56, 56, 3), (30, 200, 90), np.uint8))
        url = "data:image/png;base64," + base64.b64encode(png).decode()
        assert len(ask([{"type": "image_url", "image_url": {"url": url}},
                        {"type": "text", "text": "describe"}], 6).split()) == 6
        with urllib.request.urlopen(base.rsplit("/v1", 1)[0] + "/stats", timeout=30) as r:
            stats = json.load(r)
        assert (stats["images_decoded"], stats["images_skipped"]) == (1, 0), stats
    finally:
        proc.terminate()
        proc.wait(timeout=30)
