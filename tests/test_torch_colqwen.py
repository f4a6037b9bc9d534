"""The port's ColQwen2 / ColQwen2.5 (models/qwen2vl.py, processing_qwen2vl.py,
hf_import.colqwen2_params_from_hf, the registry's colqwen2 family) against
the JAX package's, on the CPU at tiny size.

The same numpy-seeded parameters go through both models (``params_from_flax``
on the port's side) and the same processor batch into both forwards; the
window forms (fold, mask, padded fold) are each compared with JAX's same
form. Tolerances are stated beside each comparison: float32 forwards agree
to ~1e-6, the slack is for the different matmul orders of XLA and ATen.
"""

from __future__ import annotations

import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_colpali_tpu.models.qwen2vl as JQ
from multimodal_colpali_tpu.models import hf_import as jhf
from multimodal_colpali_tpu.models import registry as JR
from multimodal_colpali_tpu.models.processing_qwen2vl import ColQwen2Processor as JProc

import multimodal_colpali_tpu_torch.models.qwen2vl as TQ
from multimodal_colpali_tpu_torch.models import hf_import as thf
from multimodal_colpali_tpu_torch.models.configs import ColQwen2ModelConfig
from multimodal_colpali_tpu_torch.models.convert import flatten_flax, params_from_flax
from multimodal_colpali_tpu_torch.models.processing_qwen2vl import ColQwen2Processor
from multimodal_colpali_tpu_torch.models.registry import load_retriever
from multimodal_colpali_tpu_torch.ops.maxsim import maxsim_scores
from multimodal_colpali_tpu_torch.ops.topk import topk_with_stable_ties

REPO = Path(__file__).resolve().parent.parent
ATOL = 2e-5      # float32 embeddings (unit vectors), JAX against the port


def _jcfg(name):
    return getattr(JQ.ColQwen2ModelConfig, name)()


def _tcfg(name):
    return getattr(ColQwen2ModelConfig, name)()


def _params(jcfg, seed=0):
    """A seeded flax tree of JAX's ColQwen2Model: kernels N(0, fan_in^-0.5),
    norm weights 1 + N(0, 0.1), biases N(0, 0.05), so every leaf matters."""
    ids = jnp.zeros((1, 8), jnp.int32)
    args = (ids, jnp.ones((1, 8), jnp.int32), jnp.zeros((3, 1, 8), jnp.int32),
            jnp.zeros((1, jcfg.grid_h * jcfg.grid_w, jcfg.vision.patch_dim), jnp.float32))
    shapes = jax.eval_shape(lambda: JQ.ColQwen2Model(jcfg).init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = getattr(path[-1], "key", str(path[-1]))
        if name == "bias":
            return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)
        if name == "weight":
            return (1.0 + rng.standard_normal(s.shape) * 0.1).astype(np.float32)
        return (rng.standard_normal(s.shape) * s.shape[0] ** -0.5).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes["params"])


_MODELS = {}


def _pair(name):
    if name not in _MODELS:
        jcfg, tcfg = _jcfg(name), _tcfg(name)
        params = _params(jcfg)
        tm = TQ.ColQwen2Model(tcfg, device="cpu", dtype=torch.float32).eval()
        tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tcfg))
        _MODELS[name] = (jcfg, tcfg, params, tm)
    return _MODELS[name]


def _pages(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def _forward_both(name, batch, with_pix, grid=None):
    jcfg, tcfg, params, tm = _pair(name)
    args = [jnp.asarray(batch["input_ids"]), jnp.asarray(batch["attention_mask"]),
            jnp.asarray(batch["position_ids"])]
    if with_pix:
        args.append(jnp.asarray(batch["pixel_values"], jnp.float32))
    want = np.asarray(JQ.ColQwen2Model(jcfg).apply({"params": params}, *args, grid=grid))
    with torch.no_grad():
        got = tm(torch.from_numpy(batch["input_ids"]).long(),
                 torch.from_numpy(batch["attention_mask"]),
                 torch.from_numpy(batch["position_ids"]),
                 (torch.from_numpy(np.asarray(batch["pixel_values"], np.float32))
                  if with_pix else None), grid=grid).numpy()
    return got, want


@pytest.mark.parametrize("name", ["tiny", "tiny_25"])
def test_text_only_matches_jax(name):
    jcfg = _jcfg(name)
    proc = JProc(jcfg)
    batch = proc.process_queries(["what binds selectins", "a much longer query about glycans"])
    got, want = _forward_both(name, batch, False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# (config, grid in patches, window form): tiny_25's windows are 2 x 2 merge
# units; 8 x 8 and 4 x 8 fold whole windows, 6 x 6 and 6 x 10 leave ragged
# edge windows (the padded fold with win_lens / kv_valid)
_IMAGE_CASES = [("tiny", None, "fold"), ("tiny_25", None, "fold"), ("tiny_25", None, "mask"),
                ("tiny_25", (6, 6), "fold"), ("tiny_25", (6, 6), "mask"),
                ("tiny_25", (6, 10), "fold"), ("tiny_25", (4, 8), "fold")]


@pytest.mark.parametrize("name,grid,form", _IMAGE_CASES)
def test_image_forward_matches_jax(monkeypatch, name, grid, form):
    monkeypatch.setattr(JQ, "_FORCE_WINDOW_MASK", form == "mask")
    monkeypatch.setattr(TQ, "_FORCE_WINDOW_MASK", form == "mask")
    jcfg = _jcfg(name)
    g = grid or (jcfg.grid_h, jcfg.grid_w)
    batch = JProc(jcfg).process_images(_pages(2, g[0] * 14, g[1] * 14), grid=g)
    got, want = _forward_both(name, batch, True, grid=grid)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_window_forms_agree():
    """The padded fold and the mask form compute one function (in the port)."""
    tcfg = _tcfg("tiny_25")
    lay = TQ.window_layout(tcfg.vision, 6, 10)
    assert lay["win"] == (6, 16) and lay["win_lens"].tolist() == [16, 16, 8, 8, 8, 4]
    assert lay["full_valid"].sum() == 60 and lay["mask"] is None
    batch = JProc(_jcfg("tiny_25")).process_images(_pages(1, 84, 140), grid=(6, 10))
    _, _, _, tm = _pair("tiny_25")
    pix = torch.from_numpy(batch["pixel_values"])
    with torch.no_grad():
        folded = tm.visual(pix, 6, 10)
        TQ._FORCE_WINDOW_MASK = True
        try:
            masked = tm.visual(pix, 6, 10)
        finally:
            TQ._FORCE_WINDOW_MASK = False
    torch.testing.assert_close(folded, masked, rtol=0, atol=1e-5)


def test_mrope_and_vision_rotary_match_jax():
    for name in ("tiny", "tiny_25", "colqwen2_5_v0_2"):
        jcfg, tcfg = _jcfg(name), _tcfg(name)
        a = JQ.vision_rotary_cos_sin(jcfg.vision, 6, 10)
        b = TQ.vision_rotary_cos_sin(tcfg.vision, 6, 10)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        pos = np.random.default_rng(0).integers(0, 900, (3, 2, 40))
        jc, js = JQ.mrope_cos_sin(jcfg.text, jnp.asarray(pos, jnp.int32))
        tc, ts = TQ.mrope_cos_sin(tcfg.text, torch.from_numpy(pos))
        # float32 cos/sin of the same float32 angles: XLA's and ATen's
        # libm differ by an ulp at most
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-7)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-7)
    for g in ((8, 8), (6, 6), (6, 10), (54, 54), (40, 76)):
        for name in ("tiny_25", "colqwen2_5_v0_2"):
            for x, y in zip(JQ.window_partition(_jcfg(name).vision, *g),
                            TQ.window_partition(_tcfg(name).vision, *g)):
                np.testing.assert_array_equal(x, y)


# -- processor --------------------------------------------------------------------

@pytest.mark.parametrize("dynamic", [False, True])
def test_processor_matches_jax(dynamic):
    jcfg, tcfg = _jcfg("tiny_25"), _tcfg("tiny_25")
    jp, tp = JProc(jcfg, dynamic_resolution=dynamic), ColQwen2Processor(
        tcfg, dynamic_resolution=dynamic)
    pages = (_pages(2, 112, 112) + _pages(2, 90, 200, seed=1) + _pages(1, 300, 47, seed=2)
             + _pages(1, 20, 20, seed=3))
    assert jp.group_by_grid(pages) == tp.group_by_grid(pages)
    for grid, idxs in tp.group_by_grid(pages):
        chunk = [pages[i] for i in idxs]
        a = tp.process_images(chunk, grid=grid)
        b = jp.process_images(chunk, grid=grid)
        assert a["grid"] == b["grid"] == grid
        for key in ("input_ids", "attention_mask", "position_ids", "pixel_values"):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key])    # bit-equal
    # the device path: a tensor page resized in float64, the same pixels
    t = tp.process_images([torch.from_numpy(pages[2])], grid=(8, 8))
    np.testing.assert_array_equal(t["pixel_values"],
                                  jp.process_images([pages[2]], grid=(8, 8))["pixel_values"])
    qs = ["Query with, punctuation!", "two", "a considerably longer query text here"]
    qa, qb = tp.process_queries(qs), jp.process_queries(qs)
    for key in ("input_ids", "attention_mask", "position_ids"):
        np.testing.assert_array_equal(qa[key], qb[key])


def test_smart_grid_matches_jax():
    from multimodal_colpali_tpu.models.processing_qwen2vl import smart_grid as jsg

    from multimodal_colpali_tpu_torch.models.processing_qwen2vl import smart_grid as tsg

    rng = np.random.default_rng(0)
    for h, w in rng.integers(1, 3000, (200, 2)):
        assert tsg(int(h), int(w), 28, 3136, 756 * 756) == jsg(int(h), int(w), 28, 3136,
                                                               756 * 756)


# -- converter, registry ------------------------------------------------------------

def _hf_state_dict(cfg, seed=0):
    """A ColQwen2.5 state dict under transformers' names, from numpy."""
    rng = np.random.default_rng(seed)
    v, t = cfg.vision, cfg.text

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    sd = {"vlm.model.visual.patch_embed.proj.weight": r(v.embed_dim, 3, 2, 14, 14),
          "vlm.model.visual.merger.ln_q.weight": r(v.embed_dim),
          "vlm.model.visual.merger.mlp.0.weight": r(4 * v.embed_dim, 4 * v.embed_dim),
          "vlm.model.visual.merger.mlp.0.bias": r(4 * v.embed_dim),
          "vlm.model.visual.merger.mlp.2.weight": r(v.hidden_size, 4 * v.embed_dim),
          "vlm.model.visual.merger.mlp.2.bias": r(v.hidden_size),
          "vlm.model.language_model.embed_tokens.weight": r(t.vocab_size, t.hidden_size),
          "vlm.model.language_model.norm.weight": r(t.hidden_size),
          "embedding_proj_layer.weight": r(cfg.embedding_dim, t.hidden_size),
          "embedding_proj_layer.bias": r(cfg.embedding_dim)}
    for i in range(v.depth):
        p = f"vlm.model.visual.blocks.{i}."
        sd.update({p + "norm1.weight": r(v.embed_dim), p + "norm2.weight": r(v.embed_dim),
                   p + "attn.qkv.weight": r(3 * v.embed_dim, v.embed_dim),
                   p + "attn.qkv.bias": r(3 * v.embed_dim),
                   p + "attn.proj.weight": r(v.embed_dim, v.embed_dim),
                   p + "attn.proj.bias": r(v.embed_dim)})
        for n, shape in (("gate_proj", (v.mlp_hidden, v.embed_dim)),
                         ("up_proj", (v.mlp_hidden, v.embed_dim)),
                         ("down_proj", (v.embed_dim, v.mlp_hidden))):
            sd[p + f"mlp.{n}.weight"] = r(*shape)
            sd[p + f"mlp.{n}.bias"] = r(shape[0])
    hd, h = t.head_dim, t.hidden_size
    for i in range(t.num_hidden_layers):
        p = f"vlm.model.language_model.layers.{i}."
        for n, rows in (("q_proj", t.num_attention_heads * hd),
                        ("k_proj", t.num_key_value_heads * hd),
                        ("v_proj", t.num_key_value_heads * hd)):
            sd[p + f"self_attn.{n}.weight"] = r(rows, h)
            sd[p + f"self_attn.{n}.bias"] = r(rows)
        sd[p + "self_attn.o_proj.weight"] = r(h, t.num_attention_heads * hd)
        sd[p + "mlp.gate_proj.weight"] = r(t.intermediate_size, h)
        sd[p + "mlp.up_proj.weight"] = r(t.intermediate_size, h)
        sd[p + "mlp.down_proj.weight"] = r(h, t.intermediate_size)
        sd[p + "input_layernorm.weight"] = r(h)
        sd[p + "post_attention_layernorm.weight"] = r(h)
    return sd


@pytest.mark.parametrize("head", ["embedding_proj_layer", "custom_text_proj"])
def test_converter_matches_jax_leaf_for_leaf(head):
    cfg = _tcfg("tiny_25")
    sd = _hf_state_dict(cfg)
    if head == "custom_text_proj":   # colpali-engine's layout: model. and custom_text_proj
        sd = {k.replace("vlm.model.", "model.").replace("embedding_proj_layer",
                                                        "custom_text_proj"): v
              for k, v in sd.items()}
    want = flatten_flax(jhf.colqwen2_params_from_hf({k: v.numpy() for k, v in sd.items()},
                                                     _jcfg("tiny_25")))
    got = flatten_flax(thf.colqwen2_params_from_hf(sd, cfg))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    state = params_from_flax(thf.colqwen2_params_from_hf(sd, cfg), cfg)
    bad = dict(sd)
    del bad[next(k for k in bad if k.endswith("blocks.1.attn.qkv.bias"))]
    with pytest.raises(ValueError, match="missing parameter"):
        params_from_flax(thf.colqwen2_params_from_hf(bad, cfg), cfg)
    assert state["visual.patch_embed.weight"].shape == (32, 1176)


def test_registry_family_rules():
    with pytest.warns(UserWarning, match="random init"):
        r = load_retriever("tiny-colqwen2.5", device="cpu", seed=3, dtype=torch.float32)
    assert r.family == "colqwen2"
    state = r.model.state_dict()
    # Qwen2 RMSNorm multiplies by w: its neutral weight is 1, not Gemma's 0
    for name in ("norm.weight", "layers.0.input_layernorm.weight",
                 "visual.blocks_0.norm1.weight", "visual.ln_q.weight"):
        assert torch.equal(state[name], torch.ones_like(state[name])), name
    assert not state["visual.blocks_0.qkv.bias"].any()
    w = state["layers.1.gate_proj.weight"]
    assert abs(float(w.std()) - 24 ** -0.5) < 0.02
    embs = r.embed_images(_pages(3, 112, 112), batch_size=2)
    assert [e.shape for e in embs] == [(22, 8)] * 3
    with pytest.raises(ValueError, match="device_preprocess"):
        load_retriever("tiny-colqwen2.5", device="cpu", device_preprocess=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_retriever("tiny-colidefics3", device="cpu", dynamic_resolution=True)


def test_dynamic_resolution_embeds_per_grid_like_jax():
    jcfg = _jcfg("tiny_25")
    params = _params(jcfg, seed=5)
    flat = {k: np.asarray(v) for k, v in flatten_flax(jax.tree.map(np.asarray, params)).items()}
    jr = JR.Retriever(name="tiny-colqwen2.5", model=JQ.ColQwen2Model(jcfg), params=params,
                      processor=JProc(jcfg, dynamic_resolution=True), dtype=jnp.float32,
                      family="colqwen2")
    tr = load_retriever("tiny-colqwen2.5", device="cpu", dtype=torch.float32, params=flat,
                        dynamic_resolution=True)
    pages = _pages(2, 112, 112) + _pages(2, 56, 112, seed=1) + _pages(1, 112, 112, seed=2)
    want = jr.embed_images(pages, batch_size=2)
    got = tr.embed_images(pages, batch_size=2)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert got[2].shape[0] != got[0].shape[0]          # two grids
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    for a, b in zip(tr.embed_queries(["glycan binding", "x"]),
                    jr.embed_queries(["glycan binding", "x"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_reproduces_committed_tiny_colqwen25_goldens(tmp_path):
    sys.path.insert(0, str(REPO / "scripts"))
    import validate_checkpoints as vc
    from multimodal_colpali_tpu.ingest.rasterize import convert_pdf_dir_to_images

    corpus = str(tmp_path / "corpus")
    vc.build_fixture_corpus(corpus)
    images_per_pdf = convert_pdf_dir_to_images(corpus)
    with np.load(REPO / "goldens" / "tiny-colqwen2.5_params.npz") as z:
        flat = {k: z[k] for k in z.files}
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # no random init: the golden's params load
        retr = load_retriever("tiny-colqwen2.5", device="cpu", dtype=torch.float32, params=flat)
    first = next(iter(images_per_pdf.values()))
    pixels = retr.processor.process_images(first)["pixel_values"]
    embs, refs = [], []
    for filename, images in images_per_pdf.items():
        for page_id, emb in enumerate(retr.embed_images(images)):
            embs.append(emb)
            refs.append(f"{Path(filename).stem}_pg_{page_id}")
    doc_embs, doc_lens = vc.pad_stack(embs)
    q_embs, q_lens = vc.pad_stack(retr.embed_queries(vc.DEFAULT_QUERIES))
    scores = maxsim_scores(torch.from_numpy(q_embs), torch.from_numpy(doc_embs),
                           torch.from_numpy(q_lens), torch.from_numpy(doc_lens))
    _, top5 = topk_with_stable_ties(scores, min(5, len(embs)))
    stages = {"pixels": np.asarray(pixels, np.float32), "doc_embs": doc_embs,
              "doc_lens": doc_lens, "q_embs": q_embs, "q_lens": q_lens,
              "scores": scores.numpy(), "top5": top5.numpy(), "refs": np.asarray(refs)}
    with np.load(REPO / "goldens" / "tiny-colqwen2.5.npz", allow_pickle=False) as z:
        golden = {k: z[k] for k in z.files}
    report = vc.compare(stages, golden)
    assert report["pixels"]["max_abs_diff"] == 0.0, report
    assert report["embeddings"]["max_abs_diff"] < 1e-3, report
    assert report["query_embeddings"]["max_abs_diff"] < 1e-3, report
    assert report["scores"]["max_abs_diff"] < 5e-3, report
    assert report["top5_bitmatch"], report
    np.testing.assert_array_equal(top5.numpy(), golden["top5"])
