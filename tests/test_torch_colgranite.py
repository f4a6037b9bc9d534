"""The port's ColGranite retriever (granite-vision with anyres tiles) against
the JAX package, on the CPU.

Both sides run in float32 with the same parameters: the committed
``goldens/tiny-colgranite_params.npz`` tree, loaded into the port by
``params_from_flax``. Inputs come from numpy seeds. The committed goldens
(frozen from HF's LLaVA-Next) are reproduced at the thresholds of
``tests/test_validate_checkpoints.py``; the processor's pixels (JAX's use
Pillow) within one float32 ulp.
"""

import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_colpali_tpu.models import granite as JG
from multimodal_colpali_tpu.models import hf_import as JH
from multimodal_colpali_tpu.models import registry as JR
from multimodal_colpali_tpu.models import processing_granite as JP
from multimodal_colpali_tpu_torch import api as tapi
from multimodal_colpali_tpu_torch.ingest import pipeline as tpipeline
from multimodal_colpali_tpu_torch.ingest.pdfwrite import PdfWriter, make_sample_pdf
from multimodal_colpali_tpu_torch.models import convert, load_retriever
from multimodal_colpali_tpu_torch.models import hf_import as TH
from multimodal_colpali_tpu_torch.models import processing_granite as TP
from multimodal_colpali_tpu_torch.models.configs import ColGraniteModelConfig
from multimodal_colpali_tpu_torch.models.granite import ColGraniteModel
from multimodal_colpali_tpu_torch.models.registry import RETRIEVER_CONFIGS
from multimodal_colpali_tpu_torch.ops.maxsim import maxsim_scores
from multimodal_colpali_tpu_torch.ops.topk import topk_with_stable_ties

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PARAMS_NPZ = REPO / "goldens" / "tiny-colgranite_params.npz"
ATOL = 1e-4
# (h, w) of pages at several aspects: exact canvases, crops along each axis
SIZES = [(32, 64), (64, 32), (45, 37), (30, 100), (100, 30), (50, 81), (64, 64)]


@pytest.fixture(scope="module")
def flat_params():
    with np.load(PARAMS_NPZ) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def nested_params(flat_params):
    tree = {}
    for key, val in flat_params.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(val)
    return tree


@pytest.fixture(scope="module")
def port_model(flat_params):
    cfg = ColGraniteModelConfig.tiny()
    model = ColGraniteModel(cfg, device="cpu", dtype=torch.float32).eval()
    model.load_state_dict(convert.params_from_flax(flat_params, cfg))
    return model


def _pil_pages(seed, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "RGB")
            for h, w in sizes]


def _pair(nested, flat, anyres):
    """(JAX Retriever, port Retriever) on the golden parameters in float32."""
    cfg = JG.ColGraniteModelConfig.tiny()
    jr = JR.Retriever(name="tiny-colgranite", model=JG.ColGraniteModel(cfg), params=nested,
                      processor=JP.ColGraniteProcessor(cfg, anyres=anyres), dtype=jnp.float32,
                      family="colgranite")
    tr = load_retriever("tiny-colgranite", device="cpu", dtype=torch.float32, params=flat,
                        dynamic_resolution=anyres)
    return jr, tr


# -- config and conversion -----------------------------------------------------------

@pytest.mark.parametrize("name", ["ibm-granite/granite-vision-3.3-2b-embedding",
                                  "tiny-colgranite"])
def test_config_matches_jax(name):
    family, jfactory = JR.RETRIEVER_CONFIGS[name]
    j, t = jfactory(), RETRIEVER_CONFIGS[name]()
    assert family == "colgranite"
    assert vars(t.vision) == vars(j.vision)
    for field, val in vars(t.text).items():     # JAX's Llama config has more fields
        assert getattr(j.text, field) == val, field
    for field in ("embedding_dim", "image_token_id", "vision_feature_layer", "grid",
                  "n_image_tokens"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.default_pinpoints() == j.default_pinpoints()
    for tiles in [(1, 2), (2, 1, 0, 3), (2, 2, 1, 0), (1, 4, 2, 0)]:
        assert t.n_image_tokens_for(tiles) == j.n_image_tokens_for(tiles)


def test_full_width_parameter_count_matches_jax():
    """granite-vision-3.3-2b-embedding at full width, shapes only: the same
    number of parameters as JAX's module (neither is materialized)."""
    j = JR.RETRIEVER_CONFIGS["ibm-granite/granite-vision-3.3-2b-embedding"][1]()
    t = RETRIEVER_CONFIGS["ibm-granite/granite-vision-3.3-2b-embedding"]()
    s = j.vision.image_size
    shapes = jax.eval_shape(lambda: JG.ColGraniteModel(j).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32),
        jnp.zeros((1, s, s, 3), jnp.float32)))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    meta = ColGraniteModel(t, device="meta")
    assert sum(p.numel() for p in meta.parameters()) == want
    assert t.grid == 27 and t.n_image_tokens == 27 * 27 + 27 * 28
    assert 2.9e9 < want < 3.0e9


def test_params_from_flax_loads_every_tiny_colgranite_array(flat_params, port_model):
    cfg = ColGraniteModelConfig.tiny()
    sd = convert.params_from_flax(flat_params, cfg)
    assert len(sd) == len(flat_params) == len(port_model.state_dict())
    assert not any("post_layernorm" in k for k in flat_params)
    np.testing.assert_array_equal(sd["projector_linear_1.weight"].numpy(),
                                  flat_params["projector_linear_1/kernel"].T)
    np.testing.assert_array_equal(sd["image_newline"].numpy(), flat_params["image_newline"])
    np.testing.assert_array_equal(
        sd["vision_tower.patch_embedding.weight"].numpy(),
        flat_params["vision_tower/patch_embedding/kernel"].transpose(3, 2, 0, 1))


def _hf_state_dict(prefix=""):
    """A tiny LLaVA-Next + Granite state dict built in-process, as
    tests/test_colgranite_parity.py builds it, with a 128-d-style head."""
    from transformers import LlavaNextConfig, LlavaNextModel

    cfg = JG.ColGraniteModelConfig.tiny(vocab_size=64)
    t = cfg.text
    hf_cfg = LlavaNextConfig(
        vision_config=dict(model_type="siglip_vision_model",
                           hidden_size=cfg.vision.hidden_size,
                           intermediate_size=cfg.vision.intermediate_size,
                           num_hidden_layers=cfg.vision.num_hidden_layers,
                           num_attention_heads=cfg.vision.num_attention_heads,
                           image_size=cfg.vision.image_size, patch_size=cfg.vision.patch_size),
        text_config=dict(model_type="granite", hidden_size=t.hidden_size,
                         intermediate_size=t.intermediate_size,
                         num_hidden_layers=t.num_hidden_layers,
                         num_attention_heads=t.num_attention_heads,
                         num_key_value_heads=t.num_key_value_heads, vocab_size=t.vocab_size,
                         rope_theta=t.rope_theta, rms_norm_eps=t.rms_norm_eps,
                         embedding_multiplier=t.embedding_multiplier,
                         attention_multiplier=t.attention_multiplier,
                         residual_multiplier=t.residual_multiplier, logits_scaling=1.0,
                         max_position_embeddings=256),
        image_grid_pinpoints=[[cfg.vision.image_size, cfg.vision.image_size]],
        vision_feature_select_strategy="full", vision_feature_layer=cfg.vision_feature_layer,
        image_token_index=cfg.image_token_id)
    torch.manual_seed(0)
    hf = LlavaNextModel(hf_cfg).eval()
    torch.manual_seed(1)
    proj = torch.nn.Linear(t.hidden_size, cfg.embedding_dim)
    sd = {prefix + k: v.detach() for k, v in hf.state_dict().items()}
    sd["embedding_proj_layer.weight"] = proj.weight.detach()
    sd["embedding_proj_layer.bias"] = proj.bias.detach()
    return sd


@pytest.mark.parametrize("prefix", ["", "model."])
def test_colgranite_params_from_hf_equal_jax(prefix):
    """The converter against JAX's, leaf for leaf; the post-LayerNorm and the
    attention-pool head of the HF tower are skipped, and the tree loads."""
    sd = _hf_state_dict(prefix)
    assert any("post_layernorm" in k for k in sd) and any(".head." in k for k in sd)
    jcfg, tcfg = JG.ColGraniteModelConfig.tiny(), ColGraniteModelConfig.tiny()
    want = convert.flatten_flax(JH.colgranite_params_from_hf(
        {k: v.numpy() for k, v in sd.items()}, jcfg))
    got = convert.flatten_flax(TH.colgranite_params_from_hf(sd, tcfg))
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key].contiguous().numpy(), val, err_msg=key)
    model = ColGraniteModel(tcfg, device="cpu", dtype=torch.float32)
    model.load_state_dict(convert.params_from_flax(got, tcfg))


# -- the model against JAX's -----------------------------------------------------------

def test_feature_tower_matches_flax(nested_params, port_model):
    cfg = JG.ColGraniteModelConfig.tiny()
    pix = np.random.default_rng(0).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    want = JG.SiglipFeatureTower(cfg.vision, cfg.vision_feature_layer).apply(
        {"params": nested_params["vision_tower"]}, jnp.asarray(pix))
    with torch.no_grad():
        got = port_model.vision_tower(torch.from_numpy(pix))
    assert port_model.vision_tower.post_layernorm is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("layout", ["text", "square", (1, 2), (2, 1, 0, 1), (2, 2, 1, 0)])
def test_colgranite_model_matches_flax(nested_params, port_model, layout):
    """Text only (with padding), the square layout, and anyres with and
    without HF's unpad crop, in float32 at atol 1e-4."""
    cfg = JG.ColGraniteModelConfig.tiny()
    rng = np.random.default_rng(7)
    tiles = layout if isinstance(layout, tuple) else None
    n_img = 0 if layout == "text" else cfg.n_image_tokens_for(tiles)
    b, s = 2, n_img + 6
    ids = rng.integers(3, cfg.text.vocab_size - 1, size=(b, s)).astype(np.int32)
    ids[:, :n_img] = cfg.image_token_id
    mask = np.ones((b, s), np.int32)
    pix = None
    if layout == "text":
        mask[1, 4:] = 0
    elif tiles is None:
        pix = rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)
    else:
        pix = rng.uniform(-1, 1, (b, 1 + tiles[0] * tiles[1], 32, 32, 3)).astype(np.float32)
    want = JG.ColGraniteModel(cfg).apply(
        {"params": nested_params}, jnp.asarray(ids), jnp.asarray(mask),
        None if pix is None else jnp.asarray(pix), tiles=tiles)
    with torch.no_grad():
        got = port_model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                         None if pix is None else torch.from_numpy(pix), tiles=tiles)
    assert got.dtype == torch.float32 and got.shape == (b, s, cfg.embedding_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


# -- the processor against JAX's (Pillow) -----------------------------------------------

def test_select_best_resolution_matches_jax():
    pins = ColGraniteModelConfig.granite_vision_3().default_pinpoints()
    for h, w in [(1100, 850), (850, 1100), (384, 384), (500, 2000), (3000, 700), (10, 10)]:
        assert TP.select_best_resolution(h, w, pins) == JP.select_best_resolution(h, w, pins)


@pytest.mark.parametrize("anyres", [False, True])
def test_processor_equals_jax(anyres):
    """Tilings, groups, ids and pixels (within one float32 ulp) at several
    aspects, PIL images and uint8 arrays."""
    jcfg, tcfg = JG.ColGraniteModelConfig.tiny(), ColGraniteModelConfig.tiny()
    jp = JP.ColGraniteProcessor(jcfg, anyres=anyres)
    tp = TP.ColGraniteProcessor(tcfg, anyres=anyres)
    pages = _pil_pages(3)
    pages[2] = np.asarray(pages[2])
    if anyres:
        assert [tp.tiling_for(p) for p in pages] == [jp.tiling_for(p) for p in pages]
        assert tp.tiling_for(pages[0]) == (1, 2, 0, 0)
        assert any(t[2] or t[3] for t in map(tp.tiling_for, pages))
    groups = tp.group_by_grid(pages)
    assert groups == jp.group_by_grid(pages)
    for grid, idxs in groups:
        sel = [pages[i] for i in idxs]
        a, b = tp.process_images(sel, grid=grid), jp.process_images(sel, grid=grid)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(a[key], b[key])
        assert a["grid"] == b["grid"] == grid
        assert a["pixel_values"].shape == b["pixel_values"].shape
        np.testing.assert_array_max_ulp(a["pixel_values"], b["pixel_values"], maxulp=1)
    qa, qb = tp.process_queries(["Query, with punctuation!", "two"]), \
        jp.process_queries(["Query, with punctuation!", "two"])
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(qa[key], qb[key])


def test_processor_on_tensors_equals_arrays():
    """Pages given as tensors take the tensor path of ``imageops.resize``
    (the card's, float64 sums): the same pixels as host arrays."""
    tp = TP.ColGraniteProcessor(ColGraniteModelConfig.tiny(), anyres=True)
    pages = [np.asarray(p) for p in _pil_pages(4, [(45, 37), (30, 100)])]
    for p in pages:
        grid = tp.tiling_for(p)
        a = tp.process_images([p], grid=grid)["pixel_values"]
        b = tp.process_images([torch.from_numpy(p)], grid=grid)["pixel_values"]
        np.testing.assert_array_equal(a, b)


# -- Retriever --------------------------------------------------------------------------

@pytest.mark.parametrize("anyres", [False, True])
def test_retriever_embeddings_match_jax(nested_params, flat_params, anyres):
    """Grouped embedding end to end (one group a layout, pages back in their
    order) and queries, in float32 at atol 1e-4."""
    jr, tr = _pair(nested_params, flat_params, anyres)
    pages = _pil_pages(5)
    want = jr.embed_images(pages, batch_size=2)
    got = tr.embed_images(pages, batch_size=2)
    assert len(got) == len(want) == len(pages)
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    if anyres:
        lens = {tr.processor.tiling_for(p): e.shape[0] for p, e in zip(pages, got)}
        assert len(set(lens.values())) > 2
        for tiles, n in lens.items():
            assert n == ColGraniteModelConfig.tiny().n_image_tokens_for(tiles) + 4
    queries = ["what binds selectins", "a longer query about glycan binding assays"]
    for a, b in zip(tr.embed_queries(queries), jr.embed_queries(queries)):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_device_preprocess_is_refused():
    """Its processor has no uint8 path, as JAX's __post_init__ says."""
    with pytest.raises(ValueError, match="device_preprocess"):
        load_retriever("tiny-colgranite", device="cpu", device_preprocess=True)


def test_random_init_follows_the_family():
    """Llama-style RMSNorms (x * w) start at 1, biases at 0, the newline
    vector and kernels N(0, fan_in^-0.5)."""
    with pytest.warns(UserWarning, match="random init"):
        r = load_retriever("tiny-colgranite", device="cpu", seed=3, dtype=torch.float32)
    assert r.family == "colgranite"
    sd = r.model.state_dict()
    rms = ("input_layernorm", "post_attention_layernorm", "norm")
    norms = [n for n in sd if n.endswith(".weight") and n.split(".")[-2] in rms]
    assert len(norms) == 5 and all(torch.all(sd[n] == 1.0) for n in norms)
    assert all(not t.any() for n, t in sd.items() if n.endswith("bias"))
    assert 0.5 * 24 ** -0.5 < float(sd["image_newline"].std()) < 1.5 * 24 ** -0.5
    for e in r.embed_images(_pil_pages(6, [(40, 40), (30, 70)])):
        assert np.isfinite(e).all()
        np.testing.assert_allclose(np.linalg.norm(e, axis=-1), 1.0, atol=1e-3)


@pytest.fixture(scope="module")
def pdf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("papers")
    make_sample_pdf(str(d / "a.pdf"), n_pages=2, lines_per_page=3, seed=0)
    w = PdfWriter(width=300, height=500)            # another page geometry
    w.add_page(text_lines=["narrow page"])
    w.save(str(d / "b.pdf"))
    return str(d)


def test_pipelined_embedder_with_anyres_equals_embed_images(flat_params, pdf_dir):
    """``PipelinedEmbedder`` feeds one sub-batch a layout: the same records
    and embeddings as ``create_document_embeddings`` (``embed_images`` a
    PDF), float32, batches of other compositions."""
    r = load_retriever("tiny-colgranite", device="cpu", dtype=torch.float32, params=flat_params,
                       dynamic_resolution=True)
    want = tapi.create_document_embeddings(pdf_dir, r, batch_size=3)
    got = tpipeline.PipelinedEmbedder(r, batch_size=2).embed_pdf_dir(pdf_dir)
    assert len(got) == len(want) == 3
    assert len({e["embedding"].shape for e in got}) == 2
    for g, w in zip(got, want):
        assert (g["doc_id"], g["page_id"], g["file_name"]) == \
            (w["doc_id"], w["page_id"], w["file_name"])
        np.testing.assert_allclose(g["embedding"], w["embedding"], rtol=0, atol=ATOL)


# -- committed goldens ------------------------------------------------------------------

def test_reproduces_committed_tiny_colgranite_goldens(tmp_path, flat_params):
    sys.path.insert(0, str(REPO / "scripts"))
    import validate_checkpoints as vc
    from multimodal_colpali_tpu.ingest.rasterize import convert_pdf_dir_to_images

    corpus = str(tmp_path / "corpus")
    vc.build_fixture_corpus(corpus)
    images_per_pdf = convert_pdf_dir_to_images(corpus)
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # the golden parameters, not a random init
        retr = load_retriever("tiny-colgranite", device="cpu", dtype=torch.float32,
                              params=flat_params)

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
    with np.load(REPO / "goldens" / "tiny-colgranite.npz", allow_pickle=False) as z:
        golden = {k: z[k] for k in z.files}
    report = vc.compare(stages, golden)
    assert report["pixels"]["max_abs_diff"] == 0.0, report
    assert report["embeddings"]["max_abs_diff"] < 1e-3, report
    assert report["query_embeddings"]["max_abs_diff"] < 1e-3, report
    assert report["scores"]["max_abs_diff"] < 5e-3, report
    assert report["top5_bitmatch"], report
    np.testing.assert_array_equal(top5.numpy(), golden["top5"])


def test_entry_points_default_to_the_card(monkeypatch):
    """The model, the processor's scoring and the registry default to
    ``device="cuda"``; without a card a default call raises and says why."""
    import inspect

    for fn in (ColGraniteModel.__init__, TP.ColGraniteProcessor.score_multi_vector):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ColGraniteModel(ColGraniteModelConfig.tiny()),
                 lambda: load_retriever("tiny-colgranite"),
                 lambda: load_retriever("tiny-colidefics3", dynamic_resolution=True,
                                        quantize="int8")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("dtype,jdtype", [(torch.bfloat16, jnp.bfloat16),
                                          (torch.float32, jnp.float32)])
def test_multipliers_round_as_jax_scalars(dtype, jdtype):
    """Granite's multipliers meet bf16 activations as JAX's weak-typed Python
    scalars do (rounded to bf16 first): the products equal JAX's bit for bit."""
    from multimodal_colpali_tpu_torch.models.granite import scalar_in

    x = np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32) * 5
    for m in (0.22, 12.0, 0.015625, 0.8):
        want = np.asarray(jnp.asarray(x, jdtype) * m, np.float32)
        got = (torch.from_numpy(x).to(dtype) * scalar_in(m, dtype)).float().numpy()
        np.testing.assert_array_equal(got, want)
