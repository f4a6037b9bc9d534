"""The port's ColIdefics3 (ColSmol) retriever against the JAX package, on the CPU.

Both sides run in float32 with the same parameters: the committed
``goldens/tiny-colidefics3_params.npz`` tree, loaded into the port by
``params_from_flax``. Inputs come from numpy seeds. The committed goldens
(frozen from the HF torch stack) are reproduced at the thresholds of
``tests/test_validate_checkpoints.py``.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_colpali_tpu.models import idefics3 as JI
from multimodal_colpali_tpu.models import registry as JR
from multimodal_colpali_tpu.models.processing_idefics3 import ColIdefics3Processor as JProcessor
from multimodal_colpali_tpu.models.qwen2vl import Qwen2RMSNorm
from multimodal_colpali_tpu.models.siglip import SiglipVisionTower as JSiglip
from multimodal_colpali_tpu_torch.models import convert, idefics3, load_retriever
from multimodal_colpali_tpu_torch.models import layers as TL
from multimodal_colpali_tpu_torch.models.configs import ColIdefics3ModelConfig
from multimodal_colpali_tpu_torch.models.idefics3 import ColIdefics3Model
from multimodal_colpali_tpu_torch.models.processing_idefics3 import (
    ColIdefics3Processor as idefics3_processor)
from multimodal_colpali_tpu_torch.ops.maxsim import maxsim_scores
from multimodal_colpali_tpu_torch.ops.topk import topk_with_stable_ties

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PARAMS_NPZ = REPO / "goldens" / "tiny-colidefics3_params.npz"
ATOL = 1e-4


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
    cfg = ColIdefics3ModelConfig.tiny()
    model = ColIdefics3Model(cfg, device="cpu", dtype=torch.float32).eval()
    model.load_state_dict(convert.params_from_flax(flat_params, cfg))
    return model


@pytest.fixture(scope="module")
def retriever_pair(nested_params, flat_params):
    """(JAX Retriever, port Retriever) pairs keyed by device_preprocess."""
    cfg = JI.ColIdefics3ModelConfig.tiny()
    pairs = {}
    for dev_pre in (False, True):
        jr = JR.Retriever(name="tiny-colidefics3", model=JI.ColIdefics3Model(cfg),
                          params=nested_params, processor=JProcessor(cfg), dtype=jnp.float32,
                          family="colidefics3", device_preprocess=dev_pre)
        tr = load_retriever("tiny-colidefics3", device="cpu", dtype=torch.float32, params=flat_params,
                            device_preprocess=dev_pre)
        pairs[dev_pre] = (jr, tr)
    return pairs


def _pixels(seed, b=3):
    return np.random.default_rng(seed).uniform(-1, 1, size=(b, 32, 32, 3)).astype(np.float32)


def _pages(seed, n=3):
    from PIL import Image

    rng = np.random.default_rng(seed)
    pages = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(n - 1)]
    pages.append(Image.fromarray(rng.integers(0, 256, (45, 37, 3), dtype=np.uint8), "RGB"))
    return pages


# -- conversion ---------------------------------------------------------------

def test_params_from_flax_loads_every_tiny_colidefics3_array(flat_params, port_model):
    cfg = ColIdefics3ModelConfig.tiny()
    sd = convert.params_from_flax(flat_params, cfg)
    assert len(sd) == len(flat_params) == len(port_model.state_dict())
    for key in ("vision_model/patch_embedding/kernel", "modality_projection/kernel",
                "embedding_proj_layer/kernel", "embed_tokens", "layers_1/gate_proj/kernel",
                "vision_model/position_embedding"):
        assert key in flat_params
    np.testing.assert_array_equal(sd["modality_projection.weight"].numpy(),
                                  flat_params["modality_projection/kernel"].T)
    np.testing.assert_array_equal(sd["embed_tokens"].numpy(), flat_params["embed_tokens"])
    np.testing.assert_array_equal(
        sd["vision_model.patch_embedding.weight"].numpy(),
        flat_params["vision_model/patch_embedding/kernel"].transpose(3, 2, 0, 1))


@pytest.mark.parametrize("fault,key,match", [
    ("missing", "layers_0/up_proj/kernel", "missing parameter 'layers.0.up_proj.weight'"),
    ("missing", "vision_model/position_embedding", "missing parameter"),
    ("extra", "layers_2/up_proj/kernel", "unexpected parameter 'layers_2/up_proj/kernel'"),
    ("shape", "modality_projection/kernel", "'modality_projection/kernel': shape"),
])
def test_params_from_flax_names_missing_or_misshapen_key(flat_params, fault, key, match):
    bad = dict(flat_params)
    if fault == "missing":
        del bad[key]
    elif fault == "extra":
        bad[key] = np.zeros((24, 48), np.float32)
    else:
        bad[key] = np.zeros((127, 24), np.float32)
    with pytest.raises(ValueError, match=match):
        convert.params_from_flax(bad, ColIdefics3ModelConfig.tiny())


def test_colpali_tree_does_not_load_as_colidefics3():
    with np.load(REPO / "goldens" / "tiny-colpali_params.npz") as z:
        colpali = {k: z[k] for k in z.files}
    with pytest.raises(ValueError, match="ColIdefics3Model"):
        convert.params_from_flax(colpali, ColIdefics3ModelConfig.tiny())


# -- building blocks ------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 5, 32])
def test_position_index_matches_jax(n):
    got = idefics3.idefics3_position_index(n)
    assert got == JI.idefics3_position_index(n)
    if n == 32:
        assert got[:4] == (0, 0, 1, 2)


@pytest.mark.parametrize("seq,d,scale", [(16, 6, 2), (64, 4, 4), (1024, 3, 4)])
def test_pixel_shuffle_matches_jax(seq, d, scale):
    x = np.random.default_rng(seq).standard_normal((2, seq, d)).astype(np.float32)
    want = np.asarray(JI.pixel_shuffle(jnp.asarray(x), scale))
    np.testing.assert_array_equal(idefics3.pixel_shuffle(torch.from_numpy(x), scale).numpy(),
                                  want)


def test_llama_rmsnorm_multiplies_by_weight():
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    norm = TL.LlamaRMSNorm(16, eps=1e-5, device="cpu", dtype=torch.float32)
    norm.weight.data.copy_(torch.from_numpy(w))
    want = Qwen2RMSNorm(eps=1e-5).apply({"params": {"weight": jnp.asarray(w)}}, jnp.asarray(h))
    np.testing.assert_allclose(norm(torch.from_numpy(h)).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_vision_tower_matches_flax(nested_params, port_model):
    pix = _pixels(0)
    cfg = JI.ColIdefics3ModelConfig.tiny()
    tower = JSiglip(cfg.vision, pos_index=JI.idefics3_position_index(4))
    want = tower.apply({"params": nested_params["vision_model"]}, jnp.asarray(pix))
    with torch.no_grad():
        got = port_model.vision_model(torch.from_numpy(pix))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("with_image", [True, False])
def test_colidefics3_model_matches_flax(nested_params, port_model, with_image):
    cfg = JI.ColIdefics3ModelConfig.tiny()
    rng = np.random.default_rng(2)
    n_img = cfg.n_image_tokens if with_image else 0
    s = n_img + 7
    ids = rng.integers(3, cfg.text.vocab_size - 1, size=(3, s)).astype(np.int32)
    ids[:, :n_img] = cfg.image_token_id
    mask = np.ones((3, s), np.int32)
    if not with_image:
        mask[1, 5:] = 0
        mask[2, 3:] = 0
    pix = _pixels(3) if with_image else None
    want = JI.ColIdefics3Model(cfg).apply(
        {"params": nested_params}, jnp.asarray(ids), jnp.asarray(mask),
        None if pix is None else jnp.asarray(pix))
    with torch.no_grad():
        got = port_model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                         None if pix is None else torch.from_numpy(pix))
    assert got.dtype == torch.float32 and got.shape == (3, s, cfg.embedding_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_text_batch_runs_llama_in_float32(flat_params):
    """Without pixels the JAX module takes float32 embeddings whatever the
    params' dtype (idefics3.py:201-204); so does the port, in bf16 too."""
    r = load_retriever("tiny-colidefics3", device="cpu", dtype=torch.bfloat16, params=flat_params)
    seen = []
    hook = r.model.layers[0].register_forward_pre_hook(lambda m, a: seen.append(a[0].dtype))
    r.embed_queries(["a query"])
    r.embed_images(_pages(1, n=1))
    hook.remove()
    assert seen == [torch.float32, torch.bfloat16]


# -- Retriever vs the JAX Retriever -------------------------------------------------

@pytest.mark.parametrize("device_preprocess", [False, True])
def test_retriever_embeddings_match_jax(retriever_pair, device_preprocess):
    jr, tr = retriever_pair[device_preprocess]
    pages = _pages(4)
    want = jr.embed_images(pages, batch_size=2)
    got = tr.embed_images(pages, batch_size=2)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    queries = ["what binds selectins", "a much longer query about glycan binding assays", "x"]
    for a, b in zip(tr.embed_queries(queries, batch_size=2),
                    jr.embed_queries(queries, batch_size=2)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_processor_batches_equal_jax(retriever_pair):
    jr, tr = retriever_pair[False]
    pages = _pages(5)
    for dev_pre in (False, True):
        a = tr.processor.process_images(pages, device_preprocess=dev_pre)
        b = jr.processor.process_images(pages, device_preprocess=dev_pre)
        for key in ("input_ids", "attention_mask", "pixel_values"):
            np.testing.assert_array_equal(a[key], b[key])
    qa = tr.processor.process_queries(["Query with, punctuation!", "two"])
    qb = jr.processor.process_queries(["Query with, punctuation!", "two"])
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(qa[key], qb[key])
    embs = tr.embed_images(pages)
    qs = tr.embed_queries(["glycan", "binding"])
    np.testing.assert_allclose(tr.processor.score_multi_vector(qs, embs, device="cpu"),
                               jr.processor.score_multi_vector(qs, embs), rtol=0, atol=ATOL)


# -- committed goldens ------------------------------------------------------------

def test_reproduces_committed_tiny_colidefics3_goldens(tmp_path, flat_params):
    sys.path.insert(0, str(REPO / "scripts"))
    import validate_checkpoints as vc
    from multimodal_colpali_tpu.ingest.rasterize import convert_pdf_dir_to_images

    corpus = str(tmp_path / "corpus")
    vc.build_fixture_corpus(corpus)
    images_per_pdf = convert_pdf_dir_to_images(corpus)
    retr = load_retriever("tiny-colidefics3", device="cpu", dtype=torch.float32, params=flat_params)

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
    with np.load(REPO / "goldens" / "tiny-colidefics3.npz", allow_pickle=False) as z:
        golden = {k: z[k] for k in z.files}
    report = vc.compare(stages, golden)
    assert report["pixels"]["max_abs_diff"] == 0.0, report
    assert report["embeddings"]["max_abs_diff"] < 1e-3, report
    assert report["query_embeddings"]["max_abs_diff"] < 1e-3, report
    assert report["scores"]["max_abs_diff"] < 5e-3, report
    assert report["top5_bitmatch"], report
    np.testing.assert_array_equal(top5.numpy(), golden["top5"])


# -- load_retriever ----------------------------------------------------------------

def test_random_init_follows_the_family():
    """The JAX package zeroes RMSNorm weights only in the colpali family
    (registry.py:280-290): Gemma multiplies by (1 + w), Llama by w."""
    with pytest.warns(UserWarning, match="random init"):
        r = load_retriever("tiny-colidefics3", device="cpu", seed=3, dtype=torch.float32)
    assert r.family == "colidefics3"
    sd = r.model.state_dict()
    rms = ("input_layernorm", "post_attention_layernorm", "norm")
    norms = [n for n in sd if n.endswith(".weight") and n.split(".")[-2] in rms]
    assert len(norms) == 5
    for name in norms:
        assert torch.all(sd[name] == 1.0), name
    for name, t in sd.items():
        if name.endswith("bias"):
            assert not t.any(), name
    emb = sd["embed_tokens"]  # flax [64, 24]: N(0, 64^-0.5)
    assert abs(float(emb.std()) - 64 ** -0.5) < 0.03
    embs = r.embed_images(_pages(6, n=2))
    for e in embs:
        assert np.isfinite(e).all()
        np.testing.assert_allclose(np.linalg.norm(e, axis=-1), 1.0, atol=1e-3)
    with pytest.warns(UserWarning, match="random init"):
        assert load_retriever("tiny-colpali", device="cpu", seed=3).family == "colpali"


def test_dynamic_resolution_raises():
    """Image splitting is ported: ``dynamic_resolution=True`` builds the
    splitting processor; it raises only with ``device_preprocess``, whose
    uint8 path holds the square layout alone (registry.py:51-65)."""
    with pytest.warns(UserWarning, match="random init"):
        r = load_retriever("tiny-colidefics3", device="cpu", dynamic_resolution=True)
    assert r.processor.dynamic_resolution
    with pytest.raises(ValueError, match="device_preprocess requires the fixed square layout"):
        load_retriever("tiny-colidefics3", device="cpu", dynamic_resolution=True,
                       device_preprocess=True)
    with pytest.raises(ValueError, match="square layout"):
        r.processor.process_images(_pages(1, n=1), grid=(1, 1), device_preprocess=True)


# -- image splitting ------------------------------------------------------------------

# (h, w) of pages: wide, tall, square, and a long strip the max_tiles clamp cuts
SPLIT_SIZES = [(40, 90), (90, 40), (45, 37), (33, 33), (20, 200), (300, 70)]


def _split_pages(seed, sizes=SPLIT_SIZES):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "RGB")
            for h, w in sizes]


@pytest.mark.parametrize("max_tiles,longest_edge", [(4, None), (2, 80), (6, 100)])
def test_split_pixels_and_ids_equal_jax(max_tiles, longest_edge):
    """Tilings, groups, prompt ids and the split pixels (JAX's through
    Pillow's LANCZOS) within one float32 ulp, a uint8 array among the PIL
    pages."""
    cfg = JI.ColIdefics3ModelConfig.tiny()
    kw = dict(image_splitting=True, max_tiles=max_tiles, longest_edge=longest_edge)
    jp = JProcessor(cfg, **kw)
    tp = idefics3_processor(ColIdefics3ModelConfig.tiny(), **kw)
    pages = _split_pages(max_tiles)
    pages[1] = np.asarray(pages[1])
    assert [tp.tiling_for(p) for p in pages] == [jp.tiling_for(p) for p in pages]
    assert all(ty * tx <= max_tiles for ty, tx in map(tp.tiling_for, pages))
    groups = tp.group_by_grid(pages)
    assert groups == jp.group_by_grid(pages) and len(groups) >= 2
    for grid, idxs in groups:
        sel = [pages[i] for i in idxs]
        a, b = tp.process_images(sel, grid=grid), jp.process_images(sel, grid=grid)
        assert tp._split_prompt_ids(grid) == jp._split_prompt_ids(grid)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(a[key], b[key])
        assert a["pixel_values"].shape == b["pixel_values"].shape == \
            (len(sel), grid[0] * grid[1] + 1, 32, 32, 3)
        np.testing.assert_array_max_ulp(a["pixel_values"], b["pixel_values"], maxulp=1)


@pytest.mark.parametrize("tiles", [(1, 2), (2, 2), (3, 1)])
def test_multi_tile_model_matches_flax(nested_params, port_model, tiles):
    """The tower and the connector over every sub-image, features in order
    into the prompt's image tokens, float32 at atol 1e-4."""
    cfg = JI.ColIdefics3ModelConfig.tiny()
    proc = JProcessor(cfg, image_splitting=True)
    seq = proc._split_prompt_ids(tiles) + [5, 9]
    ids = np.tile(np.asarray(seq, np.int32), (2, 1))
    mask = np.ones_like(ids)
    pix = np.random.default_rng(8).uniform(-1, 1, (2, tiles[0] * tiles[1] + 1, 32, 32, 3))
    pix = pix.astype(np.float32)
    want = JI.ColIdefics3Model(cfg).apply({"params": nested_params}, jnp.asarray(ids),
                                          jnp.asarray(mask), jnp.asarray(pix), tiles=tiles)
    with torch.no_grad():
        got = port_model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                         torch.from_numpy(pix), tiles=tiles)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_splitting_retriever_matches_jax(nested_params, flat_params):
    """Grouped embedding end to end, one group a tiling, pages back in their
    order: the JAX Retriever's embeddings at atol 1e-4."""
    cfg = JI.ColIdefics3ModelConfig.tiny()
    jr = JR.Retriever(name="tiny-colidefics3", model=JI.ColIdefics3Model(cfg),
                      params=nested_params, processor=JProcessor(cfg, image_splitting=True),
                      dtype=jnp.float32, family="colidefics3")
    tr = load_retriever("tiny-colidefics3", device="cpu", dtype=torch.float32,
                        params=flat_params, dynamic_resolution=True)
    pages = _split_pages(1)
    want = jr.embed_images(pages, batch_size=2)
    got = tr.embed_images(pages, batch_size=2)
    assert len({a.shape for a in got}) >= 2
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_pipelined_embedder_with_splitting_equals_embed_images(flat_params, tmp_path):
    """``PipelinedEmbedder`` feeds one sub-batch a tiling: the records and
    embeddings of ``create_document_embeddings`` (``embed_images`` a PDF)."""
    from multimodal_colpali_tpu_torch import api as tapi
    from multimodal_colpali_tpu_torch.ingest import pipeline as tpipeline
    from multimodal_colpali_tpu_torch.ingest.pdfwrite import PdfWriter, make_sample_pdf

    make_sample_pdf(str(tmp_path / "a.pdf"), n_pages=2, lines_per_page=3, seed=0)
    w = PdfWriter(width=700, height=300)             # a landscape page: another tiling
    w.add_page(text_lines=["wide page"])
    w.save(str(tmp_path / "b.pdf"))
    r = load_retriever("tiny-colidefics3", device="cpu", dtype=torch.float32,
                       params=flat_params, dynamic_resolution=True)
    want = tapi.create_document_embeddings(str(tmp_path), r, batch_size=3)
    got = tpipeline.PipelinedEmbedder(r, batch_size=2).embed_pdf_dir(str(tmp_path))
    assert len(got) == len(want) == 3
    assert len({e["embedding"].shape for e in got}) == 2
    for g, w in zip(got, want):
        assert (g["doc_id"], g["page_id"], g["file_name"]) == \
            (w["doc_id"], w["page_id"], w["file_name"])
        np.testing.assert_allclose(g["embedding"], w["embedding"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["vidore/colSmol-256M", "vidore/colidefics3-v1.0"])
def test_full_width_colsmol_config_matches_jax(name):
    from multimodal_colpali_tpu_torch.models.registry import RETRIEVER_CONFIGS

    family, jfactory = JR.RETRIEVER_CONFIGS[name]
    j, t = jfactory(), RETRIEVER_CONFIGS[name]()
    assert family == "colidefics3"
    assert vars(t.vision) == vars(j.vision)
    for field in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                  "num_attention_heads", "num_key_value_heads", "rms_norm_eps", "rope_theta",
                  "head_dim"):
        assert getattr(t.text, field) == getattr(j.text, field), field
    assert (t.embedding_dim, t.image_token_id, t.scale_factor, t.n_image_tokens) == \
        (j.embedding_dim, j.image_token_id, j.scale_factor, j.n_image_tokens) == (128, 49190, 4, 64)
    # shapes only: neither model is materialized
    shapes = jax.eval_shape(lambda: JI.ColIdefics3Model(j).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32),
        jnp.zeros((1, 512, 512, 3), jnp.float32)))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    meta = ColIdefics3Model(t, device="meta")
    assert sum(p.numel() for p in meta.parameters()) == want == 228_173_504
