"""The port's ColPali encoder against the JAX package, on the CPU.

Both sides run in float32 with the same parameters: the committed
``goldens/tiny-colpali_params.npz`` tree, loaded into the port by
``params_from_flax``. Inputs come from numpy seeds. The committed goldens
(frozen from the HF torch stack) are reproduced at the thresholds of
``tests/test_validate_checkpoints.py``.
"""

import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_colpali_tpu.models import registry as JR
from multimodal_colpali_tpu.models.colpali import ColPaliModel as JColPali
from multimodal_colpali_tpu.models.configs import ColPaliModelConfig as JCfg
from multimodal_colpali_tpu.models.gemma import GemmaModel as JGemma
from multimodal_colpali_tpu.models.processing import ColPaliProcessor as JProcessor
from multimodal_colpali_tpu.models.siglip import SiglipVisionTower as JSiglip
from multimodal_colpali_tpu_torch.models import convert, load_retriever
from multimodal_colpali_tpu_torch.models.colpali import ColPaliModel
from multimodal_colpali_tpu_torch.models.configs import ColPaliModelConfig
from multimodal_colpali_tpu_torch.ops.maxsim import maxsim_scores
from multimodal_colpali_tpu_torch.ops.topk import topk_with_stable_ties

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PARAMS_NPZ = REPO / "goldens" / "tiny-colpali_params.npz"
PORT_DIR = REPO / "multimodal_colpali_tpu_torch"
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
    cfg = ColPaliModelConfig.tiny()
    model = ColPaliModel(cfg, device="cpu", dtype=torch.float32).eval()
    model.load_state_dict(convert.params_from_flax(flat_params, cfg))
    return model


def _pixels(seed, b=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(b, 28, 28, 3)).astype(np.float32)


def _mask(b, s, seed, pad=True):
    mask = np.ones((b, s), np.int32)
    if pad:
        lens = np.random.default_rng(seed).integers(s // 2, s + 1, size=b)
        for i, n in enumerate(lens):
            mask[i, n:] = 0
    return mask


# -- conversion ---------------------------------------------------------------

def test_params_from_flax_loads_all_61_tiny_arrays(flat_params, port_model):
    cfg = ColPaliModelConfig.tiny()
    sd = convert.params_from_flax(flat_params, cfg)
    assert len(flat_params) == 61 and len(sd) == 61
    assert set(sd) == set(port_model.state_dict())
    for name, t in port_model.state_dict().items():
        assert tuple(sd[name].shape) == tuple(t.shape), name
    k = flat_params["vision_tower/patch_embedding/kernel"]
    np.testing.assert_array_equal(sd["vision_tower.patch_embedding.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    k = flat_params["language_model/layers_1/mlp/down_proj/kernel"]
    np.testing.assert_array_equal(sd["language_model.layers.1.mlp.down_proj.weight"].numpy(),
                                  k.T)
    np.testing.assert_array_equal(sd["embed.embed_tokens"].numpy(),
                                  flat_params["embed/embed_tokens"])


def test_params_from_flax_accepts_nested_tree(nested_params, flat_params):
    cfg = ColPaliModelConfig.tiny()
    a = convert.params_from_flax(nested_params, cfg)
    b = convert.params_from_flax(flat_params, cfg)
    assert set(a) == set(b)
    for name in a:
        assert torch.equal(a[name], b[name])


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_params_from_flax_rejects_mismatch(flat_params, fault):
    bad = dict(flat_params)
    if fault == "missing":
        del bad["language_model/norm/weight"]
    elif fault == "extra":
        bad["vision_tower/layers_9/mlp/fc1/bias"] = np.zeros(64, np.float32)
    else:
        bad["embed/embed_tokens"] = np.zeros((65, 16), np.float32)
    with pytest.raises(ValueError, match={"missing": "missing", "extra": "unexpected",
                                          "shape": "shape"}[fault]):
        convert.params_from_flax(bad, ColPaliModelConfig.tiny())


# -- towers and the whole model vs flax ------------------------------------------

def test_siglip_tower_matches_flax(nested_params, port_model):
    pix = _pixels(0)
    want = JSiglip(JCfg.tiny().vision).apply({"params": nested_params["vision_tower"]},
                                            jnp.asarray(pix))
    with torch.no_grad():
        got = port_model.vision_tower(torch.from_numpy(pix))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("pad", [False, True])
def test_gemma_matches_flax(nested_params, port_model, pad):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 16)).astype(np.float32)
    mask = _mask(2, 11, 1, pad=pad)
    pos = np.cumsum(mask, axis=1).astype(np.int32)
    want = JGemma(JCfg.tiny().text).apply(
        {"params": nested_params["language_model"]}, jnp.asarray(x), jnp.asarray(pos),
        jnp.asarray(mask))
    with torch.no_grad():
        got = port_model.language_model(torch.from_numpy(x), torch.from_numpy(pos),
                                        torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("with_image", [True, False])
def test_colpali_model_matches_flax(nested_params, port_model, with_image):
    cfg = JCfg.tiny()
    rng = np.random.default_rng(2)
    n_img = cfg.vision.num_patches if with_image else 0
    s = n_img + 7
    ids = rng.integers(3, cfg.text.vocab_size - 1, size=(3, s)).astype(np.int32)
    ids[:, :n_img] = cfg.image_token_id
    mask = _mask(3, s, 2, pad=not with_image)
    pix = _pixels(3) if with_image else None
    want = JColPali(cfg).apply({"params": nested_params}, jnp.asarray(ids), jnp.asarray(mask),
                               None if pix is None else jnp.asarray(pix))
    with torch.no_grad():
        got = port_model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                         None if pix is None else torch.from_numpy(pix))
    assert got.dtype == torch.float32 and got.shape == (3, s, cfg.embedding_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


# -- Retriever vs the JAX Retriever ------------------------------------------------

@pytest.fixture(scope="module")
def retriever_pair(nested_params, flat_params):
    """(JAX Retriever, port Retriever) pairs keyed by device_preprocess."""
    cfg = JCfg.tiny()
    pairs = {}
    for dev_pre in (False, True):
        jr = JR.Retriever(name="tiny-colpali", model=JColPali(cfg), params=nested_params,
                          processor=JProcessor(cfg), dtype=jnp.float32,
                          device_preprocess=dev_pre)
        tr = load_retriever("tiny-colpali", device="cpu", dtype=torch.float32, params=flat_params,
                            device_preprocess=dev_pre)
        pairs[dev_pre] = (jr, tr)
    return pairs


def _pages(seed, n=3):
    from PIL import Image

    rng = np.random.default_rng(seed)
    pages = [rng.integers(0, 256, (28, 28, 3), dtype=np.uint8) for _ in range(n - 1)]
    pages.append(Image.fromarray(rng.integers(0, 256, (40, 33, 3), dtype=np.uint8), "RGB"))
    return pages


@pytest.mark.parametrize("device_preprocess", [False, True])
def test_retriever_embed_images_matches_jax(retriever_pair, device_preprocess):
    jr, tr = retriever_pair[device_preprocess]
    pages = _pages(4)
    want = jr.embed_images(pages, batch_size=2)
    got = tr.embed_images(pages, batch_size=2)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


@pytest.mark.parametrize("device_preprocess", [False, True])
def test_retriever_embed_queries_matches_jax(retriever_pair, device_preprocess):
    jr, tr = retriever_pair[device_preprocess]
    queries = ["what binds selectins", "a much longer query about glycan binding assays",
               "x"]
    want = jr.embed_queries(queries, batch_size=2)
    got = tr.embed_queries(queries, batch_size=2)
    for a, b in zip(got, want):
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


# -- committed goldens ------------------------------------------------------------

def test_reproduces_committed_tiny_colpali_goldens(tmp_path, flat_params):
    sys.path.insert(0, str(REPO / "scripts"))
    import validate_checkpoints as vc
    from multimodal_colpali_tpu.ingest.rasterize import convert_pdf_dir_to_images

    corpus = str(tmp_path / "corpus")
    vc.build_fixture_corpus(corpus)
    images_per_pdf = convert_pdf_dir_to_images(corpus)
    retr = load_retriever("tiny-colpali", device="cpu", dtype=torch.float32, params=flat_params)

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
    with np.load(REPO / "goldens" / "tiny-colpali.npz", allow_pickle=False) as z:
        report = vc.compare(stages, {k: z[k] for k in z.files})
    assert report["pixels"]["max_abs_diff"] == 0.0, report
    assert report["embeddings"]["max_abs_diff"] < 1e-3, report
    assert report["query_embeddings"]["max_abs_diff"] < 1e-3, report
    assert report["scores"]["max_abs_diff"] < 5e-3, report
    assert report["top5_bitmatch"], report


# -- load_retriever ----------------------------------------------------------------

def test_random_init_follows_fast_random_params_rules():
    with pytest.warns(UserWarning, match="random init"):
        a = load_retriever("tiny-colpali", device="cpu", seed=3, dtype=torch.float32)
    with pytest.warns(UserWarning, match="random init"):
        b = load_retriever("tiny-colpali", device="cpu", seed=3, dtype=torch.float32)
    with pytest.warns(UserWarning, match="random init"):
        c = load_retriever("tiny-colpali", device="cpu", seed=4, dtype=torch.float32)
    sa, sb, sc = (r.model.state_dict() for r in (a, b, c))
    for name, t in sa.items():
        assert torch.equal(t, sb[name]), name  # seeded
        leaf, parent = name.split(".")[-1], name.split(".")[-2]
        if leaf == "bias":
            assert not t.any(), name
        elif leaf == "weight" and t.dim() == 1:
            want = 0.0 if parent in ("input_layernorm", "post_attention_layernorm", "norm") else 1.0
            assert torch.all(t == want), name
        else:
            assert not torch.equal(t, sc[name]), name
    # N(0, fan_in^-0.5) with fan_in the first dim of the flax layout
    w = sa["language_model.layers.0.mlp.down_proj.weight"]  # flax [32, 16]
    assert abs(float(w.std()) - 32 ** -0.5) < 0.05
    emb = sa["embed.embed_tokens"]  # flax [64, 16]
    assert abs(float(emb.std()) - 64 ** -0.5) < 0.03


def test_random_init_in_bf16_embeds_finite_unit_vectors():
    with pytest.warns(UserWarning, match="random init"):
        r = load_retriever("tiny-colpali", device="cpu", seed=0, device_preprocess=True)
    assert all(p.dtype == torch.bfloat16 for p in r.model.parameters())
    embs = r.embed_images(_pages(6, n=2))
    for e in embs:
        assert np.isfinite(e).all()
        np.testing.assert_allclose(np.linalg.norm(e, axis=-1), 1.0, atol=1e-3)


def test_load_retriever_rejects_int8_and_unknown_names():
    """W8A8 and ColGranite are ported: ``quantize="int8"`` builds int8
    projections and the granite names load; an unknown quantize mode raises
    ``ValueError`` and an unknown name ``KeyError``."""
    with pytest.warns(UserWarning, match="random init"):
        r = load_retriever("tiny-colpali", device="cpu", quantize="int8")
    assert r.quantize == "int8" and r.model.multi_modal_projector.weight.dtype == torch.int8
    with pytest.raises(ValueError, match="unknown quantize mode 'int4'"):
        load_retriever("tiny-colpali", device="cpu", quantize="int4")
    with pytest.raises(KeyError):
        load_retriever("ibm-granite/granite-vision-3.3-2b")
    with pytest.warns(UserWarning, match="random init"):
        assert load_retriever("tiny-colgranite", device="cpu").family == "colgranite"


@pytest.mark.parametrize("name", ["vidore/colpali-v1.2", "vidore/colpali-v1.3",
                                  "vidore/colpali-v1.3-hf", "vidore/colpali-v1.3-merged"])
def test_full_width_configs_match_jax(name):
    from multimodal_colpali_tpu_torch.models.registry import RETRIEVER_CONFIGS

    _, jfactory = JR.RETRIEVER_CONFIGS[name]
    j, t = jfactory(), RETRIEVER_CONFIGS[name]()
    for part in ("vision", "text"):
        assert vars(getattr(t, part)) == vars(getattr(j, part)), part
    assert (t.embedding_dim, t.image_token_id) == (j.embedding_dim, j.image_token_id)
    # shapes only: the full-width model is never materialized here
    meta = ColPaliModel(t, device="meta")
    n = sum(p.numel() for p in meta.parameters())
    assert 2.9e9 < n < 3.0e9


# -- source scan --------------------------------------------------------------------

_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|orbax|multimodal_colpali_tpu|triton)"
    r"(?=[\s.,]|$)",
    re.M)


# the gloo worlds' workers run the port alone in their own processes
@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in
                                        [*PORT_DIR.rglob("*.py"), REPO / "chip_smoke.py",
                                         *(REPO / "tests").glob("*_worker.py")]))
def test_port_source_imports_no_jax(path):
    text = (REPO / path).read_text()
    hits = _FORBIDDEN.findall(text)
    assert not hits, f"{path} imports {hits}"
    assert "importlib" not in text or "jax" not in text, path


def test_source_scan_covers_the_client_and_statistics_modules():
    scanned = {str(p.relative_to(PORT_DIR)) for p in PORT_DIR.rglob("*.py")}
    assert {"config.py", "generation/client.py", "utils/health.py", "utils/housekeeping.py",
            "utils/io.py", "utils/userops.py", "evalstats/ci.py", "evalstats/wilcoxon.py",
            "evalstats/summary.py", "drivers/stat_test.py", "drivers/experiment01_eval.py",
            "parallel/__init__.py", "parallel/mesh.py", "store/distributed.py",
            "drivers/experiment02_eval.py", "drivers/create_context.py",
            *(f"ingest/{m}.py" for m in (
                "__init__", "annotate", "chunker", "imageops", "ocr", "ocr_conv", "pdf_loader",
                "pdfwrite", "pipeline", "preprocess", "rasterize", "remote_parse",
                "tables"))} <= scanned


def test_source_scan_catches_forbidden_imports():
    for line in ("import jax", "import jax.numpy as jnp", "from flax import linen",
                 "from multimodal_colpali_tpu.ops import maxsim",
                 "    import multimodal_colpali_tpu", "    import triton",
                 "import triton.language as tl", "from triton import jit", "import optax",
                 "    import orbax.checkpoint as ocp"):
        assert _FORBIDDEN.search(line), line
    for line in ("import torch", "from multimodal_colpali_tpu_torch import api",
                 "import jaxtyping_like_name_is_fine", "import tritonclient_like_name"):
        assert not _FORBIDDEN.search(line), line
