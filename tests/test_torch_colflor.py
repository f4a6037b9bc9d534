"""The port's ColFlor retriever and K6's plain version against the JAX package, on the CPU.

Both sides run in float32 with the same parameters: the committed
``goldens/tiny-colflor_params.npz`` tree, loaded into the port by
``params_from_flax`` (sub-trees of it for single modules). Inputs come from
numpy seeds. Every module is held to RTOL 1e-4 and ATOL 1e-5: both sides
compute the same float32 operations and differ only in the order of sums.
The committed goldens (frozen from the HF torch stack) are reproduced at the
thresholds of ``tests/test_validate_checkpoints.py``.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_colpali_tpu.models import florence2 as JF
from multimodal_colpali_tpu.models import registry as JR
from multimodal_colpali_tpu.models.processing_florence2 import ColFlorProcessor as JProcessor
from multimodal_colpali_tpu.ops.window_attention import (
    window_attention as j_window_attention, window_attention_xla)
from multimodal_colpali_tpu_torch.models import convert, florence2, load_retriever
from multimodal_colpali_tpu_torch.models.configs import ColFlorModelConfig
from multimodal_colpali_tpu_torch.models.florence2 import ColFlorModel
from multimodal_colpali_tpu_torch.ops import window_attention as WA
from multimodal_colpali_tpu_torch.ops.maxsim import maxsim_scores
from multimodal_colpali_tpu_torch.ops.topk import topk_with_stable_ties

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PARAMS_NPZ = REPO / "goldens" / "tiny-colflor_params.npz"
RTOL, ATOL = 1e-4, 1e-5
CFG = ColFlorModelConfig.tiny()
JCFG = JF.ColFlorModelConfig.tiny()
KW = dict(device="cpu", dtype=torch.float32)


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
    model = ColFlorModel(CFG, **KW).eval()
    model.load_state_dict(convert.params_from_flax(flat_params, CFG))
    return model


def _sub(flat, prefix):
    """The flat sub-tree under ``prefix/`` with the prefix cut off."""
    return {k[len(prefix) + 1:]: v for k, v in flat.items() if k.startswith(prefix + "/")}


def _loaded(module, flat, prefix):
    sub = _sub(flat, prefix)
    state = {convert.torch_name(k): torch.from_numpy(np.array(convert.to_torch_layout(k, v)))
             for k, v in sub.items()}
    module.load_state_dict(state)
    return module.eval()


def _jax(nested, prefix):
    node = nested
    for part in prefix.split("/"):
        node = node[part]
    return {"params": node}


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- K6's plain version ----------------------------------------------------------

@pytest.mark.parametrize("n,s,d", [(7, 144, 32), (64, 16, 8), (130, 144, 32)])
def test_window_attention_reference_matches_jax(n, s, d):
    q, k, v = (_randn(i, n, s, d) for i in range(3))
    scale = d ** -0.5
    got = WA.window_attention(*(torch.from_numpy(a) for a in (q, k, v)), scale=scale)
    assert got.dtype == torch.float32 and got.shape == (n, s, d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _close(got, window_attention_xla(jq, jk, jv, scale=scale))
    _close(got, j_window_attention(jq, jk, jv, scale=scale, interpret=True))


def test_window_attention_reference_rounds_p_to_the_value_dtype():
    """bf16 inputs: the probabilities are rounded to bf16 before P.V and the
    result comes back in bf16, as window_attention_xla does."""
    q, k, v = (_randn(i + 3, 4, 16, 8) for i in range(3))
    bq, bk, bv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = WA.window_attention_reference(bq, bk, bv, scale=0.35)
    want = window_attention_xla(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale=0.35)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)


# -- modules ------------------------------------------------------------------------

def test_window_attention_module_pads_like_jax(flat_params, nested_params):
    """10 x 10 tokens with windows of 4: padded to 12 x 12, the pad tokens
    attended unmasked, cropped after."""
    prefix = "vision_tower/blocks_0_0_spatial/window_attn"
    mod = _loaded(florence2.WindowAttention(CFG.vision, 0, **KW), flat_params, prefix)
    x = _randn(1, 2, 10, 10, 16)
    want = JF.WindowAttention(JCFG.vision, 0).apply(_jax(nested_params, prefix), jnp.asarray(x))
    with torch.no_grad():
        _close(mod(torch.from_numpy(x)), want)


def test_window_attention_module_runs_window_attention(flat_params, monkeypatch):
    """The port routes the windows to ``window_attention`` (K6 on a CUDA
    tensor), never to ``layers.attention`` (which would take K2)."""
    from multimodal_colpali_tpu_torch.models import layers as TL

    calls = []
    monkeypatch.setattr(florence2, "window_attention",
                        lambda q, k, v, scale: calls.append(q.shape) or
                        WA.window_attention_reference(q, k, v, scale=scale))
    monkeypatch.setattr(TL, "fused_attention", lambda *a, **k: pytest.fail("took K2's path"))
    mod = _loaded(florence2.WindowAttention(CFG.vision, 1, **KW), flat_params,
                  "vision_tower/blocks_1_0_spatial/window_attn")
    with torch.no_grad():
        mod(torch.from_numpy(_randn(2, 3, 4, 4, 32)))
    assert calls == [(3 * 1 * 4, 16, 8)]     # 3 windows x 4 heads, 4 x 4 tokens, head_dim 8


def test_breakdown_times_the_copies_window_attention_makes(flat_params, monkeypatch):
    """The ColFlor breakdown times ``florence2.split_heads`` and
    ``merge_heads``: ``WindowAttention`` makes its copies around K6 through
    exactly these, handing the first's q, k, v to K6 and the second's output
    to its projection, and they are the reshapes of the reference layout
    ``[n_win, S, 3, heads, hd]``."""
    seen = {}
    split, merge = florence2.split_heads, florence2.merge_heads

    def capture(q, k, v, scale):
        seen["qkv"] = (q, k, v)
        seen["out"] = torch.from_numpy(_randn(5, *q.shape))
        return seen["out"]

    mod = _loaded(florence2.WindowAttention(CFG.vision, 1, **KW), flat_params,
                  "vision_tower/blocks_1_0_spatial/window_attn")
    monkeypatch.setattr(florence2, "window_attention", capture)
    monkeypatch.setattr(florence2, "split_heads",
                        lambda proj, heads: seen.setdefault("split", split(proj, heads)))
    monkeypatch.setattr(florence2, "merge_heads",
                        lambda out, heads: seen.setdefault("merge", merge(out, heads)))
    monkeypatch.setattr(mod.proj, "forward", lambda x: seen.setdefault("proj_in", x))
    x = torch.from_numpy(_randn(3, 2, 4, 4, 32))     # 2 windows of 4 x 4 tokens
    with torch.no_grad():
        mod(x)
        proj = mod.qkv(x.reshape(2, 1, 4, 1, 4, 32).permute(0, 1, 3, 2, 4, 5).reshape(-1, 16, 32))
    assert all(got is want for got, want in zip(seen["split"], seen["qkv"]))
    assert seen["merge"] is seen["proj_in"]
    heads, hd = mod.heads, 32 // mod.heads
    rows = proj.reshape(2, 16, 3, heads, hd)
    for i, got in enumerate(seen["qkv"]):
        assert torch.equal(got, rows[:, :, i].transpose(1, 2).reshape(2 * heads, 16, hd))
    want = seen["out"].reshape(2, heads, 16, hd).permute(0, 2, 1, 3).reshape(2, 16, 32)
    assert torch.equal(seen["proj_in"], want)


@pytest.mark.parametrize("name,stage,shape", [
    ("ChannelAttention", 1, (2, 16, 32)),
    ("SpatialBlock", 0, (2, 8, 8, 16)),
    ("SpatialBlock", 1, (1, 6, 6, 32)),      # pads to 8 x 8
    ("ChannelBlock", 0, (2, 8, 8, 16)),
    ("ChannelBlock", 1, (2, 4, 4, 32)),
])
def test_vision_blocks_match_flax(flat_params, nested_params, name, stage, shape):
    kind = {"SpatialBlock": "spatial", "ChannelBlock": "channel"}.get(name)
    prefix = (f"vision_tower/blocks_{stage}_0_{kind}" if kind
              else f"vision_tower/blocks_{stage}_0_channel/channel_attn")
    mod = _loaded(getattr(florence2, name)(CFG.vision, stage, **KW), flat_params, prefix)
    x = _randn(stage + 7, *shape)
    want = getattr(JF, name)(JCFG.vision, stage).apply(_jax(nested_params, prefix),
                                                      jnp.asarray(x))
    with torch.no_grad():
        _close(mod(torch.from_numpy(x)), want)


@pytest.mark.parametrize("size", [32, 40])
def test_davit_backbone_matches_flax(port_model, nested_params, size):
    x = _randn(size, 2, size, size, 3)
    want = JF.DaViTBackbone(JCFG.vision).apply(_jax(nested_params, "vision_tower"),
                                                jnp.asarray(x))
    with torch.no_grad():
        got = port_model.vision_tower(torch.from_numpy(x))
    assert got.shape == want.shape
    _close(got, want)


def test_projector_matches_flax(port_model, nested_params):
    feats = _randn(11, 2, 4, 3, 32)      # h != w: columns and rows must not swap
    want = JF.Florence2Projector(JCFG).apply(_jax(nested_params, "multi_modal_projector"),
                                             jnp.asarray(feats))
    with torch.no_grad():
        got = port_model.multi_modal_projector(torch.from_numpy(feats))
    assert got.shape == (2, 13, CFG.vision.projection_dim)
    _close(got, want)


def test_bart_layer_matches_flax(port_model, nested_params):
    x = _randn(12, 2, 9, CFG.text.d_model)
    mask = np.ones((2, 9), bool)
    mask[1, 6:] = False
    want = JF.BartEncoderLayer(JCFG.text).apply(_jax(nested_params, "layers_0"), jnp.asarray(x),
                                                jnp.asarray(mask)[:, None, None, :])
    with torch.no_grad():
        got = port_model.layers[0](torch.from_numpy(x), torch.from_numpy(mask)[:, None, None, :])
    _close(got, want)


@pytest.mark.parametrize("with_image", [True, False])
def test_colflor_model_matches_flax(nested_params, port_model, with_image):
    rng = np.random.default_rng(2)
    n_img = 17 if with_image else 0       # 1 pooled + 4 x 4 patches at 32 px
    s = n_img + 7
    ids = rng.integers(3, CFG.text.vocab_size - 1, size=(3, s)).astype(np.int32)
    ids[:, :n_img] = CFG.image_token_id
    mask = np.ones((3, s), np.int32)
    if not with_image:
        mask[1, 5:] = 0
        mask[2, 3:] = 0
    pix = _randn(3, 3, 32, 32, 3) if with_image else None
    want = JF.ColFlorModel(JCFG).apply(
        {"params": nested_params}, jnp.asarray(ids), jnp.asarray(mask),
        None if pix is None else jnp.asarray(pix))
    with torch.no_grad():
        got = port_model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                         None if pix is None else torch.from_numpy(pix))
    assert got.dtype == torch.float32 and got.shape == (3, s, CFG.embedding_dim)
    _close(got, want)


def test_text_batch_runs_bart_in_float32(flat_params):
    """Without pixels the JAX module takes float32 embeddings whatever the
    params' dtype (florence2.py:373); so does the port, in bf16 too."""
    r = load_retriever("tiny-colflor", device="cpu", dtype=torch.bfloat16, params=flat_params)
    seen = []
    hook = r.model.layers[0].register_forward_pre_hook(lambda m, a: seen.append(a[0].dtype))
    r.embed_queries(["a query"])
    r.embed_images([np.zeros((32, 32, 3), np.uint8)])
    hook.remove()
    assert seen == [torch.float32, torch.bfloat16]


# -- conversion and the processor --------------------------------------------------

def test_params_from_flax_loads_every_tiny_colflor_array(flat_params, port_model):
    sd = convert.params_from_flax(flat_params, CFG)
    assert len(sd) == len(flat_params) == len(port_model.state_dict()) == 99
    key = "vision_tower/blocks_0_0_spatial/conv1/conv/kernel"     # depthwise [3, 3, 1, 16]
    np.testing.assert_array_equal(sd["vision_tower.blocks_0_0_spatial.conv1.conv.weight"].numpy(),
                                  flat_params[key].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["layers.0.fc1.weight"].numpy(),
                                  flat_params["layers_0/fc1/kernel"].T)
    np.testing.assert_array_equal(sd["multi_modal_projector.row_embeddings"].numpy(),
                                  flat_params["multi_modal_projector/row_embeddings"])


@pytest.mark.parametrize("fault,key,match", [
    ("missing", "vision_tower/convs_1/norm/weight", "missing parameter"),
    ("shape", "embed_positions", "'embed_positions': shape"),
])
def test_params_from_flax_names_missing_or_misshapen_key(flat_params, fault, key, match):
    bad = dict(flat_params)
    if fault == "missing":
        del bad[key]
    else:
        bad[key] = np.zeros((3, 24), np.float32)
    with pytest.raises(ValueError, match=match):
        convert.params_from_flax(bad, CFG)


def _pages(seed, n=3):
    from PIL import Image

    rng = np.random.default_rng(seed)
    pages = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(n - 1)]
    pages.append(Image.fromarray(rng.integers(0, 256, (45, 37, 3), dtype=np.uint8), "RGB"))
    return pages


def test_processor_batches_equal_jax():
    from multimodal_colpali_tpu_torch.models.processing_florence2 import ColFlorProcessor

    full = ColFlorProcessor(ColFlorModelConfig.colflor())
    assert full.n_image_tokens == 1 + (768 // 32) ** 2 == 577
    tp, jp = ColFlorProcessor(CFG), JProcessor(JCFG)
    pages = _pages(5)
    a, b = tp.process_images(pages), jp.process_images(pages)
    for key in ("input_ids", "attention_mask", "pixel_values"):
        assert a[key].dtype == b[key].dtype
        np.testing.assert_array_equal(a[key], b[key])
    assert a["input_ids"].shape == (3, 17 + 4)
    qa = tp.process_queries(["Query with, punctuation!", "two"])
    qb = jp.process_queries(["Query with, punctuation!", "two"])
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(qa[key], qb[key])


# -- Retriever vs the JAX Retriever -------------------------------------------------

def test_retriever_matches_jax(nested_params, flat_params):
    jr = JR.Retriever(name="tiny-colflor", model=JF.ColFlorModel(JCFG), params=nested_params,
                      processor=JProcessor(JCFG), dtype=jnp.float32, family="colflor")
    tr = load_retriever("tiny-colflor", device="cpu", dtype=torch.float32, params=flat_params)
    assert tr.family == "colflor"
    pages = _pages(4)
    for a, b in zip(tr.embed_images(pages, batch_size=2), jr.embed_images(pages, batch_size=2)):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    queries = ["what binds selectins", "a much longer query about glycan binding assays", "x"]
    for a, b in zip(tr.embed_queries(queries, batch_size=2),
                    jr.embed_queries(queries, batch_size=2)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    qs, ds = tr.embed_queries(queries[:2]), tr.embed_images(pages)
    np.testing.assert_allclose(tr.processor.score_multi_vector(qs, ds, device="cpu"),
                               jr.processor.score_multi_vector(qs, ds), rtol=RTOL, atol=ATOL)


def test_device_preprocess_raises_like_jax(flat_params):
    with pytest.raises(ValueError, match="device_preprocess"):
        JR.Retriever(name="tiny-colflor", model=JF.ColFlorModel(JCFG), params={},
                     processor=JProcessor(JCFG), dtype=jnp.float32, family="colflor",
                     device_preprocess=True)
    with pytest.raises(ValueError, match="device_preprocess"):
        load_retriever("tiny-colflor", device="cpu", params=flat_params, device_preprocess=True)


# -- committed goldens ------------------------------------------------------------

def test_reproduces_committed_tiny_colflor_goldens(tmp_path, flat_params):
    sys.path.insert(0, str(REPO / "scripts"))
    import validate_checkpoints as vc
    from multimodal_colpali_tpu.ingest.rasterize import convert_pdf_dir_to_images

    corpus = str(tmp_path / "corpus")
    vc.build_fixture_corpus(corpus)
    images_per_pdf = convert_pdf_dir_to_images(corpus)
    retr = load_retriever("tiny-colflor", device="cpu", dtype=torch.float32, params=flat_params)

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
    with np.load(REPO / "goldens" / "tiny-colflor.npz", allow_pickle=False) as z:
        golden = {k: z[k] for k in z.files}
    report = vc.compare(stages, golden)
    assert report["pixels"]["max_abs_diff"] == 0.0, report
    assert report["embeddings"]["max_abs_diff"] < 1e-3, report
    assert report["query_embeddings"]["max_abs_diff"] < 1e-3, report
    assert report["scores"]["max_abs_diff"] < 5e-3, report
    assert report["top5_bitmatch"], report
    np.testing.assert_array_equal(top5.numpy(), golden["top5"])


# -- load_retriever ----------------------------------------------------------------

def test_random_init_follows_the_jax_rules():
    """LayerNorm weights 1, biases 0, everything else N(0, fan_in^-0.5) with
    the flax ``fan_in``: the first dim of the flax layout, which for a conv
    kernel ``[kh, kw, cin, cout]`` is kh (registry.py:282-292)."""
    with pytest.warns(UserWarning, match="random init"):
        r = load_retriever("tiny-colflor", device="cpu", seed=3, dtype=torch.float32)
    assert r.family == "colflor"
    sd = r.model.state_dict()
    norms = [n for n, t in sd.items() if n.endswith(".weight") and t.dim() == 1]
    assert len(norms) == 14
    for name in norms:
        assert torch.all(sd[name] == 1.0), name
    for name, t in sd.items():
        if name.endswith("bias"):
            assert not t.any(), name
    conv = sd["vision_tower.convs_0.conv.weight"]        # flax [7, 7, 3, 16]: N(0, 7^-0.5)
    assert abs(float(conv.std()) - 7 ** -0.5) < 0.05
    pos = sd["embed_positions"]                          # flax [130, 24]: N(0, 130^-0.5)
    assert abs(float(pos.std()) - 130 ** -0.5) < 0.01
    for e in r.embed_images(_pages(6, n=2)):
        assert np.isfinite(e).all()
        np.testing.assert_allclose(np.linalg.norm(e, axis=-1), 1.0, atol=1e-3)


def test_full_width_colflor_config_matches_jax():
    from multimodal_colpali_tpu_torch.models.registry import RETRIEVER_CONFIGS

    family, jfactory = JR.RETRIEVER_CONFIGS["ahmed-masry/ColFlor"]
    j, t = jfactory(), RETRIEVER_CONFIGS["ahmed-masry/ColFlor"]()
    assert family == "colflor"
    assert vars(t.vision) == vars(j.vision) and vars(t.text) == vars(j.text)
    assert (t.embedding_dim, t.image_token_id, t.image_size) == \
        (j.embedding_dim, j.image_token_id, j.image_size) == (128, 51200, 768)
    # shapes only: neither model is materialized
    shapes = jax.eval_shape(lambda: JF.ColFlorModel(j).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32),
        jnp.zeros((1, 64, 64, 3), jnp.float32)))
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(x.shape)
            for path, x in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    meta = ColFlorModel(t, device="meta")
    got = {n: convert.flax_shape(n, tuple(p.shape)) for n, p in meta.named_parameters()}
    assert {convert.torch_name(k): v for k, v in want.items()} == got
    assert sum(p.numel() for p in meta.parameters()) == sum(int(np.prod(s)) for s in want.values())
