"""The port's bge text encoder (``models/bert``, ``models/text_encoder``) against
the JAX package and HF ``BertModel``, on the CPU.

The same numpy-seeded inputs go through both packages: the encoder from one
flax tree, float32 and bf16; HF ``BertModel`` built in-process, loaded
through ``hf_import.bert_params_from_hf`` from its state dict (with and
without the ``bert.`` prefix) and from a bf16 safetensors file; and
``BgeEmbeddings`` with its random init, whose leaves must be JAX's bit for
bit, its tokenizer, its checkpoint lookup and its warning.
"""

import importlib.util
import os
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from multimodal_colpali_tpu.models import hf_import as JH
from multimodal_colpali_tpu.models import layers as JL
from multimodal_colpali_tpu.models import text_encoder as JT
from multimodal_colpali_tpu.models.bert import BertEncoder as JBert
from multimodal_colpali_tpu.models.configs import BertConfig as JCfg
from multimodal_colpali_tpu_torch.models import hf_import as TH
from multimodal_colpali_tpu_torch.models import text_encoder as TT
from multimodal_colpali_tpu_torch.models.bert import BertEncoder, dense_f32
from multimodal_colpali_tpu_torch.models.configs import BertConfig
from multimodal_colpali_tpu_torch.models.convert import flatten_flax, params_from_flax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CFG = BertConfig.tiny()


def _flax_tree(seed=0):
    """A float32 flax tree of the tiny config: LayerNorms away from their
    identity, so that every leaf matters."""
    tree = TT._fast_bert_params(CFG, seed)
    rng = np.random.default_rng(seed + 100)
    for key, val in flatten_flax(tree).items():
        if key.endswith(("/bias", "layernorm/weight")):
            val[...] = rng.standard_normal(val.shape).astype(np.float32) * 0.1 + (
                1.0 if key.endswith("weight") else 0.0)
    return tree


def _inputs(seed=1, b=4, s=11):
    """Ragged masks: full, suffix padding, and a row with one real token."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG.vocab_size, size=(b, s)).astype(np.int32)
    lens = [s, 7, 1, 4][:b]
    mask = np.zeros((b, s), np.int32)
    for i, n in enumerate(lens):
        mask[i, :n] = 1
    return ids, mask


def _jax_forward(tree, ids, mask, dtype=jnp.float32):
    params = jax.tree.map(lambda p: jnp.asarray(p, dtype), tree)
    return np.asarray(JBert(JCfg.tiny()).apply({"params": params}, jnp.asarray(ids),
                                                jnp.asarray(mask)))


def _port(tree, dtype=torch.float32):
    model = BertEncoder(CFG, device="cpu", dtype=dtype)
    model.load_state_dict(params_from_flax(tree, CFG))
    return model.eval()


def _cos(a, b):
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_encoder_matches_jax_in_float32():
    tree = _flax_tree()
    ids, mask = _inputs()
    want = _jax_forward(tree, ids, mask)
    with torch.inference_mode():
        got = _port(tree)(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, CFG.hidden_size)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


def test_encoder_token_types_match_jax():
    tree = _flax_tree(seed=2)
    ids, mask = _inputs(seed=3)
    types = (np.arange(ids.shape[1])[None] >= 5).astype(np.int32).repeat(4, 0)
    params = jax.tree.map(jnp.asarray, tree)
    want = np.asarray(JBert(JCfg.tiny()).apply({"params": params}, jnp.asarray(ids),
                                               jnp.asarray(mask), jnp.asarray(types)))
    with torch.inference_mode():
        got = _port(tree)(torch.from_numpy(ids), torch.from_numpy(mask),
                          torch.from_numpy(types)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_encoder_matches_jax_in_bf16():
    tree = _flax_tree(seed=4)
    ids, mask = _inputs(seed=5)
    want = _jax_forward(tree, ids, mask, jnp.bfloat16)
    with torch.inference_mode():
        got = _port(tree, torch.bfloat16)(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    assert _cos(got.numpy(), want).min() >= 0.999


def test_padding_never_reaches_the_real_tokens():
    """A row's embedding does not depend on what its padding holds or how
    long it is: the mask reaches the einsum path as -1e30 logits."""
    tree = _flax_tree(seed=6)
    ids, mask = _inputs(seed=7)
    model = _port(tree)
    other = ids.copy()
    other[mask == 0] = 3
    wide_ids = np.concatenate([ids, np.zeros((4, 5), np.int32)], 1)
    wide_mask = np.concatenate([mask, np.zeros((4, 5), np.int32)], 1)
    with torch.inference_mode():
        a = model(torch.from_numpy(ids), torch.from_numpy(mask))
        b = model(torch.from_numpy(other), torch.from_numpy(mask))
        c = model(torch.from_numpy(wide_ids), torch.from_numpy(wide_mask))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-6)


def test_dense_rounds_once_after_the_float32_bias():
    """bf16 projections: the float32 product plus the float32 bias, one cast
    (layers.py:29-36), within one bf16 step of JAX's ``dense``."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((3, 5, 48)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((40, 48)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal(40).astype(np.float32) * 3).bfloat16()
    got = dense_f32(x, w, b)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 5, 40)
    want = (x.float() @ w.float().T + b.float()).bfloat16()
    assert torch.equal(got, want)
    jx = np.asarray(JL.dense(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                             jnp.asarray(w.float().numpy().T, jnp.bfloat16),
                             jnp.asarray(b.float().numpy(), jnp.bfloat16)).astype(jnp.float32))
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(jx), 1e-30))) - 7)
    assert (np.abs(got.float().numpy() - jx) <= step).all()


# -- HF BertModel ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def hf_model():
    from transformers import BertConfig as HFBertConfig, BertModel

    hf_cfg = HFBertConfig(
        vocab_size=CFG.vocab_size, hidden_size=CFG.hidden_size,
        num_hidden_layers=CFG.num_hidden_layers, num_attention_heads=CFG.num_attention_heads,
        intermediate_size=CFG.intermediate_size,
        max_position_embeddings=CFG.max_position_embeddings,
        type_vocab_size=CFG.type_vocab_size)
    torch.manual_seed(0)
    return BertModel(hf_cfg).eval()


def _hf_embedding(model, ids, mask):
    with torch.no_grad():
        out = model(input_ids=torch.from_numpy(ids).long(),
                    attention_mask=torch.from_numpy(mask).long()).last_hidden_state[:, 0]
    out = out.numpy()
    return out / np.linalg.norm(out, axis=-1, keepdims=True)   # bge: CLS + L2


@pytest.mark.parametrize("prefix", ["", "bert."])
def test_hf_state_dict_matches_hf_forward(hf_model, prefix):
    ids, mask = _inputs(seed=9)
    want = _hf_embedding(hf_model, ids, mask)
    sd = {prefix + k: v for k, v in hf_model.state_dict().items()}
    tree = TH.bert_params_from_hf(sd, CFG)
    jtree = JH.bert_params_from_hf({k: v.numpy() for k, v in sd.items()}, JCfg.tiny())
    jflat = flatten_flax(jtree)
    tflat = flatten_flax(tree)
    assert sorted(jflat) == sorted(tflat)
    for key, val in tflat.items():
        assert np.array_equal(val.numpy(), jflat[key]), key
    with torch.inference_mode():
        got = _port(tree)(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_bf16_safetensors_checkpoint_matches_hf(hf_model, tmp_path):
    """A bf16 file loads through ``BgeEmbeddings(checkpoint_dir=)`` in the
    file's values: a float32 encoder made from it matches HF run on the same
    bf16-rounded weights, and no random-init warning is given."""
    import copy

    rounded = copy.deepcopy(hf_model)
    with torch.no_grad():
        for p in rounded.parameters():
            p.copy_(p.bfloat16().float())
    save_file({k: v.bfloat16().contiguous() for k, v in hf_model.state_dict().items()},
              str(tmp_path / "model.safetensors"), metadata={"format": "pt"})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        emb = TT.BgeEmbeddings(cfg=CFG, checkpoint_dir=str(tmp_path), dtype=torch.float32,
                               device="cpu")
    ids, mask = _inputs(seed=10)
    want = _hf_embedding(rounded, ids, mask)
    with torch.inference_mode():
        got = emb.model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


# -- BgeEmbeddings -----------------------------------------------------------------------

def _both(jdtype=jnp.float32, tdtype=torch.float32, **kw):
    with pytest.warns(UserWarning, match="using random init"):
        j = JT.BgeEmbeddings(cfg=JCfg.tiny(), dtype=jdtype, **kw)
    with pytest.warns(UserWarning, match="using random init"):
        t = TT.BgeEmbeddings(cfg=CFG, dtype=tdtype, device="cpu", **kw)
    return j, t


TEXTS = ["glycans bind lectins", "the weather is sunny today, and tomorrow too",
         "a", "sialyl Lewis x binds E-selectin with micromolar affinity " * 3, ""]


@pytest.mark.parametrize("seed", [0, 7])
def test_random_init_is_jax_leaf_for_leaf(seed, monkeypatch):
    """``_fast_bert_params`` draws JAX's values in JAX's order: the flax
    tree flattened with its dict keys sorted as strings."""
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    j, t = _both(seed=seed)
    jflat = flatten_flax(jax.tree.map(np.asarray, j.params))
    tflat = flatten_flax(TT._fast_bert_params(CFG, seed))
    assert sorted(jflat) == sorted(tflat)
    for key in jflat:
        assert tflat[key].dtype == np.float32 and np.array_equal(jflat[key], tflat[key]), key
    state = t.model.state_dict()
    want = params_from_flax(tflat, CFG)
    for name, val in want.items():
        assert torch.equal(state[name], val), name


def test_random_init_draw_order_is_the_sorted_flattening(monkeypatch):
    """With 12 layers ``layers_10`` and ``layers_11`` draw before
    ``layers_2``, and ``key`` before ``query``: JAX's tree at bge-base's
    layer count, built at a narrow width, leaf for leaf."""
    cfg = BertConfig(vocab_size=50, hidden_size=8, intermediate_size=16,
                     num_hidden_layers=12, num_attention_heads=2,
                     max_position_embeddings=16)
    jcfg = JCfg(vocab_size=50, hidden_size=8, intermediate_size=16, num_hidden_layers=12,
                num_attention_heads=2, max_position_embeddings=16)
    jtree = JT._fast_bert_params(JBert(jcfg), jcfg, 5)
    jflat = flatten_flax(jax.tree.map(np.asarray, jtree))
    tflat = flatten_flax(TT._fast_bert_params(cfg, 5))
    assert sorted(jflat) == sorted(tflat)
    for key in jflat:
        assert np.array_equal(jflat[key], tflat[key]), key


def test_embed_documents_and_query_match_jax(monkeypatch):
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    j, t = _both(seed=3)
    want = np.array(j.embed_documents(TEXTS, batch_size=2))
    got = t.embed_documents(TEXTS, batch_size=2)
    assert isinstance(got, list) and all(isinstance(v, float) for v in got[0])
    np.testing.assert_allclose(np.array(got), want, rtol=1e-5, atol=1e-6)
    q = t.embed_query(TEXTS[1])
    np.testing.assert_allclose(q, j.embed_query(TEXTS[1]), rtol=1e-5, atol=1e-6)


def test_bf16_embeddings_match_jax(monkeypatch):
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    j, t = _both(seed=4, jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in t.model.parameters())
    want = np.array(j.embed_documents(TEXTS))
    got = np.array(t.embed_documents(TEXTS))
    assert _cos(got, want).min() >= 0.999
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("max_length,bucket", [(512, 32), (12, 32), (9, 4), (40, 8)])
def test_tokenize_matches_jax(max_length, bucket, monkeypatch):
    """[CLS]/[SEP] = 101/102 mod the vocab, truncation to max_length - 2,
    padding to a multiple of the bucket capped at max_length."""
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    j, t = _both(max_length=max_length)
    assert t.max_length == j.max_length == min(max_length, CFG.max_position_embeddings)
    jids, jmask = j._tokenize(TEXTS, bucket=bucket)
    tids, tmask = t._tokenize(TEXTS, bucket=bucket)
    assert tids.dtype == tmask.dtype == np.int32
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tmask, jmask)
    assert tids[0, 0] == 101 % CFG.vocab_size


def test_tokenizer_with_special_token_flag_is_used_without_specials(monkeypatch):
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)

    class Tok:
        def encode(self, text, add_special_tokens=True):
            assert add_special_tokens is False
            return [len(w) for w in text.split()]

    j, t = _both(tokenizer=Tok())
    for a, b in zip(t._tokenize(TEXTS), j._tokenize(TEXTS)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["none", "org", "base", "empty", "unset"])
def test_env_checkpoint_lookup_matches_jax(layout, tmp_path, monkeypatch):
    name = "BAAI/bge-base-en-v1.5"
    if layout == "unset":
        monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    else:
        monkeypatch.setenv("COLPALI_TPU_CKPT_DIR", str(tmp_path))
    sub = {"org": "BAAI--bge-base-en-v1.5", "base": "bge-base-en-v1.5",
           "empty": "BAAI--bge-base-en-v1.5"}.get(layout)
    if sub:
        (tmp_path / sub).mkdir()
        if layout != "empty":
            (tmp_path / sub / "model.safetensors").write_bytes(b"")
    got = TT._env_ckpt(name)
    assert got == JT._env_ckpt(name)
    assert (got is None) == (layout in ("none", "empty", "unset"))


def test_env_checkpoint_loads_without_warning(hf_model, tmp_path, monkeypatch):
    (tmp_path / "tiny-bge").mkdir()
    save_file({k: v.contiguous() for k, v in hf_model.state_dict().items()},
              str(tmp_path / "tiny-bge" / "model.safetensors"))
    monkeypatch.setenv("COLPALI_TPU_CKPT_DIR", str(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = TT.BgeEmbeddings("org/tiny-bge", cfg=CFG, dtype=torch.float32, device="cpu")
        j = JT.BgeEmbeddings("org/tiny-bge", cfg=JCfg.tiny(), dtype=jnp.float32)
    np.testing.assert_allclose(t.embed_documents(TEXTS[:3]), j.embed_documents(TEXTS[:3]),
                               rtol=1e-5, atol=1e-6)


def test_random_init_warning_text_is_jax_s(monkeypatch):
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        JT.BgeEmbeddings("x/y", cfg=JCfg.tiny())
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        TT.BgeEmbeddings("x/y", cfg=CFG, device="cpu")
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw] == [
        "no local checkpoint for 'x/y'; using random init"]
    assert tw[0].category is jw[0].category is UserWarning
    assert tw[0].filename == __file__          # stacklevel 2: the caller's line


def test_bge_base_config_is_bert_base():
    cfg = BertConfig.bge_base()
    assert cfg == BertConfig() and dataclass_fields(cfg) == dataclass_fields(JCfg.bge_base())
    assert (cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers,
            cfg.num_attention_heads, cfg.max_position_embeddings, cfg.type_vocab_size,
            cfg.layer_norm_eps) == (30522, 768, 3072, 12, 12, 512, 2, 1e-12)
    assert dataclass_fields(BertConfig.tiny()) == dataclass_fields(JCfg.tiny())
    n = sum(p.numel() for p in BertEncoder(cfg, device="meta").parameters())
    assert n == 108_891_648        # BERT-base (109.5M) without its pooler


def dataclass_fields(cfg):
    import dataclasses

    return dataclasses.asdict(cfg)


# -- chip_smoke's BERT checkpoint ------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_bert_tensors_are_the_hf_state_dict(smoke, hf_model):
    """The tensors chip_smoke writes for bge-base are, name for name and
    shape for shape, a ``BertModel`` state dict (the pooler included)."""
    want = [(k, tuple(v.shape)) for k, v in hf_model.state_dict().items()]
    assert smoke.bert_hf_tensors(CFG) == want


def test_smoke_bert_checkpoint_loads_without_warning(smoke, tmp_path, monkeypatch):
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    info = smoke.write_checkpoint(torch, smoke.bert_hf_tensors(CFG), str(tmp_path), seed=2,
                                  shards=1, device="cpu", norm=smoke.bert_norm)
    assert info["files"] == 1 and info["bytes"] == os.path.getsize(
        tmp_path / "model-00001-of-00001.safetensors")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        emb = TT.BgeEmbeddings(cfg=CFG, checkpoint_dir=str(tmp_path), device="cpu")
    sd = TH.load_state_dict(str(tmp_path))
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    assert torch.all(sd["encoder.layer.0.output.LayerNorm.weight"] == 1)
    assert torch.all(sd["embeddings.LayerNorm.bias"] == 0)
    checked = smoke.check_bert_leaves(torch, emb.model, CFG, str(tmp_path))
    assert len(checked) >= 5
    v = np.array(emb.embed_documents(TEXTS[:3]))
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)
