"""Checkpoint loading in the port (``models/hf_import``, the registry's
loaders, the tokenizer) against the HF models, the ``safetensors`` library
and the JAX package, on the CPU.

The HF models are built in-process from tiny configs, as the JAX parity
tests build them (``tests/test_models_parity.py``, ``test_colflor_parity.py``,
``test_colidefics_parity.py``, ``test_gemma3.py``), and saved as sharded
float32 safetensors. From such a file the port's converted tree must equal
the JAX converter's leaf for leaf, and its forward must match the HF
forward at the JAX parity tests' tolerances, through ``checkpoint_dir=`` and
through ``COLPALI_TPU_CKPT_DIR``. A bf16 copy loads in the file's dtype.
"""

import gc
import importlib.util
import json
import os
import re
import struct
import warnings
from pathlib import Path

os.environ.setdefault("HF_HUB_OFFLINE", "1")   # tokenizers load from local files only

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from multimodal_colpali_tpu.generation.engine import GemmaDecodeEngine as JEngine
from multimodal_colpali_tpu.models import hf_import as JH
from multimodal_colpali_tpu.models import registry as JR
from multimodal_colpali_tpu_torch.generation.engine import GemmaDecodeEngine, _tree_to
from multimodal_colpali_tpu_torch.models import hf_import as TH
from multimodal_colpali_tpu_torch.models import registry as TR
from multimodal_colpali_tpu_torch.models.convert import params_from_flax
from multimodal_colpali_tpu_torch.ops.quant import quantize_lm_params, quantize_lm_params_int4

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


# -- the safetensors reader --------------------------------------------------------

_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int8, torch.uint8,
           torch.int32, torch.int64, torch.bool]


def _sample(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000), shape, generator=g,
                         dtype=torch.int64).to(dtype)


def _assert_same(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
def test_reader_equals_the_library_for_every_dtype(tmp_path, dtype):
    want = {"a": _sample(dtype, (3, 5), 0), "scalar": _sample(dtype, (), 1),
            "empty": _sample(dtype, (0, 4), 2), "b": _sample(dtype, (2, 3, 4), 3)}
    path = str(tmp_path / "x.safetensors")
    save_file(want, path, metadata={"format": "pt"})
    _assert_same(TH.read_safetensors(path), load_file(path))


def test_reader_reads_sharded_directories_in_sorted_order(tmp_path):
    shards = {"model-00002-of-00002.safetensors": {"w": _sample(torch.bfloat16, (4, 4), 0),
                                                   "shared": torch.zeros(2)},
              "model-00001-of-00002.safetensors": {"v": _sample(torch.float32, (3,), 1),
                                                   "shared": torch.ones(2)}}
    want = {}
    for name in sorted(shards):
        save_file(shards[name], str(tmp_path / name))
        want.update(load_file(str(tmp_path / name)))
    (tmp_path / "config.json").write_text("{}")
    got = TH.load_state_dict(str(tmp_path))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["shared"], torch.zeros(2))     # the later file wins


def test_reader_copies_a_tensor_at_an_unaligned_offset(tmp_path):
    """A header whose length is not a multiple of 8 and a float32 tensor at
    byte 3 of the data: the library reads it, and so does the port (by
    copy), whatever the alignment of the map."""
    u8 = torch.tensor([1, 2, 3], dtype=torch.uint8)
    f32 = torch.tensor([1.5, -2.25, 3.0e-3], dtype=torch.float32)
    i64 = torch.tensor([-7, 2 ** 40], dtype=torch.int64)
    header = {"a": {"dtype": "U8", "shape": [3], "data_offsets": [0, 3]},
              "b": {"dtype": "F32", "shape": [3], "data_offsets": [3, 15]},
              "c": {"dtype": "I64", "shape": [2], "data_offsets": [15, 31]}}
    raw = json.dumps(header).encode() + b" "
    assert len(raw) % 8
    path = str(tmp_path / "odd.safetensors")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for t in (u8, f32, i64):
            f.write(t.numpy().tobytes())
    got = TH.read_safetensors(path)
    _assert_same(got, load_file(path))
    _assert_same(got, {"a": u8, "b": f32, "c": i64})


def test_reader_views_keep_their_map_alive(tmp_path):
    path = str(tmp_path / "x.safetensors")
    want = _sample(torch.bfloat16, (64, 64), 5)
    save_file({"w": want}, path)
    w = TH.read_safetensors(path)["w"]          # the dict and its map go out of scope
    gc.collect()
    assert torch.equal(w, want)
    w2 = w.float()                               # a view of a private map: reads copy nothing
    assert torch.equal(w2, want.float())


def test_bin_equals_torch_load(tmp_path):
    want = {"a": _sample(torch.bfloat16, (3, 4), 0), "b": _sample(torch.int64, (5,), 1)}
    path = str(tmp_path / "pytorch_model.bin")
    torch.save(want, path)
    _assert_same(TH.load_state_dict(path), torch.load(path, weights_only=True))
    _assert_same(TH.load_state_dict(str(tmp_path)), want)


def test_reader_refuses_what_it_cannot_read(tmp_path):
    raw = json.dumps({"a": {"dtype": "F64", "shape": [1], "data_offsets": [0, 8]}}).encode()
    path = tmp_path / "f64.safetensors"
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + b"\0" * 8)
    with pytest.raises(ValueError, match="F64"):
        TH.read_safetensors(str(path))
    raw = json.dumps({"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 8]}}).encode()
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + b"\0" * 8)
    with pytest.raises(ValueError, match="does not fit"):
        TH.read_safetensors(str(path))


# -- the HF models, built in-process ----------------------------------------------

def hf_colpali(cfg):
    from transformers import ColPaliConfig, ColPaliForRetrieval
    from transformers.models.paligemma import PaliGemmaConfig

    v, t = cfg.vision, cfg.text
    hf_cfg = ColPaliConfig(
        vlm_config=PaliGemmaConfig(
            vision_config=dict(hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
                               num_hidden_layers=v.num_hidden_layers,
                               num_attention_heads=v.num_attention_heads,
                               image_size=v.image_size, patch_size=v.patch_size),
            text_config=dict(hidden_size=t.hidden_size, intermediate_size=t.intermediate_size,
                             num_hidden_layers=t.num_hidden_layers,
                             num_attention_heads=t.num_attention_heads,
                             num_key_value_heads=t.num_key_value_heads, head_dim=t.head_dim,
                             vocab_size=t.vocab_size),
            projection_dim=t.hidden_size, image_token_index=cfg.image_token_id),
        embedding_dim=cfg.embedding_dim)
    torch.manual_seed(0)
    model = ColPaliForRetrieval(hf_cfg).eval()

    def forward(ids, mask, pix=None):
        kw = {} if pix is None else {"pixel_values": torch.from_numpy(pix)}
        with torch.no_grad():
            return model(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                         **kw).embeddings.numpy()

    return model.state_dict(), forward


def hf_colflor(cfg):
    from transformers import Florence2Config, Florence2Model

    v, t = cfg.vision, cfg.text
    hf_cfg = Florence2Config(
        vision_config=dict(
            depths=list(v.depths), embed_dim=list(v.embed_dim), num_heads=list(v.num_heads),
            num_groups=list(v.num_groups), patch_size=list(v.patch_size),
            patch_stride=list(v.patch_stride), patch_padding=list(v.patch_padding),
            patch_prenorm=list(v.patch_prenorm), window_size=v.window_size,
            drop_path_rate=0.0, projection_dim=v.projection_dim,
            image_size=[cfg.image_size, cfg.image_size],
            max_position_embeddings=v.max_position_embeddings),
        text_config=dict(
            d_model=t.d_model, encoder_layers=t.encoder_layers, decoder_layers=1,
            encoder_attention_heads=t.encoder_attention_heads, decoder_attention_heads=2,
            encoder_ffn_dim=t.encoder_ffn_dim, decoder_ffn_dim=48, vocab_size=t.vocab_size,
            max_position_embeddings=t.max_position_embeddings,
            scale_embedding=t.scale_embedding, activation_function="gelu", dropout=0.0,
            attention_dropout=0.0, activation_dropout=0.0),
        image_token_id=cfg.image_token_id)
    torch.manual_seed(0)
    model = Florence2Model(hf_cfg).eval()
    torch.manual_seed(1)
    proj = torch.nn.Linear(t.d_model, cfg.embedding_dim)
    sd = dict(model.state_dict())
    sd["custom_text_proj.weight"], sd["custom_text_proj.bias"] = proj.weight, proj.bias

    def forward(ids, mask, pix=None):
        kw = {} if pix is None else {"pixel_values": torch.from_numpy(pix)}
        with torch.no_grad():
            out = model(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                        decoder_input_ids=torch.zeros((ids.shape[0], 1), dtype=torch.long),
                        **kw).encoder_last_hidden_state
            out = proj(out)
            out = out / out.norm(dim=-1, keepdim=True)
            return (out * torch.from_numpy(mask)[..., None]).numpy()

    return sd, forward


def hf_colidefics3(cfg):
    from transformers import Idefics3Config, Idefics3Model

    v, t = cfg.vision, cfg.text
    hf_cfg = Idefics3Config(
        vision_config=dict(hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
                           num_hidden_layers=v.num_hidden_layers,
                           num_attention_heads=v.num_attention_heads,
                           image_size=v.image_size, patch_size=v.patch_size),
        text_config=dict(hidden_size=t.hidden_size, intermediate_size=t.intermediate_size,
                         num_hidden_layers=t.num_hidden_layers,
                         num_attention_heads=t.num_attention_heads,
                         num_key_value_heads=t.num_key_value_heads, vocab_size=t.vocab_size,
                         rope_theta=t.rope_theta, rms_norm_eps=t.rms_norm_eps,
                         max_position_embeddings=256),
        scale_factor=cfg.scale_factor, image_token_id=cfg.image_token_id)
    torch.manual_seed(0)
    model = Idefics3Model(hf_cfg).eval()
    torch.manual_seed(1)
    proj = torch.nn.Linear(t.hidden_size, cfg.embedding_dim)
    sd = {"model." + k: v for k, v in model.state_dict().items()}
    sd["embedding_proj_layer.weight"], sd["embedding_proj_layer.bias"] = proj.weight, proj.bias

    def forward(ids, mask, pix=None):
        kw = {} if pix is None else {"pixel_values": torch.from_numpy(pix)[:, None]}
        with torch.no_grad():
            out = proj(model(input_ids=torch.from_numpy(ids),
                             attention_mask=torch.from_numpy(mask), **kw).last_hidden_state)
            out = out / out.norm(dim=-1, keepdim=True)
            return (out * torch.from_numpy(mask)[..., None]).numpy()

    return sd, forward


def hf_gemma3(cfg):
    from transformers.models.gemma3 import Gemma3ForCausalLM
    from transformers.models.gemma3 import Gemma3TextConfig as HFCfg

    hf_cfg = HFCfg(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
        sliding_window=cfg.sliding_window, layer_types=list(cfg.layer_types_resolved),
        rope_theta=cfg.rope_theta, rope_local_base_freq=cfg.rope_local_base_freq,
        rope_scaling={"rope_type": "linear", "factor": cfg.rope_scaling_factor},
        query_pre_attn_scalar=cfg.query_pre_attn_scalar, rms_norm_eps=cfg.rms_norm_eps,
        attention_dropout=0.0)
    torch.manual_seed(0)
    model = Gemma3ForCausalLM(hf_cfg).eval()
    # random (1 + w) norm weights, so every norm of the stack matters
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.copy_(0.2 * torch.randn(p.shape, generator=g))
    return model.state_dict(), model


def save_sharded(sd, path, dtype=None, shards=2):
    """``sd`` as ``shards`` safetensors files (tied tensors written apart),
    floating tensors cast to ``dtype`` when given."""
    os.makedirs(path, exist_ok=True)
    names = list(sd)
    for i in range(shards):
        part = {}
        for k in names[i::shards]:
            t = sd[k].detach()
            part[k] = (t.to(dtype) if dtype is not None and t.is_floating_point()
                       else t).clone().contiguous()
        save_file(part, os.path.join(path, f"model-{i + 1:05d}-of-{shards:05d}.safetensors"),
                  metadata={"format": "pt"})
    return str(path)


# family -> (registry name, HF model factory, JAX converter, port converter,
#            (text rtol, atol), (image rtol, atol))
FAMILIES = {
    "colpali": ("tiny-colpali", hf_colpali, JH.colpali_params_from_hf,
                TH.colpali_params_from_hf, (2e-4, 2e-5), (5e-4, 5e-5)),
    "colflor": ("tiny-colflor", hf_colflor, JH.colflor_params_from_hf,
                TH.colflor_params_from_hf, (3e-4, 3e-5), (6e-4, 6e-5)),
    "colidefics3": ("tiny-colidefics3", hf_colidefics3, JH.colidefics3_params_from_hf,
                    TH.colidefics3_params_from_hf, (3e-4, 3e-5), (5e-4, 5e-5)),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def retriever_ckpt(request, tmp_path_factory):
    """(family, registry name, cfg, float32 checkpoint dir, bf16 checkpoint
    dir, HF forward) of one tiny family."""
    name, build, *_ = FAMILIES[request.param]
    cfg = TR.RETRIEVER_CONFIGS[name]()
    sd, forward = build(cfg)
    root = tmp_path_factory.mktemp(request.param)
    f32 = save_sharded(sd, root / "f32" / name)
    bf16 = save_sharded(sd, root / "bf16", dtype=torch.bfloat16, shards=3)
    return request.param, name, cfg, f32, bf16, forward


def test_converted_tree_equals_jax_leaf_for_leaf(retriever_ckpt):
    family, name, cfg, f32, *_ = retriever_ckpt
    _, _, jconv, tconv, *_ = FAMILIES[family]
    want = params_from_flax(jconv(JH.load_state_dict(f32), cfg), cfg)
    got = params_from_flax(tconv(TH.load_state_dict(f32), cfg), cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k


def _inputs(cfg, family, rng):
    """(text ids, text mask, image ids, image mask, NCHW pixels)."""
    ids = rng.integers(0, 60, size=(2, 9)).astype(np.int64)
    mask = np.ones((2, 9), np.int64)
    mask[1, 6:] = 0
    n_img = {"colpali": lambda: cfg.vision.num_patches, "colflor": lambda: 17,
             "colidefics3": lambda: cfg.n_image_tokens}[family]()
    size = cfg.image_size if family == "colflor" else cfg.vision.image_size
    img_ids = np.asarray([[cfg.image_token_id] * n_img + [2, 5, 9, 11]] * 2, np.int64)
    pix = rng.standard_normal((2, 3, size, size)).astype(np.float32)
    return ids, mask, img_ids, np.ones_like(img_ids), pix


@pytest.mark.parametrize("route", ["checkpoint_dir", "env"])
def test_loaded_retriever_matches_hf(retriever_ckpt, monkeypatch, route):
    """Loaded through either route, the port's forward matches the HF
    forward at the JAX parity tests' tolerances, text and image."""
    family, name, cfg, f32, _, forward = retriever_ckpt
    *_, text_tol, image_tol = FAMILIES[family]
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    if route == "env":
        monkeypatch.setenv("COLPALI_TPU_CKPT_DIR", str(Path(f32).parent))
        kw = {}
    else:
        kw = {"checkpoint_dir": f32}
    with warnings.catch_warnings():
        warnings.simplefilter("error")           # a found checkpoint: no random-init warning
        retr = TR.load_retriever(name, device="cpu", dtype=torch.float32, **kw)
    ids, mask, img_ids, img_mask, pix = _inputs(cfg, family, np.random.default_rng(0))
    t = torch.from_numpy
    with torch.no_grad():
        got = retr.model(t(ids), t(mask)).numpy()
        got_img = retr.model(t(img_ids), t(img_mask),
                             t(pix.transpose(0, 2, 3, 1).copy())).numpy()
    np.testing.assert_allclose(got, forward(ids, mask), rtol=text_tol[0], atol=text_tol[1])
    np.testing.assert_allclose(got_img, forward(img_ids, img_mask, pix), rtol=image_tol[0],
                               atol=image_tol[1])


def test_bf16_checkpoint_loads_in_the_file_dtype(retriever_ckpt):
    """Published checkpoints are bf16. The port keeps the file's bf16 (each
    parameter equals the file's tensor); the JAX converter reads the same
    file (numpy knows bfloat16 once jax has loaded ml_dtypes) into a float32
    tree on the host, whose values are the same numbers."""
    family, name, cfg, _, bf16, _ = retriever_ckpt
    _, _, jconv, tconv, *_ = FAMILIES[family]
    retr = TR.load_retriever(name, device="cpu", dtype=torch.bfloat16, checkpoint_dir=bf16)
    want = params_from_flax(tconv(TH.load_state_dict(bf16), cfg), cfg)
    state = retr.model.state_dict()
    jax_tree = params_from_flax(jconv(JH.load_state_dict(bf16), cfg), cfg)
    for k, v in want.items():
        assert v.dtype == torch.bfloat16 and torch.equal(state[k], v), k
        assert jax_tree[k].dtype == torch.float32 and torch.equal(jax_tree[k], v.float()), k


# -- tokenizer ------------------------------------------------------------------------

def _write_tokenizer(path, with_eos=True):
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"<pad>": 0, "<unk>": 1, "<bos>": 2, "<eos>": 3}
    for w in "the page shows a table of binding constants figure".split():
        vocab.setdefault(w, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    os.makedirs(path, exist_ok=True)
    tok.save(os.path.join(path, "tokenizer.json"))
    special = {"pad_token": "<pad>", "bos_token": "<bos>", "unk_token": "<unk>"}
    if with_eos:
        special["eos_token"] = "<eos>"
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", **special}, f)


@pytest.mark.parametrize("with_eos", [True, False])
def test_tokenizer_loads_as_in_jax(tmp_path, with_eos):
    _write_tokenizer(tmp_path, with_eos)
    j, t = JR._load_tokenizer_from(str(tmp_path)), TR._load_tokenizer_from(str(tmp_path))
    assert (t.pad_id, t.bos_id, t.eos_id, t.vocab_size) == \
        (j.pad_id, j.bos_id, j.eos_id, j.vocab_size)
    assert t.eos_id == (3 if with_eos else 1)     # a missing eos reads as 1
    for text in ("the page shows a table", "binding constants of the figure", "unknown words"):
        for special in (False, True):
            assert t.encode(text, add_special_tokens=special) == \
                j.encode(text, add_special_tokens=special)
        ids = t.encode(text)
        assert t.decode(ids + [0, 3]) == j.decode(ids + [0, 3])
    os.remove(tmp_path / "tokenizer.json")            # no tokenizer files: None in both
    assert TR._load_tokenizer_from(str(tmp_path)) is None
    assert JR._load_tokenizer_from(str(tmp_path)) is None


def test_a_checkpoint_tokenizer_replaces_the_processors(tmp_path, monkeypatch):
    """Unless ``tokenizer=`` is given (registry.py:515-518)."""
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    cfg = TR.RETRIEVER_CONFIGS["tiny-colpali"]()
    path = save_sharded(hf_colpali(cfg)[0], tmp_path / "ckpt")
    _write_tokenizer(path)
    retr = TR.load_retriever("tiny-colpali", device="cpu", checkpoint_dir=path)
    assert retr.processor.tokenizer.encode("the page") == [4, 5]
    mine = object()
    retr = TR.load_retriever("tiny-colpali", device="cpu", checkpoint_dir=path, tokenizer=mine)
    assert retr.processor.tokenizer is mine


# -- Gemma-3 --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gemma3_ckpt(tmp_path_factory):
    cfg = TR.GEMMA3_CONFIGS["tiny-gemma3"]()
    sd, hf = hf_gemma3(cfg)
    root = tmp_path_factory.mktemp("gemma3")
    return cfg, save_sharded(sd, root / "f32"), save_sharded(sd, root / "bf16",
                                                             dtype=torch.bfloat16), hf


def _flat(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def test_gemma3_tree_equals_jax_and_streams_match(gemma3_ckpt):
    """From the float32 file the port's engine tree equals the JAX
    converter's leaf for leaf, and the greedy streams are token-identical to
    the JAX engine's and to HF's."""
    cfg, f32, _, hf = gemma3_ckpt
    want = JH.gemma3_params_from_hf(JH.load_state_dict(f32), cfg)
    got = TH.gemma3_params_from_hf(TH.load_state_dict(f32), cfg)
    pairs = list(zip(_flat(got), _flat(want)))
    assert [p for (p, _), _ in pairs] == [p for _, (p, _) in pairs]
    for (path, g), (_, w) in pairs:
        assert torch.equal(g, torch.from_numpy(np.asarray(w))), path
    jcfg, jparams, _ = JR.load_gemma3_lm("tiny-gemma3", checkpoint_dir=f32)
    tcfg, tparams, tok = TR.load_gemma3_lm("tiny-gemma3", device="cpu", dtype=torch.float32,
                                           checkpoint_dir=f32)
    assert tok is None                               # the checkpoint has no tokenizer
    jeng = JEngine(jcfg, jax.tree.map(jnp.asarray, jparams))
    teng = GemmaDecodeEngine(tcfg, tparams, device="cpu")
    prompts = [[3, 17, 42, 7, 9, 23, 55, 4, 11, 30, 8, 2, 19], [5, 9], list(range(3, 24))]
    got = teng.generate(prompts, max_new_tokens=16)
    assert got == jeng.generate(prompts, max_new_tokens=16)
    ids = torch.tensor([prompts[0]])
    with torch.no_grad():
        out = hf.generate(input_ids=ids, attention_mask=torch.ones_like(ids), max_new_tokens=16,
                          do_sample=False)
    assert got[0] == out[0, len(prompts[0]):].tolist()


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_gemma3_quantized_at_load_equals_the_whole_tree(gemma3_ckpt, fmt):
    """Leaf by leaf at load, the codes and scales are byte-identical to
    quantizing the loaded bf16 tree whole, and the engine detects them."""
    cfg, _, bf16, _ = gemma3_ckpt
    _, native, _ = TR.load_gemma3_lm("tiny-gemma3", device="cpu", checkpoint_dir=bf16)
    whole = _tree_to(native, torch.device("cpu"), torch.bfloat16)
    whole = quantize_lm_params(whole) if fmt == "int8" else quantize_lm_params_int4(whole)
    _, leafwise, _ = TR.load_gemma3_lm("tiny-gemma3", device="cpu", checkpoint_dir=bf16,
                                       weight_dtype=fmt)
    a, b = list(_flat(leafwise)), list(_flat(whole))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), path
    assert GemmaDecodeEngine(cfg, leafwise, dtype=torch.bfloat16, device="cpu").weight_dtype \
        == fmt


# -- chip_smoke's checkpoint writer ----------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_writer_lists_the_hf_state_dict(smoke):
    """The tensors chip_smoke writes for a ColPali are, name for name and
    shape for shape, the HF ``ColPaliForRetrieval`` state dict as
    transformers saves it: the SigLIP tower without its unused pooling head,
    and without the LM head tied to the embedding table."""
    from transformers import ColPaliConfig, ColPaliForRetrieval
    from transformers.models.paligemma import PaliGemmaConfig

    cfg = TR.RETRIEVER_CONFIGS["tiny-colpali"]()
    v, t = cfg.vision, cfg.text
    hf = ColPaliForRetrieval(ColPaliConfig(
        vlm_config=PaliGemmaConfig(
            vision_config=dict(hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
                               num_hidden_layers=v.num_hidden_layers,
                               num_attention_heads=v.num_attention_heads,
                               image_size=v.image_size, patch_size=v.patch_size,
                               vision_use_head=False),
            text_config=dict(hidden_size=t.hidden_size, intermediate_size=t.intermediate_size,
                             num_hidden_layers=t.num_hidden_layers,
                             num_attention_heads=t.num_attention_heads,
                             num_key_value_heads=t.num_key_value_heads, head_dim=t.head_dim,
                             vocab_size=t.vocab_size),
            projection_dim=v.projection_dim, image_token_index=cfg.image_token_id),
        embedding_dim=cfg.embedding_dim))
    want = [(k, tuple(p.shape)) for k, p in hf.state_dict().items() if k != "vlm.lm_head.weight"]
    assert smoke.colpali_hf_tensors(cfg) == want


def test_smoke_writer_round_trips_through_the_loader(smoke, tmp_path, monkeypatch):
    """Written at tiny size on the CPU, sharded, the checkpoint reads as the
    library reads it, loads through ``load_retriever`` with its leaves equal
    to the file's, and its norm weights are the identity."""
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    cfg = TR.RETRIEVER_CONFIGS["tiny-colpali"]()
    info = smoke.write_colpali_checkpoint(torch, cfg, str(tmp_path), seed=3, shards=3,
                                          device="cpu")
    files = sorted(os.listdir(tmp_path))
    assert files == [f"model-0000{i}-of-00003.safetensors" for i in (1, 2, 3)]
    assert info["bytes"] == sum(os.path.getsize(tmp_path / f) for f in files)
    sd = TH.load_state_dict(str(tmp_path))
    lib = {}
    for f in files:
        lib.update(load_file(str(tmp_path / f)))
    _assert_same({k: sd[k] for k in lib}, lib)
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    norms = [k for k in sd if re.search(r"norm\d?\.weight$|layernorm\.weight$", k)]
    assert norms and all(
        torch.all(sd[k] == (0 if ".language_model." in k else 1)) for k in norms)
    retr = TR.load_retriever("tiny-colpali", device="cpu", checkpoint_dir=str(tmp_path))
    checked = smoke.check_loaded_leaves(torch, retr.model, cfg, str(tmp_path))
    assert len(checked) >= 8


# -- the source --------------------------------------------------------------------------

_EAGER = re.compile(r"^(?:import|from)\s+(?:safetensors|transformers|PIL|tokenizers)\b", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    [*(REPO / "multimodal_colpali_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]))
def test_optional_libraries_are_imported_lazily(path):
    """safetensors, transformers, tokenizers and Pillow are not on the card's
    machine: no module of the port, and not chip_smoke.py, imports them at
    its top level."""
    assert not _EAGER.findall((REPO / path).read_text()), path
