"""The port's registry against the JAX registry: where a checkpoint is found,
and which environment switches ``load_retriever`` reads.

Wherever the JAX registry loads a checkpoint the port loads it too (never
random weights in its place), and where none is found both warn and
random-init, an explicit empty or missing ``checkpoint_dir`` included;
``MMCP_QUANTIZE`` and ``MMCP_DEVICE_PREPROCESS`` act as in the JAX registry
(registry.py:532-535). ``tests/test_torch_checkpoint.py`` holds the loaded
weights against HF and JAX.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from multimodal_colpali_tpu.models import registry as JR
from multimodal_colpali_tpu_torch import serve
from multimodal_colpali_tpu_torch.models import registry as TR


def _write(path, name):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, name), "wb") as f:
        f.write(b"\0" * 16)


@pytest.fixture
def ckpt_env(tmp_path, monkeypatch):
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    return tmp_path


@pytest.mark.parametrize("layout", [
    "explicit", "env_dashed", "env_basename", "empty", "bin_only", "none", "explicit_over_env",
    "explicit_missing"])
def test_find_checkpoint_agrees_with_jax(ckpt_env, monkeypatch, layout):
    """The same tmp directories give the same answer in both registries:
    the explicit dir, then ``$COLPALI_TPU_CKPT_DIR/<org--name>``, then
    ``$COLPALI_TPU_CKPT_DIR/<basename>``, each holding a .safetensors or
    .bin file."""
    name = "vidore/colpali-v1.3"
    explicit = None
    root = ckpt_env / "ckpts"
    if layout == "explicit":
        explicit = str(ckpt_env / "mine")
        _write(explicit, "model.safetensors")
    elif layout == "env_dashed":
        _write(root / "vidore--colpali-v1.3", "model.safetensors")
        monkeypatch.setenv("COLPALI_TPU_CKPT_DIR", str(root))
    elif layout == "env_basename":
        _write(root / "colpali-v1.3", "model-00001-of-00002.safetensors")
        monkeypatch.setenv("COLPALI_TPU_CKPT_DIR", str(root))
    elif layout == "empty":
        (root / "vidore--colpali-v1.3").mkdir(parents=True)
        _write(root / "colpali-v1.3", "config.json")
        monkeypatch.setenv("COLPALI_TPU_CKPT_DIR", str(root))
    elif layout == "bin_only":
        _write(root / "colpali-v1.3", "pytorch_model.bin")
        monkeypatch.setenv("COLPALI_TPU_CKPT_DIR", str(root))
    elif layout == "explicit_over_env":
        explicit = str(ckpt_env / "mine")
        _write(explicit, "model.bin")
        _write(root / "vidore--colpali-v1.3", "model.safetensors")
        monkeypatch.setenv("COLPALI_TPU_CKPT_DIR", str(root))
    elif layout == "explicit_missing":
        explicit = str(ckpt_env / "absent")
        _write(root / "colpali-v1.3", "model.safetensors")
        monkeypatch.setenv("COLPALI_TPU_CKPT_DIR", str(root))
    want = JR._find_checkpoint(name, explicit)
    assert TR._find_checkpoint(name, explicit) == want
    assert (want is None) == (layout in ("empty", "none"))


def _tiny_safetensors(path):
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    save_file({"w": torch.zeros(2, 2)}, os.path.join(path, "model.safetensors"))


@pytest.mark.parametrize("name", ["tiny-colpali", "tiny-colflor"])
def test_load_retriever_loads_a_found_checkpoint(ckpt_env, monkeypatch, name):
    """A checkpoint the JAX registry would load is loaded, never replaced by
    random weights: found under ``COLPALI_TPU_CKPT_DIR`` or named by
    ``checkpoint_dir``, its weights are the model's, without a random-init
    warning."""
    from tests.test_torch_checkpoint import hf_colflor, hf_colpali, save_sharded

    cfg = TR.RETRIEVER_CONFIGS[name]()
    sd = (hf_colpali if name == "tiny-colpali" else hf_colflor)(cfg)[0]
    save_sharded(sd, ckpt_env / name)
    want = next(v for k, v in sd.items() if k.endswith("embed_tokens.weight"))
    monkeypatch.setenv("COLPALI_TPU_CKPT_DIR", str(ckpt_env))
    for kw in ({}, {"checkpoint_dir": str(ckpt_env / name)}):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            r = TR.load_retriever(name, device="cpu", dtype=torch.float32, **kw)
        got = next(v for k, v in r.model.state_dict().items() if k.endswith("embed_tokens"))
        assert torch.equal(got, want)


def test_load_gemma3_lm_and_serve_load_a_found_checkpoint(ckpt_env, monkeypatch):
    """A found Gemma-3 checkpoint is loaded by ``load_gemma3_lm`` (native and
    int4) and by ``serve.build``, as in the JAX registry. ``serve.build``
    loads the whole generator through ``load_gemma3_mm``, as JAX's 07 does,
    so the checkpoint it finds is a ``Gemma3ForConditionalGeneration``'s:
    its LM, tower and projector are the engines'."""
    from tests.test_torch_checkpoint import hf_gemma3, save_sharded
    from tests.test_torch_gemma3_mm import _hf_model

    sd, _ = hf_gemma3(TR.GEMMA3_CONFIGS["tiny-gemma3"]())
    save_sharded(sd, ckpt_env / "tiny-gemma3")
    monkeypatch.setenv("COLPALI_TPU_CKPT_DIR", str(ckpt_env))
    want = sd["model.embed_tokens.weight"]
    _, params, _ = TR.load_gemma3_lm("tiny-gemma3", device="cpu", dtype=torch.float32)
    assert torch.equal(params["embed"]["embed_tokens"], want)
    _, params, _ = TR.load_gemma3_lm("tiny-gemma3", device="cpu", weight_dtype="int4")
    assert params["embed"]["embed_tokens"]["q8"].shape[1] == want.shape[1]
    _, jparams, _ = JR.load_gemma3_lm("tiny-gemma3")
    assert np.array_equal(np.asarray(jparams["embed"]["embed_tokens"]), want.numpy())
    mm_sd = _hf_model(TR.GEMMA3_MM_CONFIGS["tiny-gemma3"]()).state_dict()
    save_sharded(mm_sd, ckpt_env / "mm" / "tiny-gemma3")
    monkeypatch.setenv("COLPALI_TPU_CKPT_DIR", str(ckpt_env / "mm"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng, _, mm, _ = serve.build(serve.parse_args(["--model", "tiny-gemma3", "--device",
                                                     "cpu", "--dtype", "float32"]))
    assert torch.equal(eng.params["embed"]["embed_tokens"],
                       mm_sd["model.language_model.embed_tokens.weight"])
    assert mm.lm is eng
    vt = "model.vision_tower.vision_model."
    assert torch.equal(mm.vision_tower.position_embedding,
                       mm_sd[vt + "embeddings.position_embedding.weight"])
    assert torch.equal(mm.projector["mm_input_projection"],
                       mm_sd["model.multi_modal_projector.mm_input_projection_weight"])


@pytest.mark.parametrize("layout", ["missing", "empty"])
def test_explicit_empty_checkpoint_dir_random_inits_in_both_packages(ckpt_env, layout):
    """F3: a ``checkpoint_dir`` that is missing, or holds no weight file,
    finds no checkpoint: both registries warn and random-init, in
    ``load_retriever`` and ``load_gemma3_lm``, and so does ``serve.build``."""
    path = ckpt_env / "ckpt"
    if layout == "empty":
        _write(path, "config.json")
    with pytest.warns(UserWarning, match="random init"):
        JR.load_retriever("tiny-colpali", checkpoint_dir=str(path))
    with pytest.warns(UserWarning, match="random init"):
        r = TR.load_retriever("tiny-colpali", device="cpu", checkpoint_dir=str(path))
    assert r.family == "colpali"
    with pytest.warns(UserWarning, match="random init"):
        JR.load_gemma3_lm("tiny-gemma3", checkpoint_dir=str(path))
    with pytest.warns(UserWarning, match="random init"):
        cfg, params, tok = TR.load_gemma3_lm("tiny-gemma3", device="cpu",
                                             checkpoint_dir=str(path))
    assert tok is None and params["embed"]["embed_tokens"].shape == (cfg.vocab_size,
                                                                     cfg.hidden_size)
    with pytest.warns(UserWarning, match="random init"):
        serve.build(serve.parse_args(["--model", "tiny-gemma3", "--device", "cpu"]))


def test_without_a_checkpoint_random_init_stays(ckpt_env, monkeypatch):
    """No checkpoint found (the variable points elsewhere): random weights,
    with the warning, as in the JAX registry."""
    _tiny_safetensors(ckpt_env / "some-other-model")
    monkeypatch.setenv("COLPALI_TPU_CKPT_DIR", str(ckpt_env))
    with pytest.warns(UserWarning, match="random init"):
        r = TR.load_retriever("tiny-colpali", device="cpu", dtype=torch.float32)
    assert r.family == "colpali"
    with pytest.warns(UserWarning, match="random init"):
        TR.load_gemma3_lm("tiny-gemma3", device="cpu", dtype=torch.float32)


def test_mmcp_quantize_acts_as_quantize(monkeypatch):
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    monkeypatch.setenv("MMCP_QUANTIZE", "int8")
    with pytest.warns(UserWarning, match="random init"):
        r = TR.load_retriever("tiny-colpali", device="cpu")
    assert r.quantize == "int8"
    assert {p.dtype for p in r.model.parameters()} == {torch.int8, torch.bfloat16}
    monkeypatch.setenv("MMCP_QUANTIZE", "int3")
    with pytest.raises(ValueError, match="int3"):
        TR.load_retriever("tiny-colpali", device="cpu")
    monkeypatch.setenv("MMCP_QUANTIZE", "")          # empty reads as unset
    with pytest.warns(UserWarning, match="random init"):
        TR.load_retriever("tiny-colpali", device="cpu", dtype=torch.float32)


def test_mmcp_device_preprocess_acts_as_device_preprocess(monkeypatch):
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    monkeypatch.delenv("MMCP_QUANTIZE", raising=False)
    monkeypatch.setenv("MMCP_DEVICE_PREPROCESS", "1")
    with pytest.warns(UserWarning, match="random init"):
        r = TR.load_retriever("tiny-colpali", device="cpu", dtype=torch.float32)
    assert r.device_preprocess
    assert not TR.load_retriever("tiny-colpali", device="cpu", dtype=torch.float32,
                                 device_preprocess=False).device_preprocess
    with pytest.raises(ValueError, match="device_preprocess"):
        TR.load_retriever("tiny-colflor", device="cpu", dtype=torch.float32)
    monkeypatch.setenv("MMCP_DEVICE_PREPROCESS", "0")
    with pytest.warns(UserWarning, match="random init"):
        assert not TR.load_retriever("tiny-colpali", device="cpu",
                                     dtype=torch.float32).device_preprocess
