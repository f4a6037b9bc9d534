"""The port's Qwen2 and Llama decode engines against the JAX package's, on the CPU.

Tiny HF ``Qwen2VLForConditionalGeneration`` and ``LlamaForCausalLM`` models
are built in-process (``tests/test_qwen2_engine.py``,
``tests/test_llama_engine.py``), with a tied and an untied head each. Their
state dicts go through both packages' converters, which must give the same
trees; the JAX tree then runs in both engines in float32. Prefill logits
agree within rtol 1e-5, and the greedy streams of ``generate`` and of both
batchers are token-identical to JAX's ``generate`` (int8 KV pools, with the
tied heads: to JAX's paged batcher with int8 pools), for native, int8 and
int4 weights (the quantized trees byte-identical to JAX's quantizers').
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_colpali_tpu.generation import engine as JE
from multimodal_colpali_tpu.models import hf_import as JH
from multimodal_colpali_tpu.models import registry as JR
from multimodal_colpali_tpu.models.clip import LlavaNextMMConfig as JLlavaCfg
from multimodal_colpali_tpu.models.idefics3 import LlamaTextConfig as JLlama
from multimodal_colpali_tpu.models.qwen2vl import ColQwen2ModelConfig as JQwen
from multimodal_colpali_tpu_torch.generation import engine as TE
from multimodal_colpali_tpu_torch.generation.paged import PagedContinuousBatcher
from multimodal_colpali_tpu_torch.generation.scheduler import ContinuousBatcher
from multimodal_colpali_tpu_torch.models import configs as TC
from multimodal_colpali_tpu_torch.models import hf_import as TH
from multimodal_colpali_tpu_torch.models import registry as TR
from multimodal_colpali_tpu_torch.models.convert import engine_params_from_jax

torch.set_num_threads(1)

PROMPTS = [[5, 9, 17, 3, 9, 17], [40, 2], list(range(3, 24))]
N_NEW = 8


def hf_qwen2vl(cfg, tie: bool):
    from transformers import Qwen2VLForConditionalGeneration
    from transformers.models.qwen2_vl import Qwen2VLConfig

    v, t = cfg.vision, cfg.text
    hf_cfg = Qwen2VLConfig(
        vision_config=dict(depth=v.depth, embed_dim=v.embed_dim, hidden_size=v.hidden_size,
                           num_heads=v.num_heads, in_chans=3,
                           spatial_merge_size=v.spatial_merge_size, patch_size=v.patch_size,
                           temporal_patch_size=v.temporal_patch_size, mlp_ratio=v.mlp_ratio),
        text_config=dict(hidden_size=t.hidden_size, intermediate_size=t.intermediate_size,
                         num_hidden_layers=t.num_hidden_layers,
                         num_attention_heads=t.num_attention_heads,
                         num_key_value_heads=t.num_key_value_heads, vocab_size=t.vocab_size,
                         rope_theta=t.rope_theta, rms_norm_eps=t.rms_norm_eps,
                         tie_word_embeddings=tie,
                         rope_scaling={"rope_type": "default",
                                       "mrope_section": list(t.mrope_section)}),
        image_token_id=cfg.image_token_id, video_token_id=cfg.image_token_id - 3,
        vision_start_token_id=cfg.vision_start_token_id,
        vision_end_token_id=cfg.vision_end_token_id)
    torch.manual_seed(0)
    return Qwen2VLForConditionalGeneration(hf_cfg).eval()


def hf_llama(cfg):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    return LlamaForCausalLM(LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads, rms_norm_eps=cfg.rms_norm_eps,
        rope_theta=cfg.rope_theta, tie_word_embeddings=cfg.tie_word_embeddings,
        attention_bias=False, mlp_bias=False)).eval()


def leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def assert_trees_equal(got, want):
    g, w = dict(leaves(got)), dict(leaves(want))
    assert g.keys() == w.keys()
    for k in g:
        a = g[k].detach().float().numpy() if isinstance(g[k], torch.Tensor) else g[k]
        np.testing.assert_array_equal(a, np.asarray(w[k], np.float32), err_msg=str(k))


@pytest.fixture(scope="module", params=["qwen2-tied", "qwen2-untied", "llama-tied",
                                        "llama-untied"])
def lm(request):
    """(arch, JAX cfg, port cfg, JAX LM tree as numpy, HF state dict)."""
    arch, head = request.param.split("-")
    tie = head == "tied"
    if arch == "qwen2":
        full = JQwen.tiny(vocab_size=64)
        full = dataclasses.replace(full, text=dataclasses.replace(full.text,
                                                                  tie_word_embeddings=tie))
        sd = hf_qwen2vl(full, tie).state_dict()
        tree = JH.qwen2vl_lm_params_from_hf(sd, full)
        jcfg = full.text
        tcfg = dataclasses.replace(TC.Qwen2TextConfig.tiny(vocab_size=64),
                                   tie_word_embeddings=tie)
    else:
        jcfg = dataclasses.replace(JLlama.tiny_lm(vocab_size=64), tie_word_embeddings=tie)
        tcfg = dataclasses.replace(TC.LlamaTextConfig.tiny_lm(vocab_size=64),
                                   tie_word_embeddings=tie)
        sd = hf_llama(jcfg).state_dict()
        tree = JH.llama_lm_params_from_hf(sd, jcfg)
    tree = {"embed": tree["embed"], "language_model": tree["language_model"]}
    return arch, jcfg, tcfg, jax.tree.map(np.asarray, tree), sd


def engines(lm, weight_dtype="native", jax_tree=None):
    """(JAX engine, port engine) on the LM tree; the JAX one on ``jax_tree``
    where given (an already quantized tree, which it takes as it is)."""
    arch, jcfg, tcfg, tree, _ = lm
    jcls, tcls = ((JE.Qwen2DecodeEngine, TE.Qwen2DecodeEngine) if arch == "qwen2"
                  else (JE.LlamaDecodeEngine, TE.LlamaDecodeEngine))
    jeng = jcls(jcfg, jax.tree.map(jnp.asarray, tree) if jax_tree is None else jax_tree,
                weight_dtype=weight_dtype)
    teng = tcls(tcfg, engine_params_from_jax(tree, device="cpu"), dtype=torch.float32,
                weight_dtype=weight_dtype, device="cpu")
    return jeng, teng


def test_configs_and_head_follow_jax(lm):
    arch, jcfg, tcfg, tree, _ = lm
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads", "rms_norm_eps", "rope_theta",
              "head_dim", "mrope_section", "tie_word_embeddings"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert ("lm_head" in tree["language_model"]) == (not tcfg.tie_word_embeddings)
    assert ("bias" in tree["language_model"]["layers_0"]["self_attn"]["q_proj"]) == \
        (arch == "qwen2")


def test_hf_converters_match_jax(lm):
    arch, jcfg, tcfg, tree, sd = lm
    if arch == "qwen2":
        full = dataclasses.replace(TC.ColQwen2ModelConfig.tiny(vocab_size=64), text=tcfg)
        got = TH.qwen2vl_lm_params_from_hf(sd, full)
        want = JH.qwen2vl_lm_params_from_hf(sd, dataclasses.replace(
            JQwen.tiny(vocab_size=64), text=jcfg))
        assert_trees_equal(got["visual"], want["visual"])
    else:
        got = TH.llama_lm_params_from_hf(sd, tcfg)
    assert_trees_equal({"embed": got["embed"], "language_model": got["language_model"]}, tree)


def test_llava_nested_state_dict_converts_like_jax():
    from transformers import LlavaNextConfig, LlavaNextForConditionalGeneration

    jcfg = JLlavaCfg.tiny(vocab_size=64)
    tcfg = TC.LlavaNextMMConfig.tiny(vocab_size=64)
    v, t = jcfg.vision, jcfg.text
    hf_cfg = LlavaNextConfig(
        vision_config=dict(model_type="clip_vision_model", hidden_size=v.hidden_size,
                           intermediate_size=v.intermediate_size,
                           num_hidden_layers=v.num_hidden_layers,
                           num_attention_heads=v.num_attention_heads,
                           image_size=v.image_size, patch_size=v.patch_size,
                           hidden_act="quick_gelu", layer_norm_eps=v.layer_norm_eps),
        text_config=dict(model_type="llama", vocab_size=t.vocab_size,
                         hidden_size=t.hidden_size, intermediate_size=t.intermediate_size,
                         num_hidden_layers=t.num_hidden_layers,
                         num_attention_heads=t.num_attention_heads,
                         num_key_value_heads=t.num_key_value_heads,
                         rms_norm_eps=t.rms_norm_eps, rope_theta=t.rope_theta,
                         tie_word_embeddings=t.tie_word_embeddings),
        image_token_index=jcfg.image_token_id, vision_feature_layer=-2,
        vision_feature_select_strategy="default",
        image_grid_pinpoints=[[v.image_size, v.image_size]])
    torch.manual_seed(0)
    sd = LlavaNextForConditionalGeneration(hf_cfg).state_dict()
    assert_trees_equal(TH.llava_next_params_from_hf(sd, tcfg),
                       jax.tree.map(np.asarray, JH.llava_next_params_from_hf(sd, jcfg)))
    # the LM alone from the nested layout
    assert_trees_equal(TH.llama_lm_params_from_hf(sd, tcfg.text),
                       jax.tree.map(np.asarray, JH.llama_lm_params_from_hf(sd, jcfg.text)))


def test_prefill_logits_match_jax(lm):
    jeng, teng = engines(lm)
    want = jeng.next_token_logits(PROMPTS)
    got = teng.next_token_logits(PROMPTS)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("weight_dtype", ["native", "int8", "int4"])
def test_greedy_streams_match_jax_in_generate_and_both_batchers(lm, weight_dtype):
    want_tree = None
    if weight_dtype != "native":
        # the quantized trees are JAX's quantizers' (run eagerly) byte for
        # byte, and JAX's engine decodes from those very bytes
        from multimodal_colpali_tpu.ops import quant as JQ

        quantize = JQ.quantize_lm_params if weight_dtype == "int8" else \
            JQ.quantize_lm_params_int4
        want_tree = quantize(jax.tree.map(jnp.asarray, lm[3]))
    jeng, teng = engines(lm, weight_dtype, want_tree)
    if weight_dtype != "native":
        assert_trees_equal(teng.params, jax.tree.map(np.asarray, want_tree))
        assert teng.weight_dtype == jeng.weight_dtype == weight_dtype
    want = jeng.generate(PROMPTS, max_new_tokens=N_NEW)
    assert teng.generate(PROMPTS, max_new_tokens=N_NEW) == want
    runs = [(PagedContinuousBatcher, {"page_size": 8})]
    if weight_dtype == "native":
        runs += [(ContinuousBatcher, {})]
        if lm[2].tie_word_embeddings:
            # the pools never see the head: int8 KV once an architecture
            runs += [(PagedContinuousBatcher, {"page_size": 8, "kv_dtype": "int8"})]
    for cls, kw in runs:
        bat = cls(teng, batch_slots=2, max_seq_len=64, chunk=3, **kw)
        futs = [bat.submit(p, max_new_tokens=N_NEW) for p in PROMPTS]
        bat.drain()
        got = [f.result(10) for f in futs]
        if kw.get("kv_dtype") == "int8":
            # int8 pools against JAX's paged batcher with int8 pools
            from multimodal_colpali_tpu.generation.paged import PagedContinuousBatcher as JP

            jb = JP(jeng, batch_slots=2, max_seq_len=64, chunk=3, **kw)
            jf = [jb.submit(p, max_new_tokens=N_NEW) for p in PROMPTS]
            jb.drain()
            assert got == [f.result(10) for f in jf], (cls.__name__, kw)
        else:
            assert got == want, (cls.__name__, kw)


QWEN_NAMES = ["AdaptLLM/biomed-Qwen2-VL-2B-Instruct", "Qwen/Qwen2-VL-2B-Instruct",
              "qwen2-vl-2b", "Qwen/Qwen2-VL-7B-Instruct", "qwen2-vl-7b", "tiny-qwen2vl"]


@pytest.mark.parametrize("name", QWEN_NAMES)
def test_qwen2vl_registry_matches_jax(name):
    j, t = JR.QWEN2VL_CONFIGS[name](), TR.QWEN2VL_CONFIGS[name]()
    assert vars(t) == vars(j)
    jf, tf = JR._QWEN2VL_FULL[name](), TR._QWEN2VL_FULL[name]()
    assert vars(tf.vision) == vars(jf.vision) and vars(tf.text) == vars(jf.text)
    assert (tf.image_token_id, tf.grid_h, tf.grid_w) == (jf.image_token_id, jf.grid_h, jf.grid_w)


@pytest.mark.parametrize("name", ["AdaptLLM/biomed-LLaVA-NeXT-Llama3-8B",
                                  "meta-llama/Meta-Llama-3-8B-Instruct", "llama-3-8b",
                                  "tiny-llama"])
def test_llama_registry_matches_jax(name):
    j, t = JR.LLAMA_CONFIGS[name](), TR.LLAMA_CONFIGS[name]()
    for f, val in vars(t).items():
        assert getattr(j, f) == val, f
    assert (t.head_dim, t.mrope_section) == (j.head_dim, j.mrope_section)


@pytest.mark.parametrize("name", ["AdaptLLM/biomed-LLaVA-NeXT-Llama3-8B",
                                  "llava-next-llama3-8b", "tiny-llava-next"])
def test_llava_next_registry_matches_jax(name):
    j, t = JR.LLAVA_NEXT_CONFIGS[name](), TR.LLAVA_NEXT_CONFIGS[name]()
    assert vars(t.vision) == vars(j.vision)
    for f, val in vars(t.text).items():
        assert getattr(j.text, f) == val, f
    for f in ("image_token_id", "vision_feature_layer", "grid", "n_image_tokens"):
        assert getattr(t, f) == getattr(j, f), f


def test_full_width_shapes_and_counts():
    """The shape trees equal JAX's, and the 2B / 8B models are the sizes their
    cards say."""
    for t, j in ((TC.Qwen2TextConfig.qwen2_vl_2b(), JQwen.qwen2_vl_2b().text),
                 (TC.LlavaNextMMConfig.llava_next_llama3_8b().text,
                  JLlavaCfg.llava_next_llama3_8b().text)):
        got = dict(leaves(TR.qwen2vl_param_shapes(t)))
        want = {k: tuple(v.shape) for k, v in leaves(JR.qwen2vl_param_shapes(j))}
        assert got == want
    n = {name: sum(int(np.prod(s)) for _, s in leaves(TR.qwen2vl_param_shapes(c)))
         for name, c in (("qwen", TC.Qwen2TextConfig.qwen2_vl_2b()),
                         ("llama", TC.LlavaNextMMConfig.llava_next_llama3_8b().text))}
    assert 1.5e9 < n["qwen"] < 1.6e9 and 8.0e9 < n["llama"] < 8.1e9
    assert TC.LlavaNextMMConfig.llava_next_llama3_8b().n_image_tokens == 1176


@pytest.mark.parametrize("loader,name", [
    ("load_qwen2vl_lm", "tiny-qwen2vl"), ("load_qwen2vl_mm", "tiny-qwen2vl"),
    ("load_llama_lm", "tiny-llama"), ("load_llava_next_mm", "tiny-llava-next")])
def test_loaders_random_init_warns_as_jax(monkeypatch, loader, name):
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        getattr(JR, loader)(name)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        cfg, params, tok = getattr(TR, loader)(name, device="cpu", dtype=torch.float32,
                                                checkpoint_dir="/nonexistent")
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw if
                                           "random init" in str(w.message)]
    assert tok is None and {"embed", "language_model"} <= set(params)
    with pytest.raises(KeyError):
        getattr(TR, loader)("tiny-gemma3", device="cpu")


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantized_random_init_is_the_native_trees_quantized(fmt):
    """``weight_dtype`` int8 / int4 makes each leaf straight into its format:
    the bytes of quantizing the native tree, which never exists."""
    from multimodal_colpali_tpu_torch.ops.quant import (
        quantize_lm_params, quantize_lm_params_int4)

    cfg = TC.LlavaNextMMConfig.tiny(vocab_size=64)
    native = TR.llava_next_random_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    quant = TR.llava_next_random_params_int8(cfg, seed=3, dtype=torch.float32, device="cpu",
                                             fmt=fmt)
    lm = {"embed": native["embed"], "language_model": native["language_model"]}
    want = (quantize_lm_params if fmt == "int8" else quantize_lm_params_int4)(lm)
    got = {"embed": quant["embed"], "language_model": quant["language_model"]}
    g, w = dict(leaves(got)), dict(leaves(want))
    assert g.keys() == w.keys()
    for k in g:
        assert torch.equal(g[k], w[k]), k
    assert "lm_head" not in got["language_model"]       # tiny ties its head
