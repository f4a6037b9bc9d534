"""HuggingFace checkpoints -> this package's parameters (counterpart of
``multimodal_colpali_tpu/models/hf_import.py``).

Two halves:

- :func:`load_state_dict` reads a checkpoint directory (its ``.safetensors``
  and ``.bin`` files in sorted order) or one file into a flat dict of CPU
  tensors in the file's own dtype. Safetensors files are read by this
  module's own reader: a memory map, and per tensor a ``torch.frombuffer``
  view of its bytes, so bf16 checkpoints load (the JAX package reads them
  through ``safetensors.numpy``, which has no bf16) and nothing is copied
  until the caller moves a tensor to its device.
- The converters take such a state dict to the flax-named tree of the JAX
  converters, with the same key normalization, transposes and tied heads,
  but as torch views of the state dict's tensors: a dense ``weight [out,
  in]`` becomes ``kernel = weight.t()`` and a conv ``[out, in, kh, kw]``
  ``permute(2, 3, 1, 0)``. ``models/convert.params_from_flax`` turns the
  retriever and BERT trees into a ``state_dict`` (its transposes undo these,
  so each leaf is a view of the file's bytes again); the Gemma-3 trees (text
  and multimodal) are the decode engine's layout as it is.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import re
from typing import Any, Dict

import torch

# safetensors dtype names -> torch dtypes (the ones published checkpoints use)
_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
              "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32, "I64": torch.int64,
              "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """One ``.safetensors`` file -> ``{name: tensor}`` on the CPU.

    The layout: an 8-byte little-endian header length N, N bytes of JSON
    (``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
    optional ``__metadata__``), then the tensors' bytes, offsets counted
    from the end of the header. Each tensor is a view of a private (copy on
    write) memory map of the file, which stays open while a view lives; a
    tensor whose bytes do not start at a multiple of its element size is
    copied into an aligned buffer instead."""
    with open(path, "rb") as f:
        n_header = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n_header))
        size = os.fstat(f.fileno()).st_size
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n_header
    out: Dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {meta['dtype']!r}; "
                             f"readable: {sorted(_ST_DTYPES)}")
        dtype = _ST_DTYPES[meta["dtype"]]
        shape = tuple(meta["shape"])
        begin, end = meta["data_offsets"]
        numel = math.prod(shape)
        itemsize = dtype.itemsize
        if end - begin != numel * itemsize or base + end > size:
            raise ValueError(f"{path}: tensor {name!r} of shape {shape} {meta['dtype']} "
                             f"does not fit its offsets {begin}..{end}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        start = base + begin
        if start % itemsize:
            buf = bytearray(mm[start:base + end])
            out[name] = torch.frombuffer(buf, dtype=dtype, count=numel).reshape(shape)
        else:
            out[name] = torch.frombuffer(mm, dtype=dtype, count=numel,
                                         offset=start).reshape(shape)
    return out


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint directory or file -> flat ``{name: CPU tensor}`` in the
    files' own dtypes (hf_import.py:646-667): ``*.safetensors``, single or
    sharded, through :func:`read_safetensors`, and torch ``*.bin`` through
    ``torch.load(weights_only=True)``. A later file's key replaces an
    earlier one's, as in the JAX loader."""
    files = [path]
    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.endswith((".safetensors", ".bin")))
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        if f.endswith(".safetensors"):
            sd.update(read_safetensors(f))
        else:
            sd.update(torch.load(f, map_location="cpu", weights_only=True))
    return sd


# -- converters -------------------------------------------------------------------

def _lin(sd: Dict[str, Any], prefix: str, bias: bool = True) -> Dict[str, torch.Tensor]:
    out = {"kernel": sd[prefix + ".weight"].t()}
    if bias and prefix + ".bias" in sd:
        out["bias"] = sd[prefix + ".bias"]
    return out


def _ln(sd: Dict[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {"weight": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def _rms(sd: Dict[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {"weight": sd[prefix + ".weight"]}


def _conv(t: torch.Tensor) -> torch.Tensor:
    """torch conv ``[out, in, kh, kw]`` -> flax ``[kh, kw, in, out]``, a view."""
    return t.permute(2, 3, 1, 0)


def _normalize_prefixes(sd: Dict[str, Any]) -> Dict[str, Any]:
    """The transformers (``vlm.model.``) and colpali-engine (``model.``)
    layouts to one, and the colpali-engine head to ``embedding_proj_layer``."""
    norm: Dict[str, Any] = {}
    for k, v in sd.items():
        k = re.sub(r"^(vlm\.)?model\.", "", k)
        k = re.sub(r"^custom_text_proj\.", "embedding_proj_layer.", k)
        norm[k] = v
    return norm


def _siglip_layer(sd: Dict[str, Any], p: str) -> Dict[str, Any]:
    return {
        "self_attn": {
            "q_proj": _lin(sd, p + "self_attn.q_proj"),
            "k_proj": _lin(sd, p + "self_attn.k_proj"),
            "v_proj": _lin(sd, p + "self_attn.v_proj"),
            "out_proj": _lin(sd, p + "self_attn.out_proj"),
        },
        "layer_norm1": _ln(sd, p + "layer_norm1"),
        "layer_norm2": _ln(sd, p + "layer_norm2"),
        "mlp": {"fc1": _lin(sd, p + "mlp.fc1"), "fc2": _lin(sd, p + "mlp.fc2")},
    }


def _siglip_tower(sd: Dict[str, Any], vt: str, n_layers: int) -> Dict[str, Any]:
    vision: Dict[str, Any] = {
        "patch_embedding": {
            "kernel": _conv(sd[vt + "embeddings.patch_embedding.weight"]),
            "bias": sd[vt + "embeddings.patch_embedding.bias"],
        },
        "position_embedding": sd[vt + "embeddings.position_embedding.weight"],
        "post_layernorm": _ln(sd, vt + "post_layernorm"),
    }
    for i in range(n_layers):
        vision[f"layers_{i}"] = _siglip_layer(sd, f"{vt}encoder.layers.{i}.")
    return vision


def _bare_attn(sd: Dict[str, Any], p: str) -> Dict[str, Any]:
    return {name: _lin(sd, p + "self_attn." + name, bias=False)
            for name in ("q_proj", "k_proj", "v_proj", "o_proj")}


def _gated_mlp(sd: Dict[str, Any], p: str) -> Dict[str, Any]:
    return {name: _lin(sd, p + "mlp." + name, bias=False)
            for name in ("gate_proj", "up_proj", "down_proj")}


def colpali_params_from_hf(sd: Dict[str, Any], cfg) -> Dict[str, Any]:
    """A ``ColPaliForRetrieval`` state dict -> the flax-named tree
    (hf_import.py:42-105); both the transformers and the colpali-engine
    layouts."""
    sd = _normalize_prefixes(sd)
    lm = "language_model."
    language: Dict[str, Any] = {"norm": _rms(sd, lm + "norm")}
    for i in range(cfg.text.num_hidden_layers):
        p = f"{lm}layers.{i}."
        language[f"layers_{i}"] = {
            "self_attn": _bare_attn(sd, p),
            "mlp": _gated_mlp(sd, p),
            "input_layernorm": _rms(sd, p + "input_layernorm"),
            "post_attention_layernorm": _rms(sd, p + "post_attention_layernorm"),
        }
    return {
        "embed": {"embed_tokens": sd[lm + "embed_tokens.weight"]},
        "vision_tower": _siglip_tower(sd, "vision_tower.vision_model.",
                                      cfg.vision.num_hidden_layers),
        "multi_modal_projector": _lin(sd, "multi_modal_projector.linear"),
        "language_model": language,
        "embedding_proj_layer": _lin(sd, "embedding_proj_layer"),
    }


def colflor_params_from_hf(sd: Dict[str, Any], cfg) -> Dict[str, Any]:
    """A Florence-2 / ColFlor state dict -> the flax-named tree
    (hf_import.py:410-488): the encoder stack only; the retrieval head under
    ``embedding_proj_layer`` or colpali-engine's ``custom_text_proj``."""
    sd = _normalize_prefixes(sd)

    def conv(prefix):
        return {"kernel": _conv(sd[prefix + ".weight"]), "bias": sd[prefix + ".bias"]}

    v = cfg.vision
    vision: Dict[str, Any] = {}
    for stage in range(len(v.depths)):
        vision[f"convs_{stage}"] = {
            "conv": conv(f"vision_tower.convs.{stage}.conv"),
            "norm": _ln(sd, f"vision_tower.convs.{stage}.norm"),
        }
        for d in range(v.depths[stage]):
            for kind, attn in (("spatial", "window_attn"), ("channel", "channel_attn")):
                p = f"vision_tower.blocks.{stage}.{d}.{kind}_block."
                vision[f"blocks_{stage}_{d}_{kind}"] = {
                    "conv1": {"conv": conv(p + "conv1")},
                    "norm1": _ln(sd, p + "norm1"),
                    attn: {"qkv": _lin(sd, p + f"{attn}.qkv"),
                           "proj": _lin(sd, p + f"{attn}.proj")},
                    "conv2": {"conv": conv(p + "conv2")},
                    "norm2": _ln(sd, p + "norm2"),
                    "ffn": {"fc1": _lin(sd, p + "ffn.fc1"), "fc2": _lin(sd, p + "ffn.fc2")},
                }
    pos = "multi_modal_projector.image_position_embed."
    projector = {
        "image_projection": _lin(sd, "multi_modal_projector.image_projection", bias=False),
        "image_proj_norm": _ln(sd, "multi_modal_projector.image_proj_norm"),
        "row_embeddings": sd[pos + "row_embeddings.weight"],
        "column_embeddings": sd[pos + "column_embeddings.weight"],
    }
    enc = "language_model.encoder."
    params: Dict[str, Any] = {
        "embed_tokens": sd[enc + "embed_tokens.weight"],
        "embed_positions": sd[enc + "embed_positions.weight"],
        "layernorm_embedding": _ln(sd, enc + "layernorm_embedding"),
        "vision_tower": vision,
        "multi_modal_projector": projector,
    }
    for i in range(cfg.text.encoder_layers):
        p = f"{enc}layers.{i}."
        params[f"layers_{i}"] = {
            "self_attn": {name: _lin(sd, p + "self_attn." + name)
                          for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "self_attn_layer_norm": _ln(sd, p + "self_attn_layer_norm"),
            "fc1": _lin(sd, p + "fc1"),
            "fc2": _lin(sd, p + "fc2"),
            "final_layer_norm": _ln(sd, p + "final_layer_norm"),
        }
    if "embedding_proj_layer.weight" in sd:
        params["embedding_proj_layer"] = _lin(sd, "embedding_proj_layer")
    return params


def colidefics3_params_from_hf(sd: Dict[str, Any], cfg) -> Dict[str, Any]:
    """An Idefics3 / SmolVLM (ColIdefics3) state dict -> the flax-named tree
    (hf_import.py:491-547)."""
    sd = _normalize_prefixes(sd)
    params: Dict[str, Any] = {
        "embed_tokens": sd["text_model.embed_tokens.weight"],
        "vision_model": _siglip_tower(sd, "vision_model.", cfg.vision.num_hidden_layers),
        "modality_projection": _lin(sd, "connector.modality_projection.proj", bias=False),
        "norm": _rms(sd, "text_model.norm"),
    }
    for i in range(cfg.text.num_hidden_layers):
        p = f"text_model.layers.{i}."
        params[f"layers_{i}"] = {
            "self_attn": _bare_attn(sd, p),
            **_gated_mlp(sd, p),
            "input_layernorm": _rms(sd, p + "input_layernorm"),
            "post_attention_layernorm": _rms(sd, p + "post_attention_layernorm"),
        }
    if "embedding_proj_layer.weight" in sd:
        params["embedding_proj_layer"] = _lin(sd, "embedding_proj_layer")
    return params


def colqwen2_params_from_hf(sd: Dict[str, Any], cfg) -> Dict[str, Any]:
    """A ``ColQwen2ForRetrieval`` (or colpali-engine ColQwen2 / ColQwen2.5)
    state dict -> the flax-named tree (hf_import.py:108-165): the tower's
    conv patch embed as a ``[patch_dim, embed_dim]`` kernel, LayerNorm or
    RMSNorm blocks by ``cfg.vision.variant``, the head from
    ``embedding_proj_layer`` or ``custom_text_proj``."""
    sd = _normalize_prefixes(sd)
    is_25 = cfg.vision.variant == "qwen2_5"
    norm_fn = _rms if is_25 else _ln
    visual: Dict[str, Any] = {
        "patch_embed": {"kernel": sd["visual.patch_embed.proj.weight"]
                        .reshape(cfg.vision.embed_dim, -1).t()},
        "ln_q": norm_fn(sd, "visual.merger.ln_q"),
        "merger_fc1": _lin(sd, "visual.merger.mlp.0"),
        "merger_fc2": _lin(sd, "visual.merger.mlp.2"),
    }
    for i in range(cfg.vision.depth):
        p = f"visual.blocks.{i}."
        block = {"norm1": norm_fn(sd, p + "norm1"), "norm2": norm_fn(sd, p + "norm2"),
                 "qkv": _lin(sd, p + "attn.qkv"), "attn_proj": _lin(sd, p + "attn.proj")}
        for name in (("gate_proj", "up_proj", "down_proj") if is_25 else ("fc1", "fc2")):
            block[name] = _lin(sd, p + "mlp." + name)
        visual[f"blocks_{i}"] = block
    params: Dict[str, Any] = {
        "embed_tokens": sd["language_model.embed_tokens.weight"],
        "visual": visual,
        "norm": _rms(sd, "language_model.norm"),
    }
    if "embedding_proj_layer.weight" in sd:
        params["embedding_proj_layer"] = _lin(sd, "embedding_proj_layer")
    for i in range(cfg.text.num_hidden_layers):
        p = f"language_model.layers.{i}."
        params[f"layers_{i}"] = {
            "self_attn": {
                "q_proj": _lin(sd, p + "self_attn.q_proj"),
                "k_proj": _lin(sd, p + "self_attn.k_proj"),
                "v_proj": _lin(sd, p + "self_attn.v_proj"),
                "o_proj": _lin(sd, p + "self_attn.o_proj", bias=False),
            },
            **_gated_mlp(sd, p),
            "input_layernorm": _rms(sd, p + "input_layernorm"),
            "post_attention_layernorm": _rms(sd, p + "post_attention_layernorm"),
        }
    return params


def gemma3_params_from_hf(sd: Dict[str, Any], cfg) -> Dict[str, Any]:
    """A ``Gemma3ForCausalLM`` state dict -> the decode engine's tree
    (hf_import.py:670-712): kernels ``[in, out]`` (views), Gemma-3's q/k and
    sandwich norms per layer, the LM head tied to the embedding table."""
    sd = {re.sub(r"^(model\.)?(language_model\.)?", "", k): v for k, v in sd.items()}
    language: Dict[str, Any] = {"norm": _rms(sd, "norm")}
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        attn = _bare_attn(sd, p)
        attn["q_norm"] = _rms(sd, p + "self_attn.q_norm")
        attn["k_norm"] = _rms(sd, p + "self_attn.k_norm")
        language[f"layers_{i}"] = {
            "self_attn": attn,
            "mlp": _gated_mlp(sd, p),
            **{name: _rms(sd, p + name) for name in (
                "input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm",
                "post_feedforward_layernorm")},
        }
    return {"embed": {"embed_tokens": sd["embed_tokens.weight"]}, "language_model": language}


def gemma3_mm_params_from_hf(sd: Dict[str, Any], cfg) -> Dict[str, Any]:
    """A ``Gemma3ForConditionalGeneration`` state dict -> the tree of JAX's
    ``Gemma3MMEngine`` (hf_import.py:715-780), as views: the SigLIP tower as
    ColPali's (its attention-pooling ``head`` is unused and skipped), the
    language tree through :func:`gemma3_params_from_hf`, and the projector's
    bias-free ``mm_input_projection`` (already ``[v_hidden, t_hidden]``) and
    ``mm_soft_emb_norm`` RMS weight. Reads both layouts: transformers >= 4.52
    writes ``model.language_model.*`` and ``model.vision_tower.*``, older
    versions ``language_model.model.*`` and ``vision_tower.*``."""
    sd = {re.sub(r"^model\.", "", k): v for k, v in sd.items()}
    lm_sd = {k[len("language_model."):]: v for k, v in sd.items()
             if k.startswith("language_model.")}
    language = gemma3_params_from_hf(lm_sd, cfg.text)
    proj = "multi_modal_projector."
    return {
        "embed": language["embed"],
        "language_model": language["language_model"],
        "vision_tower": _siglip_tower(sd, "vision_tower.vision_model.",
                                      cfg.vision.num_hidden_layers),
        "multi_modal_projector": {
            "mm_input_projection": sd[proj + "mm_input_projection_weight"],
            "mm_soft_emb_norm": _rms(sd, proj + "mm_soft_emb_norm"),
        },
    }


def bert_params_from_hf(sd: Dict[str, Any], cfg) -> Dict[str, Any]:
    """A ``BertModel`` state dict (bge-base), with or without the ``bert.``
    prefix of a task model -> the flax-named tree of ``models/bert``
    (hf_import.py:616-645), as views."""
    sd = {re.sub(r"^bert\.", "", k): v for k, v in sd.items()}
    params: Dict[str, Any] = {
        "word_embeddings": sd["embeddings.word_embeddings.weight"],
        "position_embeddings": sd["embeddings.position_embeddings.weight"],
        "token_type_embeddings": sd["embeddings.token_type_embeddings.weight"],
        "embeddings_layernorm": _ln(sd, "embeddings.LayerNorm"),
    }
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layer.{i}."
        params[f"layers_{i}"] = {
            "attention": {name: _lin(sd, p + "attention.self." + name)
                          for name in ("query", "key", "value")},
            "attention_output": _lin(sd, p + "attention.output.dense"),
            "attention_layernorm": _ln(sd, p + "attention.output.LayerNorm"),
            "intermediate": _lin(sd, p + "intermediate.dense"),
            "output": _lin(sd, p + "output.dense"),
            "output_layernorm": _ln(sd, p + "output.LayerNorm"),
        }
    return params
