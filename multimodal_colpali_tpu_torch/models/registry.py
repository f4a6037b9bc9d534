"""Retriever and generator-LM registry (counterpart of
``multimodal_colpali_tpu/models/registry.py``).

``load_retriever(name, device=...)`` returns a :class:`Retriever`: the
encoder of the name's family (ColPali, ColIdefics3, ColFlor or ColQwen2) on ``device``
plus its processor. Weights come from a flax parameter tree (``params=``,
e.g. ``load_params_npz`` of a committed golden), else from the checkpoint
that ``_find_checkpoint`` finds (``checkpoint_dir=`` or under
``COLPALI_TPU_CKPT_DIR``; ``models/hf_import`` reads it and each tensor is
copied into the model on ``device`` as it is reached), else from a seeded
random init made on ``device`` in the model dtype, with a warning, so a 3B
model never exists in float32 on the host.

``load_gemma3_lm(name, device=...)`` returns the decode-engine parameter tree
of a Gemma-3 text LM (registry.py:550-741) and the checkpoint's tokenizer:
the checkpoint's weights or random ones from a seed, either way placed leaf
by leaf on ``device`` (``weight_dtype="int8"`` or ``"int4"`` quantizes each
leaf as it arrives, so the bf16 tree never exists on the card).
``load_gemma3_mm(name, device=...)`` adds the SigLIP tower and the
projector of the multimodal generator (registry.py:1443-1540).
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import warnings
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from multimodal_colpali_tpu_torch._device import resolve_device
from multimodal_colpali_tpu_torch.models import hf_import
from multimodal_colpali_tpu_torch.models.configs import (
    ColFlorModelConfig, ColIdefics3ModelConfig, ColPaliModelConfig, ColQwen2ModelConfig,
    Gemma3MMConfig, Gemma3TextConfig)
from multimodal_colpali_tpu_torch.models.convert import (
    ModelConfig, flax_shape, model_class, params_from_flax, state_from_flax)
from multimodal_colpali_tpu_torch.models.processing import ColPaliProcessor
from multimodal_colpali_tpu_torch.models.processing_florence2 import ColFlorProcessor
from multimodal_colpali_tpu_torch.models.processing_idefics3 import ColIdefics3Processor
from multimodal_colpali_tpu_torch.models.processing_qwen2vl import ColQwen2Processor
from multimodal_colpali_tpu_torch.models.siglip import SiglipVisionTower
from multimodal_colpali_tpu_torch.ops.preprocess import normalize_images
from multimodal_colpali_tpu_torch.ops.quant import quantize_lm_leaf

RETRIEVER_CONFIGS: Dict[str, Callable[[], ModelConfig]] = {
    "vidore/colpali-v1.2": ColPaliModelConfig.colpali_v1_3,
    "vidore/colpali-v1.3": ColPaliModelConfig.colpali_v1_3,
    "vidore/colpali-v1.3-hf": ColPaliModelConfig.colpali_v1_3,
    "vidore/colpali-v1.3-merged": ColPaliModelConfig.colpali_v1_3,
    "tiny-colpali": ColPaliModelConfig.tiny,
    "vidore/colSmol-256M": ColIdefics3ModelConfig.colsmol_256m,
    "vidore/colidefics3-v1.0": ColIdefics3ModelConfig.colsmol_256m,
    "tiny-colidefics3": ColIdefics3ModelConfig.tiny,
    "ahmed-masry/ColFlor": ColFlorModelConfig.colflor,
    "tiny-colflor": ColFlorModelConfig.tiny,
    "vidore/colqwen2-v1.0": ColQwen2ModelConfig.colqwen2_v1,
    "vidore/colqwen2.5-v0.2": ColQwen2ModelConfig.colqwen2_5_v0_2,
    "tiny-colqwen2": ColQwen2ModelConfig.tiny,
    "tiny-colqwen2.5": ColQwen2ModelConfig.tiny_25,
}

PROCESSORS = {"colpali": ColPaliProcessor, "colidefics3": ColIdefics3Processor,
              "colflor": ColFlorProcessor, "colqwen2": ColQwen2Processor}
CONVERTERS = {"colpali": hf_import.colpali_params_from_hf,
              "colidefics3": hf_import.colidefics3_params_from_hf,
              "colflor": hf_import.colflor_params_from_hf,
              "colqwen2": hf_import.colqwen2_params_from_hf}

# Gemma's RMSNorm multiplies by (1 + w), so its neutral weight is 0; it
# exists only in the colpali family (Llama's RMSNorm multiplies by w).
_GEMMA_RMS_PARENTS = {"input_layernorm", "post_attention_layernorm", "norm"}


def family_of(cfg: ModelConfig) -> str:
    """The JAX registry's family name for a config."""
    if isinstance(cfg, ColIdefics3ModelConfig):
        return "colidefics3"
    if isinstance(cfg, ColFlorModelConfig):
        return "colflor"
    if isinstance(cfg, ColQwen2ModelConfig):
        return "colqwen2"
    return "colpali"


@torch.no_grad()
def init_random_params_(model: torch.nn.Module, seed: int = 0, family: str = "colpali") -> None:
    """Fill ``model`` in place, on its device and in its dtype, by the rules
    of the JAX package's ``fast_random_params`` (registry.py:264-294):
    biases 0, Gemma RMSNorm weights 0 (colpali family only), other norm
    weights 1 (Llama's and Qwen2's RMSNorm, LayerNorms), everything else N(0, fan_in^-0.5) with ``fan_in`` the first
    dim of the flax layout."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        parts = name.split(".")
        leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
        if leaf == "bias":
            p.zero_()
        elif leaf == "weight" and p.dim() == 1:
            gemma = family == "colpali" and parent in _GEMMA_RMS_PARENTS
            p.fill_(0.0 if gemma else 1.0)
        else:
            fan_in = flax_shape(name, tuple(p.shape))[0]
            p.normal_(0.0, float(fan_in) ** -0.5, generator=gen)


@dataclasses.dataclass
class Retriever:
    """A late-interaction encoder bound to its weights, ready to embed.

    ``device_preprocess=True`` uploads uint8 pixels and normalizes them on
    ``device`` inside the forward (K3 on a CUDA device); the host stage is
    resize-only. A processor whose ``process_images`` takes no
    ``device_preprocess`` (ColFlor's, ColQwen2's) refuses it, as does a
    dynamic-resolution one, as the JAX Retriever does (registry.py:51-64).

    The colqwen2 family's forward also takes the batch's mrope
    ``position_ids`` and its ``grid``; under ``dynamic_resolution`` its
    pages are embedded in per-grid groups (registry.py:170-200)."""

    name: str
    model: torch.nn.Module
    processor: Any
    device: torch.device
    dtype: torch.dtype = torch.bfloat16
    device_preprocess: bool = False
    family: str = "colpali"

    def __post_init__(self):
        if self.device_preprocess and "device_preprocess" not in inspect.signature(
                self.processor.process_images).parameters:
            raise ValueError(f"device_preprocess is not supported by "
                             f"{type(self.processor).__name__} (fixed-resolution "
                             f"ColPali-family processors only)")
        if self.device_preprocess and getattr(self.processor, "dynamic_resolution", False):
            raise ValueError("device_preprocess requires the fixed square layout; "
                             "disable dynamic_resolution/image splitting")

    def _pixels(self, pv: Any) -> torch.Tensor:
        """Pixels (host arrays or device tensors) -> the model's pixel input
        on ``device`` (registry.py:137-163)."""
        x = (pv if isinstance(pv, torch.Tensor)
             else torch.from_numpy(np.asarray(pv, np.uint8 if pv.dtype == np.uint8
                                              else np.float32)))
        x = x.to(self.device)
        if x.dtype == torch.uint8:
            pre = self.processor.image_preprocessor
            mean, std = (float(pre.mean),) * 3, (float(pre.std),) * 3
            return normalize_images(x, mean, std).to(self.dtype)
        return x.to(torch.float32).to(self.dtype)

    @torch.inference_mode()
    def _embed(self, batch: Dict[str, Any], with_image: bool) -> List[np.ndarray]:
        ids = torch.from_numpy(batch["input_ids"]).to(self.device, torch.long)
        mask_np = batch["attention_mask"]
        mask = torch.from_numpy(mask_np).to(self.device)
        pix = self._pixels(batch["pixel_values"]) if with_image else None
        if self.family == "colqwen2":
            pos = torch.from_numpy(batch["position_ids"]).to(self.device)
            out = self.model(ids, mask, pos, pix, grid=batch.get("grid"))
        else:
            out = self.model(ids, mask, pix)
        emb = out.float().cpu().numpy()
        return [emb[i][mask_np[i] == 1] for i in range(emb.shape[0])]

    def embed_images(self, images: Sequence[Any], batch_size: int = 32) -> List[np.ndarray]:
        """Page images -> list of ``[n_tokens, dim]`` float32 arrays, in the
        pages' order."""
        if getattr(self.processor, "dynamic_resolution", False):
            grouped: List[Any] = [None] * len(images)
            for grid, idxs in self.processor.group_by_grid(images):
                for start in range(0, len(idxs), batch_size):
                    sel = idxs[start: start + batch_size]
                    batch = self.processor.process_images([images[i] for i in sel], grid=grid,
                                                          device=self.device)
                    for i, emb in zip(sel, self._embed(batch, with_image=True)):
                        grouped[i] = emb
            return grouped
        out: List[np.ndarray] = []
        for start in range(0, len(images), batch_size):
            chunk = list(images[start: start + batch_size])
            batch = (self.processor.process_images(chunk, device_preprocess=True,
                                                   device=self.device)
                     if self.device_preprocess
                     else self.processor.process_images(chunk, device=self.device))
            out += self._embed(batch, with_image=True)
        return out

    def embed_queries(self, queries: Sequence[str], batch_size: int = 64) -> List[np.ndarray]:
        out: List[np.ndarray] = []
        for start in range(0, len(queries), batch_size):
            batch = self.processor.process_queries(list(queries[start: start + batch_size]))
            out += self._embed(batch, with_image=False)
        return out


class _Wrapped:
    """A transformers tokenizer with the special-id attributes the processors
    and the server read (registry.py:402-418): a missing pad id reads as 0,
    bos as 2, eos as 1; ``decode`` skips special tokens."""

    def __init__(self, t):
        self._t = t
        self.pad_id = t.pad_token_id if t.pad_token_id is not None else 0
        self.bos_id = t.bos_token_id if t.bos_token_id is not None else 2
        self.eos_id = t.eos_token_id if t.eos_token_id is not None else 1
        self.vocab_size = getattr(t, "vocab_size", None)

    def encode(self, text, add_special_tokens=False):
        return self._t.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids):
        return self._t.decode(ids, skip_special_tokens=True)


# the files transformers builds a tokenizer from; a checkpoint holding none has no tokenizer
_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "tokenizer.model", "vocab.json",
                    "vocab.txt", "merges.txt", "spiece.model", "sentencepiece.bpe.model",
                    "special_tokens_map.json")


def _load_tokenizer_from(ckpt_dir: str) -> Optional[Any]:
    """The checkpoint's tokenizer (``tokenizer.json`` through
    ``transformers.AutoTokenizer``), or None where it cannot be loaded: no
    tokenizer files, or no ``transformers`` installed (registry.py:393-420).
    Callers then keep their own tokenizer. A directory without tokenizer
    files returns None before importing transformers (seconds of imports)."""
    if not any(os.path.exists(os.path.join(ckpt_dir, f)) for f in _TOKENIZER_FILES):
        return None
    try:
        import transformers

        tok = transformers.AutoTokenizer.from_pretrained(ckpt_dir)
    except Exception:  # noqa: BLE001 - as JAX: any failure means "no tokenizer"
        return None
    return _Wrapped(tok)


def _find_checkpoint(name: str, checkpoint_dir: Optional[str]) -> Optional[str]:
    """The checkpoint directory the JAX registry would load for ``name``
    (registry.py:423-436): ``checkpoint_dir``, then
    ``$COLPALI_TPU_CKPT_DIR/<name with / -> -->``, then
    ``$COLPALI_TPU_CKPT_DIR/<basename>``; the first that holds a
    ``.safetensors`` or ``.bin`` file, else None."""
    candidates = []
    if checkpoint_dir:
        candidates.append(checkpoint_dir)
    env = os.environ.get("COLPALI_TPU_CKPT_DIR")
    if env:
        candidates.append(os.path.join(env, name.replace("/", "--")))
        candidates.append(os.path.join(env, os.path.basename(name)))
    for c in candidates:
        if c and os.path.isdir(c) and any(
                f.endswith((".safetensors", ".bin")) for f in os.listdir(c)):
            return c
    return None


def load_retriever(
    name: str,
    device: Any = "cuda",
    tokenizer: Optional[Any] = None,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    params: Optional[Mapping[str, Any]] = None,
    quantize: Optional[str] = None,
    device_preprocess: Optional[bool] = None,
    dynamic_resolution: bool = False,
    checkpoint_dir: Optional[str] = None,
) -> Retriever:
    """Load a late-interaction retriever by name (reference surface).

    ``params``: a flax parameter tree, flat (``"a/b/c"`` keys) or nested, as
    ``save_params_npz``/``load_params_npz`` write and read it. Without it a
    checkpoint found by ``_find_checkpoint`` (``checkpoint_dir``, then
    ``COLPALI_TPU_CKPT_DIR``, as the JAX registry looks) is loaded through
    the family's ``hf_import`` converter, tensor by tensor into the model on
    ``device`` (registry.py:512-519), and its tokenizer, where it has one and
    ``tokenizer`` is None, replaces the processor's. Where none is found the
    weights are random, drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device``, by the rules of the name's family, with a warning
    (registry.py:520-531). ``quantize`` and ``device_preprocess`` left None
    read ``MMCP_QUANTIZE`` and ``MMCP_DEVICE_PREPROCESS == "1"``, as the JAX
    registry does (registry.py:532-535). ``dynamic_resolution=True`` gives
    colqwen2 its smart-resize grids; ColPali and ColFlor have one layout and
    ignore it, as in JAX; idefics3 image splitting is not ported and raises."""
    if name not in RETRIEVER_CONFIGS:
        raise KeyError(f"unknown retriever {name!r}; known: {sorted(RETRIEVER_CONFIGS)}")
    if quantize is None:
        quantize = os.environ.get("MMCP_QUANTIZE") or None
    if device_preprocess is None:
        device_preprocess = os.environ.get("MMCP_DEVICE_PREPROCESS") == "1"
    if quantize == "int8":
        raise NotImplementedError(
            "W8A8 int8 projections (quantize='int8') are not ported yet; "
            "see ROADMAP.md, kernels K8/K9 and ops/quant")
    if quantize is not None:
        raise ValueError(f"unknown quantize mode {quantize!r}")
    cfg = RETRIEVER_CONFIGS[name]()
    family = family_of(cfg)
    if dynamic_resolution and family == "colidefics3":
        raise NotImplementedError(
            "dynamic_resolution (idefics3 image splitting) is not ported yet; "
            "see ROADMAP.md")
    device = resolve_device(device)
    model = model_class(cfg)(cfg, device=device, dtype=dtype).eval()
    processor = (ColQwen2Processor(cfg, tokenizer=tokenizer, dynamic_resolution=dynamic_resolution)
                 if family == "colqwen2" else PROCESSORS[family](cfg, tokenizer=tokenizer))
    ckpt = None if params is not None else _find_checkpoint(name, checkpoint_dir)
    if params is not None:
        model.load_state_dict(params_from_flax(params, cfg))
    elif ckpt is not None:
        if tokenizer is None:
            tok = _load_tokenizer_from(ckpt)
            if tok is not None:
                processor.tokenizer = tok
        tree = CONVERTERS[family](hf_import.load_state_dict(ckpt), cfg)
        # views of the files' bytes; each is copied (and cast) into its parameter
        model.load_state_dict(params_from_flax(tree, cfg))
    else:
        warnings.warn(f"no local checkpoint for {name!r}; using random init (seed {seed}; "
                      f"set COLPALI_TPU_CKPT_DIR to load real weights)", stacklevel=2)
        init_random_params_(model, seed, family)
    return Retriever(name=name, model=model, processor=processor, device=device, dtype=dtype,
                     device_preprocess=bool(device_preprocess), family=family)


# -- Gemma-3 generator LMs (not retrievers) -----------------------------------

GEMMA3_CONFIGS: Dict[str, Callable[[], Gemma3TextConfig]] = {
    "google/gemma-3-27b-it": Gemma3TextConfig.gemma3_27b,
    "gemma-3-27b": Gemma3TextConfig.gemma3_27b,
    "google/gemma-3-12b-it": Gemma3TextConfig.gemma3_12b,
    "gemma-3-12b": Gemma3TextConfig.gemma3_12b,
    "google/gemma-3-4b-it": Gemma3TextConfig.gemma3_4b,
    "gemma-3-4b": Gemma3TextConfig.gemma3_4b,
    "google/gemma-3-1b-it": Gemma3TextConfig.gemma3_1b,
    "gemma-3-1b": Gemma3TextConfig.gemma3_1b,
    "tiny-gemma3": Gemma3TextConfig.tiny,
}


def gemma3_param_shapes(cfg: Gemma3TextConfig) -> Dict[str, Any]:
    """The engine tree's leaf shapes (registry.py:572-602): kernels ``[in, out]``."""
    h, hd = cfg.hidden_size, cfg.head_dim
    nq, nkv, inter = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.intermediate_size
    layer = {
        "self_attn": {
            "q_proj": {"kernel": (h, nq * hd)},
            "k_proj": {"kernel": (h, nkv * hd)},
            "v_proj": {"kernel": (h, nkv * hd)},
            "o_proj": {"kernel": (nq * hd, h)},
            "q_norm": {"weight": (hd,)},
            "k_norm": {"weight": (hd,)},
        },
        "mlp": {
            "gate_proj": {"kernel": (h, inter)},
            "up_proj": {"kernel": (h, inter)},
            "down_proj": {"kernel": (inter, h)},
        },
        "input_layernorm": {"weight": (h,)},
        "post_attention_layernorm": {"weight": (h,)},
        "pre_feedforward_layernorm": {"weight": (h,)},
        "post_feedforward_layernorm": {"weight": (h,)},
    }
    language: Dict[str, Any] = {f"layers_{i}": layer for i in range(cfg.num_hidden_layers)}
    language["norm"] = {"weight": (h,)}
    return {"embed": {"embed_tokens": (cfg.vocab_size, h)}, "language_model": language}


def tree_leaves(tree: Dict[str, Any], prefix=()):
    """(path, shape) of every leaf, keys sorted at each level (JAX's flatten order)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _build_tree(cfg: Gemma3TextConfig, make_leaf) -> Dict[str, Any]:
    """Fill the shape tree leaf by leaf, largest first (the embed table's
    float32 transient is the biggest, made while the tree is still empty)."""
    flat = list(tree_leaves(gemma3_param_shapes(cfg)))
    order = sorted(range(len(flat)), key=lambda i: -int(np.prod(flat[i][1])))
    tree: Dict[str, Any] = {}
    for i in order:
        path, shape = flat[i]
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = make_leaf(i, path[-1], tuple(shape))
    return tree


def _normal_leaf(i: int, shape, seed: int, device: torch.device) -> torch.Tensor:
    """Leaf ``i`` of a seeded random tree: N(0, fan_in^-0.5) in float32 on
    ``device``, from its own generator, so the bf16 and the int8 trees are
    made from the same float32 weights."""
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + i)
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w.mul_(float(fan_in) ** -0.5)


def gemma3_random_params(cfg: Gemma3TextConfig, seed: int = 0,
                         dtype: torch.dtype = torch.bfloat16, device: Any = "cuda"):
    """Random Gemma-3 engine params on ``device`` (registry.py:605-640):
    (1 + w) RMSNorm weights 0, everything else N(0, fan_in^-0.5) in ``dtype``."""
    device = resolve_device(device)

    def leaf(i, name, shape):
        if name == "weight":
            return torch.zeros(shape, dtype=dtype, device=device)
        return _normal_leaf(i, shape, seed, device).to(dtype)

    return _build_tree(cfg, leaf)


def gemma3_random_params_int8(cfg: Gemma3TextConfig, seed: int = 0,
                              dtype: torch.dtype = torch.bfloat16, device: Any = "cuda",
                              fmt: str = "int8"):
    """The same random weights made directly as weight-only int8 on
    ``device``, one leaf at a time (registry.py:643-701): kernels per column,
    the embed table per row (padded), norm weights in ``dtype``. The peak is
    the quantized tree plus one leaf's float32 transient.

    ``fmt="int4"`` packs each kernel group-wise int4 instead, with the group
    ``_int4_group_for(K, 256)``; a kernel whose K admits no even group stays
    int8, and the embed table is int8 in both formats."""
    if fmt not in ("int8", "int4"):
        raise ValueError(f"fmt must be 'int8' or 'int4', got {fmt!r}")
    device = resolve_device(device)

    def leaf(i, name, shape):
        if name == "weight":
            return torch.zeros(shape, dtype=dtype, device=device)
        return quantize_lm_leaf(name, _normal_leaf(i, shape, seed, device), fmt)

    return _build_tree(cfg, leaf)


def _place_lm(tree: Dict[str, Any], device: torch.device, dtype: torch.dtype,
              weight_dtype: str) -> Dict[str, Any]:
    """An engine tree of CPU tensors (views of a checkpoint's files) on
    ``device``, one leaf at a time: each leaf is cast to ``dtype`` there and,
    under ``weight_dtype="int8"|"int4"``, quantized before the next is read,
    so the bytes equal those that quantizing the whole ``dtype`` tree gives,
    without that tree ever existing."""
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out[name] = _place_lm(v, device, dtype, weight_dtype)
            continue
        x = v.to(device=device, dtype=dtype)
        out[name] = (x if weight_dtype == "native" or name not in ("kernel", "embed_tokens")
                     else quantize_lm_leaf(name, x, weight_dtype))
    return out


def gemma3_params_from_checkpoint(ckpt: str, cfg: Gemma3TextConfig,
                                  dtype: torch.dtype = torch.bfloat16, device: Any = "cuda",
                                  weight_dtype: str = "native"):
    """A Gemma-3 checkpoint's engine tree on ``device``, placed one leaf at
    a time from the files' memory maps (:func:`_place_lm`)."""
    device = resolve_device(device)
    tree = hf_import.gemma3_params_from_hf(hf_import.load_state_dict(ckpt), cfg)
    return _place_lm(tree, device, dtype, weight_dtype)


def load_gemma3_lm(name: str, device: Any = "cuda", dtype: torch.dtype = torch.bfloat16,
                   seed: int = 0, weight_dtype: str = "native",
                   params: Optional[Mapping[str, Any]] = None,
                   checkpoint_dir: Optional[str] = None):
    """A Gemma-3 generator LM by name -> (cfg, engine params, tokenizer).

    ``params`` (an engine tree of tensors, e.g. from
    ``convert.engine_params_from_jax``) is used as given, with no tokenizer.
    Otherwise a checkpoint found by ``_find_checkpoint`` (``checkpoint_dir``,
    then ``COLPALI_TPU_CKPT_DIR``) is loaded leaf by leaf onto ``device``
    (:func:`gemma3_params_from_checkpoint`), with its tokenizer where one
    loads (registry.py:717-723); where none is found the weights are random
    from ``seed``, made on ``device``, with a warning (registry.py:725-740).
    A None tokenizer leaves callers to ``ByteTokenizer``/``ModuloTokenizer``."""
    if name not in GEMMA3_CONFIGS:
        raise KeyError(f"unknown gemma3 LM {name!r}; known: {sorted(GEMMA3_CONFIGS)}")
    if weight_dtype not in ("native", "int8", "int4"):
        raise ValueError(f"weight_dtype must be 'native', 'int8' or 'int4', got {weight_dtype!r}")
    cfg = GEMMA3_CONFIGS[name]()
    if params is not None:
        return cfg, params, None
    ckpt = _find_checkpoint(name, checkpoint_dir)
    if ckpt is not None:
        params = gemma3_params_from_checkpoint(ckpt, cfg, dtype=dtype, device=device,
                                               weight_dtype=weight_dtype)
        return cfg, params, _load_tokenizer_from(ckpt)
    warnings.warn(f"no local checkpoint for {name!r}; using random init (seed {seed}; "
                  f"set COLPALI_TPU_CKPT_DIR to load real weights)", stacklevel=2)
    if weight_dtype == "native":
        params = gemma3_random_params(cfg, seed, dtype=dtype, device=device)
    else:
        params = gemma3_random_params_int8(cfg, seed, dtype=dtype, device=device,
                                           fmt=weight_dtype)
    return cfg, params, None


# -- the Gemma-3 multimodal generator (vision + LM) ------------------------------

# 1b is text-only upstream: it has no entry here and serves as text
GEMMA3_MM_CONFIGS: Dict[str, Callable[[], Gemma3MMConfig]] = {
    "google/gemma-3-27b-it": Gemma3MMConfig.gemma3_27b,
    "gemma-3-27b": Gemma3MMConfig.gemma3_27b,
    "google/gemma-3-12b-it": Gemma3MMConfig.gemma3_12b,
    "gemma-3-12b": Gemma3MMConfig.gemma3_12b,
    "google/gemma-3-4b-it": Gemma3MMConfig.gemma3_4b,
    "gemma-3-4b": Gemma3MMConfig.gemma3_4b,
    "tiny-gemma3": Gemma3MMConfig.tiny,
}


def _vision_parts(cfg: Gemma3MMConfig, device: torch.device, dtype: torch.dtype,
                  tree: Optional[Dict[str, Any]] = None, seed: int = 0):
    """The SigLIP tower (an ``nn.Module``) and the projector's tensors on
    ``device`` in ``dtype``: from ``tree`` (the flax-named vision and
    projector subtrees of a checkpoint, views, each copied once), else
    random by the JAX ``fill`` rule (registry.py:1482-1492): biases 0,
    LayerNorm weights 1, N(0, fan_in^-0.5) elsewhere, the projector's
    (1 + w) norm weight 0."""
    tower = SiglipVisionTower(cfg.vision, device=device, dtype=dtype).eval()
    v_h, t_h = cfg.vision.hidden_size, cfg.text.hidden_size
    if tree is not None:
        tower.load_state_dict(state_from_flax(tree["vision_tower"], tower))
        proj = tree["multi_modal_projector"]
        projector = {"mm_input_projection": proj["mm_input_projection"].to(device, dtype),
                     "mm_soft_emb_norm": {
                         "weight": proj["mm_soft_emb_norm"]["weight"].to(device, dtype)}}
        return tower, projector
    init_random_params_(tower, seed + 1, family="siglip")
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    w = torch.randn((v_h, t_h), generator=gen, device=device, dtype=torch.float32)
    projector = {"mm_input_projection": w.mul_(float(v_h) ** -0.5).to(dtype),
                 "mm_soft_emb_norm": {"weight": torch.zeros(v_h, dtype=dtype, device=device)}}
    return tower, projector


def gemma3_mm_random_params(cfg: Gemma3MMConfig, seed: int = 0,
                            dtype: torch.dtype = torch.bfloat16, device: Any = "cuda",
                            weight_dtype: str = "native"):
    """Random Gemma-3 multimodal params on ``device`` (registry.py:1466-1507):
    the LM through ``gemma3_random_params`` or, for ``weight_dtype`` int8 /
    int4, leaf by leaf straight into the quantized format (a 27B LM never
    exists in bf16 beside its quantized copy); ``vision_tower`` a
    ``SiglipVisionTower`` module and ``multi_modal_projector`` its tensors
    (:func:`_vision_parts`)."""
    device = resolve_device(device)
    if weight_dtype == "native":
        lang = gemma3_random_params(cfg.text, seed, dtype=dtype, device=device)
    else:
        lang = gemma3_random_params_int8(cfg.text, seed, dtype=dtype, device=device,
                                         fmt=weight_dtype)
    tower, projector = _vision_parts(cfg, device, dtype, seed=seed)
    return {**lang, "vision_tower": tower, "multi_modal_projector": projector}


def load_gemma3_mm(name: str, device: Any = "cuda", dtype: torch.dtype = torch.bfloat16,
                   seed: int = 0, weight_dtype: str = "native",
                   checkpoint_dir: Optional[str] = None):
    """The whole Gemma-3 generator (vision + LM) by name -> (cfg, params,
    tokenizer) (registry.py:1510-1540). ``params`` holds the LM's engine
    tree (``embed``, ``language_model``), ``vision_tower`` (a
    ``SiglipVisionTower`` on ``device``) and ``multi_modal_projector`` (its
    tensors). A checkpoint found by ``_find_checkpoint`` is read through
    ``hf_import.gemma3_mm_params_from_hf`` and placed leaf by leaf, the LM
    quantized on ``device`` as each leaf arrives under ``weight_dtype``
    int8 / int4 (as :func:`load_gemma3_lm` does; JAX quantizes the whole
    tree after the load); where none is found the weights are random from
    ``seed`` (:func:`gemma3_mm_random_params`), with a warning. A name
    without a multimodal config (gemma-3-1b) raises ``KeyError``, as in JAX."""
    if name not in GEMMA3_MM_CONFIGS:
        raise KeyError(f"unknown gemma3 mm model {name!r}; known: {sorted(GEMMA3_MM_CONFIGS)}")
    if weight_dtype not in ("native", "int8", "int4"):
        raise ValueError(f"weight_dtype must be 'native', 'int8' or 'int4', got {weight_dtype!r}")
    cfg = GEMMA3_MM_CONFIGS[name]()
    device = resolve_device(device)
    ckpt = _find_checkpoint(name, checkpoint_dir)
    if ckpt is not None:
        tree = hf_import.gemma3_mm_params_from_hf(hf_import.load_state_dict(ckpt), cfg)
        lang = _place_lm({"embed": tree["embed"], "language_model": tree["language_model"]},
                         device, dtype, weight_dtype)
        tower, projector = _vision_parts(cfg, device, dtype, tree=tree)
        params = {**lang, "vision_tower": tower, "multi_modal_projector": projector}
        return cfg, params, _load_tokenizer_from(ckpt)
    warnings.warn(f"no local checkpoint for {name!r}; using random init (seed {seed}; "
                  f"set COLPALI_TPU_CKPT_DIR to load real weights)", stacklevel=2)
    return cfg, gemma3_mm_random_params(cfg, seed, dtype=dtype, device=device,
                                        weight_dtype=weight_dtype), None
