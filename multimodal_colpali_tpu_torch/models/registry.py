"""Retriever and generator-LM registry (counterpart of
``multimodal_colpali_tpu/models/registry.py``).

``load_retriever(name, device=...)`` returns a :class:`Retriever`: the
encoder of the name's family (ColPali, ColIdefics3, ColFlor, ColQwen2 or
ColGranite) on ``device`` plus its processor, its projections W8A8 under
``quantize="int8"``. Weights come from a flax parameter tree (``params=``,
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

The old-model generators (registry.py:756-1169): ``load_qwen2vl_lm`` /
``load_qwen2vl_mm`` (Qwen2-VL-2B/7B, the LM alone or with the ColQwen2 tower),
``load_llama_lm`` and ``load_llava_next_mm`` (LLaVA-NeXT-Llama3-8B: CLIP tower,
projector, Llama-3-8B), and ``load_mllama_mm`` (Llama-3.2-11B-Vision: the tiled
tower, projector, cross layers and Llama-3.1-8B, registry.py:1170-1440). Their random weights are made on ``device``, the LM
leaf by leaf like Gemma-3's (straight into int8 / int4 under ``weight_dtype``,
so the 8B LM never exists in bf16 beside its quantized copy); norm weights 1
(plain RMSNorm), biases 0, the rest N(0, fan_in^-0.5).
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
    ColFlorModelConfig, ColGraniteModelConfig, ColIdefics3ModelConfig, ColPaliModelConfig,
    ColQwen2ModelConfig, Gemma3MMConfig, Gemma3TextConfig, LlamaTextConfig, LlavaNextMMConfig,
    Qwen2TextConfig)
from multimodal_colpali_tpu_torch.models.convert import (
    ModelConfig, flax_shape, model_class, params_from_flax, state_from_flax)
from multimodal_colpali_tpu_torch.models.processing import ColPaliProcessor
from multimodal_colpali_tpu_torch.models.processing_florence2 import ColFlorProcessor
from multimodal_colpali_tpu_torch.models.processing_granite import ColGraniteProcessor
from multimodal_colpali_tpu_torch.models.processing_idefics3 import ColIdefics3Processor
from multimodal_colpali_tpu_torch.models.processing_qwen2vl import ColQwen2Processor
from multimodal_colpali_tpu_torch.models.siglip import SiglipVisionTower
from multimodal_colpali_tpu_torch.ops.preprocess import normalize_images
from multimodal_colpali_tpu_torch.ops.quant import quantize_encoder_params, quantize_lm_leaf
from multimodal_colpali_tpu_torch.parallel.mesh import Sharding, batch_sharding

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
    "ibm-granite/granite-vision-3.3-2b-embedding": ColGraniteModelConfig.granite_vision_3,
    "tiny-colgranite": ColGraniteModelConfig.tiny,
}

PROCESSORS = {"colpali": ColPaliProcessor, "colidefics3": ColIdefics3Processor,
              "colflor": ColFlorProcessor, "colqwen2": ColQwen2Processor,
              "colgranite": ColGraniteProcessor}
CONVERTERS = {"colpali": hf_import.colpali_params_from_hf,
              "colidefics3": hf_import.colidefics3_params_from_hf,
              "colflor": hf_import.colflor_params_from_hf,
              "colqwen2": hf_import.colqwen2_params_from_hf,
              "colgranite": hf_import.colgranite_params_from_hf}
# each family's processor keyword for dynamic_resolution (registry.py:470-506);
# ColPali and ColFlor have one layout and ignore the flag
DYNAMIC_KWARG = {"colqwen2": "dynamic_resolution", "colidefics3": "image_splitting",
                 "colgranite": "anyres"}

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
    if isinstance(cfg, ColGraniteModelConfig):
        return "colgranite"
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
    ``position_ids`` and its ``grid``, colgranite's and colidefics3's a
    grouped batch's layout as ``tiles``; under a dynamic-resolution
    processor pages are embedded in per-layout groups (registry.py:107-114,
    170-200).

    ``quantize="int8"`` makes every dense projection of the model W8A8
    (``ops/quant.quantize_encoder_params``, in place, from the weights in
    the model's dtype on its device, as registry.py:80-93 quantizes after
    the cast); any other mode raises ``ValueError``.

    ``mesh`` (``parallel.get_mesh``, a ``data`` axis) makes embedding
    data-parallel (registry.py:46-169): every rank holds the same weights
    (each builds them from the same checkpoint or seed), a batch is padded to
    a multiple of the ``data`` size with copies of its last item, each rank
    runs the forward on its share of the rows (``position_ids``' batch axis
    is its second), and the outputs are all-gathered, so every rank returns
    every embedding, in order. ``device`` must be the mesh's."""

    name: str
    model: torch.nn.Module
    processor: Any
    device: torch.device
    dtype: torch.dtype = torch.bfloat16
    device_preprocess: bool = False
    family: str = "colpali"
    quantize: Optional[str] = None
    mesh: Any = None

    def __post_init__(self):
        if self.device_preprocess and "device_preprocess" not in inspect.signature(
                self.processor.process_images).parameters:
            raise ValueError(f"device_preprocess is not supported by "
                             f"{type(self.processor).__name__} (fixed-resolution "
                             f"ColPali-family processors only)")
        if self.device_preprocess and getattr(self.processor, "dynamic_resolution", False):
            raise ValueError("device_preprocess requires the fixed square layout; "
                             "disable dynamic_resolution/image splitting")
        if self.quantize is not None:
            if self.quantize != "int8":
                raise ValueError(f"unknown quantize mode {self.quantize!r}; only 'int8'")
            quantize_encoder_params(self.model)
        if self.mesh is not None:
            self.mesh.check(torch.empty(0, device=self.device))

    def _pad_batch(self, items: List[Any]) -> List[Any]:
        """``items`` padded with copies of the last to a multiple of the
        ``data`` size (registry.py:163-170)."""
        dp = self.mesh.size("data") if self.mesh is not None else 1
        return items + items[-1:] * ((-len(items)) % dp)

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
    def _embed(self, batch: Dict[str, Any], with_image: bool, n: Optional[int] = None
               ) -> List[np.ndarray]:
        """The first ``n`` rows' embeddings (all rows by default); on a mesh
        this rank embeds its share of the rows and gathers the rest."""
        mask_np = batch["attention_mask"]
        n = mask_np.shape[0] if n is None else n
        if self.mesh is not None:
            batch = {k: v if k == "grid" else Sharding(
                self.mesh, "data", 1 if k == "position_ids" else 0).local(v)
                for k, v in batch.items()}
        ids = torch.from_numpy(batch["input_ids"]).to(self.device, torch.long)
        mask = torch.from_numpy(batch["attention_mask"]).to(self.device)
        pix = self._pixels(batch["pixel_values"]) if with_image else None
        if self.family == "colqwen2":
            pos = torch.from_numpy(batch["position_ids"]).to(self.device)
            out = self.model(ids, mask, pos, pix, grid=batch.get("grid"))
        elif batch.get("grid") is not None:       # a tiled layout (idefics3, granite)
            out = self.model(ids, mask, pix, tiles=batch["grid"])
        else:
            out = self.model(ids, mask, pix)
        if self.mesh is not None:
            out = batch_sharding(self.mesh, "data").gather(out)
        emb = out.float().cpu().numpy()
        return [emb[i][mask_np[i] == 1] for i in range(n)]

    def embed_images(self, images: Sequence[Any], batch_size: int = 32) -> List[np.ndarray]:
        """Page images -> list of ``[n_tokens, dim]`` float32 arrays, in the
        pages' order."""
        if getattr(self.processor, "dynamic_resolution", False):
            grouped: List[Any] = [None] * len(images)
            for grid, idxs in self.processor.group_by_grid(images):
                for start in range(0, len(idxs), batch_size):
                    sel = idxs[start: start + batch_size]
                    batch = self.processor.process_images(
                        self._pad_batch([images[i] for i in sel]), grid=grid,
                        device=self.device)
                    for i, emb in zip(sel, self._embed(batch, with_image=True, n=len(sel))):
                        grouped[i] = emb
            return grouped
        out: List[np.ndarray] = []
        for start in range(0, len(images), batch_size):
            chunk = list(images[start: start + batch_size])
            padded = self._pad_batch(chunk)
            batch = (self.processor.process_images(padded, device_preprocess=True,
                                                   device=self.device)
                     if self.device_preprocess
                     else self.processor.process_images(padded, device=self.device))
            out += self._embed(batch, with_image=True, n=len(chunk))
        return out

    def embed_queries(self, queries: Sequence[str], batch_size: int = 64) -> List[np.ndarray]:
        out: List[np.ndarray] = []
        for start in range(0, len(queries), batch_size):
            chunk = list(queries[start: start + batch_size])
            batch = self.processor.process_queries(self._pad_batch(chunk))
            out += self._embed(batch, with_image=False, n=len(chunk))
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
    mesh: Any = None,
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
    registry does (registry.py:532-535); ``quantize="int8"`` is W8A8 (see
    :class:`Retriever`). ``dynamic_resolution=True`` gives colqwen2 its
    smart-resize grids, colidefics3 SmolVLM's image splitting and colgranite
    LLaVA-Next's anyres tiles; ColPali and ColFlor have one layout and
    ignore it, as in JAX. ``mesh`` makes embedding data-parallel over its
    ``data`` axis (see :class:`Retriever`)."""
    if name not in RETRIEVER_CONFIGS:
        raise KeyError(f"unknown retriever {name!r}; known: {sorted(RETRIEVER_CONFIGS)}")
    if quantize is None:
        quantize = os.environ.get("MMCP_QUANTIZE") or None
    if device_preprocess is None:
        device_preprocess = os.environ.get("MMCP_DEVICE_PREPROCESS") == "1"
    if quantize not in (None, "int8"):             # before any weight is made
        raise ValueError(f"unknown quantize mode {quantize!r}; only 'int8'")
    cfg = RETRIEVER_CONFIGS[name]()
    family = family_of(cfg)
    device = resolve_device(device)
    model = model_class(cfg)(cfg, device=device, dtype=dtype).eval()
    dyn = {DYNAMIC_KWARG[family]: dynamic_resolution} if family in DYNAMIC_KWARG else {}
    processor = PROCESSORS[family](cfg, tokenizer=tokenizer, **dyn)
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
                     device_preprocess=bool(device_preprocess), family=family, quantize=quantize,
                     mesh=mesh)


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


def _build_tree(shapes: Dict[str, Any], make_leaf) -> Dict[str, Any]:
    """Fill the shape tree leaf by leaf, largest first (the embed table's
    float32 transient is the biggest, made while the tree is still empty)."""
    flat = list(tree_leaves(shapes))
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

    return _build_tree(gemma3_param_shapes(cfg), leaf)


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

    return _build_tree(gemma3_param_shapes(cfg), leaf)


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


# -- the old-model generators: Qwen2-VL, Llama, LLaVA-NeXT --------------------------

QWEN2VL_CONFIGS: Dict[str, Callable[[], Qwen2TextConfig]] = {
    "AdaptLLM/biomed-Qwen2-VL-2B-Instruct": Qwen2TextConfig.qwen2_vl_2b,
    "Qwen/Qwen2-VL-2B-Instruct": Qwen2TextConfig.qwen2_vl_2b,
    "qwen2-vl-2b": Qwen2TextConfig.qwen2_vl_2b,
    "Qwen/Qwen2-VL-7B-Instruct": Qwen2TextConfig.qwen2_vl_7b,
    "qwen2-vl-7b": Qwen2TextConfig.qwen2_vl_7b,
    "tiny-qwen2vl": Qwen2TextConfig.tiny,
}
# the whole generator (tower + LM) under the same names
_QWEN2VL_FULL: Dict[str, Callable[[], ColQwen2ModelConfig]] = {
    "AdaptLLM/biomed-Qwen2-VL-2B-Instruct": ColQwen2ModelConfig.qwen2_vl_2b,
    "Qwen/Qwen2-VL-2B-Instruct": ColQwen2ModelConfig.qwen2_vl_2b,
    "qwen2-vl-2b": ColQwen2ModelConfig.qwen2_vl_2b,
    "Qwen/Qwen2-VL-7B-Instruct": ColQwen2ModelConfig.qwen2_vl_7b,
    "qwen2-vl-7b": ColQwen2ModelConfig.qwen2_vl_7b,
    "tiny-qwen2vl": ColQwen2ModelConfig.tiny,
}
LLAMA_CONFIGS: Dict[str, Callable[[], LlamaTextConfig]] = {
    "AdaptLLM/biomed-LLaVA-NeXT-Llama3-8B": LlamaTextConfig.llama3_8b,
    "meta-llama/Meta-Llama-3-8B-Instruct": LlamaTextConfig.llama3_8b,
    "llama-3-8b": LlamaTextConfig.llama3_8b,
    "tiny-llama": LlamaTextConfig.tiny_lm,
}
LLAVA_NEXT_CONFIGS: Dict[str, Callable[[], LlavaNextMMConfig]] = {
    "AdaptLLM/biomed-LLaVA-NeXT-Llama3-8B": LlavaNextMMConfig.llava_next_llama3_8b,
    "llava-next-llama3-8b": LlavaNextMMConfig.llava_next_llama3_8b,
    "tiny-llava-next": LlavaNextMMConfig.tiny,
}


def qwen2vl_param_shapes(cfg) -> Dict[str, Any]:
    """The Qwen2 / Llama engine tree's leaf shapes (registry.py:781-820):
    q/k/v biases for a Qwen2 config only, mlp nested, ``lm_head`` for an
    untied one."""
    h, hd = cfg.hidden_size, cfg.head_dim
    nq, nkv, inter = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.intermediate_size
    biased = getattr(cfg, "is_qwen2", False)

    def proj(k, n):
        return {"kernel": (k, n), **({"bias": (n,)} if biased else {})}

    layer = {
        "self_attn": {"q_proj": proj(h, nq * hd), "k_proj": proj(h, nkv * hd),
                      "v_proj": proj(h, nkv * hd), "o_proj": {"kernel": (nq * hd, h)}},
        "mlp": {"gate_proj": {"kernel": (h, inter)}, "up_proj": {"kernel": (h, inter)},
                "down_proj": {"kernel": (inter, h)}},
        "input_layernorm": {"weight": (h,)},
        "post_attention_layernorm": {"weight": (h,)},
    }
    language: Dict[str, Any] = {f"layers_{i}": layer for i in range(cfg.num_hidden_layers)}
    language["norm"] = {"weight": (h,)}
    if not cfg.tie_word_embeddings:
        language["lm_head"] = {"kernel": (h, cfg.vocab_size)}
    return {"embed": {"embed_tokens": (cfg.vocab_size, h)}, "language_model": language}


def qwen2vl_random_params(cfg, seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                          device: Any = "cuda", weight_dtype: str = "native"):
    """Random Qwen2 / Llama LM params on ``device`` (registry.py:823-840):
    plain RMSNorm weights 1, biases 0, kernels and the table N(0,
    fan_in^-0.5) in ``dtype``, or under ``weight_dtype`` int8 / int4 each
    made straight into its quantized format, one leaf at a time
    (registry.py:1037-1090)."""
    _check_weight_dtype(weight_dtype)
    device = resolve_device(device)

    def leaf(i, name, shape):
        if name in ("weight", "bias"):
            fill = torch.ones if name == "weight" else torch.zeros
            return fill(shape, dtype=dtype, device=device)
        w = _normal_leaf(i, shape, seed, device)
        return w.to(dtype) if weight_dtype == "native" else quantize_lm_leaf(name, w,
                                                                              weight_dtype)

    return _build_tree(qwen2vl_param_shapes(cfg), leaf)


def _random_module(module: torch.nn.Module, seed: int, family: str) -> torch.nn.Module:
    init_random_params_(module, seed, family=family)
    return module.eval()


def qwen2vl_mm_random_params(cfg: ColQwen2ModelConfig, seed: int = 0,
                             dtype: torch.dtype = torch.bfloat16, device: Any = "cuda",
                             weight_dtype: str = "native"):
    """Random whole Qwen2-VL params (registry.py:873-898): the LM by
    :func:`qwen2vl_random_params` and ``visual``, a ``Qwen2VisionTower`` on
    ``device`` (norm weights 1, biases 0, the rest N(0, fan_in^-0.5))."""
    from multimodal_colpali_tpu_torch.models.qwen2vl import Qwen2VisionTower

    device = resolve_device(device)
    lm = qwen2vl_random_params(cfg.text, seed, dtype, device, weight_dtype)
    lm["visual"] = _random_module(Qwen2VisionTower(cfg.vision, device=device, dtype=dtype),
                                  seed + 1, "colqwen2")
    return lm


def _llava_projector(cfg: LlavaNextMMConfig, seed: int, dtype: torch.dtype,
                     device: torch.device) -> Dict[str, Any]:
    v_h, t_h = cfg.vision.hidden_size, cfg.text.hidden_size
    gen = torch.Generator(device=device).manual_seed(seed + 2)

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return w.mul_(float(fan_in) ** -0.5).to(dtype)

    return {"linear_1": {"kernel": normal((v_h, t_h), v_h),
                         "bias": torch.zeros(t_h, dtype=dtype, device=device)},
            "linear_2": {"kernel": normal((t_h, t_h), t_h),
                         "bias": torch.zeros(t_h, dtype=dtype, device=device)},
            "image_newline": normal((t_h,), t_h)}


def llava_next_random_params(cfg: LlavaNextMMConfig, seed: int = 0,
                             dtype: torch.dtype = torch.bfloat16, device: Any = "cuda"):
    """Random whole LLaVA-NeXT params on ``device`` (registry.py:997-1034):
    the Llama LM by :func:`qwen2vl_random_params`, ``vision_tower`` a
    ``ClipFeatureTower`` (LayerNorm weights 1, biases 0), the projector's
    linears and ``image_newline``."""
    return _llava_random(cfg, seed, dtype, device, "native")


def llava_next_random_params_int8(cfg: LlavaNextMMConfig, seed: int = 0,
                                  dtype: torch.dtype = torch.bfloat16, device: Any = "cuda",
                                  fmt: str = "int8"):
    """The same with the LM made straight into weight-only int8 (or int4),
    one leaf at a time (registry.py:1037-1127): the 8B LM never exists in
    bf16; the peak is the quantized tree plus one leaf's float32 transient.
    The tower and the projector stay in ``dtype``."""
    if fmt not in ("int8", "int4"):
        raise ValueError(f"fmt must be 'int8' or 'int4', got {fmt!r}")
    return _llava_random(cfg, seed, dtype, device, fmt)


def _llava_random(cfg, seed, dtype, device, weight_dtype):
    from multimodal_colpali_tpu_torch.models.clip import ClipFeatureTower

    device = resolve_device(device)
    lm = qwen2vl_random_params(cfg.text, seed, dtype, device, weight_dtype)
    lm["vision_tower"] = _random_module(ClipFeatureTower(
        cfg.vision, cfg.vision_feature_layer, device=device, dtype=dtype), seed + 1, "clip")
    lm["multi_modal_projector"] = _llava_projector(cfg, seed, dtype, device)
    return lm


def _warn_random(name: str) -> None:
    """The JAX loaders' warning on random init (registry.py:862-866)."""
    warnings.warn(f"no local checkpoint for {name!r}; using random init "
                  f"(set COLPALI_TPU_CKPT_DIR to load real weights)", stacklevel=3)


def _check_weight_dtype(weight_dtype: str) -> None:
    if weight_dtype not in ("native", "int8", "int4"):
        raise ValueError(f"weight_dtype must be 'native', 'int8' or 'int4', got {weight_dtype!r}")


def _loaded_module(module: torch.nn.Module, flax_tree: Dict[str, Any]) -> torch.nn.Module:
    """``module`` (made on its device) filled from a checkpoint's flax-named subtree."""
    module.load_state_dict(state_from_flax(flax_tree, module))
    return module.eval()


def load_qwen2vl_lm(name: str, device: Any = "cuda", dtype: torch.dtype = torch.bfloat16,
                    seed: int = 0, weight_dtype: str = "native",
                    checkpoint_dir: Optional[str] = None):
    """A Qwen2-VL generator's LM by name -> (cfg, engine params, tokenizer)
    (registry.py:843-870): a checkpoint (the whole VL one; its tower is
    dropped) placed leaf by leaf on ``device``, else random from ``seed``
    with JAX's warning."""
    if name not in QWEN2VL_CONFIGS:
        raise KeyError(f"unknown qwen2-vl LM {name!r}; known: {sorted(QWEN2VL_CONFIGS)}")
    _check_weight_dtype(weight_dtype)
    cfg = QWEN2VL_CONFIGS[name]()
    device = resolve_device(device)
    ckpt = _find_checkpoint(name, checkpoint_dir)
    if ckpt is not None:
        tree = hf_import.qwen2vl_lm_params_from_hf(hf_import.load_state_dict(ckpt),
                                                   _QWEN2VL_FULL[name]())
        tree.pop("visual")
        return cfg, _place_lm(tree, device, dtype, weight_dtype), _load_tokenizer_from(ckpt)
    _warn_random(name)
    return cfg, qwen2vl_random_params(cfg, seed, dtype, device, weight_dtype), None


def load_qwen2vl_mm(name: str, device: Any = "cuda", dtype: torch.dtype = torch.bfloat16,
                    seed: int = 0, weight_dtype: str = "native",
                    checkpoint_dir: Optional[str] = None):
    """The whole Qwen2-VL generator by name -> (cfg, params, tokenizer)
    (registry.py:901-931): ``cfg`` the plain-VL ``ColQwen2ModelConfig``;
    ``params`` the LM's engine tree and ``visual``, a ``Qwen2VisionTower`` on
    ``device``. A checkpoint converts through
    ``hf_import.qwen2vl_lm_params_from_hf`` (the ColQwen2 path), the LM
    placed leaf by leaf (quantized as it arrives under ``weight_dtype``)."""
    from multimodal_colpali_tpu_torch.models.qwen2vl import Qwen2VisionTower

    if name not in _QWEN2VL_FULL:
        raise KeyError(f"unknown qwen2-vl model {name!r}; known: {sorted(_QWEN2VL_FULL)}")
    _check_weight_dtype(weight_dtype)
    cfg = _QWEN2VL_FULL[name]()
    device = resolve_device(device)
    ckpt = _find_checkpoint(name, checkpoint_dir)
    if ckpt is not None:
        tree = hf_import.qwen2vl_lm_params_from_hf(hf_import.load_state_dict(ckpt), cfg)
        visual = tree.pop("visual")
        params = _place_lm(tree, device, dtype, weight_dtype)
        params["visual"] = _loaded_module(
            Qwen2VisionTower(cfg.vision, device=device, dtype=dtype), visual)
        return cfg, params, _load_tokenizer_from(ckpt)
    _warn_random(name)
    return cfg, qwen2vl_mm_random_params(cfg, seed, dtype, device, weight_dtype), None


def load_llama_lm(name: str, device: Any = "cuda", dtype: torch.dtype = torch.bfloat16,
                  seed: int = 0, weight_dtype: str = "native",
                  checkpoint_dir: Optional[str] = None):
    """A Llama generator LM by name -> (cfg, engine params, tokenizer)
    (registry.py:951-977): a bare Llama or a LLaVA-NeXT checkpoint (its
    nesting stripped, its vision subtrees ignored), else random from
    ``seed`` with JAX's warning."""
    if name not in LLAMA_CONFIGS:
        raise KeyError(f"unknown llama LM {name!r}; known: {sorted(LLAMA_CONFIGS)}")
    _check_weight_dtype(weight_dtype)
    cfg = LLAMA_CONFIGS[name]()
    device = resolve_device(device)
    ckpt = _find_checkpoint(name, checkpoint_dir)
    if ckpt is not None:
        tree = hf_import.llama_lm_params_from_hf(hf_import.load_state_dict(ckpt), cfg)
        return cfg, _place_lm(tree, device, dtype, weight_dtype), _load_tokenizer_from(ckpt)
    _warn_random(name)
    return cfg, qwen2vl_random_params(cfg, seed, dtype, device, weight_dtype), None


def load_llava_next_mm(name: str, device: Any = "cuda", dtype: torch.dtype = torch.bfloat16,
                       seed: int = 0, weight_dtype: str = "native",
                       checkpoint_dir: Optional[str] = None):
    """The whole LLaVA-NeXT generator by name -> (cfg, params, tokenizer)
    (registry.py:1130-1169): ``params`` the LM's engine tree,
    ``vision_tower`` (a ``ClipFeatureTower`` on ``device``) and
    ``multi_modal_projector`` (its tensors). A checkpoint's embedding rows set
    the vocab, as in JAX; without one the weights are random from ``seed``,
    the LM made straight into int8 / int4 under ``weight_dtype``."""
    from multimodal_colpali_tpu_torch.models.clip import ClipFeatureTower

    if name not in LLAVA_NEXT_CONFIGS:
        raise KeyError(f"unknown llava-next model {name!r}; known: "
                       f"{sorted(LLAVA_NEXT_CONFIGS)}")
    _check_weight_dtype(weight_dtype)
    cfg = LLAVA_NEXT_CONFIGS[name]()
    device = resolve_device(device)
    ckpt = _find_checkpoint(name, checkpoint_dir)
    if ckpt is not None:
        tree = hf_import.llava_next_params_from_hf(hf_import.load_state_dict(ckpt), cfg)
        rows = int(tree["embed"]["embed_tokens"].shape[0])
        if rows != cfg.text.vocab_size:
            cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, vocab_size=rows))
        vision, proj = tree.pop("vision_tower"), tree.pop("multi_modal_projector")
        params = _place_lm(tree, device, dtype, weight_dtype)
        params["vision_tower"] = _loaded_module(ClipFeatureTower(
            cfg.vision, cfg.vision_feature_layer, device=device, dtype=dtype), vision)
        params["multi_modal_projector"] = _place_lm(proj, device, dtype, "native")
        return cfg, params, _load_tokenizer_from(ckpt)
    _warn_random(name)
    return cfg, _llava_random(cfg, seed, dtype, device, weight_dtype), None


# -- Mllama (Llama-3.2-Vision) ---------------------------------------------------------

def _mllama_configs() -> Dict[str, Callable[[], Any]]:
    from multimodal_colpali_tpu_torch.models.mllama import MllamaMMConfig

    return {
        "AdaptLLM/biomed-Llama-3.2-11B-Vision-Instruct": MllamaMMConfig.llama32_11b_vision,
        "meta-llama/Llama-3.2-11B-Vision-Instruct": MllamaMMConfig.llama32_11b_vision,
        "llama-3.2-11b-vision": MllamaMMConfig.llama32_11b_vision,
        "tiny-mllama": MllamaMMConfig.tiny,
    }


MLLAMA_CONFIGS: Dict[str, Callable[[], Any]] = _mllama_configs()
# the random cross blocks' and tower's tanh gates (registry.py:1237-1238,
# :1258-1259): at 0 every cross block and gated embedding would be an identity
RANDOM_GATE = 0.25


def mllama_param_shapes(cfg) -> Dict[str, Any]:
    """The LM and cross-layer leaf shapes (registry.py:1265-1293): the Llama
    tree with HF's ``vocab_size + 8`` embedding rows (``<|image|>`` lies past
    the head's vocab) and ``cross_layers`` keyed by global index."""
    c = cfg.text
    h, hd, inter = c.hidden_size, c.head_dim, c.intermediate_size
    shapes = qwen2vl_param_shapes(c)
    shapes["embed"]["embed_tokens"] = (c.vocab_size + 8, h)
    layer = {
        "cross_attn": {
            "q_proj": {"kernel": (h, c.num_attention_heads * hd)},
            "k_proj": {"kernel": (h, c.num_key_value_heads * hd)},
            "v_proj": {"kernel": (h, c.num_key_value_heads * hd)},
            "o_proj": {"kernel": (c.num_attention_heads * hd, h)},
            "q_norm": {"weight": (hd,)},
            "k_norm": {"weight": (hd,)},
        },
        "input_layernorm": {"weight": (h,)},
        "post_attention_layernorm": {"weight": (h,)},
        "mlp": {"gate_proj": {"kernel": (h, inter)}, "up_proj": {"kernel": (h, inter)},
                "down_proj": {"kernel": (inter, h)}},
        "gate_attn": (1,),
        "gate_mlp": (1,),
    }
    shapes["cross_layers"] = {str(g): layer for g in cfg.cross_attention_layers}
    return shapes


def mllama_random_params(cfg, seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                         device: Any = "cuda", weight_dtype: str = "native"):
    """Random whole Mllama params on ``device`` (registry.py:1193-1262,
    :1296-1397): the LM and the cross layers leaf by leaf (norm weights 1,
    gates ``RANDOM_GATE``, the rest N(0, fan_in^-0.5); under ``weight_dtype``
    int8 / int4 each kernel and the table made straight into its quantized
    format, so the 11B tree never exists in bf16 beside its quantized copy),
    ``vision_tower`` an ``MllamaVisionTower`` (LayerNorm weights 1, biases 0,
    gates ``RANDOM_GATE``) and the projector's tensors, in ``dtype``."""
    from multimodal_colpali_tpu_torch.models.mllama import MllamaVisionTower

    _check_weight_dtype(weight_dtype)
    device = resolve_device(device)

    def leaf(i, name, shape):
        if name == "weight":
            return torch.ones(shape, dtype=dtype, device=device)
        if name in ("gate_attn", "gate_mlp"):
            return torch.full(shape, RANDOM_GATE, dtype=torch.float32, device=device)
        w = _normal_leaf(i, shape, seed, device)
        return w.to(dtype) if weight_dtype == "native" else quantize_lm_leaf(name, w,
                                                                              weight_dtype)

    params = _build_tree(mllama_param_shapes(cfg), leaf)
    tower = _random_module(MllamaVisionTower(cfg.vision, device=device, dtype=dtype),
                           seed + 1, "mllama")
    with torch.no_grad():
        for name, p in tower.named_parameters():
            if name.rsplit(".", 1)[-1] in ("pre_tile_gate", "pos_gate", "post_tile_gate",
                                           "gate_attn", "gate_ffn"):
                p.fill_(RANDOM_GATE)
    params["vision_tower"] = tower
    v, th = cfg.vision.output_dim, cfg.text.hidden_size
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    w = torch.randn((v, th), generator=gen, device=device, dtype=torch.float32)
    params["multi_modal_projector"] = {"kernel": w.mul_(float(v) ** -0.5).to(dtype),
                                       "bias": torch.zeros(th, dtype=dtype, device=device)}
    return params


def load_mllama_mm(name: str, device: Any = "cuda", dtype: torch.dtype = torch.bfloat16,
                   seed: int = 0, weight_dtype: str = "native",
                   checkpoint_dir: Optional[str] = None):
    """The whole Llama-3.2-Vision generator by name -> (cfg, params,
    tokenizer) (registry.py:1400-1440): ``params`` the LM's engine tree,
    ``cross_layers``, ``vision_tower`` (an ``MllamaVisionTower`` on
    ``device``) and ``multi_modal_projector``. A checkpoint converts through
    ``hf_import.mllama_params_from_hf``, the LM and the cross layers placed
    leaf by leaf (quantized as they arrive under ``weight_dtype``), its head's
    columns setting the vocab; without one the weights are random from
    ``seed`` (:func:`mllama_random_params`) with JAX's warning."""
    from multimodal_colpali_tpu_torch.models.mllama import MllamaVisionTower

    if name not in MLLAMA_CONFIGS:
        raise KeyError(f"unknown mllama model {name!r}; known: {sorted(MLLAMA_CONFIGS)}")
    _check_weight_dtype(weight_dtype)
    cfg = MLLAMA_CONFIGS[name]()
    device = resolve_device(device)
    ckpt = _find_checkpoint(name, checkpoint_dir)
    if ckpt is not None:
        tree = hf_import.mllama_params_from_hf(hf_import.load_state_dict(ckpt), cfg)
        head = tree["language_model"].get("lm_head")
        if head is not None and int(head["kernel"].shape[1]) != cfg.text.vocab_size:
            cfg = dataclasses.replace(cfg, text=dataclasses.replace(
                cfg.text, vocab_size=int(head["kernel"].shape[1])))
        vision, proj = tree.pop("vision_tower"), tree.pop("multi_modal_projector")
        params = _place_lm(tree, device, dtype, weight_dtype)
        params["vision_tower"] = _loaded_module(
            MllamaVisionTower(cfg.vision, device=device, dtype=dtype), vision)
        params["multi_modal_projector"] = _place_lm(proj, device, dtype, "native")
        return cfg, params, _load_tokenizer_from(ckpt)
    _warn_random(name)
    return cfg, mllama_random_params(cfg, seed, dtype, device, weight_dtype), None
