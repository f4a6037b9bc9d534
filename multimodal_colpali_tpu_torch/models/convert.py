"""Flax parameter trees -> this package's ``state_dict``.

Reads the ``"a/b/c"`` keys that ``save_params_npz`` writes
(scripts/validate_checkpoints.py:63-86), or the nested dict that
``load_params_npz`` returns, and renames and re-lays out each array:

- ``layers_<i>`` path parts become ``layers.<i>``, ``/`` becomes ``.``;
- a dense ``kernel [in, out]`` becomes ``weight [out, in]``;
- a conv ``kernel [kh, kw, cin, cout]`` becomes ``weight [cout, cin, kh, kw]``
  (a depthwise ``[3, 3, 1, C]`` becomes ``[C, 1, 3, 3]``);
- every other array keeps its name and layout.

``params_from_flax`` checks every name and shape against the model of the
config's family (:func:`model_class`) and raises on anything missing, left
over or misshapen.

The decode engine keeps the JAX layout instead (a nested dict, dense kernels
``[in, out]``, int8 weights as ``{"q8", "scale"}`` dicts):
:func:`engine_params_from_jax` carries a JAX engine tree over as it is
(Gemma, Qwen2 and Llama LMs alike; :func:`gemma3_mm_params_from_jax`,
:func:`qwen2vl_mm_params_from_jax`, :func:`llava_next_params_from_jax` and
:func:`mllama_params_from_jax` a multimodal one, its tower as a ``state_dict``), and
:func:`engine_params_from_state_dict` turns a retriever's ``state_dict`` back
into that layout for its Gemma LM.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple, Type, Union

import numpy as np
import torch

from torch import nn

from multimodal_colpali_tpu_torch._device import resolve_device
from multimodal_colpali_tpu_torch.models.bert import BertEncoder
from multimodal_colpali_tpu_torch.models.colpali import ColPaliModel
from multimodal_colpali_tpu_torch.models.configs import (
    BertConfig, ColFlorModelConfig, ColGraniteModelConfig, ColIdefics3ModelConfig,
    ColPaliModelConfig, ColQwen2ModelConfig)
from multimodal_colpali_tpu_torch.models.florence2 import ColFlorModel
from multimodal_colpali_tpu_torch.models.granite import ColGraniteModel
from multimodal_colpali_tpu_torch.models.idefics3 import ColIdefics3Model
from multimodal_colpali_tpu_torch.models.qwen2vl import ColQwen2Model
from multimodal_colpali_tpu_torch.models.siglip import SiglipVisionTower

ModelConfig = Union[ColPaliModelConfig, ColIdefics3ModelConfig, ColFlorModelConfig,
                    ColQwen2ModelConfig, ColGraniteModelConfig, BertConfig]

_LAYER = re.compile(r"^layers_(\d+)$")


def flatten_flax(params: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> ``{"a/b/c": array}``; a flat mapping passes through.
    Torch tensors stay tensors; anything else becomes a numpy array."""
    flat: Dict[str, Any] = {}
    for key, val in params.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(flatten_flax(val, name))
        else:
            flat[name] = val if isinstance(val, torch.Tensor) else np.asarray(val)
    return flat


def torch_name(flax_key: str) -> str:
    parts = []
    for part in flax_key.split("/"):
        m = _LAYER.match(part)
        parts.append(f"layers.{m.group(1)}" if m else part)
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def to_torch_layout(flax_key: str, arr):
    """The torch layout of a flax leaf (numpy array or tensor; a tensor's is a view)."""
    if flax_key.endswith("/kernel"):
        if arr.ndim == 2:
            return arr.T
        if arr.ndim == 4:
            return (arr.permute(3, 2, 0, 1) if isinstance(arr, torch.Tensor)
                    else arr.transpose(3, 2, 0, 1))
    return arr


def flax_shape(name: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The flax layout of the torch parameter ``name`` of ``shape``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and len(shape) == 2:
        return (shape[1], shape[0])
    if leaf == "weight" and len(shape) == 4:
        cout, cin, kh, kw = shape
        return (kh, kw, cin, cout)
    return tuple(shape)


def model_class(cfg: ModelConfig) -> Type[nn.Module]:
    """The port's model class for a config: ColPali, ColIdefics3, ColFlor,
    ColQwen2, ColGranite or the bge BERT encoder."""
    if isinstance(cfg, BertConfig):
        return BertEncoder
    if isinstance(cfg, ColGraniteModelConfig):
        return ColGraniteModel
    if isinstance(cfg, ColQwen2ModelConfig):
        return ColQwen2Model
    if isinstance(cfg, ColIdefics3ModelConfig):
        return ColIdefics3Model
    if isinstance(cfg, ColFlorModelConfig):
        return ColFlorModel
    if isinstance(cfg, ColPaliModelConfig):
        return ColPaliModel
    raise TypeError(f"no ported model for {type(cfg).__name__}")


def params_from_flax(params: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A flax tree (flat or nested; numpy arrays or tensors) of the config's
    family -> ``state_dict`` of CPU tensors: numpy leaves are copied, tensor
    leaves (``models/hf_import``'s views of a checkpoint) stay views."""
    return state_from_flax(params, model_class(cfg)(cfg, device="meta"))


def state_from_flax(params: Mapping[str, Any], module: nn.Module) -> Dict[str, torch.Tensor]:
    """A flax tree -> ``module``'s ``state_dict`` (as :func:`params_from_flax`),
    every name and shape checked against ``module`` (a meta one will do)."""
    flat = flatten_flax(params)
    expected = {n: tuple(p.shape) for n, p in module.state_dict().items()}
    state: Dict[str, torch.Tensor] = {}
    seen = set()
    problems = []
    for key, arr in flat.items():
        name = torch_name(key)
        if name not in expected:
            problems.append(f"unexpected parameter {key!r}")
            continue
        seen.add(name)
        t = to_torch_layout(key, arr)
        if tuple(t.shape) != expected[name]:
            problems.append(f"{key!r}: shape {tuple(arr.shape)} does not map to "
                            f"{expected[name]}")
            continue
        # a numpy leaf becomes a writable, contiguous copy
        state[name] = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t))
    problems += [f"missing parameter {n!r}" for n in expected if n not in seen]
    if problems:
        raise ValueError(f"flax params do not fit the {type(module).__name__} config:\n  "
                         + "\n  ".join(problems))
    return state


def _tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":   # ml_dtypes' bfloat16, which numpy cannot hand over
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def engine_params_from_jax(tree: Mapping[str, Any], device: Any = "cuda",
                           dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A JAX decode-engine tree (nested dict of numpy or JAX arrays, plain or
    quantized) -> the same tree of tensors on ``device``. With ``dtype``,
    floating leaves are cast to it, except the float32 scales of quantized
    dicts, which stay float32 as in the JAX engine."""
    device = resolve_device(device)

    def conv(t, in_quant):
        if isinstance(t, Mapping):
            quant = "q8" in t or "q4" in t
            return {k: conv(v, quant) for k, v in t.items()}
        x = _tensor_from_numpy(np.asarray(t)).to(device)
        if dtype is not None and x.is_floating_point() and not in_quant:
            x = x.to(dtype)
        return x

    return conv(tree, False)


def gemma3_mm_params_from_jax(tree: Mapping[str, Any], cfg, device: Any = "cuda",
                              dtype: Optional[torch.dtype] = None):
    """A JAX ``Gemma3MMEngine`` tree (``embed``, ``language_model``,
    ``vision_tower``, ``multi_modal_projector``; numpy or JAX arrays) ->
    (the decode engine's LM tree on ``device``, the ``SiglipVisionTower``
    ``state_dict`` of ``cfg.vision``, the projector's tensors on ``device``).
    ``dtype`` casts the floating leaves of the LM and the projector, as
    :func:`engine_params_from_jax` does."""
    lm = engine_params_from_jax({"embed": tree["embed"],
                                 "language_model": tree["language_model"]}, device, dtype)
    tower = state_from_flax(tree["vision_tower"],
                            SiglipVisionTower(cfg.vision, device="meta", dtype=torch.float32))
    projector = engine_params_from_jax(tree["multi_modal_projector"], device, dtype)
    return lm, tower, projector


def qwen2vl_mm_params_from_jax(tree: Mapping[str, Any], cfg, device: Any = "cuda",
                               dtype: Optional[torch.dtype] = None):
    """A JAX ``Qwen2VLMMEngine`` tree (``embed``, ``language_model`` with its
    biases and any ``lm_head``, ``visual``) -> (the LM tree on ``device``, the
    ``Qwen2VisionTower`` ``state_dict`` of ``cfg.vision``)."""
    from multimodal_colpali_tpu_torch.models.qwen2vl import Qwen2VisionTower

    lm = engine_params_from_jax({"embed": tree["embed"],
                                 "language_model": tree["language_model"]}, device, dtype)
    tower = state_from_flax(tree["visual"],
                            Qwen2VisionTower(cfg.vision, device="meta", dtype=torch.float32))
    return lm, tower


def llava_next_params_from_jax(tree: Mapping[str, Any], cfg, device: Any = "cuda",
                               dtype: Optional[torch.dtype] = None):
    """A JAX ``LlavaNextMMEngine`` tree -> (the LM tree on ``device``, the
    ``ClipFeatureTower`` ``state_dict`` of ``cfg``, the projector's tensors
    (``linear_1``, ``linear_2``, ``image_newline``) on ``device``)."""
    from multimodal_colpali_tpu_torch.models.clip import ClipFeatureTower

    lm = engine_params_from_jax({"embed": tree["embed"],
                                 "language_model": tree["language_model"]}, device, dtype)
    tower = state_from_flax(tree["vision_tower"], ClipFeatureTower(
        cfg.vision, cfg.vision_feature_layer, device="meta", dtype=torch.float32))
    projector = engine_params_from_jax(tree["multi_modal_projector"], device, dtype)
    return lm, tower, projector


def mllama_params_from_jax(tree: Mapping[str, Any], cfg, device: Any = "cuda",
                           dtype: Optional[torch.dtype] = None):
    """A JAX ``MllamaMMEngine`` tree (``embed``, ``language_model``,
    ``cross_layers``, ``vision_tower``, ``multi_modal_projector``) -> (the LM
    tree, the ``MllamaVisionTower`` ``state_dict`` of ``cfg.vision``, the
    projector's tensors, the cross layers' tree), the tensors on ``device``."""
    from multimodal_colpali_tpu_torch.models.mllama import MllamaVisionTower

    lm = engine_params_from_jax({"embed": tree["embed"],
                                 "language_model": tree["language_model"]}, device, dtype)
    tower = state_from_flax(tree["vision_tower"],
                            MllamaVisionTower(cfg.vision, device="meta", dtype=torch.float32))
    projector = engine_params_from_jax(tree["multi_modal_projector"], device, dtype)
    cross = engine_params_from_jax(tree["cross_layers"], device, dtype)
    return lm, tower, projector, cross


def engine_params_from_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The ``embed`` and ``language_model`` entries of a ColPali
    ``state_dict`` -> the engine's nested tree: ``layers.<i>`` becomes
    ``layers_<i>`` and each 2-D dense ``weight [out, in]`` a ``kernel [in, out]``
    (a transposed view, no copy). A W8A8 retriever's LM (int8 encoder
    projections, ``quantize="int8"``) is refused: the engine's int8 weights
    are weight-only dicts of another layout."""
    tree: Dict[str, Any] = {}
    for name, t in state.items():
        parts = name.split(".")
        if parts[0] not in ("embed", "language_model"):
            continue
        if t.dtype == torch.int8 or parts[-1] == "weight_scale":
            raise ValueError(f"{name} is a W8A8 encoder projection: load the retriever "
                             f"without quantize to serve its LM")
        path = []
        i = 0
        while i < len(parts):
            if parts[i] == "layers" and i + 1 < len(parts) and parts[i + 1].isdigit():
                path.append(f"layers_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        if path[-1] == "weight" and t.dim() == 2:
            path[-1], t = "kernel", t.T
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = t
    return tree
