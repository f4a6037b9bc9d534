"""Flax parameter trees -> this package's ``state_dict``.

Reads the ``"a/b/c"`` keys that ``save_params_npz`` writes
(scripts/validate_checkpoints.py:63-86), or the nested dict that
``load_params_npz`` returns, and renames and re-lays out each array:

- ``layers_<i>`` path parts become ``layers.<i>``, ``/`` becomes ``.``;
- a dense ``kernel [in, out]`` becomes ``weight [out, in]``;
- a conv ``kernel [kh, kw, cin, cout]`` becomes ``weight [cout, cin, kh, kw]``;
- every other array keeps its name and layout.

``params_from_flax`` checks every name and shape against the model the
config describes and raises on anything missing, left over or misshapen.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from multimodal_colpali_tpu_torch.models.colpali import ColPaliModel
from multimodal_colpali_tpu_torch.models.configs import ColPaliModelConfig

_LAYER = re.compile(r"^layers_(\d+)$")


def flatten_flax(params: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> ``{"a/b/c": array}``; a flat mapping passes through."""
    flat: Dict[str, np.ndarray] = {}
    for key, val in params.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(flatten_flax(val, name))
        else:
            flat[name] = np.asarray(val)
    return flat


def torch_name(flax_key: str) -> str:
    parts = []
    for part in flax_key.split("/"):
        m = _LAYER.match(part)
        parts.append(f"layers.{m.group(1)}" if m else part)
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def to_torch_layout(flax_key: str, arr: np.ndarray) -> np.ndarray:
    if flax_key.endswith("/kernel"):
        if arr.ndim == 2:
            return arr.T
        if arr.ndim == 4:
            return arr.transpose(3, 2, 0, 1)
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


def params_from_flax(params: Mapping[str, Any],
                     cfg: ColPaliModelConfig) -> Dict[str, torch.Tensor]:
    """A flax ColPali tree (flat or nested numpy) -> ``state_dict`` of CPU tensors."""
    flat = flatten_flax(params)
    expected = {n: tuple(p.shape) for n, p in
                ColPaliModel(cfg, device="meta").state_dict().items()}
    state: Dict[str, torch.Tensor] = {}
    seen = set()
    problems = []
    for key, arr in flat.items():
        name = torch_name(key)
        if name not in expected:
            problems.append(f"unexpected parameter {key!r}")
            continue
        seen.add(name)
        t = np.array(to_torch_layout(key, arr))  # a writable, contiguous copy
        if tuple(t.shape) != expected[name]:
            problems.append(f"{key!r}: shape {arr.shape} does not map to {expected[name]}")
            continue
        state[name] = torch.from_numpy(t)
    problems += [f"missing parameter {n!r}" for n in expected if n not in seen]
    if problems:
        raise ValueError("flax params do not fit the ColPali config:\n  "
                         + "\n  ".join(problems))
    return state
