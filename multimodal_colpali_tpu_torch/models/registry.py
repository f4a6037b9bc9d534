"""Retriever registry (counterpart of ``multimodal_colpali_tpu/models/registry.py``).

``load_retriever(name, device=...)`` returns a :class:`Retriever`: a ColPali
encoder on ``device`` plus its processor. Weights come from a flax parameter
tree (``params=``, e.g. ``load_params_npz`` of a committed golden) or, when
none is given, from a seeded random init made on ``device`` in the model
dtype, so a 3B model never exists in float32 on the host.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from multimodal_colpali_tpu_torch.models.colpali import ColPaliModel
from multimodal_colpali_tpu_torch.models.configs import ColPaliModelConfig
from multimodal_colpali_tpu_torch.models.convert import flax_shape, params_from_flax
from multimodal_colpali_tpu_torch.models.processing import ColPaliProcessor
from multimodal_colpali_tpu_torch.ops.preprocess import normalize_images

RETRIEVER_CONFIGS: Dict[str, Callable[[], ColPaliModelConfig]] = {
    "vidore/colpali-v1.2": ColPaliModelConfig.colpali_v1_3,
    "vidore/colpali-v1.3": ColPaliModelConfig.colpali_v1_3,
    "vidore/colpali-v1.3-hf": ColPaliModelConfig.colpali_v1_3,
    "vidore/colpali-v1.3-merged": ColPaliModelConfig.colpali_v1_3,
    "tiny-colpali": ColPaliModelConfig.tiny,
}

# Gemma's RMSNorm multiplies by (1 + w), so its neutral weight is 0.
_GEMMA_RMS_PARENTS = {"input_layernorm", "post_attention_layernorm", "norm"}


@torch.no_grad()
def init_random_params_(model: torch.nn.Module, seed: int = 0) -> None:
    """Fill ``model`` in place, on its device and in its dtype, by the rules
    of the JAX package's ``fast_random_params`` (registry.py:264-294):
    biases 0, Gemma RMSNorm weights 0, other norm weights 1, everything else
    N(0, fan_in^-0.5) with ``fan_in`` the first dim of the flax layout."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        parts = name.split(".")
        leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
        if leaf == "bias":
            p.zero_()
        elif leaf == "weight" and p.dim() == 1:
            p.fill_(0.0 if parent in _GEMMA_RMS_PARENTS else 1.0)
        else:
            fan_in = flax_shape(name, tuple(p.shape))[0]
            p.normal_(0.0, float(fan_in) ** -0.5, generator=gen)


@dataclasses.dataclass
class Retriever:
    """A late-interaction encoder bound to its weights, ready to embed.

    ``device_preprocess=True`` uploads uint8 pixels and normalizes them on
    ``device`` inside the forward (K3 on a CUDA device); the host stage is
    resize-only."""

    name: str
    model: ColPaliModel
    processor: ColPaliProcessor
    device: torch.device
    dtype: torch.dtype = torch.bfloat16
    device_preprocess: bool = False

    def _pixels(self, pv: np.ndarray) -> torch.Tensor:
        """Host pixels -> the model's pixel input on ``device`` (registry.py:137-163)."""
        if pv.dtype == np.uint8:
            pre = self.processor.image_preprocessor
            mean, std = (float(pre.mean),) * 3, (float(pre.std),) * 3
            x = torch.from_numpy(pv).to(self.device)
            return normalize_images(x, mean, std).to(self.dtype)
        return torch.from_numpy(np.asarray(pv, np.float32)).to(self.device, self.dtype)

    @torch.inference_mode()
    def _embed(self, batch: Dict[str, Any], with_image: bool) -> List[np.ndarray]:
        ids = torch.from_numpy(batch["input_ids"]).to(self.device, torch.long)
        mask_np = batch["attention_mask"]
        mask = torch.from_numpy(mask_np).to(self.device)
        pix = self._pixels(batch["pixel_values"]) if with_image else None
        emb = self.model(ids, mask, pix).float().cpu().numpy()
        return [emb[i][mask_np[i] == 1] for i in range(emb.shape[0])]

    def embed_images(self, images: Sequence[Any], batch_size: int = 32) -> List[np.ndarray]:
        """Page images -> list of ``[n_tokens, dim]`` float32 arrays."""
        out: List[np.ndarray] = []
        for start in range(0, len(images), batch_size):
            chunk = list(images[start: start + batch_size])
            batch = self.processor.process_images(chunk,
                                                  device_preprocess=self.device_preprocess)
            out += self._embed(batch, with_image=True)
        return out

    def embed_queries(self, queries: Sequence[str], batch_size: int = 64) -> List[np.ndarray]:
        out: List[np.ndarray] = []
        for start in range(0, len(queries), batch_size):
            batch = self.processor.process_queries(list(queries[start: start + batch_size]))
            out += self._embed(batch, with_image=False)
        return out


def load_retriever(
    name: str,
    device: Any = "cpu",
    tokenizer: Optional[Any] = None,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    params: Optional[Mapping[str, Any]] = None,
    quantize: Optional[str] = None,
    device_preprocess: bool = False,
) -> Retriever:
    """Load a late-interaction retriever by name (reference surface).

    ``params``: a flax parameter tree, flat (``"a/b/c"`` keys) or nested, as
    ``save_params_npz``/``load_params_npz`` write and read it. Without it the
    weights are random, drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device``."""
    if name not in RETRIEVER_CONFIGS:
        raise KeyError(f"unknown retriever {name!r}; known: {sorted(RETRIEVER_CONFIGS)}")
    if quantize == "int8":
        raise NotImplementedError(
            "W8A8 int8 projections (quantize='int8') are not ported yet; "
            "see ROADMAP.md, kernels K8/K9 and ops/quant")
    if quantize is not None:
        raise ValueError(f"unknown quantize mode {quantize!r}")
    cfg = RETRIEVER_CONFIGS[name]()
    device = torch.device(device)
    model = ColPaliModel(cfg, device=device, dtype=dtype).eval()
    if params is not None:
        model.load_state_dict(params_from_flax(params, cfg))
    else:
        warnings.warn(f"no checkpoint given for {name!r}; using random init "
                      f"(seed {seed})", stacklevel=2)
        init_random_params_(model, seed)
    return Retriever(name=name, model=model, processor=ColPaliProcessor(cfg, tokenizer=tokenizer),
                     device=device, dtype=dtype, device_preprocess=bool(device_preprocess))
