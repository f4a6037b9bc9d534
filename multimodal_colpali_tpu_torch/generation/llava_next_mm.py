"""Image-conditioned LLaVA-NeXT generation, the old-model tier's
AdaptLLM/biomed-LLaVA-NeXT-Llama3-8B (counterpart of
``multimodal_colpali_tpu/generation/llava_next_mm.py``).

- The CLIP ViT-L/14-336 tower read at layer -2 without its CLS row
  (``models/clip.ClipFeatureTower``: 23 layers, K2 on a CUDA tensor at
  ``[n, 577, 16, 64]``);
- the projector: linear, exact GELU, linear (HF
  ``LlavaNextMultiModalProjector``);
- static square anyres packing: the base image's 576 tokens, then the base
  again as its one tile with the ``image_newline`` feature after each of its
  24 rows, 1,176 tokens an image (HF's unpad crop is a no-op on the square);
- plain positions and a causal prompt: every token, image tokens too,
  advances the position by one.

The rest (the merge of features into the ``<image>`` slots, the prefill,
``generate``) is ``Qwen2VLMMEngine``'s, as in JAX; ``lm`` is the
``LlamaDecodeEngine`` that serves text beside this engine. ``pixel_values``
are normalized NHWC, ``[B, H, W, 3]`` or ``[B, N, H, W, 3]``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch
import torch.nn.functional as F

from multimodal_colpali_tpu_torch.generation.engine import LlamaDecodeEngine, _dense
from multimodal_colpali_tpu_torch.generation.qwen2vl_mm import Qwen2VLMMEngine
from multimodal_colpali_tpu_torch.models.configs import LlavaNextMMConfig
from multimodal_colpali_tpu_torch.models.processing import _resized, image_device, normalize_on
from multimodal_colpali_tpu_torch.ops.quant import quantize_encoder_params

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class LlavaNextImagePreprocessor:
    """RGB images (arrays or tensors) -> normalized ``[N, S, S, 3]`` float32
    at the base square (llava_next_mm.py:43-66): resized with Pillow's BICUBIC
    by ``ingest/imageops`` (no Pillow) on ``device`` or the pages' own, then
    CLIP's normalization. A numpy array on the CPU, a tensor on a CUDA device."""

    def __init__(self, cfg: LlavaNextMMConfig, device: Any = None):
        self.size = cfg.vision.image_size
        self.device = device

    def __call__(self, images: Sequence[Any]):
        dev = image_device(images, self.device)
        pix = normalize_on(torch.stack([_resized(im, self.size, dev, torch.float32)
                                        for im in images]), CLIP_MEAN, CLIP_STD)
        return pix.numpy() if pix.device.type == "cpu" else pix


class LlavaNextMMEngine(Qwen2VLMMEngine):
    """Image-conditioned LLaVA-NeXT generation on a ``LlavaNextMMConfig``.

    ``tower`` is the ``ClipFeatureTower`` and ``projector`` its tensors
    (``linear_1`` / ``linear_2`` kernels ``[in, out]`` with biases,
    ``image_newline``), on ``lm``'s device in its dtype, as
    ``models/registry.load_llava_next_mm`` makes them. ``vision_dtype="int8"``
    makes the tower's projections W8A8, in place."""

    image_rank = 3          # one image is [H, W, 3]
    first_position = 0
    shares_prefix_pages = True

    def __init__(self, cfg: LlavaNextMMConfig, tower: torch.nn.Module,
                 projector: Dict[str, Any], lm: LlamaDecodeEngine,
                 vision_dtype: str = "native"):
        if vision_dtype not in ("native", "int8"):
            raise ValueError(f"vision_dtype must be 'native' or 'int8', got {vision_dtype!r}")
        self.cfg = cfg
        self.vision_tower = tower
        if vision_dtype == "int8":
            quantize_encoder_params(tower)
        self.projector = projector
        self.lm = lm

    @property
    def tokens_per_image(self) -> int:
        return self.cfg.n_image_tokens

    def _tower(self, pix: torch.Tensor) -> torch.Tensor:
        if pix.dim() == 4:
            pix = pix[:, None]                       # [B, 1, H, W, 3]
        return self.vision_tower(pix.reshape((-1,) + tuple(pix.shape[2:])).to(self.lm.dtype))

    def _project(self, vis: torch.Tensor, b: int) -> torch.Tensor:
        """CLIP features ``[B * N, g^2, v_hidden]`` -> packed ``[B, N *
        n_image_tokens, t_hidden]`` (llava_next_mm.py:117-147): the projector,
        then per image its tokens and the same as a tile with a newline a row."""
        c, p = self.cfg, self.projector
        h = F.gelu(_dense(vis, p["linear_1"]["kernel"], p["linear_1"]["bias"]))
        proj = _dense(h, p["linear_2"]["kernel"], p["linear_2"]["bias"])
        g, th, bn = c.grid, c.text.hidden_size, proj.shape[0]
        newline = p["image_newline"].to(proj.dtype)[None, None, None, :].expand(bn, g, 1, th)
        tile = torch.cat([proj.reshape(bn, g, g, th), newline], dim=2).reshape(bn, g * (g + 1),
                                                                              th)
        feats = torch.cat([proj, tile], dim=1)       # the base first, as HF packs it
        return feats.reshape(b, -1, th).to(self.lm.dtype)

    def _positions(self, ids: torch.Tensor, mask: torch.Tensor):
        positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
        return positions, positions

    def build_mm_prompt(self, text_ids: Sequence[int], bos_id: int = -1, n_images: int = 1,
                        newline_ids: Sequence[int] = ()) -> List[int]:
        """LLaVA-NeXT's layout (llava_next_mm.py:169-180): per image one run
        of ``n_image_tokens`` image tokens, then the text and ``newline_ids``."""
        seq: List[int] = [] if bos_id < 0 else [bos_id]
        for _ in range(max(1, n_images)):
            seq += [self.cfg.image_token_id] * self.tokens_per_image
        return seq + list(text_ids) + list(newline_ids)
