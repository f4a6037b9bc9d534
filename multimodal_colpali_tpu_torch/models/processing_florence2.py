"""Input processing for ColFlor (counterpart of
``multimodal_colpali_tpu/models/processing_florence2.py``).

Florence-2 preprocessing: a bicubic resize to the square canvas (768 x 768
for the base model; an array already at that size is not resized;
``ingest.imageops``, Pillow's pixels without Pillow) and ImageNet
normalization, on the host, or on a CUDA ``device`` with the same float32
operations. A page contributes 1 pooled + (size / 32)^2 patch tokens as
``<image>`` placeholders (577 at 768 px), followed by the prompt ``Describe
the image.\\n``; queries are ``Query: {query}\\n`` plus 10 ``<pad>``
augmentation tokens, padded to a multiple of 16. ``process_images`` takes
no ``device_preprocess`` (K3's uint8 path), as in the JAX package.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from multimodal_colpali_tpu_torch.models.configs import ColFlorModelConfig
from multimodal_colpali_tpu_torch.models.processing import (
    SimpleTokenizer, _resized, image_device, normalize_on, on_host, score_multi_vector)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

IMAGE_PROMPT = "Describe the image."
QUERY_PREFIX = "Query: "
QUERY_AUGMENTATION_TOKENS = 10


class ColFlorProcessor:
    def __init__(self, cfg: ColFlorModelConfig, tokenizer: Optional[Any] = None,
                 query_pad_to_multiple: int = 16):
        self.cfg = cfg
        self.tokenizer = tokenizer or SimpleTokenizer(cfg.text.vocab_size, cfg.image_token_id)
        self.query_pad_to_multiple = query_pad_to_multiple
        ds = int(np.prod(cfg.vision.patch_stride))   # total downsampling of the backbone
        self.n_image_tokens = 1 + (cfg.image_size // ds) ** 2   # pooled token + patches

    def _ids(self, text: str) -> List[int]:
        try:
            return list(self.tokenizer.encode(text, add_special_tokens=False))
        except TypeError:
            return list(self.tokenizer.encode(text))

    def process_images(self, images: Sequence[Any], device: Any = None) -> dict:
        """-> {input_ids, attention_mask [B, S], pixel_values [B, H, W, 3] float32};
        the pixels are a tensor on a CUDA ``device`` (or the pages' own)."""
        size = self.cfg.image_size
        dev = image_device(images, device)
        pix = on_host(normalize_on(torch.stack([_resized(im, size, dev, torch.float32)
                                                for im in images]), IMAGENET_MEAN, IMAGENET_STD))
        seq = [self.cfg.image_token_id] * self.n_image_tokens + self._ids(IMAGE_PROMPT + "\n")
        input_ids = np.tile(np.asarray(seq, np.int32), (len(images), 1))
        return {"input_ids": input_ids, "attention_mask": np.ones_like(input_ids),
                "pixel_values": pix}

    def process_queries(self, queries: Sequence[str]) -> dict:
        pad = getattr(self.tokenizer, "pad_id", 0)
        rows = [self._ids(QUERY_PREFIX + q + "\n") + [pad] * QUERY_AUGMENTATION_TOKENS
                for q in queries]
        m = self.query_pad_to_multiple
        max_len = -(-max(len(r) for r in rows) // m) * m
        input_ids = np.full((len(rows), max_len), pad, np.int32)
        attention_mask = np.zeros((len(rows), max_len), np.int32)
        for i, r in enumerate(rows):
            input_ids[i, : len(r)] = r
            attention_mask[i, : len(r)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}

    def score_multi_vector(self, qs: Sequence[np.ndarray], ds: Sequence[np.ndarray],
                           device: Any = "cuda") -> np.ndarray:
        return score_multi_vector(qs, ds, device)
