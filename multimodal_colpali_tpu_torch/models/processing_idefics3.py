"""Input processing for ColIdefics3 / ColSmol
(counterpart of ``multimodal_colpali_tpu/models/processing_idefics3.py``).

The fixed square layout only: one full-page image resized to the vision size
(bicubic), normalized with mean = std = 0.5, behind ``n_image_tokens`` image
tokens and the prompt ``Describe the image.\\n``; queries are
``Query: {query}\\n`` plus 10 ``<pad>`` augmentation tokens, padded to a
multiple of 16. Image splitting (``image_splitting=True`` in the JAX
processor) is not ported.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from multimodal_colpali_tpu_torch.models.configs import ColIdefics3ModelConfig
from multimodal_colpali_tpu_torch.models.processing import (
    ImagePreprocessor, SimpleTokenizer, score_multi_vector)

IMAGE_PROMPT = "Describe the image."
QUERY_PREFIX = "Query: "
QUERY_AUGMENTATION_TOKENS = 10


class ColIdefics3Processor:
    def __init__(self, cfg: ColIdefics3ModelConfig, tokenizer: Optional[Any] = None,
                 query_pad_to_multiple: int = 16):
        self.cfg = cfg
        self.tokenizer = tokenizer or SimpleTokenizer(cfg.text.vocab_size, cfg.image_token_id)
        self.query_pad_to_multiple = query_pad_to_multiple
        self.image_preprocessor = ImagePreprocessor(cfg.vision.image_size)
        self.n_image_tokens = cfg.n_image_tokens

    def _ids(self, text: str) -> List[int]:
        try:
            return list(self.tokenizer.encode(text, add_special_tokens=False))
        except TypeError:
            return list(self.tokenizer.encode(text))

    def process_images(self, images: Sequence[Any], device_preprocess: bool = False,
                       device: Any = None) -> dict:
        """-> {input_ids, attention_mask [B, S], pixel_values [B, H, W, 3]};
        ``device_preprocess=True`` leaves the pixels as uint8; on a CUDA
        ``device`` they are a tensor there."""
        pix = (self.image_preprocessor.u8(images, device) if device_preprocess
               else self.image_preprocessor(images, device))
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
