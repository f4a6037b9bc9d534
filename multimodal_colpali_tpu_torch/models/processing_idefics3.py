"""Input processing for ColIdefics3 / ColSmol
(counterpart of ``multimodal_colpali_tpu/models/processing_idefics3.py``).

The fixed square layout: one full-page image resized to the vision size
(bicubic), normalized with mean = std = 0.5, behind ``n_image_tokens`` image
tokens and the prompt ``Describe the image.\\n``; queries are
``Query: {query}\\n`` plus 10 ``<pad>`` augmentation tokens, padded to a
multiple of 16.

``image_splitting=True`` is SmolVLM's image splitting, HF
``Idefics3ImageProcessor``'s chain (processing_idefics3.py:57-180): the page
LANCZOS to ``longest_edge`` (the short side rounded to an even number),
LANCZOS again onto a canvas of whole encoder-size tiles (``tiling_for``,
clamped to ``max_tiles``), cut row-major, and the canvas LANCZOS to the
encoder size as the global view, last; every step ends in uint8, as
Pillow's does (``ingest.imageops.resize``, on the pages' device). The
prompt interleaves the tokenizer's markers (``<fake_token_around_image>``,
``<row_i_col_j>``, ``<global-img>``) with each sub-image's image tokens.
Batches are grouped by tiling (``group_by_grid``).
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_colpali_tpu_torch.ingest.imageops import resize
from multimodal_colpali_tpu_torch.models.configs import ColIdefics3ModelConfig
from multimodal_colpali_tpu_torch.models.processing import (
    ImagePreprocessor, SimpleTokenizer, _size_of, _upload, group_by_layout, image_device,
    normalize_on, on_host, score_multi_vector)

IMAGE_PROMPT = "Describe the image."
QUERY_PREFIX = "Query: "
QUERY_AUGMENTATION_TOKENS = 10


class ColIdefics3Processor:
    def __init__(self, cfg: ColIdefics3ModelConfig, tokenizer: Optional[Any] = None,
                 query_pad_to_multiple: int = 16, image_splitting: bool = False,
                 max_tiles: int = 4, longest_edge: Optional[int] = None):
        self.cfg = cfg
        self.tokenizer = tokenizer or SimpleTokenizer(cfg.text.vocab_size, cfg.image_token_id)
        self.query_pad_to_multiple = query_pad_to_multiple
        self.image_preprocessor = ImagePreprocessor(cfg.vision.image_size)
        self.n_image_tokens = cfg.n_image_tokens
        self.dynamic_resolution = image_splitting  # JAX's keyword, the registry's flag
        self.max_tiles = max_tiles
        self.longest_edge = longest_edge or 2 * cfg.vision.image_size

    def _ids(self, text: str) -> List[int]:
        try:
            return list(self.tokenizer.encode(text, add_special_tokens=False))
        except TypeError:
            return list(self.tokenizer.encode(text))

    # -- splitting ------------------------------------------------------------------

    def _resize_dims(self, w: int, h: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """HF's two sizes (processing_idefics3.py:59-84): (w1, h1), the longest
        edge at ``longest_edge`` and the other side rounded up to even, then
        (w2, h2), that stretched to whole tiles."""
        s = self.cfg.vision.image_size
        aspect = w / max(h, 1)
        if w >= h:
            w1 = self.longest_edge
            h1 = int(w1 / aspect)
            h1 += h1 % 2
        else:
            h1 = self.longest_edge
            w1 = int(h1 * aspect)
            w1 += w1 % 2
        w1, h1 = max(w1, 1), max(h1, 1)
        aspect = w1 / max(h1, 1)
        if w1 >= h1:
            w2 = math.ceil(w1 / s) * s
            h2 = math.ceil(int(w2 / aspect) / s) * s
        else:
            h2 = math.ceil(h1 / s) * s
            w2 = math.ceil(int(h2 * aspect) / s) * s
        return (w1, h1), (max(w2, s), max(h2, s))

    def tiling_for(self, img: Any) -> Tuple[int, int]:
        """(ty, tx): the tile grid of the stretched canvas, its longer axis
        shrunk first while it holds more than ``max_tiles``
        (processing_idefics3.py:86-104)."""
        h, w = _size_of(img)
        s = self.cfg.vision.image_size
        _, (w2, h2) = self._resize_dims(w, h)
        ty, tx = h2 // s, w2 // s
        while ty * tx > self.max_tiles:
            if ty >= tx and ty > 1:
                ty -= 1
            elif tx > 1:
                tx -= 1
            else:
                break
        return ty, tx

    def group_by_grid(self, images: Sequence[Any]) -> List[Tuple[Any, List[int]]]:
        """Image indices grouped by tiling (one group, key None, without
        splitting), in order of the tilings."""
        return group_by_layout(images, self.tiling_for if self.dynamic_resolution
                               else lambda _: None)

    def _split_tiles(self, img: Any, tiles: Tuple[int, int], device: torch.device) -> torch.Tensor:
        """uint8 ``[T + 1, S, S, 3]`` on ``device``: the canvas's tiles
        row-major, then the global view (processing_idefics3.py:113-141)."""
        s = self.cfg.vision.image_size
        ty, tx = tiles
        t = _upload(img, device).to(torch.uint8)
        h, w = t.shape[:2]
        (w1, h1), _ = self._resize_dims(w, h)
        canvas = t
        for size in ((w1, h1), (tx * s, ty * s)):
            if tuple(canvas.shape[:2]) != (size[1], size[0]):
                canvas = resize(canvas, size, "lanczos")
        parts = canvas.reshape(ty, s, tx, s, 3).permute(0, 2, 1, 3, 4).reshape(ty * tx, s, s, 3)
        glob = canvas if (ty, tx) == (1, 1) else resize(canvas, (s, s), "lanczos")
        return torch.cat([parts, glob[None]])

    def _split_prompt_ids(self, tiles: Tuple[int, int]) -> List[int]:
        """HF ``_prompt_split_image``: per tile a marker, its row/column tag and
        its image tokens, a newline a row, then the global view's
        (processing_idefics3.py:143-156)."""
        ty, tx = tiles
        img = self.cfg.image_token_id
        fake = self._ids("<fake_token_around_image>")
        seq: List[int] = []
        for yi in range(ty):
            for xi in range(tx):
                seq += fake + self._ids(f"<row_{yi + 1}_col_{xi + 1}>")
                seq += [img] * self.n_image_tokens
            seq += self._ids("\n")
        seq += self._ids("\n") + fake + self._ids("<global-img>")
        return seq + [img] * self.n_image_tokens + fake

    def process_images(self, images: Sequence[Any], grid: Optional[tuple] = None,
                       device_preprocess: bool = False, device: Any = None) -> dict:
        """-> {input_ids, attention_mask [B, S], pixel_values, grid}: pixels
        ``[B, H, W, 3]`` (``grid`` None) or, for a tiling from
        ``group_by_grid``, ``[B, T + 1, S, S, 3]``. ``device_preprocess=True``
        leaves square-layout pixels as uint8 (splitting refuses it); on a
        CUDA ``device`` the pixels are a tensor there."""
        prompt_ids = self._ids(IMAGE_PROMPT + "\n")
        if grid is not None:
            if device_preprocess:
                raise ValueError("device_preprocess supports the fixed square layout "
                                 "only, not image splitting")
            dev = image_device(images, device)
            u8 = torch.stack([self._split_tiles(im, grid, dev) for im in images])
            pre = self.image_preprocessor
            pix = on_host(normalize_on(u8.to(torch.float32), pre.mean, pre.std))
            seq = self._split_prompt_ids(grid) + prompt_ids
        else:
            pix = (self.image_preprocessor.u8(images, device) if device_preprocess
                   else self.image_preprocessor(images, device))
            seq = [self.cfg.image_token_id] * self.n_image_tokens + prompt_ids
        input_ids = np.tile(np.asarray(seq, np.int32), (len(images), 1))
        return {"input_ids": input_ids, "attention_mask": np.ones_like(input_ids),
                "pixel_values": pix, "grid": grid}

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
