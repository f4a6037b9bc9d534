"""Input processing for ColGranite (counterpart of
``multimodal_colpali_tpu/models/processing_granite.py``).

granite-vision / LLaVA-Next inputs, without Pillow: SigLIP normalization
(mean = std = 0.5), the prompt ``<image> * n Describe the image.\\n`` and
the usual ``Query: {query}\\n`` + 10 ``<pad>`` queries. The square layout
resizes each page BICUBIC to 384 px. ``anyres=True`` gives each page
LLaVA-Next's best-fit canvas among ``pinpoints`` (``tiling_for``: the
tiling and HF's ``unpad_image`` crop in feature units), and
``process_images(grid=)`` builds, per page, the base image and the
canvas's tiles: a BICUBIC fit of the page pasted at the centre of a black
canvas, the original page BICUBIC to the base square. Every resize is
``ingest.imageops.resize`` (Pillow's pixels) on the pages' device, ending
in uint8 as Pillow's does. Batches are grouped by layout
(``group_by_grid``); the Retriever and ``PipelinedEmbedder`` do it.

``process_images`` takes no ``device_preprocess``, so the Retriever refuses
it for this family, as the JAX Retriever does (registry.py:51-65).
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_colpali_tpu_torch.ingest.imageops import resize
from multimodal_colpali_tpu_torch.models.configs import ColGraniteModelConfig
from multimodal_colpali_tpu_torch.models.processing import (
    ImagePreprocessor, SimpleTokenizer, _size_of, _upload, group_by_layout, image_device,
    normalize_on, on_host, score_multi_vector)

IMAGE_PROMPT = "Describe the image."
QUERY_PREFIX = "Query: "
QUERY_AUGMENTATION_TOKENS = 10


def select_best_resolution(h: int, w: int, pinpoints) -> tuple:
    """LLaVA-Next's pinpoint choice (HF ``select_best_resolution``,
    processing_granite.py:22-35): the most original pixels kept after an
    aspect-preserving fit, ties to the least wasted canvas. (H, W) pairs."""
    best, best_fit, best_waste = None, -1, None
    for ph, pw in pinpoints:
        scale = min(pw / w, ph / h)
        dw, dh = int(w * scale), int(h * scale)
        fit = min(dw * dh, w * h)
        waste = ph * pw - fit
        if fit > best_fit or (fit == best_fit and waste < best_waste):
            best, best_fit, best_waste = (ph, pw), fit, waste
    return best


def _fit(t: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """``t`` BICUBIC to (w, h) unless it is that size (Pillow copies then)."""
    return t if tuple(t.shape[:2]) == (h, w) else resize(t, (w, h), "bicubic")


class ColGraniteProcessor:
    def __init__(self, cfg: ColGraniteModelConfig, tokenizer: Optional[Any] = None,
                 query_pad_to_multiple: int = 16, anyres: bool = False,
                 pinpoints: Optional[Sequence[tuple]] = None):
        self.cfg = cfg
        self.tokenizer = tokenizer or SimpleTokenizer(cfg.text.vocab_size, cfg.image_token_id)
        self.query_pad_to_multiple = query_pad_to_multiple
        self.image_preprocessor = ImagePreprocessor(cfg.vision.image_size)
        self.n_image_tokens = cfg.n_image_tokens
        self.dynamic_resolution = anyres  # JAX's keyword, the registry's flag
        self.pinpoints = list(pinpoints) if pinpoints is not None else cfg.default_pinpoints()

    def _ids(self, text: str) -> List[int]:
        try:
            return list(self.tokenizer.encode(text, add_special_tokens=False))
        except TypeError:
            return list(self.tokenizer.encode(text))

    # -- anyres tiling ------------------------------------------------------------

    def tiling_for(self, img: Any) -> Tuple[int, int, int, int]:
        """``(ty, tx, dy, dx)``: the best-fit canvas in tiles and HF's
        ``unpad_image`` crop of the ``[ty * g, tx * g]`` feature grid, in
        feature rows / columns a side, with HF's float comparison and
        ``int(round(x, 7))`` (processing_granite.py:68-99)."""
        h, w = _size_of(img)
        ph, pw = select_best_resolution(h, w, self.pinpoints)
        s = self.cfg.vision.image_size
        ty, tx = ph // s, pw // s
        g = self.cfg.grid
        ch, cw = ty * g, tx * g
        dy = dx = 0
        if w / h > cw / ch:
            new_h = int(round(h * (cw / w), 7))
            dy = (ch - new_h) // 2
        else:
            new_w = int(round(w * (ch / h), 7))
            dx = (cw - new_w) // 2
        return ty, tx, dy, dx

    def group_by_grid(self, images: Sequence[Any]) -> List[Tuple[Any, List[int]]]:
        """Image indices grouped by layout (one group, key None, without
        anyres), the square layout first, then layouts in order."""
        return group_by_layout(images, self.tiling_for if self.dynamic_resolution
                               else lambda _: None)

    def _canvas_tiles(self, img: Any, tiles: Tuple[int, int], device: torch.device) -> torch.Tensor:
        """uint8 ``[1 + T, S, S, 3]`` on ``device``: the page BICUBIC to the
        base square, then the canvas's tiles row-major: the page BICUBIC-fit
        into ``(ty * S, tx * S)`` and pasted at its centre on black
        (processing_granite.py:109-132)."""
        s = self.cfg.vision.image_size
        ty, tx = tiles
        t = _upload(img, device).to(torch.uint8)
        h, w = t.shape[:2]
        th, tw = ty * s, tx * s
        scale = min(tw / w, th / h)
        nw, nh = min(int(math.ceil(w * scale)), tw), min(int(math.ceil(h * scale)), th)
        canvas = torch.zeros((th, tw, 3), dtype=torch.uint8, device=device)
        y0, x0 = (th - nh) // 2, (tw - nw) // 2
        canvas[y0: y0 + nh, x0: x0 + nw] = _fit(t, nw, nh)
        parts = canvas.reshape(ty, s, tx, s, 3).permute(0, 2, 1, 3, 4).reshape(ty * tx, s, s, 3)
        return torch.cat([_fit(t, s, s)[None], parts])

    def process_images(self, images: Sequence[Any], grid: Optional[tuple] = None,
                       device: Any = None) -> dict:
        """-> {input_ids, attention_mask [B, S], pixel_values, grid}: pixels
        ``[B, S, S, 3]`` for the square layout (``grid`` None) or
        ``[B, 1 + T, S, S, 3]`` for an anyres layout from ``group_by_grid``;
        a tensor on a CUDA ``device`` (or the pages' own), else host arrays."""
        if grid is not None:
            dev = image_device(images, device)
            u8 = torch.stack([self._canvas_tiles(im, grid[:2], dev) for im in images])
            pre = self.image_preprocessor
            pix = on_host(normalize_on(u8.to(torch.float32), pre.mean, pre.std))
            n_tok = self.cfg.n_image_tokens_for(grid)
        else:
            pix = self.image_preprocessor(images, device)
            n_tok = self.n_image_tokens
        seq = [self.cfg.image_token_id] * n_tok + self._ids(IMAGE_PROMPT + "\n")
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
