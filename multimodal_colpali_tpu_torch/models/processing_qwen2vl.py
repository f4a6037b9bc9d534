"""Input processing for ColQwen2 (counterpart of ``multimodal_colpali_tpu/models/processing_qwen2vl.py``).

The Qwen2-VL image pipeline: a BICUBIC resize to the grid's pixels
(``imageops.resize``, Pillow's pixels: int64 sums for a host array, float64
on a tensor's device), CLIP normalization in float32 with the JAX module's
order of operations (``normalize_on``: device constants, not a CPU scalar),
temporal doubling and merge-group patch flattening; the retrieval prompts of
colpali-engine's ColQwen2Processor; and the mrope position ids of
``get_rope_index`` for the one-image-prefix layout.

``dynamic_resolution=True`` picks each image's grid by Qwen2-VL's
``smart_resize`` within the static bucket's pixel budget; batches are then
grouped by grid (``group_by_grid``). ``process_images`` takes no
``device_preprocess``: the Retriever refuses it for this family, as the JAX
Retriever does (registry.py:51-64).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_colpali_tpu_torch.ingest.imageops import resize
from multimodal_colpali_tpu_torch.models.configs import ColQwen2ModelConfig
from multimodal_colpali_tpu_torch.models.processing import (
    SimpleTokenizer, _rgb, image_device, normalize_on, on_host, score_multi_vector)

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

IMAGE_PROMPT = "Describe the image."
QUERY_PREFIX = "Query: "
QUERY_AUGMENTATION_TOKENS = 10


def flatten_patches(img: Any, cfg: ColQwen2ModelConfig,
                    grid: Optional[Tuple[int, int]] = None) -> Any:
    """``[..., H, W, 3]`` -> ``[..., grid_h * grid_w, C * T * ps * ps]`` in
    merge-group order (processing_qwen2vl.py:33-42), for a numpy array or a
    tensor, with or without a leading batch axis."""
    v = cfg.vision
    ps, m, t = v.patch_size, v.spatial_merge_size, v.temporal_patch_size
    gh, gw = grid if grid is not None else (cfg.grid_h, cfg.grid_w)
    lead = tuple(img.shape[:-3])
    if isinstance(img, torch.Tensor):
        chw = img.movedim(-1, -3)                                  # [..., C, H, W]
        frames = chw.unsqueeze(-4).expand(*lead, t, *chw.shape[-3:])
        p = frames.reshape(*lead, t, 3, gh // m, m, ps, gw // m, m, ps)
        n = len(lead)
        p = p.permute(*range(n), *(n + i for i in (2, 5, 3, 6, 1, 0, 4, 7)))
    else:
        chw = np.moveaxis(img, -1, -3)
        frames = np.repeat(chw[..., None, :, :, :], t, axis=-4)
        p = frames.reshape(*lead, t, 3, gh // m, m, ps, gw // m, m, ps)
        n = len(lead)
        p = p.transpose(*range(n), *(n + i for i in (2, 5, 3, 6, 1, 0, 4, 7)))
    return p.reshape(*lead, gh * gw, 3 * t * ps * ps)


def smart_grid(h_px: int, w_px: int, factor: int,
               min_pixels: int, max_pixels: int) -> Tuple[int, int]:
    """Qwen2-VL ``smart_resize``: native pixel dims -> (H, W) rounded to
    ``factor``, the area clamped into [min_pixels, max_pixels]
    (processing_qwen2vl.py:45-65)."""
    h = max(round(h_px / factor), 1) * factor
    w = max(round(w_px / factor), 1) * factor
    if h * w > max_pixels:
        beta = math.sqrt(h_px * w_px / max_pixels)
        h = max(math.floor(h_px / beta / factor), 1) * factor
        w = max(math.floor(w_px / beta / factor), 1) * factor
    elif h * w < min_pixels:
        beta = math.sqrt(min_pixels / (h_px * w_px))
        h = math.ceil(h_px * beta / factor) * factor
        w = math.ceil(w_px * beta / factor) * factor
    return h, w


def _size_of(img: Any) -> Tuple[int, int]:
    """(height, width) of a PIL image, array or tensor."""
    if not isinstance(img, (np.ndarray, torch.Tensor)) and hasattr(img, "size"):
        w_px, h_px = img.size
        return h_px, w_px
    return int(img.shape[0]), int(img.shape[1])


class ColQwen2Processor:
    def __init__(self, cfg: ColQwen2ModelConfig, tokenizer: Optional[Any] = None,
                 query_pad_to_multiple: int = 16, dynamic_resolution: bool = False,
                 min_pixels: Optional[int] = None, max_pixels: Optional[int] = None):
        self.cfg = cfg
        self.tokenizer = tokenizer or SimpleTokenizer(cfg.text.vocab_size, cfg.image_token_id)
        self.query_pad_to_multiple = query_pad_to_multiple
        m = cfg.vision.spatial_merge_size
        self.n_image_tokens = (cfg.grid_h // m) * (cfg.grid_w // m)
        self.dynamic_resolution = dynamic_resolution
        ps = cfg.vision.patch_size
        self.factor = ps * m
        self.min_pixels = min_pixels if min_pixels is not None else 4 * self.factor ** 2
        self.max_pixels = (max_pixels if max_pixels is not None
                           else cfg.grid_h * cfg.grid_w * ps * ps)

    def smart_grid(self, img: Any) -> Tuple[int, int]:
        """An image's (grid_h, grid_w) in patches by ``smart_resize``."""
        h_px, w_px = _size_of(img)
        h, w = smart_grid(h_px, w_px, self.factor, self.min_pixels, self.max_pixels)
        ps = self.cfg.vision.patch_size
        return h // ps, w // ps

    def group_by_grid(self, images: Sequence[Any]) -> List[Tuple[Tuple[int, int], List[int]]]:
        """Image indices grouped by grid (the static bucket when dynamic
        resolution is off), grids in sorted order."""
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, img in enumerate(images):
            g = (self.smart_grid(img) if self.dynamic_resolution
                 else (self.cfg.grid_h, self.cfg.grid_w))
            groups.setdefault(g, []).append(i)
        return sorted(groups.items())

    def _ids(self, text: str) -> List[int]:
        try:
            return list(self.tokenizer.encode(text, add_special_tokens=False))
        except TypeError:
            return list(self.tokenizer.encode(text))

    # -- images ---------------------------------------------------------------

    def _pixels(self, img: Any, h_px: int, w_px: int, device: torch.device) -> torch.Tensor:
        """One image's uint8 pixels at ``h_px`` x ``w_px`` on ``device``."""
        a = _rgb(img)
        t = (a.to(device) if isinstance(a, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(a)).to(device))
        if tuple(t.shape[:2]) != (h_px, w_px):
            t = resize(t.to(torch.uint8), (w_px, h_px), "bicubic")
        return t

    def process_images(self, images: Sequence[Any], grid: Optional[Tuple[int, int]] = None,
                       device: Any = None) -> dict:
        """-> {input_ids, attention_mask [B, S], pixel_values [B, P, patch_dim],
        position_ids [3, B, S], grid}; every image at one grid (the bucket,
        or a group's from ``group_by_grid``). The pixels are a tensor on a
        CUDA ``device`` (or the pages' own), else a host array."""
        c = self.cfg
        m = c.vision.spatial_merge_size
        gh, gw = grid if grid is not None else (c.grid_h, c.grid_w)
        ps = c.vision.patch_size
        dev = image_device(images, device)
        u8 = torch.stack([self._pixels(im, gh * ps, gw * ps, dev) for im in images])
        pix = flatten_patches(normalize_on(u8.to(torch.float32), CLIP_MEAN, CLIP_STD),
                              c, (gh, gw))
        seq = ([c.vision_start_token_id] + [c.image_token_id] * ((gh // m) * (gw // m))
               + [c.vision_end_token_id] + self._ids(IMAGE_PROMPT + "\n"))
        input_ids = np.tile(np.asarray(seq, np.int32), (len(images), 1))
        attention_mask = np.ones_like(input_ids)
        return {"input_ids": input_ids, "attention_mask": attention_mask,
                "pixel_values": on_host(pix.contiguous()),
                "position_ids": self.mrope_position_ids(input_ids, attention_mask, grid=(gh, gw)),
                "grid": (gh, gw)}

    # -- queries ----------------------------------------------------------------

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
        return {"input_ids": input_ids, "attention_mask": attention_mask,
                "position_ids": self.mrope_position_ids(input_ids, attention_mask)}

    # -- mrope ------------------------------------------------------------------

    def mrope_position_ids(self, input_ids: np.ndarray, attention_mask: np.ndarray,
                           grid: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """``[3, B, S]`` int64 positions of ``get_rope_index`` for at most one
        image block as a prefix and right padding
        (processing_qwen2vl.py:192-227)."""
        c = self.cfg
        m = c.vision.spatial_merge_size
        g = grid if grid is not None else (c.grid_h, c.grid_w)
        gh, gw = g[0] // m, g[1] // m
        b, s = input_ids.shape
        pos = np.zeros((3, b, s), np.int64)
        for i in range(b):
            ids = input_ids[i]
            valid = attention_mask[i] == 1
            img_slots = np.nonzero((ids == c.image_token_id) & valid)[0]
            if img_slots.size == 0:
                pos[:, i, :] = np.where(valid, np.cumsum(valid) - 1, 0)
                continue
            start = img_slots[0]
            pos[:, i, :start] = np.arange(start)
            block = slice(start, start + gh * gw)
            pos[0, i, block] = start
            pos[1, i, block] = start + np.repeat(np.arange(gh), gw)
            pos[2, i, block] = start + np.tile(np.arange(gw), gh)
            nxt = start + max(gh, gw)
            tail = np.nonzero(valid)[0]
            tail = tail[tail >= start + gh * gw]
            pos[:, i, tail] = nxt + np.arange(len(tail))
        return pos

    def score_multi_vector(self, qs: Sequence[np.ndarray], ds: Sequence[np.ndarray],
                           device: Any = "cuda") -> np.ndarray:
        return score_multi_vector(qs, ds, device)
