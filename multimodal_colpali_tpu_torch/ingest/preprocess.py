"""Image size normalization for ingestion (counterpart of
``multimodal_colpali_tpu/ingest/preprocess.py``).

``resize_image`` keeps the reference's semantics (functions.py:219-233):
upscale so the *short* side is >= 224, then downscale so the *long* side is
<= 1300, LANCZOS, aspect ratio kept, sizes by Python's ``round``. It takes a
uint8 array (resized on the host) or tensor (resized on its device) and
returns the same type, through ``imageops.resize``, whose pixels equal
Pillow's. An image already in range is returned as it is.
``resize_image_on`` resizes a host array on a given device.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from multimodal_colpali_tpu_torch.ingest.imageops import resize

MIN_SIDE = 224
MAX_SIDE = 1300


def resize_image(img: Any, min_side: int = MIN_SIDE, max_side: int = MAX_SIDE) -> Any:
    h, w = int(img.shape[0]), int(img.shape[1])
    short, long = min(w, h), max(w, h)
    scale = 1.0
    if short < min_side:
        scale = min_side / short
    if long * scale > max_side:
        scale = max_side / long
    if scale == 1.0:
        return img
    nw, nh = max(1, round(w * scale)), max(1, round(h * scale))
    return resize(img, (nw, nh), "lanczos")


def resize_image_on(img: np.ndarray, device: torch.device) -> Any:
    """``resize_image`` of a host uint8 array on ``device``: a host array on
    the CPU; on a CUDA device the array is uploaded first and a tensor there
    comes back (the same pixels)."""
    if device.type != "cpu":
        img = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    return resize_image(img)
