"""Input processing for ColPali (counterpart of ``multimodal_colpali_tpu/models/processing.py``).

The JAX package's processors are numpy-only, but importing them runs that
package's ``__init__``, which imports JAX; so this module carries its own
copy. Behaviour is the same:

- images -> fixed 448x448 bicubic resize, rescale 1/255, normalize to
  [-1, 1], prompt ``<image>*1024 <bos> Describe the image.\\n``;
  the resize is ``ingest.imageops.resize``, whose pixels equal Pillow's
  (no retriever needs Pillow: a PIL image is read through its own
  ``convert("RGB")`` and ``np.asarray``). The pages are resized and
  normalized as torch tensors on ``device``: on the CPU (returned as numpy
  arrays) or uploaded as uint8 to a CUDA device (the same pixels and the
  same float32 operations);
- queries -> ``<bos> Query: {query}`` + 10 ``<pad>`` augmentation tokens.

``score_multi_vector`` runs the port's MaxSim (K1 on a CUDA device).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_colpali_tpu_torch._device import resolve_device
from multimodal_colpali_tpu_torch.ingest.imageops import resize
from multimodal_colpali_tpu_torch.models.configs import ColPaliModelConfig
from multimodal_colpali_tpu_torch.ops.maxsim import maxsim_scores

IMAGE_PROMPT = "Describe the image."
QUERY_PREFIX = "Query: "
QUERY_AUGMENTATION_TOKENS = 10


class SimpleTokenizer:
    """Deterministic hash tokenizer for runs without a checkpoint tokenizer.

    Splits on whitespace/punctuation and hashes (FNV-1a) into the vocab,
    reserving ids 0=<pad>, 1=<eos>, 2=<bos>, image_token_id=<image>."""

    def __init__(self, vocab_size: int, image_token_id: int):
        self.vocab_size = vocab_size
        self.pad_id = 0
        self.eos_id = 1
        self.bos_id = 2
        self.image_token_id = image_token_id

    def encode(self, text: str) -> List[int]:
        pieces = re.findall(r"\w+|[^\w\s]", text.lower())
        lo, hi = 3, self.vocab_size - 1
        out = []
        for p in pieces:
            h = 2166136261
            for ch in p.encode():  # FNV-1a, stable across runs and processes
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            out.append(lo + h % (hi - lo))
        return out


def _rgb(img: Any) -> Any:
    """A PIL image as an RGB array (its own ``convert``; Pillow is not
    imported here); arrays and tensors as they are."""
    if not isinstance(img, (np.ndarray, torch.Tensor)) and hasattr(img, "convert"):
        return np.asarray(img.convert("RGB"))
    return img


def _resized(img: Any, size: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A page at ``size`` x ``size`` on ``device`` as ``dtype``: its uint8
    pixels uploaded, then (unless already that size) BICUBIC-resized there
    (``imageops``' float64 sums, equal to its host int64 path and to
    Pillow)."""
    a = _rgb(img)
    t = (a.to(device) if isinstance(a, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(a)).to(device))
    if tuple(t.shape[:2]) == (size, size):
        return t.to(dtype)
    return resize(t.to(torch.uint8), (size, size), "bicubic").to(dtype)


def normalize_on(x: torch.Tensor, mean: Any, std: Any) -> torch.Tensor:
    """``(x / 255 - mean) / std`` in float32 on ``x``'s device, each step the
    host's IEEE operation. The constants are tensors on that device: CUDA
    divides by a CPU scalar as a product with its reciprocal, which can
    differ from the division by one ulp."""
    def const(v):
        return torch.as_tensor(v, dtype=torch.float32, device=x.device)

    return (x / const(255.0) - const(mean)) / const(std)


def image_device(images: Sequence[Any], device: Any = None) -> torch.device:
    """Where to resize ``images``: ``device`` if given, else the device of
    tensor pages, else the CPU."""
    if device is None and images and isinstance(images[0], torch.Tensor):
        device = images[0].device
    return torch.device("cpu" if device is None else device)


def on_host(pix: torch.Tensor) -> Any:
    """Pixels as the processors return them: a numpy array on the CPU, the
    tensor itself on a CUDA device."""
    return pix.numpy() if pix.device.type == "cpu" else pix


@dataclasses.dataclass
class ImagePreprocessor:
    """PIL or array -> normalized NHWC float32, SigLIP convention."""

    image_size: int = 448
    mean: float = 0.5
    std: float = 0.5

    def __call__(self, images: Sequence[Any], device: Any = None):
        """-> normalized ``[B, S, S, 3]`` float32 on ``image_device(images,
        device)``: a numpy array on the CPU, a tensor on a CUDA device."""
        dev = image_device(images, device)
        return on_host(normalize_on(torch.stack([_resized(img, self.image_size, dev,
                                                          torch.float32) for img in images]),
                                    self.mean, self.std))

    def u8(self, images: Sequence[Any], device: Any = None):
        """-> resized uint8 NHWC (numpy on the CPU, a tensor on a CUDA
        device); normalization happens on the device
        (``ops/preprocess.normalize_images``, K3 on a CUDA device)."""
        dev = image_device(images, device)
        return on_host(torch.stack([_resized(img, self.image_size, dev, torch.uint8)
                                    for img in images]))


class ColPaliProcessor:
    """Builds model inputs; shape-compatible with the HF processor surface."""

    def __init__(self, cfg: ColPaliModelConfig, tokenizer: Optional[Any] = None,
                 query_pad_to_multiple: int = 16):
        self.cfg = cfg
        self.tokenizer = tokenizer or SimpleTokenizer(cfg.text.vocab_size, cfg.image_token_id)
        self.image_seq_length = cfg.vision.num_patches
        self.image_preprocessor = ImagePreprocessor(cfg.vision.image_size)
        self.query_pad_to_multiple = query_pad_to_multiple

    def _ids(self, text: str) -> List[int]:
        tok = self.tokenizer
        if not hasattr(tok, "encode"):
            raise TypeError("tokenizer must expose .encode()")
        try:
            return list(tok.encode(text, add_special_tokens=False))
        except TypeError:
            return list(tok.encode(text))

    def _special(self, name: str, default: int) -> int:
        return getattr(self.tokenizer, name, default)

    def process_images(self, images: Sequence[Any], device_preprocess: bool = False,
                       device: Any = None) -> dict:
        """-> {input_ids, attention_mask [B, S], pixel_values [B, H, W, 3]};
        ``device_preprocess=True`` leaves the pixels as uint8. The pixels are
        a tensor on a CUDA ``device`` (or the pages' own), else host arrays."""
        if device_preprocess:
            pix = self.image_preprocessor.u8(images, device)
        else:
            pix = self.image_preprocessor(images, device)
        seq = ([self.cfg.image_token_id] * self.image_seq_length
               + [self._special("bos_id", 2)] + self._ids(IMAGE_PROMPT + "\n"))
        input_ids = np.tile(np.asarray(seq, np.int32), (len(images), 1))
        return {"input_ids": input_ids, "attention_mask": np.ones_like(input_ids),
                "pixel_values": pix}

    def process_queries(self, queries: Sequence[str]) -> dict:
        """-> {input_ids, attention_mask [B, S]} padded to a length bucket."""
        bos = self._special("bos_id", 2)
        pad = self._special("pad_id", 0)
        rows = [[bos] + self._ids(QUERY_PREFIX + q + "\n") + [pad] * QUERY_AUGMENTATION_TOKENS
                for q in queries]
        m = self.query_pad_to_multiple
        max_len = -(-max(len(r) for r in rows) // m) * m
        input_ids = np.full((len(rows), max_len), pad, np.int32)
        attention_mask = np.zeros((len(rows), max_len), np.int32)
        for i, r in enumerate(rows):
            input_ids[i, : len(r)] = r
            # the <pad> augmentation tokens are attended (query expansion)
            attention_mask[i, : len(r)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}

    def score_multi_vector(self, qs: Sequence[np.ndarray], ds: Sequence[np.ndarray],
                           device: Any = "cuda") -> np.ndarray:
        return score_multi_vector(qs, ds, device)


def score_multi_vector(qs: Sequence[np.ndarray], ds: Sequence[np.ndarray],
                       device: Any = "cuda") -> np.ndarray:
    """MaxSim scores ``[n_queries, n_docs]`` from variable-length embeddings,
    computed on ``device``."""
    device = resolve_device(device)
    q_pad, q_lens = pad_multivectors(qs)
    d_pad, d_lens = pad_multivectors(ds)
    scores = maxsim_scores(
        torch.from_numpy(q_pad).to(device), torch.from_numpy(d_pad).to(device),
        torch.from_numpy(q_lens).to(device), torch.from_numpy(d_lens).to(device))
    return scores.cpu().numpy()


def pad_multivectors(arrs: Sequence[np.ndarray],
                     multiple: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length [n_i, dim] arrays into [N, max_n, dim] + lengths."""
    lens = np.asarray([a.shape[0] for a in arrs], np.int32)
    max_n = int(max(1, -(-lens.max() // multiple) * multiple))
    out = np.zeros((len(arrs), max_n, arrs[0].shape[-1]), np.float32)
    for i, a in enumerate(arrs):
        out[i, : a.shape[0]] = np.asarray(a, np.float32)
    return out, lens
