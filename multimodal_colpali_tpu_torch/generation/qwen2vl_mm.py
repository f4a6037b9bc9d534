"""Image-conditioned Qwen2-VL generation, the old-model tier's
AdaptLLM/biomed-Qwen2-VL-2B-Instruct (counterpart of
``multimodal_colpali_tpu/generation/qwen2vl_mm.py``).

- The tower is the ColQwen2 retrievers' ``Qwen2VisionTower`` (an
  ``nn.Module``; full attention over an image's patches, K2 on a CUDA
  tensor), whose 2 x 2 merger already projects to the LM's width: there is no
  separate projector. At the static 54 x 54 grid an image is 2,916 patches
  and 729 tokens.
- The prompt is causal, images included, at mrope positions computed from
  the ids alone (:func:`mrope_positions_from_ids`, HF's ``get_rope_index``):
  text advances one, an image block takes ``(t, base + row, base + col)`` and
  advances ``max(grid_h, grid_w)`` after its last token. Decoding is text:
  the three streams are equal, from HF's ``max(position) + 1``. A prompt's
  decode position therefore runs behind its KV length; the batchers keep
  both (``scheduler.py``).
- Decoding reuses the text engine's ``_chunk`` and ``_decode``: ``lm`` is the
  ``Qwen2DecodeEngine`` that serves text beside this engine.

``pixel_values`` are pre-patchified, ``[B, P, patch_dim]`` or ``[B, N, P,
patch_dim]`` for N images a row (``image_rank = 2``: one image is ``[P,
patch_dim]``), as :class:`Qwen2VLImagePreprocessor` makes them.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from multimodal_colpali_tpu_torch.generation.engine import (
    Qwen2DecodeEngine, _ImageEngine, attn_scale, layer_stack)
from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.models.processing import image_device, normalize_on
from multimodal_colpali_tpu_torch.models.processing_qwen2vl import (
    CLIP_MEAN, CLIP_STD, ColQwen2Processor, flatten_patches)
from multimodal_colpali_tpu_torch.ops.quant import quantize_encoder_params


def mrope_positions_from_ids(ids: torch.Tensor, mask: torch.Tensor, image_token_id: int,
                             grid_hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF's ``get_rope_index`` for generation layouts (qwen2vl_mm.py:47-81):
    ``ids``/``mask`` ``[B, S]`` left-padded, every image block ``gh * gw``
    tokens of the merged grid ``grid_hw``. -> (positions ``[3, B, S]``,
    ``last_pos [B]``), ``last_pos + 1`` the first generated token's position."""
    gh, gw = grid_hw
    n_tok = gh * gw
    valid = mask.bool()
    is_img = (ids == image_token_id) & valid
    is_txt = valid & ~is_img
    j = (torch.cumsum(is_img.long(), dim=1) - 1) % n_tok      # in-block index
    block_last = is_img & (j == n_tok - 1)
    adv = is_txt.long() + block_last.long() * max(gh, gw)    # advance after a token
    base = torch.where(valid, torch.cumsum(adv, dim=1) - adv, torch.zeros_like(adv))
    zero = torch.zeros_like(j)
    pos = torch.stack([base, base + torch.where(is_img, j // gw, zero),
                       base + torch.where(is_img, j % gw, zero)])
    return pos, adv.sum(dim=1) - 1


class Qwen2VLImagePreprocessor:
    """RGB images (arrays or tensors) -> ``[N, P, patch_dim]`` float32 at the
    config's static grid (qwen2vl_mm.py:84-97): a BICUBIC resize to the
    grid's pixels (``ingest/imageops``, Pillow's pixels, on ``device`` or the
    pages' own), CLIP normalization, patches in merge order. A numpy array on
    the CPU, a tensor on a CUDA device."""

    def __init__(self, cfg, device: Any = None):
        self._proc = ColQwen2Processor(cfg)
        self.cfg = cfg
        self.device = device

    def __call__(self, images: Sequence[Any]):
        c = self.cfg
        ps = c.vision.patch_size
        dev = image_device(images, self.device)
        u8 = torch.stack([self._proc._pixels(im, c.grid_h * ps, c.grid_w * ps, dev)
                          for im in images])
        pix = flatten_patches(normalize_on(u8.to(torch.float32), CLIP_MEAN, CLIP_STD), c)
        return pix.numpy() if pix.device.type == "cpu" else pix


class Qwen2VLMMEngine(_ImageEngine):
    """Image-conditioned Qwen2-VL generation on the plain-VL
    ``ColQwen2ModelConfig`` (``qwen2_vl_2b`` / ``qwen2_vl_7b``).

    ``tower`` is the ``Qwen2VisionTower`` of ``cfg.vision`` on ``lm``'s device
    in its dtype, as ``models/registry.load_qwen2vl_mm`` makes it;
    ``vision_dtype="int8"`` makes its projections W8A8, in place."""

    image_rank = 2          # one image is [P, patch_dim]
    # positions start at 0; causal prompts with fixed-length image blocks may
    # share prefix pages (their positions, too, follow from the tokens before)
    first_position = 0
    shares_prefix_pages = True

    def __init__(self, cfg, tower: torch.nn.Module, lm: Qwen2DecodeEngine,
                 vision_dtype: str = "native"):
        if vision_dtype not in ("native", "int8"):
            raise ValueError(f"vision_dtype must be 'native' or 'int8', got {vision_dtype!r}")
        self.cfg = cfg
        self.vision_tower = tower
        if vision_dtype == "int8":
            quantize_encoder_params(tower)
        self.lm = lm

    @property
    def _grid_merged(self) -> Tuple[int, int]:
        m = self.cfg.vision.spatial_merge_size
        return self.cfg.grid_h // m, self.cfg.grid_w // m

    @property
    def tokens_per_image(self) -> int:
        gh, gw = self._grid_merged
        return gh * gw

    # -- vision ----------------------------------------------------------------

    def _tower(self, pix: torch.Tensor) -> torch.Tensor:
        """``[B, N, P, patch_dim]`` (or ``[B, P, patch_dim]``) -> merged
        features ``[B * N, P / 4, hidden]``."""
        if pix.dim() == 3:
            pix = pix[:, None]
        flat = pix.reshape((-1,) + tuple(pix.shape[2:])).to(self.lm.dtype)
        return self.vision_tower(flat, self.cfg.grid_h, self.cfg.grid_w)

    def _project(self, vis: torch.Tensor, b: int) -> torch.Tensor:
        return vis.reshape(b, -1, vis.shape[-1]).to(self.lm.dtype)

    def _merge(self, ids: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        """Text embeddings (not scaled) with the image features in the
        ``<image>`` slots, image after image (qwen2vl_mm.py:165-178)."""
        eng = self.lm
        is_img = ids == self.cfg.image_token_id
        embeds = eng._embed(eng.params, torch.where(is_img, torch.zeros_like(ids), ids))
        img_pos = (torch.cumsum(is_img.long(), dim=1) - 1).clamp(0, img.shape[1] - 1)
        gathered = torch.gather(img, 1, img_pos[..., None].expand(-1, -1, img.shape[-1]))
        return torch.where(is_img[..., None], gathered, embeds)

    # -- prefill -----------------------------------------------------------------

    def _positions(self, ids: torch.Tensor, mask: torch.Tensor):
        """(the layers' positions, the decode positions ``[B, S]``)."""
        pos3, _ = mrope_positions_from_ids(ids, mask, self.cfg.image_token_id,
                                           self._grid_merged)
        # the largest stream: its last column is HF's max(position)
        return pos3, pos3.amax(dim=0)

    def prompt_positions(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self._positions(ids, mask)[1]

    def _prefill_embeds(self, ids: torch.Tensor, mask: torch.Tensor, x: torch.Tensor, kc, vc):
        """The causal prompt ``ids``/``mask [B, s]`` with embeddings ``x``
        through every layer (qwen2vl_mm.py:182-199), K/V written into the
        caches' first ``s`` rows -> (hidden, (k, v), decode positions)."""
        eng = self.lm
        s = ids.shape[1]
        layer_pos, positions = self._positions(ids, mask)
        t = kc[0].shape[1]
        valid = torch.zeros((ids.shape[0], t), dtype=torch.bool, device=ids.device)
        valid[:, :s] = mask.bool()
        cols = torch.arange(t, device=ids.device)
        att = (valid[:, None, None, :] & (cols[None, :] <= cols[:s, None])[None, None])
        sc = attn_scale(eng.cfg)

        def kv_write(i, k, v):
            kc[i][:, :s] = k
            vc[i][:, :s] = v
            return kc[i], vc[i]

        def attend(i, q, k, v):
            return L.attention(q, k, v, mask=att, scale=sc)

        hidden, kv = layer_stack(eng.params, eng.cfg, x, layer_pos, kv_write, attend)
        return hidden, kv, positions

    def build_mm_prompt(self, text_ids: Sequence[int], bos_id: int = -1, n_images: int = 1,
                        newline_ids: Sequence[int] = ()) -> List[int]:
        """Qwen2-VL's layout (qwen2vl_mm.py:304-319): per image
        ``<|vision_start|>``, ``tokens_per_image`` image tokens and
        ``<|vision_end|>``, then the text and ``newline_ids``; ``bos_id < 0``
        leaves the bos out (Qwen2 has none)."""
        c = self.cfg
        seq: List[int] = [] if bos_id < 0 else [bos_id]
        for _ in range(max(1, n_images)):
            seq.append(c.vision_start_token_id)
            seq += [c.image_token_id] * self.tokens_per_image
            seq.append(c.vision_end_token_id)
        return seq + list(text_ids) + list(newline_ids)
